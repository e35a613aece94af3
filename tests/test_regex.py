"""Regex compiler vs Python `re` (DOTALL, search semantics)."""

import re

import numpy as np
import pytest

from duckdb_parquet_parser.ops.regex import (
    UnsupportedPattern,
    compile_pattern,
    like_to_regex,
)
from duckdb_parquet_parser.ops.scan import dfa_match

CASES = [
    ("abc", ["abc", "xxabcyy", "ab", "ABC", ""]),
    ("^abc$", ["abc", "xabc", "abcx", "abc "]),
    ("a.c", ["abc", "axc", "ac", "a\nc"]),
    ("a*b", ["b", "aab", "aaa", "xb", ""]),
    ("(ab|cd)+", ["ab", "cdab", "ad", "", "abcdcd"]),
    ("[a-f]+z", ["az", "ffz", "gz", "z", "abcdefz"]),
    ("[^0-9]x", ["ax", "1x", "x", "!x"]),
    ("\\d+\\.\\d+", ["3.14", "3,14", "a12.5b", "12."]),
    ("colou?r", ["color", "colour", "colouur"]),
    ("^(foo|bar)*$", ["", "foofoo", "barfoo", "fooba"]),
    ("\\w+@\\w+", ["joe@example", "@", "a@b", "a b"]),
    ("\\s", ["a b", "ab", "\tx"]),
    ("x|", ["x", "y", ""]),  # empty alternative matches everything
]


@pytest.mark.parametrize("pattern,strings", CASES)
def test_compile_matches_re(pattern, strings):
    dfa = compile_pattern(pattern)
    for s in strings:
        want = re.search(pattern.encode(), s.encode(), re.DOTALL) is not None
        assert dfa.match_str(s.encode()) == want, (pattern, s)


def test_binary_bytes():
    dfa = compile_pattern("a.b")
    assert dfa.match_str(b"a\xffb")
    assert dfa.match_str(b"\x00a\x00b\x00")


def test_like_translation():
    dfa = compile_pattern(like_to_regex("%foo_bar%"))
    assert dfa.match_str(b"xx fooXbar yy")
    assert not dfa.match_str(b"foobar")
    dfa2 = compile_pattern(like_to_regex("ab%"))
    assert dfa2.match_str(b"abzzz")
    assert not dfa2.match_str(b"zab")


@pytest.mark.parametrize("pattern", ["(?=x)", "\\bword", "a(b", "*x", "a{2,1}", "a{999}"])
def test_unsupported_raises(pattern):
    with pytest.raises(UnsupportedPattern):
        compile_pattern(pattern)


COUNTED = [
    ("a{3}", ["aa", "aaa", "aaaa", "baaab"]),
    ("a{2,4}b", ["ab", "aab", "aaaab", "aaaaab", "b"]),
    ("(ab){2,}", ["ab", "abab", "ababab", "aabb"]),
    ("x{0,2}y", ["y", "xy", "xxy", "xxxy"]),
    ("[ab]{2}c", ["abc", "bac", "ac", "aabc"]),
]


@pytest.mark.parametrize("pattern,strings", COUNTED)
def test_counted_repeats(pattern, strings):
    dfa = compile_pattern(pattern)
    for s in strings:
        want = re.search(pattern.encode(), s.encode(), re.DOTALL) is not None
        assert dfa.match_str(s.encode()) == want, (pattern, s)


@pytest.mark.parametrize("xp_name", ["numpy", "jax"])
def test_dfa_match_vectorized(xp_name, rng):
    if xp_name == "jax":
        import jax.numpy as xp
    else:
        xp = np
    pattern = "(alpha|bravo)+.*z"
    dfa = compile_pattern(pattern)
    strings = [
        b"alphaz", b"bravo last z", b"alpha", b"", b"zzz alphabravo then z",
        b"ALPHAZ", b"xx", b"alphaalphaz",
    ] * 7
    pitch = max(len(s) for s in strings)
    chars = np.zeros((len(strings), pitch), np.uint8)
    lens = np.zeros(len(strings), np.int32)
    for i, s in enumerate(strings):
        chars[i, : len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    got = np.asarray(
        dfa_match(xp, xp.asarray(chars), xp.asarray(lens), dfa.table, dfa.accept)
    )
    want = np.array(
        [re.search(pattern.encode(), s, re.DOTALL) is not None for s in strings]
    )
    assert np.array_equal(got, want)
