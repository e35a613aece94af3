"""Device-side string kernels (raw-payload path): offsets/lens parsing and
the streaming DFA, vs host string tables and Python re."""

import re

import numpy as np
import pytest

import jax.numpy as jnp

from duckdb_parquet_parser.host import bindings
from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser.ops.regex import compile_pattern
from duckdb_parquet_parser.ops.strings import (
    match_payload_stream,
    match_values_by_offset,
    string_offsets,
)
from tests import fixtures


@pytest.fixture(scope="module")
def plain_file(tmp_path_factory):
    rng = np.random.default_rng(17)
    return fixtures.strings_file(
        tmp_path_factory.mktemp("str") / "p.parquet", rng, n=1200, null_p=0.25
    )


def _both(reader):
    host = reader.prescan("s", pad_strings=8)
    dev = reader.prescan("s", flags=bindings.PS_PAYLOAD)
    return host, dev


@pytest.mark.parametrize("xp", [np, jnp])
def test_string_offsets_match_host_tables(plain_file, xp):
    r = ParquetReader(plain_file)
    host, dev = _both(r)
    offs, lens = string_offsets(
        xp, xp.asarray(dev.arrays["payload"]),
        xp.asarray(dev.arrays["page_nn"]), dev.nn_cap,
    )
    offs, lens = np.asarray(offs), np.asarray(lens)
    nn_start = host.arrays["str_nn_start"]
    for p in range(host.n_pages):
        cnt = nn_start[p + 1] - nn_start[p]
        assert np.array_equal(
            lens[p, :cnt], host.arrays["str_lens"][nn_start[p] : nn_start[p + 1]]
        )
        # offsets point at the value bytes inside the payload
        for k in range(min(cnt, 3)):
            ln = lens[p, k]
            got = dev.arrays["payload"][p, offs[p, k] : offs[p, k] + ln]
            e = nn_start[p] + k
            off = host.arrays["str_offs"][e]
            want = host.arrays["str_chars"][off : off + ln]
            assert np.array_equal(got, want)


@pytest.mark.parametrize("xp", [np, jnp])
@pytest.mark.parametrize("pattern", ["alpha", "a.*z", "^q", "x{2,3}"])
def test_stream_matcher_counts(plain_file, xp, pattern):
    r = ParquetReader(plain_file)
    _, dev = _both(r)
    dfa = compile_pattern(pattern)
    hits, seen = match_payload_stream(
        xp, xp.asarray(dev.arrays["payload"]),
        dev.arrays["page_payload_len"], dev.arrays["page_nn"],
        dfa.table, dfa.accept,
    )
    hits, seen = np.asarray(hits), np.asarray(seen)
    assert np.array_equal(seen, dev.arrays["page_nn"])

    col = r.read_column("s")
    rx = re.compile(pattern.encode(), re.DOTALL)
    row_start = dev.arrays["page_row_start"]
    want = np.zeros(dev.n_pages, np.int64)
    for pos in np.nonzero(col.valid)[0]:
        p = np.searchsorted(row_start, pos, "right") - 1
        want[p] += rx.search(col.values[pos]) is not None
    assert np.array_equal(hits, want)


@pytest.mark.parametrize("xp", [np, jnp])
def test_offset_matcher_agrees_with_stream(plain_file, xp):
    r = ParquetReader(plain_file)
    _, dev = _both(r)
    dfa = compile_pattern("(al|be).*a")
    payload = xp.asarray(dev.arrays["payload"])
    nn = xp.asarray(dev.arrays["page_nn"])
    offs, lens = string_offsets(xp, payload, nn, dev.nn_cap)
    pitch = int(np.asarray(lens).max()) + 1
    acc = match_values_by_offset(xp, payload, offs, lens, dfa.table, dfa.accept, pitch)
    valid = np.arange(dev.nn_cap)[None, :] < dev.arrays["page_nn"][:, None]
    hits2 = (np.asarray(acc) & valid).sum(axis=1)
    hits1, _ = match_payload_stream(
        np, dev.arrays["payload"], dev.arrays["page_payload_len"],
        dev.arrays["page_nn"], dfa.table, dfa.accept,
    )
    assert np.array_equal(hits1, hits2)


def test_empty_and_zero_length_values(tmp_path):
    path = str(tmp_path / "e.parquet")
    # unique suffixes keep the column PLAIN-encoded (the payload matcher
    # applies to kind==0 pages only; dict pages take the dict fast path)
    vals = [
        v
        for i in range(60)
        for v in (b"", b"ab%d" % i, None, b"", b"xyz%d" % i, b"")
    ]
    w = ParquetWriter(
        path, [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    w.write_row_group({"s": vals})
    w.close()
    r = ParquetReader(path)
    dev = r.prescan("s", flags=bindings.PS_PAYLOAD)
    for pattern, matcher in [("^$", None), ("ab", None), ("", None)]:
        dfa = compile_pattern(pattern)
        hits, seen = match_payload_stream(
            np, dev.arrays["payload"], dev.arrays["page_payload_len"],
            dev.arrays["page_nn"], dfa.table, dfa.accept,
        )
        rx = re.compile(pattern.encode(), re.DOTALL)
        want_total = sum(
            1 for v in vals if v is not None and rx.search(v) is not None
        )
        assert int(hits.sum()) == want_total, pattern
        assert int(seen.sum()) == sum(v is not None for v in vals)


@pytest.mark.parametrize("pattern", [
    "special.*requests", "aa", "aab", "aaa", "ab.*ab", "spe.*cial.*req", "q",
])
@pytest.mark.parametrize("xp", [np, jnp])
def test_bitap_chain_matches_dfa(tmp_path_factory, pattern, xp):
    """The Shift-And fast path must match the general DFA bit-exactly,
    including self-overlapping needles and ordered multi-needle chains."""
    from duckdb_parquet_parser.ops.regex import substring_chain

    d = tmp_path_factory.mktemp("bitap")
    vals = [
        b"aaab", b"abab", b"aab", b"special xx requests", b"requests special",
        b"", b"spespecial requests x", b"aaa", b"specialrequests",
        b"xspecial", None, b"requests requests", b"q",
    ] * 30
    vals = [None if v is None else v + b"#%d" % i for i, v in enumerate(vals)]
    path = str(d / "b.parquet")
    w = ParquetWriter(
        path, [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    w.write_row_group({"s": vals})
    w.close()
    r = ParquetReader(path)
    dev = r.prescan("s", flags=bindings.PS_PAYLOAD)
    chain = substring_chain(pattern)
    assert chain is not None
    dfa = compile_pattern(pattern)
    args = (dev.arrays["payload"], dev.arrays["page_payload_len"],
            dev.arrays["page_nn"], dfa.table, dfa.accept)
    want, _ = match_payload_stream(np, *args)
    got, seen = match_payload_stream(
        xp, xp.asarray(args[0]), *args[1:], use_mxu=(xp is jnp), chain=chain
    )
    assert np.array_equal(np.asarray(got), want)
    assert np.array_equal(np.asarray(seen), dev.arrays["page_nn"])


@pytest.mark.parametrize("xp", [np, jnp])
@pytest.mark.parametrize("pattern", ["alpha", "a.*z", "^q", "x{2,3}"])
def test_transposed_stream_parity(plain_file, xp, pattern):
    """transposed=True (the pre-transposed resident serving layout) must be
    bit-identical to the [N, P] entry point on every transition kind."""
    from duckdb_parquet_parser.ops.bitprog import (
        BitprogUnsupported,
        compile_bitprog,
    )
    from duckdb_parquet_parser.ops.regex import substring_chain

    r = ParquetReader(plain_file)
    _, dev = _both(r)
    dfa = compile_pattern(pattern)
    try:
        prog = compile_bitprog(pattern)
        chain = None
    except BitprogUnsupported:
        prog = None
        chain = substring_chain(pattern)
    payload = dev.arrays["payload"]
    args = (dev.arrays["page_payload_len"], dev.arrays["page_nn"],
            dfa.table, dfa.accept)
    kw = dict(use_mxu=(xp is jnp), chain=chain, prog=prog)
    want, seen0 = match_payload_stream(xp, xp.asarray(payload), *args, **kw)
    got, seen1 = match_payload_stream(
        xp, xp.asarray(np.ascontiguousarray(payload.T)), *args,
        transposed=True, **kw,
    )
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.array_equal(np.asarray(seen1), np.asarray(seen0))


def test_substring_chain_detection():
    from duckdb_parquet_parser.ops.regex import substring_chain

    assert substring_chain("special.*requests") == [b"special", b"requests"]
    assert substring_chain("^.*foo.*$") == [b"foo"]          # LIKE '%foo%'
    assert substring_chain("a\\.b") == [b"a.b"]
    assert substring_chain("plain") == [b"plain"]
    assert substring_chain(".*x.*") == [b"x"]
    for not_chain in ["a.c", "a|b", "[ab]", "a+", "^anchored", "end$",
                      "\\d+", "", ".*", "x" * 32]:
        assert substring_chain(not_chain) is None, not_chain
