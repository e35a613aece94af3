"""Bit-parallel NFA programs (ops/bitprog.py) vs the DFA oracle.

The transition must be bit-identical to the table-walk DFA on every
supported pattern family — classes, quantifiers, counted repeats, '.*'
gaps, alternation (packed registers), and their compositions — on both the
numpy and jitted jnp paths, including value-boundary interplay (empty
values, truncated sections) handled by match_payload_stream.
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.ops.bitprog import (
    BitprogUnsupported,
    compile_bitprog,
    make_bitprog_transition,
)
from duckdb_parquet_parser.ops.regex import compile_pattern
from duckdb_parquet_parser.ops.strings import match_payload_stream

SUPPORTED = [
    "abc", "a", "a.*z", "a.*b.*c", "q[ax]+x", "q[a-f]{2,4}z", "ab?c",
    "x+y*z", "a.c", "[^a]x", "a{3}", ".+q", "q\\w+z", "a[bcd]*e",
    "cat|dog|q", "(ab|cd)x", "(ab){1,2}x", "ab|cde|fg|q.z",
    "aaa|bbb|ccc|ddd|eee", "a?b?c?d", "xy|ab.*cd", "a.*[xyz]q?",
    "gr[ae]y|colou?r", "[a-c][d-f][g-i]",
    # mixed bit-sliced singletons + interval classes in one register
    "abcd[xy]e", "abcde|fgq", "ab?c.*de?f", "aq.*bx.*cy",
    # oversized machine (>31 total positions -> one register per segment)
    "abcdefgabcdefgabq.*cdefgabcdefgqxyz",
    # WIDE segments (>31 positions -> carry-chained register chunks)
    "a{40}",                      # 40 positions, 2 chunks
    "x{40}y{40}",                 # 80 positions, 3 chunks
    "q[ab]{28,36}z",              # optional run crossing the chunk boundary
    "a{30}b+c",                   # repeatable position at the chunk top
    "a{30}b*c",                   # star at the chunk top (smear carry)
    "a{28}zb?c?d?e",              # optionals straddling the boundary
    "a{29}b?c?",                  # accept run crossing the boundary
    "a{40}.*b{35}",               # two wide segments chained through a gap
    "aa|bb|cc|dd|ee|ff|gg|hh|ii", # 9-way alternation (fan-out > 8)
    # edge anchors (whole-pattern, DFA-compiler semantics): LIKE 'lit%',
    # '%lit', exact matches, anchored gaps/classes/alternations, and edges
    # where a gap or absorbed optional defeats the anchor
    "^abc", "abc$", "^abc$", "^a.*z", "a.*z$", "^a.*z$", "^q[ax]+x",
    "ab?c$", "^ab?c$", "^cat|dog", "cat|dog$", "^.*abc", "abc.*$",
    "^a?.*bc", "bc.*a?$", "^[ab]{1,2}q$", "^aq|bx$", "^x+y*z$",
    "^abcdefgabcdefgabq.*cdefgabcdefgqxyz$",
    "^a{40}$", "^x{40}y{40}",     # anchored wide segments
    # INTERIOR counted runs -> anchored counter (_collapse_interior_runs)
    "qx{40}z",                    # bounded exact, disjoint prefix
    "q[0-9]{33,45}z",             # bounded range
    "ky{38,}w",                   # unbounded
    "q[ab]{35}",                  # suffix-empty bounded
    "ab?x{40}c",                  # optional prefix tail (still disjoint)
    "qx{40}z$",                   # end-anchored suffix
]

UNSUPPORTED = [
    "(ab)*x",          # unbounded multi-byte repeat
    "aa|bb|cc|dd|ee|ff|gg|hh|ii|jj|kk|ll|mm|nn|oo|pp|qq",  # > MAX_MACHINES
    "a[ab]{200}c",     # bounded interior run, prefix class NOT disjoint
                       # (counter age would be ambiguous) -> > 124 positions
    "x[bx]{140}",      # same, suffix-empty ('x' can re-anchor mid-streak)
    "x{99999}",        # beyond the token-expansion sanity cap
    "a?^b",            # anchor adjacent to an optional (positional)
    "^a?$",            # empty-matching branch pinned by both anchors
]


def _pages(rng, n_pages=60, vals_per_page=8, maxlen=24, alphabet=b"abcdefgqxyz "):
    letters = np.frombuffer(alphabet, np.uint8)
    payloads, plens, nns = [], [], []
    for _ in range(n_pages):
        buf = bytearray()
        nv = int(rng.integers(1, vals_per_page + 1))
        for _ in range(nv):
            ln = int(rng.integers(0, maxlen))
            s = bytes(rng.choice(letters, ln))
            buf += len(s).to_bytes(4, "little") + s
        payloads.append(bytes(buf))
        plens.append(len(buf))
        nns.append(nv)
    pitch = max(plens) + 8
    pm = np.zeros((n_pages, pitch), np.uint8)
    for i, b in enumerate(payloads):
        pm[i, : len(b)] = np.frombuffer(b, np.uint8)
    return pm, np.array(plens, np.int32), np.array(nns, np.int32)


@pytest.fixture(scope="module")
def pages():
    return _pages(np.random.default_rng(5))


@pytest.mark.parametrize("pattern", SUPPORTED)
def test_numpy_parity(pages, pattern):
    pm, pl, nn = pages
    prog = compile_bitprog(pattern)
    dfa = compile_pattern(pattern)
    h_dfa, s_dfa = match_payload_stream(np, pm, pl, nn, dfa.table, dfa.accept)
    h_bp, s_bp = match_payload_stream(
        np, pm, pl, nn, dfa.table, dfa.accept, prog=prog
    )
    np.testing.assert_array_equal(h_bp, h_dfa)
    np.testing.assert_array_equal(s_bp, s_dfa)


@pytest.mark.parametrize("pattern", UNSUPPORTED)
def test_unsupported_falls_back(pattern):
    with pytest.raises(BitprogUnsupported):
        compile_bitprog(pattern)


def test_jnp_parity(pages):
    import jax.numpy as jnp

    pm, pl, nn = pages
    for pattern in ["a.*z", "q[ax]+x", "cat|dog|q", "a[bcd]*e", "(ab|cd)x",
                    "^ab", "bc$", "^a.*z$", "^cat|dog$"]:
        prog = compile_bitprog(pattern)
        dfa = compile_pattern(pattern)
        h_np, s_np = match_payload_stream(
            np, pm, pl, nn, dfa.table, dfa.accept, prog=prog
        )
        h_j, s_j = match_payload_stream(
            jnp, jnp.asarray(pm), jnp.asarray(pl), jnp.asarray(nn),
            dfa.table, dfa.accept, prog=prog,
        )
        np.testing.assert_array_equal(np.asarray(h_j), h_np)
        np.testing.assert_array_equal(np.asarray(s_j), s_np)


def test_chain_equivalence(pages):
    """A pure substring chain must behave exactly like the bitap path."""
    from duckdb_parquet_parser.ops.regex import substring_chain

    pm, pl, nn = pages
    pattern = "ab.*q"
    chain = substring_chain(pattern)
    assert chain == [b"ab", b"q"]
    dfa = compile_pattern(pattern)
    h_bitap, _ = match_payload_stream(
        np, pm, pl, nn, dfa.table, dfa.accept, chain=chain
    )
    h_prog, _ = match_payload_stream(
        np, pm, pl, nn, dfa.table, dfa.accept, prog=compile_bitprog(pattern)
    )
    np.testing.assert_array_equal(h_prog, h_bitap)


def test_fuzz_parity():
    """Random pattern compositions over random payloads."""
    rng = np.random.default_rng(77)
    atoms = ["a", "b", "q", "[ab]", "[^q]", ".", "x", "yz"]
    quants = ["", "?", "+", "*", "{1,2}"]
    checked = 0
    for trial in range(120):
        n_parts = int(rng.integers(1, 5))
        parts = []
        for _ in range(n_parts):
            a = atoms[int(rng.integers(len(atoms)))]
            q = quants[int(rng.integers(len(quants)))]
            if len(a) > 1 and not a.startswith("[") and q in ("+", "*"):
                q = ""  # unbounded multi-byte repeats are out of family
            parts.append(a + q)
            if rng.random() < 0.2:
                parts.append(".*")
        pattern = "".join(parts)
        if rng.random() < 0.25:
            pattern = "^" + pattern
        if rng.random() < 0.25:
            pattern = pattern + "$"
        try:
            prog = compile_bitprog(pattern)
        except BitprogUnsupported:
            continue
        dfa = compile_pattern(pattern)
        pm, pl, nn = _pages(rng, n_pages=20, vals_per_page=5, maxlen=12)
        h_dfa, _ = match_payload_stream(np, pm, pl, nn, dfa.table, dfa.accept)
        h_bp, _ = match_payload_stream(
            np, pm, pl, nn, dfa.table, dfa.accept, prog=prog
        )
        np.testing.assert_array_equal(h_bp, h_dfa, err_msg=pattern)
        checked += 1
    assert checked > 50  # the family should cover most compositions


def test_register_packing():
    """Gap-free alternation branches share registers."""
    _, n_regs, _ = make_bitprog_transition(
        np, compile_bitprog("cat|dog|mouse")
    )
    assert n_regs == 2  # one packed register + one sticky accept word


def test_fused_chain_packing():
    """A '.*' chain that fits one register pays (reg, done) — not
    one register per segment."""
    _, n_regs, _ = make_bitprog_transition(
        np, compile_bitprog("special.*requests")
    )
    assert n_regs == 2
    # oversized chains keep the per-segment layout (2 segments + done)
    _, n_regs_wide, _ = make_bitprog_transition(
        np, compile_bitprog("abcdefgabcdefgabq.*cdefgabcdefgqxyz")
    )
    assert n_regs_wide == 3


def test_wide_segment_semantics():
    """Hand-picked values around the 31-position register boundary of WIDE
    segments (shift carry, smear carry, self-loop at the chunk top, accept
    runs crossing the boundary) — vs Python re."""
    import re

    cases = {
        "a{40}": [b"a" * 40, b"a" * 39, b"a" * 41, b"x" + b"a" * 40 + b"y",
                  b"a" * 80, b"b" * 40, b""],
        "x{40}y{40}": [b"x" * 40 + b"y" * 40, b"x" * 39 + b"y" * 40,
                       b"x" * 40 + b"y" * 39, b"x" * 45 + b"y" * 45,
                       b"z" + b"x" * 40 + b"y" * 40 + b"z",
                       b"x" * 40 + b"z" + b"y" * 40],
        "q[ab]{28,36}z": [b"q" + b"a" * k + b"z" for k in range(26, 39)]
                        + [b"q" + b"ab" * 16 + b"z"],
        "a{30}b+c": [b"a" * 30 + b"bc", b"a" * 30 + b"b" * 9 + b"c",
                     b"a" * 30 + b"c", b"a" * 29 + b"bc", b"a" * 31 + b"bc"],
        "a{30}b*c": [b"a" * 30 + b"c", b"a" * 30 + b"bbbc",
                     b"a" * 30 + b"bd", b"a" * 29 + b"c"],
        "a{28}zb?c?d?e": [b"a" * 28 + b"z" + t + b"e"
                          for t in (b"", b"b", b"bc", b"bcd", b"bd", b"cd")]
                        + [b"a" * 28 + b"zbcd", b"a" * 27 + b"ze"],
        "a{29}b?c?": [b"a" * 29, b"a" * 29 + b"b", b"a" * 29 + b"bc",
                      b"a" * 28, b"a" * 29 + b"c"],
        "a{40}.*b{35}": [b"a" * 40 + b"qq" + b"b" * 35, b"a" * 40 + b"b" * 35,
                         b"a" * 40 + b"b" * 34, b"a" * 39 + b"q" + b"b" * 35,
                         b"a" * 40 + b"q" * 50 + b"b" * 40],
        "^a{40}$": [b"a" * 40, b"a" * 39, b"a" * 41, b"xa" * 20 + b"a" * 40],
        "aa|bb|cc|dd|ee|ff|gg|hh|ii": [b"xaay", b"ii", b"hh", b"ab", b"",
                                       b"zffz", b"i", b"abcdefghi"],
    }
    for pattern, vals in cases.items():
        prog = compile_bitprog(pattern)
        dfa = compile_pattern(pattern)
        rx = re.compile(pattern.encode())
        buf = bytearray()
        for v in vals:
            buf += len(v).to_bytes(4, "little") + v
        pm = np.frombuffer(bytes(buf), np.uint8)[None, :].copy()
        pl = np.array([len(buf)], np.int32)
        nn = np.array([len(vals)], np.int32)
        hits, seen = match_payload_stream(
            np, pm, pl, nn, dfa.table, dfa.accept, prog=prog
        )
        expect = sum(1 for v in vals if rx.search(v))
        assert hits[0] == expect, (pattern, hits[0], expect)
        assert seen[0] == len(vals)


def test_wide_fuzz_parity():
    """Random long patterns (wide segments) over random long payloads."""
    rng = np.random.default_rng(99)
    checked = 0
    for _ in range(40):
        # random run of counted atoms totalling 32-90 positions
        parts, total = [], 0
        while total < int(rng.integers(32, 90)):
            a = ["a", "b", "[ab]", "[^b]", "."][int(rng.integers(5))]
            k = int(rng.integers(1, 20))
            q = ["", "?", "+", "*"][int(rng.integers(4))] if k == 1 else ""
            parts.append(a + (f"{{{k}}}" if k > 1 else "") + q)
            total += k
        pattern = "".join(parts)
        try:
            prog = compile_bitprog(pattern)
        except BitprogUnsupported:
            continue
        pm, pl, nn = _pages(rng, n_pages=12, vals_per_page=4, maxlen=110,
                            alphabet=b"aabbq")
        # oracle: Python re over the parsed values (the DFA oracle can
        # state-blow-up on long counted repeats of overlapping classes)
        import re

        rx = re.compile(pattern.encode())
        expect = np.zeros(len(pl), np.int32)
        for p in range(len(pl)):
            row, off = pm[p].tobytes(), 0
            for _ in range(nn[p]):
                ln = int.from_bytes(row[off:off + 4], "little")
                if rx.search(row[off + 4:off + 4 + ln]):
                    expect[p] += 1
                off += 4 + ln
        table = np.zeros((1, 256), np.int32)
        h_bp, _ = match_payload_stream(
            np, pm, pl, nn, table, np.zeros(1, bool), prog=prog
        )
        np.testing.assert_array_equal(h_bp, expect, err_msg=pattern)
        checked += 1
    assert checked > 20


def test_fused_boundary_semantics():
    """Hand-picked values around the segment boundary of a fused chain with
    trailing/leading optionals (the cross-boundary carry/smear cases)."""
    import re

    for pattern in ["a.*b", "ab?.*c?d", "ab.*cd", "a+.*b+", "ax?.*y?b.*c"]:
        prog = compile_bitprog(pattern)
        dfa = compile_pattern(pattern)
        rx = re.compile(pattern.encode())
        vals = [b"", b"ab", b"ad", b"ba", b"acd", b"abcd", b"ad b", b"axyb",
                b"aaabbb", b"abab", b"axybc", b"adc", b"a" * 30 + b"b",
                b"ab" * 8, b"axxxxyd", b"acdc", b"abdcd", b"aybc"]
        buf = bytearray()
        for v in vals:
            buf += len(v).to_bytes(4, "little") + v
        pm = np.frombuffer(bytes(buf), np.uint8)[None, :].copy()
        pl = np.array([len(buf)], np.int32)
        nn = np.array([len(vals)], np.int32)
        hits, seen = match_payload_stream(
            np, pm, pl, nn, dfa.table, dfa.accept, prog=prog
        )
        expect = sum(1 for v in vals if rx.search(v))
        assert hits[0] == expect, (pattern, hits[0], expect)
        assert seen[0] == len(vals)


def test_pair_step_parity():
    """The 2-bytes-per-step composed transition is bit-identical to the
    per-byte walk across the no-smear family (chains, classes, self-loop
    repeats, gaps, anchors, packed alternations), on the jit path where it
    engages."""
    import jax.numpy as jnp

    from duckdb_parquet_parser.ops import strings as S
    from duckdb_parquet_parser.ops.bitprog import pair_supported
    from duckdb_parquet_parser.utils.config import (
        EngineConfig,
        set_config,
    )

    rng = np.random.default_rng(1234)
    pm, pl, nn = _pages(rng, n_pages=40, vals_per_page=6, maxlen=20)
    if pm.shape[1] % 2:  # pair mode needs an even step count
        pm = np.pad(pm, ((0, 0), (0, 1)))
    pmj, plj, nnj = jnp.asarray(pm), jnp.asarray(pl), jnp.asarray(nn)

    engaged = []
    orig = S._pair_scan

    def spy(*a, **k):
        engaged.append(True)
        return orig(*a, **k)

    S._pair_scan = spy
    try:
        checked = 0
        for pattern in SUPPORTED:
            prog = compile_bitprog(pattern)
            if not pair_supported(prog):
                continue
            dfa = compile_pattern(pattern)
            engaged.clear()
            set_config(EngineConfig(pair_step=True))
            h_pair, s_pair = match_payload_stream(
                jnp, pmj, plj, nnj, dfa.table, dfa.accept, prog=prog)
            assert engaged, pattern  # the pair path must actually run
            set_config(EngineConfig(pair_step=False))
            h_byte, s_byte = match_payload_stream(
                jnp, pmj, plj, nnj, dfa.table, dfa.accept, prog=prog)
            np.testing.assert_array_equal(
                np.asarray(h_pair), np.asarray(h_byte), err_msg=pattern)
            np.testing.assert_array_equal(
                np.asarray(s_pair), np.asarray(s_byte), err_msg=pattern)
            checked += 1
        assert checked >= 15  # the pair family covers most of SUPPORTED
    finally:
        S._pair_scan = orig
        set_config(None)


def test_pair_step_fuzz():
    """Random compositions: pair vs per-byte vs the numpy DFA oracle."""
    import jax.numpy as jnp

    from duckdb_parquet_parser.ops.bitprog import pair_supported
    from duckdb_parquet_parser.utils.config import (
        EngineConfig,
        set_config,
    )

    rng = np.random.default_rng(4321)
    atoms = ["a", "b", "q", "[ab]", "[^q]", ".", "x", "yz"]
    quants = ["", "+", "{1,2}", "{3}"]
    try:
        checked = 0
        for _ in range(90):
            parts = []
            for _ in range(int(rng.integers(1, 5))):
                a = atoms[int(rng.integers(len(atoms)))]
                q = quants[int(rng.integers(len(quants)))]
                if len(a) > 1 and not a.startswith("[") and q == "+":
                    q = ""
                parts.append(a + q)
                if rng.random() < 0.2:
                    parts.append(".*")
            pattern = "".join(parts)
            if rng.random() < 0.25:
                pattern = "^" + pattern
            if rng.random() < 0.25:
                pattern = pattern + "$"
            try:
                prog = compile_bitprog(pattern)
            except BitprogUnsupported:
                continue
            if not pair_supported(prog):
                continue
            dfa = compile_pattern(pattern)
            pm, pl, nn = _pages(rng, n_pages=16, vals_per_page=5, maxlen=12)
            if pm.shape[1] % 2:
                pm = np.pad(pm, ((0, 0), (0, 1)))
            h_dfa, _ = match_payload_stream(np, pm, pl, nn, dfa.table,
                                            dfa.accept)
            set_config(EngineConfig(pair_step=True))
            h_pair, _ = match_payload_stream(
                jnp, jnp.asarray(pm), jnp.asarray(pl), jnp.asarray(nn),
                dfa.table, dfa.accept, prog=prog)
            np.testing.assert_array_equal(np.asarray(h_pair), h_dfa,
                                          err_msg=pattern)
            checked += 1
        assert checked > 30
    finally:
        set_config(None)


def test_inner_anchors_and_empty_matchers():
    """Round-3 family extensions (VERDICT #7): unsatisfiable inner anchors
    compile to never-match machines, edge-equivalent inner anchors anchor
    the machine, empty-matching patterns ('.*', 'a?') accept every value —
    all at device speed, with Python re as the oracle."""
    import re as _re

    rng = np.random.default_rng(9)
    pm, pl, nn = _pages(rng, n_pages=30, vals_per_page=6, maxlen=15)

    # reconstruct per-page values to drive the re oracle
    vals = []
    for i in range(pm.shape[0]):
        off, page = 0, []
        for _ in range(int(nn[i])):
            ln = int(np.frombuffer(pm[i, off:off + 4].tobytes(), "<i4")[0])
            page.append(pm[i, off + 4:off + 4 + ln].tobytes())
            off += 4 + ln
        vals.append(page)

    cases = [".*", "a?", "a^b", "a$b", "(^a)b", "ab$c", "x{2}^q",
             "b|a^q"]  # alternation with one unsatisfiable branch
    for pattern in cases:
        prog = compile_bitprog(pattern)
        rx = _re.compile(pattern.encode())
        want = np.array([sum(1 for v in page if rx.search(v))
                         for page in vals])
        h, seen = match_payload_stream(np, pm, pl, nn, None, None, prog=prog)
        np.testing.assert_array_equal(h, want, err_msg=pattern)
        np.testing.assert_array_equal(seen, nn)


def test_never_match_dfa():
    """compile_pattern on unsatisfiable inner-anchor patterns yields a
    never-accepting DFA (so dictionary pages and the one-hot DFA path agree with
    the bitprog never-machines) instead of falling back to the host."""
    for pattern in ("a^b", "a$b", "x{2}^q"):
        dfa = compile_pattern(pattern)
        assert dfa.n_states == 1 and not dfa.accept.any()
        assert not dfa.match_str(b"ab")


def test_wide_counted_repeats():
    """MAX_COUNTED now spans the full wide-register range: counted repeats
    up to ~124 positions run on the register machines (were DFA/host
    fallback)."""
    import re as _re

    rng = np.random.default_rng(10)
    for pattern, gen in [
        ("x{70}", lambda: b"x" * int(rng.integers(60, 80))),
        ("q[ab]{60,100}z",
         lambda: b"q" + bytes(rng.choice([97, 98], int(rng.integers(50, 110))).astype(np.uint8)) + b"z"),
    ]:
        prog = compile_bitprog(pattern)
        rx = _re.compile(pattern.encode())
        payloads, plens, nns, vals = [], [], [], []
        for _ in range(25):
            buf = bytearray()
            page = []
            for _ in range(4):
                v = gen()
                buf += len(v).to_bytes(4, "little") + v
                page.append(bytes(v))
            payloads.append(bytes(buf))
            plens.append(len(buf))
            nns.append(4)
            vals.append(page)
        pitch = max(plens) + 8
        pm = np.zeros((len(payloads), pitch), np.uint8)
        for i, b in enumerate(payloads):
            pm[i, :len(b)] = np.frombuffer(b, np.uint8)
        want = np.array([sum(1 for v in page if rx.search(v))
                         for page in vals])
        h, _ = match_payload_stream(np, pm, np.array(plens, np.int32),
                                    np.array(nns, np.int32), None, None,
                                    prog=prog)
        np.testing.assert_array_equal(h, want, err_msg=pattern)
        assert want.sum() > 0  # the generator must produce real matches


def test_arith_fill_safety_and_parity(pages):
    """The arithmetic carry-fill smear (constant 5 ops) must only engage when
    no optional run crosses a packed-component boundary, and must stay
    bit-identical to the doubling plan wherever it engages."""
    from duckdb_parquet_parser.ops.bitprog import (
        _arith_fill_ok,
        _compile_registers,
    )

    # trailing optional of machine 0 adjacent to leading optional of
    # machine 1 in the shared register -> the add would leak a carry
    # across the boundary -> must be flagged unsafe
    cp = _compile_registers(compile_bitprog("ab?|c?d"))
    (sc,) = cp.packed
    assert not _arith_fill_ok(sc)

    # non-adjacent optionals across the same boundary -> safe
    cp = _compile_registers(compile_bitprog("ab?x|yc?d"))
    (sc,) = cp.packed
    assert _arith_fill_ok(sc)

    # DFA parity on smear-heavy shapes: long optional runs (arith path),
    # packed boundary-adjacent optionals (doubling fallback), fused gapped
    # machines with optional tails, anchored optionals (clear interaction)
    pm, pl, nn = pages
    for pattern in [
        "ab?|c?d", "xy?|z?w|q?r", "a?b|c?d",
        "qa?b?c?d?e?f?g?x", "q[ab]{2,9}z", "a?b?c?.*x?y?z",
        "^a?b?c?q", "qa?b?c?$", "ga?b?q|xc?d?y",
    ]:
        prog = compile_bitprog(pattern)
        dfa = compile_pattern(pattern)
        h_dfa, s_dfa = match_payload_stream(np, pm, pl, nn, dfa.table,
                                            dfa.accept)
        h_bp, s_bp = match_payload_stream(np, pm, pl, nn, dfa.table,
                                          dfa.accept, prog=prog)
        np.testing.assert_array_equal(h_bp, h_dfa, err_msg=pattern)
        np.testing.assert_array_equal(s_bp, s_dfa, err_msg=pattern)


def test_lead_run_counter_semantics():
    """Leading same-class runs collapse to a saturating counter
    (_collapse_lead_runs).  Adversarial streak shapes around the threshold:
    exact/short/long runs, interrupted streaks, streaks ending at the value
    edge, '$' samples, '.*' residuals, ANY-class runs, and residual chars
    that themselves extend the class streak."""
    import re as _re

    from duckdb_parquet_parser.ops.bitprog import _compile_registers

    def pages_from(values_per_page):
        payloads, plens, nns = [], [], []
        for page in values_per_page:
            buf = bytearray()
            for v in page:
                buf += len(v).to_bytes(4, "little") + v
            payloads.append(bytes(buf))
            plens.append(len(buf))
            nns.append(len(page))
        pitch = max(plens) + 8
        pm = np.zeros((len(payloads), pitch), np.uint8)
        for i, b in enumerate(payloads):
            pm[i, : len(b)] = np.frombuffer(b, np.uint8)
        return pm, np.array(plens, np.int32), np.array(nns, np.int32)

    cases = {
        "[ab]{10}": [b"a" * 9, b"a" * 10, b"ab" * 5, b"a" * 30,
                     b"a" * 9 + b"x" + b"b" * 9, b"a" * 5 + b"b" * 5,
                     b"x" * 4 + b"ab" * 6 + b"x", b""],
        "[ab]{12}$": [b"a" * 12, b"a" * 12 + b"x", b"x" + b"b" * 12,
                      b"a" * 11, b"a" * 20 + b"b"],
        "[a-z]{9,11}q": [b"abcdefghi" + b"q", b"abcdefgh" + b"q",
                         b"z" * 40 + b"q", b"z" * 8 + b" " + b"z" * 9 + b"q",
                         b"q" * 10, b"qqqqqqqqq"],
        ".{12}q": [b"x" * 12 + b"q", b"x" * 11 + b"q", b"q" * 13,
                   b"\x00" * 12 + b"q"],
        "[ab]{9}c?d": [b"a" * 9 + b"d", b"a" * 9 + b"cd", b"a" * 9 + b"ccd",
                       b"a" * 8 + b"cd", b"b" * 15 + b"d"],
        "[a-z]{10}.*qx": [b"m" * 10 + b"   qx", b"m" * 10 + b"qx",
                          b"m" * 9 + b"qx", b"m" * 10, b"qx" + b"m" * 10],
        "e{9}|q{9}": [b"e" * 9, b"q" * 9, b"e" * 8 + b"q" * 8,
                      b"e" * 4 + b"q" * 9],
        # residual chars extend the class streak (overlap shape)
        "[a-z]{10,12}requests": [b"m" * 10 + b"requests",
                                 b"m" * 2 + b"requests" + b"requests",
                                 b"m" * 9 + b"requests",
                                 b"requestsrequests", b"requests" * 3],
    }
    for pat, vals in cases.items():
        prog = compile_bitprog(pat)
        assert _compile_registers(prog).counted, pat  # transform engaged
        rx = _re.compile(pat.encode())
        pages = [vals[i : i + 3] for i in range(0, len(vals), 3)]
        pages = [p for p in pages if p]
        pm, pl, nn = pages_from(pages)
        want = np.array([sum(1 for v in page if rx.search(v))
                         for page in pages])
        h, seen = match_payload_stream(np, pm, pl, nn, None, None, prog=prog)
        np.testing.assert_array_equal(h, want, err_msg=pat)
        np.testing.assert_array_equal(seen, [len(p) for p in pages],
                                      err_msg=pat)
    # fuzz: random streak soups vs re, numpy AND jax paths
    import jax.numpy as jnp

    rng = np.random.default_rng(123)
    pats = ["[ab]{9}", "[ab]{9,14}x", "[ab]{10}.*q", "[ab]{12}$",
            "a{9}b", ".{9}b"]
    pages = []
    for _ in range(40):
        page = []
        for _ in range(int(rng.integers(1, 5))):
            parts = []
            for _ in range(int(rng.integers(1, 5))):
                ch = bytes([int(rng.choice([97, 98, 120, 113]))])
                parts.append(ch * int(rng.integers(0, 16)))
            page.append(b"".join(parts))
        pages.append(page)
    pm, pl, nn = pages_from(pages)
    for pat in pats:
        prog = compile_bitprog(pat)
        rx = _re.compile(pat.encode())
        want = np.array([sum(1 for v in page if rx.search(v))
                         for page in pages])
        h, _ = match_payload_stream(np, pm, pl, nn, None, None, prog=prog)
        np.testing.assert_array_equal(h, want, err_msg=pat)
        hj, _ = match_payload_stream(jnp, jnp.asarray(pm), jnp.asarray(pl),
                                     jnp.asarray(nn), None, None, prog=prog)
        np.testing.assert_array_equal(np.asarray(hj), want, err_msg=pat)


def test_lead_run_lifts_counted_limit():
    """Leading counted repeats beyond the old 124-position register budget
    now compile via the counter (MAX_COUNTED is a token sanity cap only);
    mid-segment runs keep raising."""
    import re as _re

    for pat, mk in [
        ("x{140}", lambda k: b"x" * k),
        ("a" * 130, lambda k: b"a" * k),
        ("[ab]{200}q", lambda k: b"ab" * (k // 2) + b"q"),
        ("m{500}", lambda k: b"m" * k),
    ]:
        prog = compile_bitprog(pat)  # must not raise
        rx = _re.compile(pat.encode())
        m = 500 if "500" in pat else (200 if "200" in pat else
                                      (140 if "140" in pat else 130))
        vals = [mk(m - 1), mk(m), mk(m + 40), b"q" * 8]
        payloads, plens = [], []
        for v in vals:
            payloads.append(len(v).to_bytes(4, "little") + v)
        buf = b"".join(payloads)
        pm = np.zeros((1, len(buf) + 8), np.uint8)
        pm[0, : len(buf)] = np.frombuffer(buf, np.uint8)
        want = sum(1 for v in vals if rx.search(v))
        h, seen = match_payload_stream(
            np, pm, np.array([len(buf)], np.int32),
            np.array([len(vals)], np.int32), None, None, prog=prog)
        assert int(h[0]) == want and int(seen[0]) == len(vals), pat


# ── interior counted-run counter machines (_collapse_interior_runs) ─────────

INTERIOR_RUN_PATTERNS = [
    "a[0-9]{40}b",        # bounded exact, disjoint prefix class
    "a[0-9]{40,60}b",     # bounded range
    "xy[0-9]{35,}z",      # unbounded
    "q[a-f]{32,40}",      # suffix-empty bounded
    "[a-z][0-9]{33,}",    # class prefix, suffix-empty unbounded
    "ab?[0-9]{40}c",      # optional in the prefix tail (classes disjoint)
    "k[0-9]{38}[0-9]",    # suffix shares the run class (allowed)
    "no[0-9]{32}pe$",     # end-anchored suffix
    "a[0-9]{200}b",       # far past MAX_POSITIONS * MAX_WIDE_REGS
    "q[ab]{500,}z",       # unbounded long run
]


def test_interior_run_collapses():
    for pattern in INTERIOR_RUN_PATTERNS:
        prog = compile_bitprog(pattern)
        assert any(m.mid_run is not None for m in prog.machines), pattern


def test_interior_run_re_parity():
    """Anchored-counter machines vs Python re on long random values —
    lengths bracket every counter threshold (off-by-one hunting)."""
    import random
    import re

    random.seed(17)
    vals = []
    for _ in range(300):
        n = random.randint(0, 260)
        vals.append("".join(
            random.choice("abcxyzq0123456789kpenof") for _ in range(n)))
    for k in (31, 32, 33, 38, 39, 40, 41, 59, 60, 61, 199, 200, 201,
              499, 500, 501):
        for pre, mid, post in (("a", "7", "b"), ("xy", "1", "z"),
                               ("ab", "9", "c"), ("k", "5", ""),
                               ("no", "3", "pe"), ("no", "3", "pex"),
                               ("q", "a", "z"), ("q", "ab", "z")):
            vals.append(pre + mid * k + post)
    for pattern in INTERIOR_RUN_PATTERNS:
        prog = compile_bitprog(pattern)
        trans, n_regs, acc_empty = make_bitprog_transition(np, prog)
        for v in vals:
            bs = v.encode()
            state = tuple(np.zeros(1, np.int32) for _ in range(n_regs))
            a = np.zeros(1, np.int32)
            for b in bs:
                state, a = trans(state, np.array([b], np.int32))
            got = bool(a[0]) if bs else bool(acc_empty)
            want = bool(re.search(pattern, v))
            assert got == want, (pattern, v[:80], got, want)


def test_interior_run_stream_parity():
    """Counter machines through match_payload_stream (value boundaries,
    truncation, empty values) and the streaming kernel in interpret mode."""
    from tests.test_pallas_stream import _kernel

    rng = np.random.default_rng(23)
    # long values so >31-byte runs actually occur
    pm, pl_, nn = _pages(rng, n_pages=80, vals_per_page=3, maxlen=90,
                         alphabet=b"aq0123456789bz")
    for pattern in ["a[0-9]{34}b", "q[0-9]{32,50}z", "a[0-9]{33,}"]:
        prog = compile_bitprog(pattern)
        dfa = compile_pattern(pattern)
        h_dfa, s_dfa = match_payload_stream(np, pm, pl_, nn, dfa.table,
                                            dfa.accept)
        h_bp, s_bp = match_payload_stream(np, pm, pl_, nn, None, None,
                                          prog=prog)
        np.testing.assert_array_equal(h_bp, h_dfa, err_msg=pattern)
        np.testing.assert_array_equal(s_bp, s_dfa, err_msg=pattern)
        (h_pl,), s_pl = _kernel(pm, pl_, nn, [(None, prog)])
        np.testing.assert_array_equal(h_pl, h_dfa, err_msg=pattern)
        np.testing.assert_array_equal(s_pl, s_dfa, err_msg=pattern)
