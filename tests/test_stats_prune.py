"""ColumnIndex stats pruning in the cold scan (VERDICT r3 #3).

Soundness contract: pruning may only SKIP WORK, never change results — the
(page_gid, match_counts, value_counts) triple must be bit-identical to the
golden matcher with and without pruning, for any pattern, on any file.
Pruning applies only to non-negated anchored-prefix patterns on PLAIN pages
of chunks that carry a ColumnIndex (our writer emits one; see
host/native/dpq_pageindex.hpp for the spec's truncation semantics).
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser.models.scan import ScanEngine
from duckdb_parquet_parser.ops.regex import anchored_literal_prefix


def test_anchored_literal_prefix():
    cases = [
        ("^special.*requests", b"special"),
        ("special.*requests", None),       # unanchored: no pruning ever
        ("^user_0009", b"user_0009"),
        ("^abc$", b"abc"),
        ("^ab+c", b"ab"),                  # b mandatory >=1, stop after it
        ("^ab?c", b"a"),                   # b optional
        ("^ab*c", b"a"),
        ("^a{2,3}", None),                 # quantified first char
        ("^\\.x", b".x"),                  # escaped metachar is literal
        ("^\\dx", None),                   # escape class is not literal
        ("^ab|cd", None),                  # top-level alternation bails
        ("^a(b|c)", b"a"),                 # grouped alternation is fine
        ("^[ab]x", None),                  # class first
        ("^.x", None),                     # dot first
        ("^", None),
        ("^x\xff", b"x\xff"),
    ]
    for pat, want in cases:
        assert anchored_literal_prefix(pat) == want, pat


def _sorted_file(path, n=20000, null_p=0.0, rgs=1, fmt="user_{:07d} tail",
                 optional=True, shuffle=False, seed=5):
    rng = np.random.default_rng(seed)
    vals: list = [fmt.format(i) for i in range(n)]
    if shuffle:
        rng.shuffle(vals)
    if null_p > 0:
        vals = [None if rng.random() < null_p else v for v in vals]
    w = ParquetWriter(
        str(path), [ColumnSpec("k", ParquetType.BYTE_ARRAY, optional=optional)]
    )
    per = (n + rgs - 1) // rgs
    for g in range(rgs):
        chunk = vals[g * per:(g + 1) * per]
        if chunk:
            w.write_row_group({"k": chunk})
    w.close()
    return str(path)


def test_prune_fires_and_results_identical(tmp_path):
    path = _sorted_file(tmp_path / "s.parquet", rgs=3, null_p=0.05)
    eng = ScanEngine(path)
    r = eng.cold_scan("k", "^user_00091", exact_counts=True)
    golden = eng.scan("k", "^user_00091", engine="numpy")
    assert r.stats_pruned_pages > 0  # sorted file: most pages prunable
    np.testing.assert_array_equal(r.page_gid, golden.page_gid)
    np.testing.assert_array_equal(r.match_counts, golden.match_counts)
    np.testing.assert_array_equal(r.value_counts, golden.value_counts)


def test_prune_never_under_negation(tmp_path):
    path = _sorted_file(tmp_path / "s.parquet")
    eng = ScanEngine(path)
    r = eng.cold_scan("k", "^user_00091", negate=True, exact_counts=True)
    assert r.stats_pruned_pages == 0
    golden = eng.scan("k", "^user_00091", negate=True, engine="numpy")
    np.testing.assert_array_equal(r.match_counts, golden.match_counts)


def test_prune_env_off(tmp_path, monkeypatch):
    path = _sorted_file(tmp_path / "s.parquet")
    eng = ScanEngine(path)
    monkeypatch.setenv("DPQ_NO_PRUNE", "1")
    r = eng.cold_scan("k", "^user_00091", exact_counts=True)
    assert r.stats_pruned_pages == 0


@pytest.mark.parametrize("pattern", [
    "^user_00091", "^user_0009", "^user_", "^zzz", "^user_0000000 tail$",
    "^user_00.*tail", "^user_0+", "^aaa|bbb",
])
@pytest.mark.parametrize("kind", ["sorted", "shuffled", "nulls"])
def test_prune_soundness_matrix(tmp_path, pattern, kind):
    """Bit-identical triples across sorted/shuffled/nullable layouts for
    anchored patterns that prune a lot, a little, everything, or nothing."""
    path = _sorted_file(
        tmp_path / f"{kind}.parquet", n=8000, rgs=2,
        shuffle=(kind == "shuffled"), null_p=0.2 if kind == "nulls" else 0.0,
    )
    eng = ScanEngine(path)
    golden = eng.scan("k", pattern, engine="numpy")
    for exact in (True, False):
        r = eng.cold_scan("k", pattern, exact_counts=exact)
        np.testing.assert_array_equal(r.page_gid, golden.page_gid)
        np.testing.assert_array_equal(r.value_counts, golden.value_counts)
        if exact:
            np.testing.assert_array_equal(r.match_counts, golden.match_counts)
        else:
            np.testing.assert_array_equal(
                np.sort(r.pruned_pages()), np.sort(golden.pruned_pages())
            )


def test_prune_dict_encoded_chunks_untouched(tmp_path):
    """Low-cardinality (dict-encoded) chunks: pruning must leave the dict
    short-circuit path alone and still produce golden counts."""
    rng = np.random.default_rng(9)
    vals = [f"key_{rng.integers(0, 8):02d}" for _ in range(5000)]
    w = ParquetWriter(
        str(tmp_path / "d.parquet"),
        [ColumnSpec("k", ParquetType.BYTE_ARRAY, optional=True)],
    )
    w.write_row_group({"k": vals})
    w.close()
    eng = ScanEngine(str(tmp_path / "d.parquet"))
    golden = eng.scan("k", "^key_03", engine="numpy")
    r = eng.cold_scan("k", "^key_03", exact_counts=True)
    assert r.stats_pruned_pages == 0  # dict pages are never pruned
    np.testing.assert_array_equal(r.match_counts, golden.match_counts)
    np.testing.assert_array_equal(r.value_counts, golden.value_counts)


def test_prune_0xff_prefix_boundary(tmp_path):
    """All-0xFF prefixes have no finite successor: only the max < P test may
    prune; values above the prefix must never be wrongly skipped."""
    vals = ["aaa", "mmm", "\xff\xff tail", "\xff\xffzz", "zzz"] * 400
    vals.sort()
    w = ParquetWriter(
        str(tmp_path / "f.parquet"),
        [ColumnSpec("k", ParquetType.BYTE_ARRAY, optional=True)],
    )
    w.write_row_group({"k": vals})
    w.close()
    eng = ScanEngine(str(tmp_path / "f.parquet"))
    golden = eng.scan("k", "^\xff\xff", engine="numpy")
    r = eng.cold_scan("k", "^\xff\xff", exact_counts=True)
    np.testing.assert_array_equal(r.match_counts, golden.match_counts)
    np.testing.assert_array_equal(r.value_counts, golden.value_counts)


def test_prune_random_prefix_fuzz(tmp_path):
    """Random value distributions x random anchored prefixes: the pruned
    run must match the unpruned run bit-for-bit, and PageStats.prune's
    'prefix' op must agree with (be a subset of) the pages the scan found
    empty."""
    rng = np.random.default_rng(123)
    alphabet = "abcdef"
    vals = [
        "".join(rng.choice(list(alphabet), size=rng.integers(1, 12)))
        for _ in range(6000)
    ]
    vals.sort()  # sorted => tight per-page ranges => pruning exercises
    path = str(tmp_path / "fz.parquet")
    w = ParquetWriter(path, [ColumnSpec("k", ParquetType.BYTE_ARRAY,
                                        optional=True)])
    w.write_row_group({"k": vals})
    w.close()
    eng = ScanEngine(path)
    reader = ParquetReader(path)
    ps = reader.page_stats("k")
    for _ in range(12):
        pfx = "".join(rng.choice(list(alphabet), size=rng.integers(1, 4)))
        pattern = f"^{pfx}"
        golden = eng.scan("k", pattern, engine="numpy")
        r = eng.cold_scan("k", pattern, exact_counts=True)
        np.testing.assert_array_equal(r.match_counts, golden.match_counts)
        np.testing.assert_array_equal(r.value_counts, golden.value_counts)
        # PageStats 'prefix' pruning is sound: every pruned gid really has
        # zero matches
        dead = ps.prune("prefix", pfx.encode())
        golden_by_gid = dict(zip(golden.page_gid, golden.match_counts))
        for gid in dead:
            assert golden_by_gid[int(gid)] == 0


# ── exact-literal equality pruning (round 5) ────────────────────────────────


def test_exact_literal():
    from duckdb_parquet_parser.ops.regex import exact_literal

    cases = [
        ("^user_0000042 tail$", b"user_0000042 tail"),
        ("^abc$", b"abc"),
        ("^a\\.b$", b"a.b"),        # escaped metachar is literal
        ("abc", None),              # unanchored
        ("^abc", None),             # prefix only
        ("abc$", None),
        ("^ab?c$", None),           # quantifier
        ("^a.c$", None),            # dot
        ("^a[bc]$", None),          # class
        ("^a|b$", None),            # alternation
        ("^\\db$", None),           # escape class
        ("^$", None),               # empty literal: no pruning hook
        ("^abc\\$", None),          # escaped trailing $: not an anchor
    ]
    for pat, want in cases:
        assert exact_literal(pat) == want, pat


def test_exact_literal_prunes_tighter_than_prefix(tmp_path):
    """`^user_0000042 tail$` keeps only pages that can hold THAT value —
    strictly more pruning than the prefix range on a sorted file — with the
    golden triple intact."""
    path = _sorted_file(tmp_path / "ex.parquet", rgs=2)
    eng = ScanEngine(path)
    r_ex = eng.cold_scan("k", "^user_0000042 tail$", exact_counts=True)
    golden = eng.scan("k", "^user_0000042 tail$", engine="numpy")
    np.testing.assert_array_equal(r_ex.page_gid, golden.page_gid)
    np.testing.assert_array_equal(r_ex.match_counts, golden.match_counts)
    np.testing.assert_array_equal(r_ex.value_counts, golden.value_counts)
    assert int(golden.match_counts.sum()) == 1  # the value exists once
    # the equality range prunes at least as much as the prefix range on a
    # PREFIX pattern that admits more values
    r_pre = eng.cold_scan("k", "^user_0000042", exact_counts=True)
    assert r_ex.stats_pruned_pages >= r_pre.stats_pruned_pages
    assert r_ex.stats_pruned_pages > 0


@pytest.mark.parametrize("pattern", [
    "^user_0000000 tail$",   # first value
    "^user_0019999 tail$",   # last value
    "^user_0004242 tail$",   # interior
    "^user_0004242$",        # literal that is a PREFIX of stored values —
                             # equality range must keep the page holding it
    "^zzzz$",                # above every value
    "^AAAA$",                # below every value
])
@pytest.mark.parametrize("kind", ["sorted", "shuffled", "nulls"])
def test_exact_literal_soundness_matrix(tmp_path, pattern, kind):
    path = _sorted_file(
        tmp_path / f"x{kind}.parquet", n=20000, rgs=2,
        shuffle=(kind == "shuffled"), null_p=0.2 if kind == "nulls" else 0.0,
    )
    eng = ScanEngine(path)
    golden = eng.scan("k", pattern, engine="numpy")
    for exact in (True, False):
        r = eng.cold_scan("k", pattern, exact_counts=exact)
        np.testing.assert_array_equal(r.page_gid, golden.page_gid)
        np.testing.assert_array_equal(r.value_counts, golden.value_counts)
        if exact:
            np.testing.assert_array_equal(r.match_counts, golden.match_counts)
        else:
            np.testing.assert_array_equal(
                np.sort(r.pruned_pages()), np.sort(golden.pruned_pages())
            )


# ── class-extended prune ranges (round 5, unified [lo, hi)) ─────────────────


def test_anchored_prune_range():
    from duckdb_parquet_parser.ops.regex import anchored_prune_range

    cases = [
        ("^abc", (b"abc", b"abd")),                    # plain prefix
        ("^abc$", (b"abc", b"abc\x00")),               # exact literal
        ("^user_00[0-4]", (b"user_000", b"user_005")),  # class-extended
        ("^user_00[0-4]x", (b"user_000", b"user_005")),
        ("^a[bc]+z", (b"ab", b"ad")),                  # '+' class mandatory
        ("^a[bc]?z", (b"a", b"b")),                    # optional class: plain
        ("^a[bc]*z", (b"a", b"b")),
        ("^a.", (b"a\x00", b"b")),                     # '.' extends lo
        ("^a.*z", (b"a", b"b")),                       # '.' optional: plain
        ("^a+b", (b"a", b"b")),                        # '+' char: no peek
        ("^x\xff[ab]", (b"x\xffa", b"x\xffc")),
        ("abc", None),                                 # unanchored
        ("^[ab]x", None),                              # class first: no prefix
    ]
    for pat, want in cases:
        assert anchored_prune_range(pat) == want, pat


def test_class_extended_prunes_more(tmp_path):
    """`^user_000000[0-4]` must prune at least as much as its plain prefix
    and stay bit-identical to the numpy golden."""
    path = _sorted_file(tmp_path / "cls.parquet", rgs=2)
    eng = ScanEngine(path)
    r_cls = eng.cold_scan("k", "^user_000000[0-4]", exact_counts=True)
    golden = eng.scan("k", "^user_000000[0-4]", engine="numpy")
    np.testing.assert_array_equal(r_cls.page_gid, golden.page_gid)
    np.testing.assert_array_equal(r_cls.match_counts, golden.match_counts)
    np.testing.assert_array_equal(r_cls.value_counts, golden.value_counts)
    assert int(golden.match_counts.sum()) == 5  # user_0000000..4
    r_pre = eng.cold_scan("k", "^user_000000", exact_counts=True)
    assert r_cls.stats_pruned_pages >= r_pre.stats_pruned_pages
    assert r_cls.stats_pruned_pages > 0


@pytest.mark.parametrize("pattern", [
    "^user_001[0-9]",        # matching decade
    "^user_[5-9]",           # upper half
    "^zz[a-z]",              # above every value
    "^user_0000000 tai[k-m]",  # class at the value tail
    "^user_00[0-4][0-9]x",   # trailing literal after two classes
])
@pytest.mark.parametrize("kind", ["sorted", "shuffled", "nulls"])
def test_class_prune_soundness_matrix(tmp_path, pattern, kind):
    path = _sorted_file(
        tmp_path / f"c{kind}.parquet", n=8000, rgs=2,
        shuffle=(kind == "shuffled"), null_p=0.2 if kind == "nulls" else 0.0,
    )
    eng = ScanEngine(path)
    golden = eng.scan("k", pattern, engine="numpy")
    for exact in (True, False):
        r = eng.cold_scan("k", pattern, exact_counts=exact)
        np.testing.assert_array_equal(r.page_gid, golden.page_gid)
        np.testing.assert_array_equal(r.value_counts, golden.value_counts)
        if exact:
            np.testing.assert_array_equal(r.match_counts, golden.match_counts)
        else:
            np.testing.assert_array_equal(
                np.sort(r.pruned_pages()), np.sort(golden.pruned_pages())
            )
