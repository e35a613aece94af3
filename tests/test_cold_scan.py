"""Fused native cold-path scan (host/native/dpq_scan.hpp) vs the engine.

Contract: identical surviving/pruned page sets to every other matcher path
(and identical match/value counts with exact_counts=True) across dict/plain
encodings, nulls, negation, chain and DFA modes.
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.models.scan import ScanEngine
from duckdb_parquet_parser.ops.scan import scan_batch

from .fixtures import mixed_file, strings_file

PATTERNS = [
    ("alpha.*bravo", False),      # substring chain (bitap/memmem class)
    ("alpha.*bravo", True),
    ("charlie", False),           # single needle
    ("a", False),                 # dense single byte
    ("a", True),
    ("[ad]el.a", False),          # general DFA (class + dot)
    ("x{2,3}[a-f]+", False),      # counted repeats
    ("^alpha", False),            # anchored (DFA mode)
]


@pytest.fixture(scope="module")
def dict_file(tmp_path_factory):
    rng = np.random.default_rng(11)
    return strings_file(
        tmp_path_factory.mktemp("cold") / "dict.parquet", rng,
        n=900, n_unique=12, null_p=0.15, rgs=3,
    )


@pytest.fixture(scope="module")
def plain_file(tmp_path_factory):
    rng = np.random.default_rng(12)
    return strings_file(
        tmp_path_factory.mktemp("cold") / "plain.parquet", rng,
        n=900, n_unique=None, null_p=0.1, rgs=2,
    )


@pytest.mark.parametrize("pattern,neg", PATTERNS)
@pytest.mark.parametrize("which", ["dict", "plain"])
def test_cold_scan_parity(dict_file, plain_file, pattern, neg, which):
    eng = ScanEngine(dict_file if which == "dict" else plain_file)
    golden = eng.scan("s", pattern, negate=neg, engine="numpy")
    exact = eng.cold_scan("s", pattern, negate=neg, exact_counts=True)
    ind = eng.cold_scan("s", pattern, negate=neg)

    np.testing.assert_array_equal(exact.page_gid, golden.page_gid)
    np.testing.assert_array_equal(exact.match_counts, golden.match_counts)
    np.testing.assert_array_equal(exact.value_counts, golden.value_counts)
    # indicator mode: same page sets, counts clamped to {0, 1}
    np.testing.assert_array_equal(
        np.sort(ind.pruned_pages()), np.sort(golden.pruned_pages())
    )
    np.testing.assert_array_equal(
        np.sort(ind.surviving_pages()), np.sort(golden.surviving_pages())
    )
    assert set(np.unique(ind.match_counts)) <= {0, 1}
    np.testing.assert_array_equal(ind.value_counts, golden.value_counts)


def test_cold_scan_mixed_columns(tmp_path):
    rng = np.random.default_rng(13)
    path = mixed_file(tmp_path / "mix.parquet", rng)
    eng = ScanEngine(path)
    for col in ["city", "comment"]:
        for pattern, neg in [("alpha", False), ("o.*a", True), ("[a-m]{3}", False)]:
            golden = eng.scan(col, pattern, negate=neg, engine="numpy")
            exact = eng.cold_scan(col, pattern, negate=neg, exact_counts=True)
            np.testing.assert_array_equal(exact.match_counts, golden.match_counts)
            np.testing.assert_array_equal(exact.value_counts, golden.value_counts)


def test_cold_scan_type_error(tmp_path):
    rng = np.random.default_rng(14)
    path = mixed_file(tmp_path / "mix.parquet", rng)
    eng = ScanEngine(path)
    with pytest.raises(TypeError, match="BYTE_ARRAY"):
        eng.cold_scan("i64", "x")


def test_cold_scan_like_and_fallback(plain_file):
    eng = ScanEngine(plain_file)
    # LIKE translation goes through the same path
    a = eng.cold_scan("s", "%ab%cd%", like=True, exact_counts=True)
    b = eng.scan("s", "^.*ab.*cd.*$", engine="numpy")
    np.testing.assert_array_equal(a.match_counts, b.match_counts)
    # patterns outside the DFA subset fall back to the host `re` matcher
    c = eng.cold_scan("s", r"(ab)\1", exact_counts=True)
    d = eng.scan("s", r"(ab)\1", engine="numpy")
    np.testing.assert_array_equal(c.match_counts, d.match_counts)


def test_cold_scan_empty_and_full_match(plain_file):
    eng = ScanEngine(plain_file)
    # '.*' accepts every value including empty: every page survives
    r = eng.cold_scan("s", ".*", exact_counts=True)
    np.testing.assert_array_equal(r.match_counts, r.value_counts)
    # negated '.*' matches nothing: every page is reported
    rn = eng.cold_scan("s", ".*", negate=True, exact_counts=True)
    assert (rn.match_counts == 0).all()


def test_cold_scan_neg_indicator_dense_candidates(tmp_path):
    """neg+indicator on a PLAIN column where every value contains every
    needle candidate (regression: the per-value confirm walk read the
    non-filter needles' masks, which the rarest-needle screen no longer
    fills chunk-wide — crashed when pages weren't screened out first)."""
    from duckdb_parquet_parser.host.writer import ParquetWriter, ColumnSpec
    from duckdb_parquet_parser.host.schema import ParquetType

    rng = np.random.default_rng(21)
    path = str(tmp_path / "dense.parquet")
    # all values contain "alpha" and "bravo" candidates; a random minority
    # break the chain order so some values FAIL (neg indicator must fire
    # only on pages that have a failing value)
    vals = []
    for i in range(4000):
        if rng.random() < 0.03:
            vals.append(f"bravo pad{i} alpha")          # wrong order: fails
        else:
            vals.append(f"alpha pad{i} bravo tail")      # matches
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY)])
    w.write_row_group({"s": vals})
    w.close()
    eng = ScanEngine(path)
    for neg in (False, True):
        golden = eng.scan("s", "alpha.*bravo", negate=neg, engine="numpy")
        exact = eng.cold_scan("s", "alpha.*bravo", negate=neg, exact_counts=True)
        ind = eng.cold_scan("s", "alpha.*bravo", negate=neg)
        np.testing.assert_array_equal(exact.match_counts, golden.match_counts)
        np.testing.assert_array_equal(
            np.sort(ind.surviving_pages()), np.sort(golden.surviving_pages())
        )


@pytest.mark.parametrize("pattern,neg", [("alpha.*bravo", False), ("charlie", True)])
def test_scan_streaming_parity(dict_file, plain_file, pattern, neg):
    """The pipelined cold device scan produces the same page sets/counts as
    the golden matcher, across row-group block boundaries."""
    for path in (dict_file, plain_file):
        eng = ScanEngine(path)
        golden = eng.scan("s", pattern, negate=neg, engine="numpy")
        got = eng.scan_streaming("s", pattern, negate=neg, block_pages=8)
        np.testing.assert_array_equal(got.page_gid, golden.page_gid)
        np.testing.assert_array_equal(got.match_counts, golden.match_counts)
        np.testing.assert_array_equal(got.value_counts, golden.value_counts)


def test_length_buckets_cover_and_bound():
    from duckdb_parquet_parser.ops.scan import length_buckets

    rng = np.random.default_rng(3)
    plen = rng.integers(100, 1400, 5000).astype(np.int32)
    buckets = length_buckets(plen, min_bucket=100)
    got = np.concatenate([idx for idx, _ in buckets])
    np.testing.assert_array_equal(np.sort(got), np.arange(len(plen)))
    for idx, steps in buckets:
        assert steps >= int(plen[idx].max())
    # two buckets must beat one on total lane-steps for spread-out lengths
    if len(buckets) == 2:
        (i1, s1), (i2, s2) = buckets
        assert len(i1) * s1 + len(i2) * s2 < len(plen) * int(plen.max())


def test_resident_bucketed_scan_parity(dict_file, plain_file, monkeypatch):
    """Two-bucket resident serving returns the same counts as the golden
    matcher (forced split via a tiny min_bucket)."""
    import duckdb_parquet_parser.ops.scan as S

    orig = S.length_buckets
    monkeypatch.setattr(
        S, "length_buckets",
        lambda plen, max_buckets=2, min_bucket=1024: orig(
            plen, max_buckets, min_bucket=2
        ),
    )
    for path in (dict_file, plain_file):
        eng = ScanEngine(path)
        res = eng.resident("s")
        assert len(res._buckets) >= 1
        for pattern, neg in [("alpha.*bravo", False), ("charlie", True)]:
            got = res.scan(pattern, negate=neg)
            golden = eng.scan("s", pattern, negate=neg, engine="numpy")
            np.testing.assert_array_equal(got.match_counts, golden.match_counts)
            np.testing.assert_array_equal(got.value_counts, golden.value_counts)
            np.testing.assert_array_equal(got.page_gid, golden.page_gid)


# ── dict-miss short-circuit (round 5) ───────────────────────────────────────


def _dict_file(tmp_path, n_unique, name, n=4000, null_p=0.1, rgs=2):
    rng = np.random.default_rng(101)
    return strings_file(tmp_path / name, rng, n=n,
                        n_unique=n_unique, null_p=null_p, rgs=rgs)


def test_dict_all_miss_short_circuit(tmp_path):
    """A positive pattern matching zero dictionary entries skips the
    index-run walk — same pages, counts, and values as the full walk —
    but ONLY when (1 << idx_bw) <= dict_n proves OOB indices impossible."""
    import os

    from duckdb_parquet_parser.host.reader import ParquetReader

    # dict_n == 8 (power of two): bw == 3 and 2^3 <= 8 -> skip engages
    p8 = _dict_file(tmp_path, 8, "d8.parquet")
    miss = "zz_nothing_matches"
    res_skip = ScanEngine(p8).cold_scan("s", miss, exact_counts=True)
    assert res_skip.dict_skipped_pages > 0
    # forced full walk via a pattern that accepts one entry (no skip) has
    # identical value_counts; and the indicator mode agrees too
    os.environ["DPQ_NO_CI_NN"] = "1"  # also exercise the def-decode fall
    try:
        res_ind = ScanEngine(p8).cold_scan("s", miss)
    finally:
        os.environ.pop("DPQ_NO_CI_NN", None)
    assert np.array_equal(res_skip.page_gid, res_ind.page_gid)
    assert np.array_equal(res_skip.value_counts, res_ind.value_counts)
    assert not res_skip.match_counts.any()
    # cross-check against the device/prescan path (oracle for counts)
    batch = ParquetReader(p8).prescan("s", pad_strings=8)
    ref = scan_batch(batch, miss)
    assert np.array_equal(np.asarray(res_ind.match_counts) > 0,
                          np.asarray(ref.match_counts) > 0)

    # dict_n == 5: bw == 3 but 2^3 > 5 -> OOB is EXPRESSIBLE, never skip
    p5 = _dict_file(tmp_path, 5, "d5.parquet")
    res5 = ScanEngine(p5).cold_scan("s", miss, exact_counts=True)
    assert res5.dict_skipped_pages == 0


def test_dict_all_miss_negation_never_skips(tmp_path):
    """Negated patterns match THROUGH non-accepted entries — the all-miss
    short-circuit must never engage."""
    from duckdb_parquet_parser.models.scan import ScanEngine

    p8 = _dict_file(tmp_path, 8, "dneg.parquet")
    res = ScanEngine(p8).cold_scan("s", "zz_nothing", negate=True,
                                   exact_counts=True)
    assert res.dict_skipped_pages == 0
    assert res.match_counts.sum() > 0  # every non-null value survives


def test_dict_oob_page_never_skips(tmp_path):
    """A page with a REAL out-of-range index: corrupt one RLE run value to
    an index >= dict_n (expressible because 2^bw > dict_n) and check the
    cold scan still walks it and drops the OOB values from the
    participating count, exactly like the prescan path."""
    from duckdb_parquet_parser.host.reader import ParquetReader
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    rng = np.random.default_rng(7)
    path = str(tmp_path / "oob.parquet")
    # 5 unique -> bw 3; one row group, no nulls -> def section all-ones RLE
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                        optional=True)],
                      key_value={"pad": "x" * 512})
    # runs of >= 4 repeats make the writer emit RLE idx runs (patchable
    # value byte); 5 distinct entries -> bw 3, OOB expressible
    uniq = [b"aaaa", b"bbbb", b"cccc", b"dddd", b"eeee"]
    vals = [u for u in uniq for _ in range(40)]
    w.write_row_group({"s": vals})
    w.close()

    r = ParquetReader(path)
    batch = r.prescan("s", pad_strings=8)
    assert int(batch.arrays["page_kind"][0]) == 1  # dict-encoded
    bw = int(batch.arrays["page_idx_bw"][0])
    assert (1 << bw) > 5  # OOB expressible
    # locate the first data page's index section inside the FILE: data page
    # payload = [u32 def_len][def RLE][bw byte][idx RLE runs]
    import struct
    e = r.page_index_entry(int(batch.arrays["page_gid"][0]))
    raw = bytearray(open(path, "rb").read())
    off = e.data_offset
    def_len = struct.unpack_from("<I", raw, off)[0]
    idx_at = off + 4 + def_len
    assert raw[idx_at] == bw
    # first idx run header: RLE run = varint(count << 1), then value byte.
    # Patch the value byte to 7 (>= dict_n == 5) — a real OOB run.
    hdr_at = idx_at + 1
    assert raw[hdr_at] & 1 == 0, "expected an RLE run, got a literal group"
    val_at = hdr_at + 1
    while raw[val_at - 1] & 0x80:  # skip varint continuation bytes
        val_at += 1
    old = raw[val_at]
    assert old < 5
    raw[val_at] = 7
    cpath = str(tmp_path / "oob_corrupt.parquet")
    open(cpath, "wb").write(bytes(raw))

    res = ScanEngine(cpath).cold_scan("s", "zz_nothing", exact_counts=True)
    assert res.dict_skipped_pages == 0  # bw check forbids the skip
    # oracle: the prescan/device path drops OOB values identically
    ref = scan_batch(ParquetReader(cpath).prescan("s", pad_strings=8),
                     "zz_nothing")
    order = np.argsort(res.page_gid)
    order_ref = np.argsort(ref.page_gid)
    assert np.array_equal(res.value_counts[order],
                          np.asarray(ref.value_counts)[order_ref])
    # the corrupt run really removed participating values
    full = ScanEngine(path).cold_scan("s", "zz_nothing", exact_counts=True)
    assert res.value_counts.sum() < full.value_counts.sum()
