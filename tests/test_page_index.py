"""Page Index (ColumnIndex / OffsetIndex) reading + stats-based page pruning.

Engine extension: the reference parses ColumnChunk ids 1-3 only and never
touches the page-index region (reference: src/reader/metadata.cpp:68-86).
Oracles:

  * pyarrow-written page indexes (write_page_index=True);
  * the engine's own decoded values: every ColumnIndex bound must contain
    the true per-page extremes (computed via the engine's page row spans),
    and pruned pages must contain zero qualifying values;
  * the OffsetIndex must agree exactly with the engine's own page index
    (offsets, sizes, first-row indices) — a cross-implementation check of
    the header-walking page indexer itself.
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader

pa = pytest.importorskip("pyarrow")


def _write(tmp, name, table, **kw):
    import pyarrow.parquet as pq

    path = tmp / name
    pq.write_table(table, path, write_page_index=True, use_dictionary=False,
                   write_statistics=True, **kw)
    return str(path)


@pytest.fixture(scope="module")
def pidx_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    n = 30000
    x = rng.integers(-(1 << 50), 1 << 50, n)
    svals = [None if rng.random() < 0.08 else
             f"tok-{int(v):012d}" for v in rng.integers(0, 10**12, n)]
    f = rng.random(n) * 1e6 - 5e5
    table = pa.table({
        "x": pa.array(x, type=pa.int64()),
        "xs": pa.array(np.sort(x), type=pa.int64()),  # clustered: prunable
        "s": pa.array(svals, type=pa.binary()),
        "f": pa.array(f, type=pa.float64()),
    })
    tmp = tmp_path_factory.mktemp("pidx")
    path = _write(tmp, "pidx.parquet", table, data_page_size=2048,
                  row_group_size=10000)
    return path, table


def test_offset_index_matches_engine_page_index(pidx_file):
    """pyarrow's OffsetIndex vs our header-walking page indexer."""
    path, _ = pidx_file
    r = ParquetReader(path)
    for col in ("x", "s", "f"):
        ps = r.page_stats(col)
        assert len(ps) > 10
        assert (ps.oi_first_row >= 0).all()  # OffsetIndex present
        np.testing.assert_array_equal(ps.oi_first_row, ps.row_start)
        for i in range(len(ps)):
            e = r.page_index_entry(int(ps.gid[i]))
            # OffsetIndex points at the page HEADER; our entry at the data
            # after it — header bytes = data_offset - oi_offset
            hdr = e.data_offset - int(ps.oi_offset[i])
            assert 0 < hdr < 64
            # OffsetIndex size INCLUDES the header; ours excludes it
            assert e.data_size == int(ps.oi_csize[i]) - hdr


def test_column_index_bounds_contain_true_extremes(pidx_file):
    path, table = pidx_file
    r = ParquetReader(path)
    for col in ("x", "f"):
        vals = table.column(col).to_numpy()
        ps = r.page_stats(col)
        n_rows = r.num_rows()
        for i in range(len(ps)):
            lo = int(ps.row_start[i])
            hi = int(ps.row_start[i + 1]) if i + 1 < len(ps) and \
                ps.row_start[i + 1] > lo else n_rows
            # row spans only bound within a row group; clamp via next page
            seg = vals[lo:hi]
            if not len(seg):
                continue
            assert ps.mins[i] <= seg.min() and ps.maxs[i] >= seg.max()


def test_prune_soundness_and_effectiveness(pidx_file):
    path, table = pidx_file
    r = ParquetReader(path)
    vals = table.column("xs").to_numpy()
    ps = r.page_stats("xs")
    n_rows = r.num_rows()
    row_spans = {}
    for i in range(len(ps)):
        lo = int(ps.row_start[i])
        hi = int(ps.row_start[i + 1]) if i + 1 < len(ps) and \
            ps.row_start[i + 1] > lo else n_rows
        row_spans[int(ps.gid[i])] = (lo, hi)

    lo_q, hi_q = np.quantile(vals, [0.2, 0.25])
    cases = [("==", int(lo_q), None), (">", int(hi_q), None),
             (">=", int(hi_q), None), ("<", int(lo_q), None),
             ("<=", int(lo_q), None), ("between", int(lo_q), int(hi_q))]
    for op, v, hi in cases:
        pruned = ps.prune(op, v, hi)
        assert len(pruned) > 0, op  # effectiveness on random data
        for gid in pruned:
            a, b = row_spans[int(gid)]
            seg = vals[a:b]
            if op == "==":
                ok = ~np.any(seg == v)
            elif op == ">":
                ok = ~np.any(seg > v)
            elif op == ">=":
                ok = ~np.any(seg >= v)
            elif op == "<":
                ok = ~np.any(seg < v)
            elif op == "<=":
                ok = ~np.any(seg <= v)
            else:
                ok = ~np.any((seg >= v) & (seg <= hi))
            assert ok, (op, gid)


def test_string_stats_and_null_counts(pidx_file):
    path, table = pidx_file
    r = ParquetReader(path)
    ps = r.page_stats("s")
    svals = table.column("s").to_pylist()
    n_rows = r.num_rows()
    assert (ps.null_count >= 0).all()
    total_nulls = sum(1 for v in svals if v is None)
    assert int(ps.null_count.sum()) == total_nulls
    for i in range(len(ps)):
        lo = int(ps.row_start[i])
        hi = int(ps.row_start[i + 1]) if i + 1 < len(ps) and \
            ps.row_start[i + 1] > lo else n_rows
        seg = [v for v in svals[lo:hi] if v is not None]
        if not seg or ps.mins[i] is None:
            continue
        assert ps.mins[i] <= min(seg) and ps.maxs[i] >= max(seg)
        assert ps.null_count[i] == sum(1 for v in svals[lo:hi] if v is None)
    # byte-wise pruning: every value is 'tok-…' so '>= b"u"' kills all
    # pages, '>= b"tok-"' kills none (unsorted strings span each page)
    assert len(ps.prune(">=", b"u")) == len(ps)
    assert ps.prune(">=", b"tok-").size == 0


def test_no_page_index_degrades(tmp_path):
    import pyarrow.parquet as pq

    table = pa.table({"x": pa.array(np.arange(5000), type=pa.int64())})
    path = tmp_path / "noidx.parquet"
    pq.write_table(table, path, write_page_index=False, data_page_size=1024)
    ps = ParquetReader(str(path)).page_stats("x")
    assert len(ps) > 1
    assert not ps.has_stats.any()
    assert ps.prune("==", 3).size == 0  # nothing prunable without stats
    # engine row accounting still present
    assert ps.row_start[0] == 0 and (np.diff(ps.row_start) > 0).all()


def test_page_index_with_compression_and_v2(tmp_path):
    import pyarrow.parquet as pq

    rng = np.random.default_rng(9)
    n = 20000
    x = np.sort(rng.integers(0, 10**9, n))
    table = pa.table({"x": pa.array(x, type=pa.int64())})
    for codec, ver in (("zstd", "1.0"), ("snappy", "2.0")):
        path = tmp_path / f"pidx_{codec}_{ver}.parquet"
        pq.write_table(table, path, write_page_index=True, compression=codec,
                       data_page_version=ver, data_page_size=2048,
                       use_dictionary=False)
        r = ParquetReader(str(path))
        ps = r.page_stats("x")
        assert ps.has_stats.all() and len(ps) > 5
        # ascending data: pruning below the median kills ~half the pages
        pruned = ps.prune("<", int(x[n // 2]))
        assert len(pruned) >= len(ps) // 3
        np.testing.assert_array_equal(ps.oi_first_row, ps.row_start)


def test_own_writer_page_index_roundtrip(tmp_path):
    # our writer emits ColumnIndex/OffsetIndex too (engine extension); its
    # OffsetIndex must agree with our header-walking page indexer and its
    # bounds must prune soundly — incl. dict-encoded pages and all-null pages
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    rng = np.random.default_rng(7)
    n = 12000
    vals = np.sort(rng.integers(0, 10**6, n))
    valid = np.ones(n, np.uint8)
    valid[3000:3500] = 0
    # dict pages hold ~1024 rows (1-byte indices); a 2500-row null prefix
    # makes the leading dict pages fully null
    kvalid = np.ones(n, np.uint8)
    kvalid[:2500] = 0
    path = tmp_path / "own.parquet"
    w = ParquetWriter(str(path), [
        ColumnSpec("x", ParquetType.INT64, optional=True),
        ColumnSpec("k", ParquetType.INT32,  # low-cardinality: dict pages
                   optional=True),
    ])
    kdata = ((vals % 7).astype(np.int32), kvalid)
    w.write_row_group({"x": (vals, valid), "k": kdata})
    w.write_row_group({"x": (vals, valid), "k": kdata})
    w.close()

    r = ParquetReader(str(path))
    for col in ("x", "k"):
        ps = r.page_stats(col)
        assert len(ps) > 3 and ps.has_stats.all()
        np.testing.assert_array_equal(ps.oi_first_row, ps.row_start)
        for i in range(len(ps)):
            e = r.page_index_entry(int(ps.gid[i]))
            hdr = e.data_offset - int(ps.oi_offset[i])
            assert 0 < hdr < 64
            assert e.data_size == int(ps.oi_csize[i]) - hdr

    kps = r.page_stats("k")
    assert kps.null_page.any()  # the null prefix produced all-null pages
    assert all(kps.mins[i] is None for i in range(len(kps))
               if kps.null_page[i])

    ps = r.page_stats("x")
    full = np.concatenate([vals, vals])
    fullv = np.concatenate([valid, valid]).astype(bool)
    n_rows = 2 * n
    med = int(vals[n // 2])
    pruned = ps.prune("<", med)
    assert len(pruned) > len(ps) // 4
    spans = {int(ps.gid[i]): (int(ps.row_start[i]),
                              int(ps.row_start[i + 1]) if i + 1 < len(ps)
                              else n_rows)
             for i in range(len(ps))}
    for gid in pruned:
        a, b = spans[int(gid)]
        seg = full[a:b][fullv[a:b]]
        assert not np.any(seg < med)

    # pyarrow detects the page index on our files
    import pyarrow.parquet as pq

    c = pq.ParquetFile(str(path)).metadata.row_group(0).column(0)
    assert c.has_column_index and c.has_offset_index
