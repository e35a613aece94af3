"""DataPageV2 read support (engine extension; pyarrow as the writer oracle).

The reference SKIPS the V2 header field (PageHeader id 8 is not in its field
map, reference: src/reader/metadata.cpp:138-150) and decodes nothing from V2
pages; the engine reads them: [rep][def] level sections stored uncompressed
without the u32 prefix, values optionally codec-compressed.
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader

pa = pytest.importorskip("pyarrow")


def _v2_file(tmp_path, compression, use_dictionary, name):
    import pyarrow.parquet as pq

    rng = np.random.default_rng(99)
    n = 6000
    card = 40 if use_dictionary else 100000
    svals = [None if rng.random() < 0.15 else
             f"city-{int(rng.integers(0, card))}" for _ in range(n)]
    table = pa.table({
        "x": pa.array(rng.integers(-(1 << 40), 1 << 40, n), type=pa.int64()),
        "f": pa.array([None if rng.random() < 0.1 else float(v)
                       for v in rng.random(n)], type=pa.float64()),
        "s": pa.array(svals, type=pa.binary()),
    })
    path = tmp_path / name
    pq.write_table(table, path, compression=compression,
                   use_dictionary=use_dictionary,
                   data_page_version="2.0", write_statistics=False,
                   data_page_size=4096)
    return str(path), table, svals


@pytest.mark.parametrize("compression,use_dictionary", [
    ("none", True), ("none", False),
    ("snappy", True), ("snappy", False),
])
def test_v2_read_column(tmp_path, compression, use_dictionary):
    path, table, svals = _v2_file(
        tmp_path, compression, use_dictionary,
        f"v2_{compression}_{int(use_dictionary)}.parquet")
    r = ParquetReader(path)
    cx = r.read_column("x")
    np.testing.assert_array_equal(np.asarray(cx.values),
                                  table.column("x").to_numpy())
    cf = r.read_column("f")
    ref_f = table.column("f").to_numpy()
    valid_f = np.asarray(cf.valid)
    np.testing.assert_array_equal(valid_f, ~np.isnan(ref_f))
    np.testing.assert_array_equal(np.asarray(cf.values)[valid_f],
                                  ref_f[~np.isnan(ref_f)])
    cs = r.read_column("s")
    got = [bytes(v) if ok else None
           for v, ok in zip(cs.values, np.asarray(cs.valid))]
    assert got == [None if v is None else v.encode() for v in svals]


def test_v2_page_index_has_pages(tmp_path):
    path, _table, _ = _v2_file(tmp_path, "none", True, "v2_pages.parquet")
    r = ParquetReader(path)
    assert r.num_pages() > 1  # split by data_page_size
    # iterator emissions line up with the decoded column
    cs = r.read_column("s")
    expect = [(i, bytes(v)) for i, (v, ok) in
              enumerate(zip(cs.values, np.asarray(cs.valid))) if ok]
    got = [(item[0], bytes(item[-1])) for item in r.column_iterator("s")]
    assert got == expect


def test_v2_scan_matches_re(tmp_path):
    import re

    from duckdb_parquet_parser.models.scan import ScanEngine

    path, _table, svals = _v2_file(tmp_path, "snappy", True, "v2_scan.parquet")
    res = ScanEngine(path).scan("s", "city-1[0-9]$")
    rx = re.compile(rb"city-1[0-9]$")
    expect = sum(1 for v in svals
                 if v is not None and rx.search(v.encode()))
    assert int(res.match_counts.sum()) == expect

    cold = ScanEngine(path).cold_scan("s", "city-1[0-9]$", exact_counts=True)
    assert int(cold.match_counts.sum()) == expect
