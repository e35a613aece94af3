"""read_rows: page-granular row-span decode (engine extension).

The reference can only decode whole column chunks (reference:
src/reader/parquet_reader.cpp:133-165).  read_rows restricts the pre-scan to
the data pages overlapping [row_lo, row_hi) and trims the edge pages.
Oracle: read_column's full decode sliced to the same span — bit-exact on
every span class (page-interior, page-straddling, row-group-straddling,
point, full, empty) across types, codecs, and page versions.
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

pa = pytest.importorskip("pyarrow")


def _spans(rng, n, count=12):
    spans = [(0, min(10, n)), (max(0, n - 7), n), (0, n), (n // 2, n // 2),
             (n // 3, n // 3 + 1)]
    for _ in range(count):
        a = int(rng.integers(0, n))
        b = int(rng.integers(a, min(n, a + int(rng.integers(1, n // 2 + 2)))))
        spans.append((a, b))
    return spans


def _check_column(r, col, spans):
    full = r.read_column(col)
    fv = np.asarray(full.valid)
    for lo, hi in spans:
        got = r.read_rows(col, lo, hi)
        assert len(got) == hi - lo, (col, lo, hi)
        np.testing.assert_array_equal(np.asarray(got.valid), fv[lo:hi])
        if isinstance(full.values, np.ndarray):
            np.testing.assert_array_equal(np.asarray(got.values),
                                          np.asarray(full.values)[lo:hi])
        else:
            for i in range(hi - lo):
                if fv[lo + i]:
                    assert bytes(got.values[i]) == bytes(full.values[lo + i])


def test_read_rows_own_writer(tmp_path, rng):
    n = 25000
    words = [b"alpha", b"bravo", b"charlie", b"x" * 120]
    vals = [words[int(rng.integers(4))] for _ in range(n)]
    offs = np.zeros(n + 1, np.int64)
    offs[1:] = np.cumsum([len(v) for v in vals])
    chars = np.frombuffer(b"".join(vals), np.uint8)
    valid = (rng.random(n) > 0.15).astype(np.uint8)
    path = tmp_path / "own.parquet"
    w = ParquetWriter(str(path), [
        ColumnSpec("i", ParquetType.INT64, optional=True),
        ColumnSpec("d", ParquetType.DOUBLE),
        ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True),
        ColumnSpec("b", ParquetType.BOOLEAN),
    ])
    data = {
        "i": (rng.integers(-(1 << 40), 1 << 40, n), valid),
        "d": rng.random(n),
        "s": (offs, chars, valid),
        "b": rng.integers(0, 2, n).astype(bool),
    }
    w.write_row_group(data)
    w.write_row_group(data)  # rg boundary at n
    w.close()
    r = ParquetReader(str(path))
    spans = _spans(rng, 2 * n) + [(n - 3, n + 3)]  # rg straddle
    for col in ("i", "d", "s", "b"):
        _check_column(r, col, spans)


@pytest.mark.parametrize("codec,ver", [("zstd", "1.0"), ("snappy", "2.0")])
def test_read_rows_pyarrow_compressed(tmp_path, rng, codec, ver):
    import pyarrow.parquet as pq

    n = 20000
    ints = rng.integers(0, 10**9, n)
    svals = [None if rng.random() < 0.1 else f"k{int(v) % 97:02d}"
             for v in ints]  # low cardinality -> dict pages
    t = pa.table({"x": pa.array(ints, type=pa.int64()),
                  "s": pa.array(svals, type=pa.binary())})
    path = tmp_path / f"r_{codec}_{ver}.parquet"
    pq.write_table(t, path, compression=codec, data_page_version=ver,
                   row_group_size=8000, data_page_size=1024)
    r = ParquetReader(str(path))
    spans = _spans(rng, n) + [(7995, 8005), (15995, 16005)]
    for col in ("x", "s"):
        _check_column(r, col, spans)


def test_read_rows_edge_semantics(tmp_path, rng):
    path = tmp_path / "edge.parquet"
    w = ParquetWriter(str(path), [ColumnSpec("i", ParquetType.INT64)])
    w.write_row_group({"i": np.arange(1000)})
    w.close()
    r = ParquetReader(str(path))
    # clamping
    c = r.read_rows("i", -5, 3)
    np.testing.assert_array_equal(np.asarray(c.values), [0, 1, 2])
    c = r.read_rows("i", 995, 10**9)
    np.testing.assert_array_equal(np.asarray(c.values), np.arange(995, 1000))
    assert len(r.read_rows("i", 500, 500)) == 0
    assert len(r.read_rows("i", 800, 100)) == 0
    with pytest.raises(KeyError):
        r.read_rows("nope", 0, 10)
