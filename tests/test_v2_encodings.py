"""V2 value encodings (engine extension; pyarrow as the writer oracle):
RLE booleans, DELTA_BINARY_PACKED ints, DELTA_LENGTH_BYTE_ARRAY /
DELTA_BYTE_ARRAY strings, BYTE_STREAM_SPLIT floats — all decoded host-side
into the engine's canonical PLAIN layouts (host/native/dpq_delta.hpp).

The reference decodes only PLAIN + dictionary pages; every encoding here is
beyond its surface.
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader

pa = pytest.importorskip("pyarrow")


def _write(tmp_path, name, table, encodings, **kw):
    import pyarrow.parquet as pq

    path = tmp_path / name
    pq.write_table(
        table, path, use_dictionary=False, column_encoding=encodings,
        data_page_version="2.0", write_statistics=False, **kw,
    )
    return str(path)


@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_rle_booleans(tmp_path, compression):
    rng = np.random.default_rng(3)
    n = 5000
    vals = [None if rng.random() < 0.1 else bool(v)
            for v in rng.integers(0, 2, n)]
    table = pa.table({"b": pa.array(vals, type=pa.bool_())})
    path = _write(tmp_path, f"rle_bool_{compression}.parquet", table,
                  {"b": "RLE"}, compression=compression)
    col = ParquetReader(path).read_column("b")
    got = [bool(v) if ok else None
           for v, ok in zip(np.asarray(col.values), np.asarray(col.valid))]
    assert got == vals


@pytest.mark.parametrize("dtype,patype", [
    (np.int32, "int32"), (np.int64, "int64"),
])
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_delta_binary_packed(tmp_path, dtype, patype, compression):
    rng = np.random.default_rng(4)
    n = 7000
    lo, hi = (-(1 << 30), 1 << 30) if dtype == np.int32 else (-(1 << 55), 1 << 55)
    base = rng.integers(lo, hi, n).astype(dtype)
    base[:100] = np.arange(100, dtype=dtype)  # a low-bit-width run
    vals = [None if rng.random() < 0.08 else int(v) for v in base]
    table = pa.table({"x": pa.array(vals, type=getattr(pa, patype)())})
    path = _write(tmp_path, f"dbp_{patype}_{compression}.parquet", table,
                  {"x": "DELTA_BINARY_PACKED"}, compression=compression)
    col = ParquetReader(path).read_column("x")
    got = [int(v) if ok else None
           for v, ok in zip(np.asarray(col.values), np.asarray(col.valid))]
    assert got == vals


@pytest.mark.parametrize("encoding", ["DELTA_LENGTH_BYTE_ARRAY",
                                      "DELTA_BYTE_ARRAY"])
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_delta_strings(tmp_path, encoding, compression):
    rng = np.random.default_rng(5)
    n = 4000
    # shared prefixes exercise DELTA_BYTE_ARRAY's front coding
    vals = [None if rng.random() < 0.1 else
            f"prefix-{int(rng.integers(0, 9))}/key-{int(rng.integers(0, 999)):06d}"
            for _ in range(n)]
    table = pa.table({"s": pa.array(vals, type=pa.binary())})
    path = _write(tmp_path, f"{encoding}_{compression}.parquet", table,
                  {"s": encoding}, compression=compression)
    r = ParquetReader(path)
    col = r.read_column("s")
    got = [bytes(v).decode() if ok else None
           for v, ok in zip(col.values, np.asarray(col.valid))]
    assert got == vals
    # iterator emissions line up too
    expect = [(i, v.encode()) for i, v in enumerate(vals) if v is not None]
    assert [(p, bytes(b)) for p, *_, b in r.column_iterator("s")] == expect


def test_byte_stream_split(tmp_path):
    rng = np.random.default_rng(6)
    n = 3000
    fv = rng.random(n)
    table = pa.table({
        "f": pa.array(fv, type=pa.float64()),
        "g": pa.array(fv.astype(np.float32), type=pa.float32()),
    })
    path = _write(tmp_path, "bss.parquet", table,
                  {"f": "BYTE_STREAM_SPLIT", "g": "BYTE_STREAM_SPLIT"})
    r = ParquetReader(path)
    np.testing.assert_array_equal(np.asarray(r.read_column("f").values), fv)
    np.testing.assert_array_equal(np.asarray(r.read_column("g").values),
                                  fv.astype(np.float32))


def test_delta_strings_scan_and_cold_fallback(tmp_path):
    import re

    from duckdb_parquet_parser.models.scan import ScanEngine

    rng = np.random.default_rng(8)
    n = 3000
    vals = [f"city-{int(rng.integers(0, 60))}" for _ in range(n)]
    table = pa.table({"s": pa.array(vals, type=pa.binary())})
    path = _write(tmp_path, "delta_scan.parquet", table,
                  {"s": "DELTA_BYTE_ARRAY"}, compression="snappy")
    rx = re.compile(rb"city-[12]$")
    expect = sum(1 for v in vals if rx.search(v.encode()))
    res = ScanEngine(path).scan("s", "city-[12]$")
    assert int(res.match_counts.sum()) == expect
    # cold scan falls back to the prescan path on delta pages
    cold = ScanEngine(path).cold_scan("s", "city-[12]$", exact_counts=True)
    assert int(cold.match_counts.sum()) == expect


# ── device-side DELTA_BINARY_PACKED decode (round 5) ────────────────────────


@pytest.mark.parametrize("dtype,patype", [
    (np.int32, "int32"), (np.int64, "int64"),
])
@pytest.mark.parametrize("compression", ["none", "snappy"])
@pytest.mark.parametrize("engine", ["numpy", "jax"])
def test_delta_device_decode(tmp_path, dtype, patype, compression, engine):
    """PS_DELTA_RAW structure planes + the device bit-unpack/prefix-sum
    kernel (ops/delta.py) against the host decoder / pyarrow values —
    mixed miniblock widths, nulls, full-range magnitudes, constant runs
    (bw 0) and both page versions of the arithmetic (wrap carries)."""
    from duckdb_parquet_parser.ops.delta import read_delta_column

    rng = np.random.default_rng(11)
    n = 9000
    lo, hi = ((-(1 << 31), 1 << 31) if dtype == np.int32
              else (-(1 << 62), 1 << 62))
    base = rng.integers(lo, hi, n).astype(dtype)
    base[:200] = np.arange(200, dtype=dtype)      # low-width run
    base[300:500] = dtype(7)                      # constant run (bw 0)
    base[600:640] = dtype(lo + 1)                 # extreme negatives
    vals = [None if rng.random() < 0.08 else int(v) for v in base]
    table = pa.table({"x": pa.array(vals, type=getattr(pa, patype)())})
    path = _write(tmp_path, f"dev_{patype}_{compression}_{engine}.parquet",
                  table, {"x": "DELTA_BINARY_PACKED"},
                  compression=compression, data_page_size=1300)
    r = ParquetReader(path)
    col = read_delta_column(r, "x", engine=engine)
    got = [int(v) if ok else None
           for v, ok in zip(np.asarray(col.values), np.asarray(col.valid))]
    assert got == vals
    # the host route over the same file stays the golden model
    host = r.read_column("x")
    hgot = [int(v) if ok else None
            for v, ok in zip(np.asarray(host.values), np.asarray(host.valid))]
    assert hgot == vals


def test_delta_device_required_column(tmp_path):
    """REQUIRED (no nulls) delta column through the identity decode path."""
    from duckdb_parquet_parser.ops.delta import read_delta_column

    vals = list(range(0, 40000, 3))
    table = pa.table({"x": pa.array(vals, type=pa.int64())})
    path = _write(tmp_path, "dev_req.parquet", table,
                  {"x": "DELTA_BINARY_PACKED"})
    col = read_delta_column(ParquetReader(path), "x", engine="numpy")
    assert np.asarray(col.valid).all()
    assert np.asarray(col.values).tolist() == vals


def test_delta_raw_rejects_plain(tmp_path):
    """PS_DELTA_RAW on a PLAIN file raises (mixed/absent delta pages) and
    read_delta_column surfaces it."""
    from duckdb_parquet_parser.host.bindings import NativeError
    from duckdb_parquet_parser.ops.delta import read_delta_column

    table = pa.table({"x": pa.array(list(range(100)), type=pa.int64())})
    path = _write(tmp_path, "plain.parquet", table, {"x": "PLAIN"})
    with pytest.raises(NativeError):
        read_delta_column(ParquetReader(path), "x", engine="numpy")
