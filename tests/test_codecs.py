"""GZIP/ZSTD/LZ4/LZ4_RAW/BROTLI page codecs (engine extension).

The reference rejects every codec but UNCOMPRESSED (reference:
src/reader/column_reader.cpp:13-15).  Snappy parity lives in
tests/test_snappy.py; this file covers the remaining codecs the engine
supports through the generic native codec layer (host/native/dpq_codec.hpp):

  * byte-level cross-oracle vs pyarrow's codecs, both directions;
  * pyarrow-WRITTEN compressed parquet files decode bit-exact
    (read_column / iterators / device scan / fused cold scan);
  * engine-written compressed files read back bit-exact by pyarrow;
  * rejection of codecs the build does not support (LZO everywhere;
    everything has a clear error naming the codec).
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host import bindings
from duckdb_parquet_parser.host.bindings import (
    NativeError,
    codec_compress,
    codec_decompress,
    codec_supported,
)
from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import CompressionCodec, ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

pa = pytest.importorskip("pyarrow")

# (engine codec enum, engine writer name, pyarrow codec-level name,
#  pyarrow parquet compression name)
CODECS = [
    (CompressionCodec.GZIP, "gzip", "gzip", "gzip"),
    (CompressionCodec.ZSTD, "zstd", "zstd", "zstd"),
    (CompressionCodec.LZ4_RAW, "lz4_raw", "lz4_raw", "lz4"),
    (CompressionCodec.BROTLI, "brotli", "brotli", "brotli"),
]


def _require(cid: CompressionCodec) -> None:
    if not codec_supported(int(cid)):
        pytest.skip(f"native build lacks {cid.name}")


# ── codec level ──────────────────────────────────────────────────────────────


@pytest.mark.parametrize("cid,_w,pa_name,_p", CODECS)
def test_codec_cross_oracle(cid, _w, pa_name, _p):
    _require(cid)
    rng = np.random.default_rng(int(cid))
    cases = [
        b"",
        b"a",
        b"ab" * 40,
        bytes(rng.integers(0, 256, 70000, dtype=np.uint8)),
        b"the quick brown fox " * 4000,
        b"\x00" * 66000,
    ]
    for _ in range(20):
        n = int(rng.integers(0, 3000))
        cases.append(bytes(rng.integers(0, 256, n, dtype=np.uint8)))
    for data in cases:
        ours = codec_compress(int(cid), data)
        assert pa.decompress(ours, decompressed_size=len(data),
                             codec=pa_name, asbytes=True) == data
        theirs = pa.compress(data, codec=pa_name, asbytes=True)
        assert codec_decompress(int(cid), theirs, len(data)) == data


def test_lz4_hadoop_framing():
    """Codec 5 (legacy LZ4): Hadoop framing decodes, raw block falls back."""
    _require(CompressionCodec.LZ4_RAW)
    data = b"hadoop framed lz4 " * 700
    framed = codec_compress(int(CompressionCodec.LZ4), data)
    # the frame header carries the big-endian uncompressed size
    assert framed[:4] == len(data).to_bytes(4, "big")
    assert codec_decompress(int(CompressionCodec.LZ4), framed,
                            len(data)) == data
    raw = codec_compress(int(CompressionCodec.LZ4_RAW), data)
    assert codec_decompress(int(CompressionCodec.LZ4), raw, len(data)) == data


@pytest.mark.parametrize("cid,_w,_pa,_p", CODECS)
def test_codec_rejects_corrupt(cid, _w, _pa, _p):
    _require(cid)
    good = codec_compress(int(cid), b"payload payload payload")
    with pytest.raises(NativeError):
        codec_decompress(int(cid), good, 5)  # length mismatch
    with pytest.raises(NativeError):
        codec_decompress(int(cid), good[: len(good) // 2], 23)  # truncated


def test_lzo_unsupported_everywhere(tmp_path):
    assert not codec_supported(int(CompressionCodec.LZO))
    with pytest.raises(NativeError, match="LZO"):
        codec_compress(int(CompressionCodec.LZO), b"x")
    with pytest.raises(NativeError, match="unsupported codec LZO"):
        ParquetWriter(str(tmp_path / "x.parquet"),
                      [ColumnSpec("i", ParquetType.INT64)], codec="lzo")


# ── engine fixtures: every codec twin decodes identically ────────────────────


def _twin_data(rng, n=3000):
    words = [b"san diego", b"new york", b"chicago", b"spec trail", b"x" * 300]
    offs = np.zeros(n + 1, np.int64)
    parts = []
    for i in range(n):
        v = words[int(rng.integers(0, len(words)))]
        parts.append(v)
        offs[i + 1] = offs[i] + len(v)
    chars = np.frombuffer(b"".join(parts), np.uint8)
    valid_s = (rng.random(n) > 0.12).astype(np.uint8)
    offs2 = np.zeros(n + 1, np.int64)
    parts2 = []
    for i in range(n):
        v = bytes(rng.integers(97, 123, int(rng.integers(3, 30)),
                               dtype=np.uint8))
        parts2.append(v)
        offs2[i + 1] = offs2[i] + len(v)
    chars2 = np.frombuffer(b"".join(parts2), np.uint8)
    cols = [
        ColumnSpec("i", ParquetType.INT64),
        ColumnSpec("f", ParquetType.DOUBLE, optional=True),
        ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True),
        ColumnSpec("p", ParquetType.BYTE_ARRAY),
    ]
    data = {
        "i": rng.integers(0, 1 << 40, n),
        "f": (rng.random(n), (rng.random(n) > 0.1).astype(np.uint8)),
        "s": (offs, chars, valid_s),
        "p": (offs2, chars2, np.ones(n, np.uint8)),
    }
    return cols, data


@pytest.fixture(scope="module")
def codec_twins(tmp_path_factory):
    rng = np.random.default_rng(77)
    cols, data = _twin_data(rng)
    tmp = tmp_path_factory.mktemp("codecs")
    paths = {}
    names = ["uncompressed"] + [
        w for cid, w, _, _ in CODECS if codec_supported(int(cid))
    ]
    for codec in names:
        path = tmp / f"twin_{codec}.parquet"
        w = ParquetWriter(str(path), cols, codec=codec)
        w.write_row_group(data)
        w.write_row_group(data)
        w.close()
        paths[codec] = str(path)
    return paths


def test_twin_decode_identical(codec_twins):
    ru = ParquetReader(codec_twins["uncompressed"])
    for codec, path in codec_twins.items():
        if codec == "uncompressed":
            continue
        rc = ParquetReader(path)
        for col in ("i", "f", "s", "p"):
            cu = ru.read_column(col)
            cc = rc.read_column(col)
            np.testing.assert_array_equal(np.asarray(cu.valid),
                                          np.asarray(cc.valid))
            assert cu.to_strings() == cc.to_strings(), (codec, col)


def test_twin_scan_identical(codec_twins):
    from duckdb_parquet_parser.models.scan import ScanEngine

    base = ScanEngine(codec_twins["uncompressed"]).scan("s", "san.*o")
    for codec, path in codec_twins.items():
        if codec == "uncompressed":
            continue
        got = ScanEngine(path).scan("s", "san.*o")
        np.testing.assert_array_equal(base.match_counts, got.match_counts)
        np.testing.assert_array_equal(base.value_counts, got.value_counts)
        cold = ScanEngine(path).cold_scan("s", "san.*o", exact_counts=True)
        np.testing.assert_array_equal(base.match_counts, cold.match_counts)


def test_twin_files_read_back_by_pyarrow(codec_twins):
    import pyarrow.parquet as pq

    tu = pq.read_table(codec_twins["uncompressed"])
    for codec, path in codec_twins.items():
        if codec == "uncompressed":
            continue
        tc = pq.read_table(path)
        assert tc.equals(tu), codec
        meta = pq.ParquetFile(path).metadata.row_group(0).column(0)
        assert meta.compression.lower().replace("_raw", "") in (
            codec.replace("_raw", ""), "lz4"), codec


# ── cross-implementation: pyarrow-written compressed files ──────────────────


@pytest.mark.parametrize("cid,_w,_pa,pq_name", CODECS)
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
def test_reads_pyarrow_compressed_file(tmp_path, cid, _w, _pa, pq_name,
                                       page_version):
    _require(cid)
    import pyarrow.parquet as pq

    rng = np.random.default_rng(int(cid) + 100)
    n = 5000
    svals = [None if rng.random() < 0.1 else
             f"value-{int(rng.integers(0, 50))}" for _ in range(n)]
    pvals = ["".join(chr(int(c)) for c in rng.integers(97, 123, 12))
             for _ in range(n)]  # high-cardinality → PLAIN pages
    table = pa.table({
        "x": pa.array(rng.integers(0, 1 << 50, n), type=pa.int64()),
        "s": pa.array(svals, type=pa.binary()),
        "p": pa.array(pvals, type=pa.binary()),
    })
    path = tmp_path / f"arrow_{pq_name}_{page_version}.parquet"
    pq.write_table(table, path, compression=pq_name, use_dictionary=["s"],
                   data_page_version=page_version, write_statistics=False)
    r = ParquetReader(str(path))
    np.testing.assert_array_equal(
        np.asarray(r.read_column("x").values), table.column("x").to_numpy())
    cs = r.read_column("s")
    got = [bytes(v) if ok else None
           for v, ok in zip(cs.values, np.asarray(cs.valid))]
    assert got == [None if v is None else v.encode() for v in svals]
    cp = r.read_column("p")
    assert [bytes(v) for v in cp.values] == [v.encode() for v in pvals]
    # iterator emissions skip nulls with global row positions
    it = list(r.column_iterator("s"))
    expect = [(i, v.encode()) for i, v in enumerate(svals) if v is not None]
    assert [(pos, bytes(raw)) for pos, _ln, raw in it] == expect


@pytest.mark.parametrize("cid,_w,_pa,pq_name", CODECS)
def test_scans_pyarrow_compressed_file(tmp_path, cid, _w, _pa, pq_name):
    _require(cid)
    import pyarrow.parquet as pq

    from duckdb_parquet_parser.models.scan import ScanEngine

    rng = np.random.default_rng(int(cid) + 7)
    n = 4000
    words = ["san diego", "new york", "special sauce", "plain"]
    svals = [words[int(rng.integers(0, 4))] for _ in range(n)]
    table = pa.table({"s": pa.array(svals, type=pa.binary())})
    path = tmp_path / f"scan_{pq_name}.parquet"
    pq.write_table(table, path, compression=pq_name, use_dictionary=False,
                   data_page_version="1.0", write_statistics=False)
    expect = sum(1 for v in svals if "an" in v)
    dev = ScanEngine(str(path)).scan("s", "an")
    assert int(np.asarray(dev.match_counts).sum()) == expect
    cold = ScanEngine(str(path)).cold_scan("s", "an", exact_counts=True)
    assert int(np.asarray(cold.match_counts).sum()) == expect
