"""Snappy codec + compressed-file support (engine extension).

The reference rejects every codec but UNCOMPRESSED (reference:
src/reader/column_reader.cpp:13-15) — that rejection parity is pinned here —
while the engine reads and writes Snappy pages.  Oracles:

  * pyarrow's snappy codec (raw byte-level cross-check, both directions);
  * pyarrow-WRITTEN snappy parquet files (cross-implementation read parity);
  * the engine's own uncompressed twin of each fixture (bit-identical
    decoded values / scan counts / index maps across codecs).
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host import bindings
from duckdb_parquet_parser.host.bindings import (
    NativeError,
    snappy_compress,
    snappy_decompress,
)
from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

pa = pytest.importorskip("pyarrow")


# ── codec level ──────────────────────────────────────────────────────────────


def test_codec_cross_oracle():
    rng = np.random.default_rng(7)
    cases = [
        b"", b"a", b"ab" * 40, b"hello hello hello hello",
        bytes(rng.integers(0, 256, 70000, dtype=np.uint8)),
        b"the quick brown fox " * 4000,
        b"\x00" * 66000,  # >1 block of a single byte (overlapping copies)
    ]
    for trial in range(60):
        n = int(rng.integers(0, 3000))
        cases.append(bytes(rng.integers(0, 256, n, dtype=np.uint8)))
        words = [b"alpha", b"beta", b"x", b"token-with-length"]
        cases.append(b"".join(
            words[int(k)] for k in rng.integers(0, 4, n // 4 + 1)))
    for data in cases:
        ours = snappy_compress(data)
        assert pa.decompress(ours, decompressed_size=len(data),
                             codec="snappy", asbytes=True) == data
        theirs = pa.compress(data, codec="snappy", asbytes=True)
        assert snappy_decompress(theirs, len(data)) == data


def test_codec_rejects_malformed():
    with pytest.raises(NativeError):
        snappy_decompress(b"\x05\x0f", 5)  # truncated literal
    with pytest.raises(NativeError):
        snappy_decompress(b"\x05\x09abc\x01", 5)  # copy before start
    with pytest.raises(NativeError):
        snappy_decompress(snappy_compress(b"abcdef"), 5)  # length mismatch


# ── engine fixtures: snappy twin must decode identically ─────────────────────


def _twin_files(tmp_path, rng):
    """The same mixed-type data written UNCOMPRESSED and SNAPPY."""
    n = 4000
    words = [b"san diego", b"new york", b"chicago", b"spec trail",
             b"x" * 300]  # one long value
    offs = np.zeros(n + 1, np.int64)
    parts = []
    for i in range(n):
        v = words[int(rng.integers(0, len(words)))]
        parts.append(v)
        offs[i + 1] = offs[i] + len(v)
    chars = np.frombuffer(b"".join(parts), np.uint8)
    valid_s = (rng.random(n) > 0.12).astype(np.uint8)
    # high-cardinality strings (PLAIN pages) in a second column
    offs2 = np.zeros(n + 1, np.int64)
    parts2 = []
    for i in range(n):
        v = bytes(rng.integers(97, 123, int(rng.integers(3, 30)), dtype=np.uint8))
        parts2.append(v)
        offs2[i + 1] = offs2[i] + len(v)
    chars2 = np.frombuffer(b"".join(parts2), np.uint8)
    cols = [
        ColumnSpec("i", ParquetType.INT64),
        ColumnSpec("f", ParquetType.DOUBLE, optional=True),
        ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True),
        ColumnSpec("p", ParquetType.BYTE_ARRAY),
        ColumnSpec("b", ParquetType.BOOLEAN),
    ]
    data = {
        "i": rng.integers(0, 1 << 40, n),
        "f": (rng.random(n), (rng.random(n) > 0.1).astype(np.uint8)),
        "s": (offs, chars, valid_s),
        "p": (offs2, chars2, np.ones(n, np.uint8)),
        "b": rng.integers(0, 2, n).astype(bool),
    }
    paths = {}
    for codec in ("uncompressed", "snappy"):
        path = tmp_path / f"twin_{codec}.parquet"
        w = ParquetWriter(str(path), cols, codec=codec)
        w.write_row_group(data)
        w.write_row_group(data)  # two row groups
        w.close()
        paths[codec] = str(path)
    return paths


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    rng = np.random.default_rng(2024)
    return _twin_files(tmp_path_factory.mktemp("snappy"), rng)


def test_twin_decode_identical(twins):
    ru = ParquetReader(twins["uncompressed"])
    rs = ParquetReader(twins["snappy"])
    for col in ("i", "f", "s", "p", "b"):
        cu = ru.read_column(col)
        cs = rs.read_column(col)
        np.testing.assert_array_equal(np.asarray(cu.valid), np.asarray(cs.valid))
        assert cu.to_strings() == cs.to_strings()


def test_twin_file_is_smaller_and_flagged(twins):
    import json
    import os

    assert os.path.getsize(twins["snappy"]) < os.path.getsize(
        twins["uncompressed"])
    meta = json.dumps(ParquetReader(twins["snappy"]).metadata())
    assert '"codec":1' in meta.replace(" ", "") or '"codec": 1' in meta


def test_twin_scan_and_iterator_identical(twins):
    from duckdb_parquet_parser.models.scan import ScanEngine

    for pattern in ["san.*o", "^new", "[a-f]{4}", "spec|chicago"]:
        a = ScanEngine(twins["uncompressed"]).scan("s", pattern)
        b = ScanEngine(twins["snappy"]).scan("s", pattern)
        np.testing.assert_array_equal(a.match_counts, b.match_counts)
        np.testing.assert_array_equal(a.value_counts, b.value_counts)
    itu = list(ParquetReader(twins["uncompressed"]).column_iterator("s"))
    its = list(ParquetReader(twins["snappy"]).column_iterator("s"))
    assert len(itu) == len(its)
    for a, b in zip(itu, its):
        assert a[0] == b[0] and bytes(a[-1]) == bytes(b[-1])


def test_twin_cold_scan_and_index_identical(twins):
    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops.index import build_index_for_column

    a = ScanEngine(twins["uncompressed"]).cold_scan("s", "san.*o",
                                                    exact_counts=True)
    b = ScanEngine(twins["snappy"]).cold_scan("s", "san.*o", exact_counts=True)
    np.testing.assert_array_equal(a.match_counts, b.match_counts)
    np.testing.assert_array_equal(a.value_counts, b.value_counts)

    iu = build_index_for_column(ParquetReader(twins["uncompressed"]), "s")
    is_ = build_index_for_column(ParquetReader(twins["snappy"]), "s")
    assert iu.num_chunks == is_.num_chunks
    np.testing.assert_array_equal(iu.tuple_to_chunk, is_.tuple_to_chunk)


# ── cross-implementation: files written by pyarrow ───────────────────────────


def test_reads_pyarrow_snappy_file(tmp_path):
    import pyarrow.parquet as pq

    rng = np.random.default_rng(5)
    n = 5000
    svals = [None if rng.random() < 0.1 else
             f"value-{int(rng.integers(0, 50))}" for _ in range(n)]
    table = pa.table({
        "x": pa.array(rng.integers(0, 1 << 50, n), type=pa.int64()),
        "s": pa.array(svals, type=pa.binary()),
    })
    path = tmp_path / "arrow_snappy.parquet"
    pq.write_table(table, path, compression="snappy", use_dictionary=True,
                   data_page_version="1.0", write_statistics=False)
    r = ParquetReader(str(path))
    cx = r.read_column("x")
    np.testing.assert_array_equal(
        np.asarray(cx.values), table.column("x").to_numpy())
    cs = r.read_column("s")
    got = [bytes(v) if ok else None
           for v, ok in zip(cs.values, np.asarray(cs.valid))]
    assert got == [None if v is None else v.encode() for v in svals]


def test_writes_files_pyarrow_reads(twins):
    import pyarrow.parquet as pq

    # pyarrow cannot read dict-encoded BOOLEAN pages (its limitation:
    # "Dictionary encoding not implemented for boolean type"), so read the
    # other columns
    t = pq.read_table(twins["snappy"], columns=["i", "f", "s", "p"])
    ru = ParquetReader(twins["uncompressed"])
    np.testing.assert_array_equal(
        t.column("i").to_numpy(), np.asarray(ru.read_column("i").values))
    s = t.column("s").to_pylist()
    cu = ru.read_column("s")
    expect = [bytes(v) if ok else None
              for v, ok in zip(cu.values, np.asarray(cu.valid))]
    assert s == expect


# ── reference rejection parity ───────────────────────────────────────────────


def test_reference_rejects_snappy(twins):
    import subprocess

    from tests.oracle.build_oracle import build_oracle

    exe = build_oracle()
    if exe is None:
        pytest.skip("reference sources unavailable")
    res = subprocess.run([str(exe), twins["snappy"], "column", "i"],
                         capture_output=True, text=True)
    assert res.returncode != 0
    assert "Only uncompressed" in (res.stderr + res.stdout)


def test_engine_rejects_unbuilt_codecs():
    # Every pyarrow-writable codec is now supported (tests/test_codecs.py);
    # LZO has no system library anywhere, so it pins the rejection path.
    from duckdb_parquet_parser.host.schema import CompressionCodec

    assert not bindings.codec_supported(int(CompressionCodec.LZO))
    with pytest.raises(NativeError, match="unsupported codec LZO"):
        bindings.codec_decompress(int(CompressionCodec.LZO), b"\x00", 1)
