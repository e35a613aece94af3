"""Chunked inverted index: oracle parity (counts + row->chunk map) and unit
tests of the boundary recurrence (flush-before-append overshoot semantics)."""

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.ops.index import (
    build_index,
    build_index_for_column,
    chunk_boundaries,
    entry_sizes,
)
from tests import fixtures


def scalar_chunks(sizes, chunk_size):
    """Direct restatement of the reference loop (src/main.cpp:21-32)."""
    chunk_of = []
    cur = 0
    cid = 0
    for s in sizes:
        if cur >= chunk_size:
            cur = 0
            cid += 1
        cur += s
        chunk_of.append(cid)
    return chunk_of


def test_entry_sizes_digit_prefix():
    lens = np.array([0, 1, 9, 10, 99, 100, 999, 1000, 12345])
    got = entry_sizes(lens)
    want = np.array([len(str(l)) + l for l in lens])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("chunk_size", [64, 1000, 4096])
def test_boundaries_match_scalar_loop(chunk_size, rng):
    sizes = rng.integers(1, 60, 5000)
    starts = chunk_boundaries(sizes, chunk_size)
    chunk_of = np.searchsorted(starts, np.arange(len(sizes)), side="right") - 1
    assert chunk_of.tolist() == scalar_chunks(sizes, chunk_size)


def test_index_oracle_parity(tmp_path, oracle, rng):
    for kind, kwargs in [("plain", {}), ("dict", {"n_unique": 10})]:
        path = fixtures.strings_file(
            tmp_path / f"{kind}.parquet", rng, n=2500, null_p=0.2, **kwargs
        )
        r = ParquetReader(path)
        for cs in (1000, 4096):
            idx = build_index_for_column(r, "s", cs)
            out = oracle(path, "index", "s", str(cs)).splitlines()
            assert idx.num_rows == int(out[0].split()[1])
            assert idx.num_chunks == int(out[1].split()[1])
            ref_map = np.array([int(x) for x in out[2:]], np.int64)
            assert np.array_equal(idx.tuple_to_chunk, ref_map)


def test_materialize_chunk_roundtrip(tmp_path, rng):
    from duckdb_parquet_parser.host.reader import _string_stream

    path = fixtures.strings_file(tmp_path / "m.parquet", rng, n=500, null_p=0.1)
    r = ParquetReader(path)
    batch = r.prescan("s")
    pos, lens, offs, chars = _string_stream(batch)
    idx = build_index(pos, lens, r.num_rows(), 512)
    blob = idx.materialize_chunk(0, chars, offs)
    # chunk content = concatenated "<len><bytes>" entries
    first_len = int(lens[0])
    assert blob.startswith(str(first_len).encode())
    decoded = r.read_column("s")
    first_val = decoded.values[int(pos[0])]
    assert blob[len(str(first_len)) : len(str(first_len)) + first_len] == first_val


def test_native_plan_matches_numpy(tmp_path, rng):
    """The native PS_INDEX emission + dpq_index_plan sweep is bit-identical
    to the vectorized numpy golden model across layouts (plain, dict,
    nulls, pyarrow-written pages)."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    paths = [
        fixtures.strings_file(tmp_path / "a.parquet", rng, n=3000, null_p=0.3),
        fixtures.strings_file(tmp_path / "b.parquet", rng, n=3000,
                              null_p=0.05, n_unique=7),
    ]
    vals = [None if rng.random() < 0.2
            else bytes(rng.integers(97, 123, rng.integers(0, 40))
                       .astype(np.uint8))
            for _ in range(4000)]
    p3 = tmp_path / "c.parquet"
    pq.write_table(pa.table({"s": pa.array(vals, type=pa.binary())}), p3,
                   compression="snappy", data_page_size=700,
                   row_group_size=900)
    paths.append(str(p3))
    # V2 pages (unprefixed levels, values-only compression): the fused
    # build must handle them natively too
    p4 = tmp_path / "d.parquet"
    pq.write_table(pa.table({"s": pa.array(vals, type=pa.binary())}), p4,
                   compression="zstd", data_page_size=700,
                   row_group_size=900, data_page_version="2.0")
    paths.append(str(p4))
    for path in paths:
        r = ParquetReader(str(path))
        for cs in (700, 4096):
            a = build_index_for_column(r, "s", cs, engine="numpy")
            b = build_index_for_column(r, "s", cs, engine="native")
            c = build_index_for_column(r, "s", cs, engine="emission")
            for other in (b, c):
                for f in ("positions", "lens", "chunk_of_entry",
                          "tuple_to_chunk", "chunk_starts"):
                    np.testing.assert_array_equal(
                        getattr(a, f), getattr(other, f), err_msg=f)


def test_null_rows_keep_zero(tmp_path, rng):
    path = fixtures.strings_file(tmp_path / "z.parquet", rng, n=300, null_p=0.5)
    r = ParquetReader(path)
    idx = build_index_for_column(r, "s")
    decoded = r.read_column("s")
    assert np.all(idx.tuple_to_chunk[~decoded.valid] == 0)


def test_fused_build_zero_fills_on_short_index_section(tmp_path):
    """A dictionary page whose index runs cover FEWER ranks than the value
    count: trailing ranks decode as index 0 (the reference RleDecoder
    zero-fills on exhaustion — quirk pinned in test_decode) and must EMIT,
    not drop.  All three engines must agree on the corrupted file."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
    import struct

    path = str(tmp_path / "short_idx.parquet")
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                        optional=True)],
                      key_value={"pad": "x" * 512})
    uniq = [b"aaaa", b"bbbb", b"cccc", b"dddd", b"eeee"]
    vals = [u for u in uniq for _ in range(40)]  # 5 RLE runs of 40
    w.write_row_group({"s": vals})
    w.close()

    r = ParquetReader(path)
    batch = r.prescan("s", pad_strings=8)
    assert int(batch.arrays["page_kind"][0]) == 1
    bw = int(batch.arrays["page_idx_bw"][0])
    e = r.page_index_entry(int(batch.arrays["page_gid"][0]))
    raw = bytearray(open(path, "rb").read())
    off = e.data_offset
    def_len = struct.unpack_from("<I", raw, off)[0]
    idx_at = off + 4 + def_len
    assert raw[idx_at] == bw
    hdr_at = idx_at + 1
    assert raw[hdr_at] == (40 << 1)  # first RLE run: count 40
    raw[hdr_at] = 8 << 1             # shrink to 8 -> 32 trailing ranks short
    cpath = str(tmp_path / "short_idx_corrupt.parquet")
    open(cpath, "wb").write(bytes(raw))

    rc = ParquetReader(cpath)
    a = build_index_for_column(rc, "s", 700, engine="numpy")
    b = build_index_for_column(rc, "s", 700, engine="native")
    c = build_index_for_column(rc, "s", 700, engine="emission")
    for other in (b, c):
        for f in ("positions", "lens", "chunk_of_entry", "tuple_to_chunk",
                  "chunk_starts"):
            np.testing.assert_array_equal(getattr(a, f), getattr(other, f),
                                          err_msg=f)
    # the zero-filled tail really emits "aaaa" lengths (index 0)
    assert int(a.lens.min()) == 4 and len(a.positions) == 200
