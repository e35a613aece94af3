"""Opt-in ASAN/UBSAN lane: DPQ_SANITIZE=1 python -m pytest tests/test_sanitizer.py

Builds the native library with -fsanitize=address,undefined and exercises
the full native surface (writer, open, page index, prescan incl. the
materialized planes and string views, cold scan both modes) in a fresh
interpreter with libasan preloaded.  Any heap error / UB aborts the child,
failing the test."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("DPQ_SANITIZE") != "1",
    reason="sanitizer lane is opt-in (DPQ_SANITIZE=1)",
)

_CHILD = r"""
import numpy as np
from duckdb_parquet_parser.host.build import build_library
from duckdb_parquet_parser.host import bindings
# route every native call through the sanitized build
so = build_library(sanitize=True)
bindings.build_library = lambda *a, **k: so
bindings._lib = None

from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.models.scan import cold_scan

rng = np.random.default_rng(1)
path = "/tmp/dpq_asan_fixture.parquet"
w = ParquetWriter(path, [
    ColumnSpec("i", ParquetType.INT64, optional=True),
    ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True),
])
n = 900
words = [b"alpha", b"bravo", b"charlie", b"delta"]
vals = [words[int(rng.integers(4))] for _ in range(n)]
offs = np.zeros(n + 1, np.int64); offs[1:] = np.cumsum([len(v) for v in vals])
chars = np.frombuffer(b"".join(vals), np.uint8)
valid = (rng.random(n) > 0.15).astype(np.uint8)
w.write_row_group({
    "i": (rng.integers(-99, 99, n), valid),
    "s": (offs, chars, valid),
})
w.close()

r = ParquetReader(path)
assert r.num_rows() == n
b = r.prescan("s", pad_strings=8,
              flags=bindings.PS_HOST_STRINGS | bindings.PS_PAYLOAD)
assert b.n_pages > 0
b2 = r.prescan("s", flags=bindings.PS_HOST_STRINGS | bindings.PS_STR_VIEWS)
col = r.read_column("i")
assert len(col) == n
res = cold_scan(r, "s", "alp.*a", exact_counts=True)
res2 = cold_scan(r, "s", "[abc]l?pha", negate=True)
assert len(res.page_gid) == len(res2.page_gid)

# Codecs: round trip (incl. malformed-input rejection) + a compressed twin
# through prescan / read_column / cold scan, for every codec in the build
blob = bytes(rng.integers(0, 256, 20000, dtype=np.uint8)) + b"abc" * 5000
assert bindings.snappy_decompress(bindings.snappy_compress(blob), len(blob)) == blob
try:
    bindings.snappy_decompress(b"\x7f\x00\xff\xff", 127)
    raise SystemExit("malformed snappy accepted")
except bindings.NativeError:
    pass
from duckdb_parquet_parser.host.schema import CompressionCodec
cu = r.read_column("s")
for codec in ("snappy", "gzip", "zstd", "lz4", "lz4_raw", "brotli"):
    cid = int(CompressionCodec[codec.upper()])
    if not bindings.codec_supported(cid):
        continue
    enc = bindings.codec_compress(cid, blob)
    assert bindings.codec_decompress(cid, enc, len(blob)) == blob
    for bad in (enc[: len(enc) // 2], b"\x7f\x00\xff\xff", enc + b"x" * 9):
        try:
            bindings.codec_decompress(cid, bad, len(blob))
        except bindings.NativeError:
            pass
    spath = "/tmp/dpq_asan_%s.parquet" % codec
    ws = ParquetWriter(spath, [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)],
                       codec=codec)
    ws.write_row_group({"s": (offs, chars, valid)})
    ws.close()
    rs = ParquetReader(spath)
    assert rs.read_column("s").to_strings() == cu.to_strings(), codec
    res3 = cold_scan(rs, "s", "alp.*a", exact_counts=True)
    assert int(res3.match_counts.sum()) == int(res.match_counts.sum()), codec

# Nested file: rep-level section capture (v1 spec order), the PS_REP_LEVELS
# plane, and the cold scan's nested parse — pyarrow writes, the sanitized
# lib reads
try:
    import pyarrow as pa
    import pyarrow.parquet as pq
except ImportError:
    pa = None
if pa is not None:
    lists = ([None, [], [b"aa", None, b"bb"], [b"alpha"]] * 120)
    t = pa.table({"l": pa.array(lists, type=pa.list_(pa.binary()))})
    pq.write_table(t, "/tmp/dpq_asan_nested.parquet", compression="NONE",
                   data_page_size=400, row_group_size=150)
    rn = ParquetReader("/tmp/dpq_asan_nested.parquet")
    lc = rn.read_list_column("element")
    assert lc.to_pylist() == t.column("l").to_pylist()
    res4 = cold_scan(rn, "element", "alp.*a", exact_counts=True)
    assert int(res4.match_counts.sum()) == 120

# Round-3 native surfaces: PS_INDEX emission + dpq_index_plan sweep (parity
# vs the numpy model under ASAN) and the lean PS_COL_ONLY column read
from duckdb_parquet_parser.ops.index import build_index_for_column
ia = build_index_for_column(r, "s", 700, engine="numpy")
ib = build_index_for_column(r, "s", 700, engine="native")
assert np.array_equal(ia.tuple_to_chunk, ib.tuple_to_chunk)
assert np.array_equal(ia.chunk_starts, ib.chunk_starts)
b3 = r.prescan("s", flags=(bindings.PS_HOST_STRINGS | bindings.PS_STR_VIEWS
                           | bindings.PS_COLUMN | bindings.PS_RUNS_ONLY
                           | bindings.PS_COL_ONLY))
assert int(b3.dims.get("col_mat", 0)) == 1

# Round-5 native surfaces: the fused one-call index build (engine="native"
# above already routes through it), PS_DELTA_RAW structure planes, the
# dict-miss short-circuit, and the unified prune range
if pa is not None:
    base = np.cumsum(rng.integers(-5, 9, 4000)).astype(np.int64)
    dv = [None if rng.random() < 0.1 else int(v) for v in base]
    pq.write_table(pa.table({"x": pa.array(dv, type=pa.int64())}),
                   "/tmp/dpq_asan_delta.parquet", use_dictionary=False,
                   column_encoding={"x": "DELTA_BINARY_PACKED"},
                   data_page_version="2.0", data_page_size=700)
    rdq = ParquetReader("/tmp/dpq_asan_delta.parquet")
    from duckdb_parquet_parser.ops.delta import read_delta_column
    dc = read_delta_column(rdq, "x", engine="numpy")
    hc = rdq.read_column("x")
    assert np.array_equal(np.asarray(dc.valid), np.asarray(hc.valid))
    assert np.array_equal(np.asarray(dc.values), np.asarray(hc.values))
res5 = cold_scan(r, "s", "zzz_nothing_matches")   # all-miss dictionaries
assert int(res5.match_counts.sum()) == 0
res6 = cold_scan(r, "s", "^alp[a-z]a$", exact_counts=True)  # class range
assert len(res6.page_gid) == len(res.page_gid)
print("ASAN_LANE_OK")
"""


def test_native_surface_asan_clean(tmp_path):
    from duckdb_parquet_parser.host.build import build_library

    build_library(sanitize=True)  # compile outside the child for clear errors
    asan = subprocess.run(
        ["gcc", "-print-file-name=libasan.so"], capture_output=True, text=True
    ).stdout.strip()
    stdcxx = subprocess.run(
        ["gcc", "-print-file-name=libstdc++.so.6"], capture_output=True,
        text=True,
    ).stdout.strip()
    env = dict(os.environ)
    # libstdc++ must be resident when asan initializes, or its __cxa_throw
    # interceptor aborts on the first native exception
    env["LD_PRELOAD"] = f"{asan} {stdcxx}"
    env["ASAN_OPTIONS"] = "detect_leaks=0"  # CPython itself "leaks" arenas
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], capture_output=True, text=True,
        env=env, timeout=600, cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ASAN_LANE_OK" in proc.stdout


_CORRUPT_CHILD = r"""
import os
from duckdb_parquet_parser.host import build, bindings
so = os.environ["DPQ_FORCE_LIB"]
build.build_library = lambda *a, **k: so
bindings.build_library = lambda *a, **k: so
import sys
import pytest
sys.exit(pytest.main(["-q", "tests/test_corruption.py"]))
"""


def test_corruption_fuzz_asan_clean(tmp_path):
    """The corruption fuzz (tests/test_corruption.py) re-run against the
    sanitized build: malformed inputs must raise cleanly with no heap
    errors / UB along the rejection paths."""
    from duckdb_parquet_parser.host.build import build_library

    so = build_library(sanitize=True)
    asan = subprocess.run(
        ["gcc", "-print-file-name=libasan.so"], capture_output=True, text=True
    ).stdout.strip()
    stdcxx = subprocess.run(
        ["gcc", "-print-file-name=libstdc++.so.6"], capture_output=True,
        text=True,
    ).stdout.strip()
    env = dict(os.environ)
    env["LD_PRELOAD"] = f"{asan} {stdcxx}"
    env["ASAN_OPTIONS"] = "detect_leaks=0"
    env["JAX_PLATFORMS"] = "cpu"
    env["DPQ_FORCE_LIB"] = str(so)
    proc = subprocess.run(
        [sys.executable, "-c", _CORRUPT_CHILD], capture_output=True,
        text=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
