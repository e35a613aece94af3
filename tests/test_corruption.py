"""Corruption fuzz: random byte flips anywhere in a valid file must either
decode (flip landed in unread padding / didn't change semantics) or raise a
clean Python exception — never crash the process.  The opt-in ASAN lane
(DPQ_SANITIZE=1) gives the same surface memory-error coverage."""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host.bindings import NativeError
from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter


@pytest.fixture(scope="module")
def base_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = tmp_path_factory.mktemp("corrupt") / "base.parquet"
    w = ParquetWriter(str(path), [
        ColumnSpec("i", ParquetType.INT64, optional=True),
        ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True),
    ], key_value={"pad": "x" * 512})
    n = 800
    vals = [None if rng.random() < 0.1 else
            f"w{int(rng.integers(30))}".encode() for i in range(n)]
    ints = (rng.integers(-9, 9, n), (rng.random(n) > 0.1).astype(np.uint8))
    w.write_row_group({"i": ints, "s": vals})
    w.close()
    return path.read_bytes()


def _exercise(path):
    r = ParquetReader(path)
    r.read_column("i")   # lean PS_COL_ONLY path (round 3)
    r.read_column("s")
    list(r.page_stats(0) or [])
    from duckdb_parquet_parser.models.scan import cold_scan
    from duckdb_parquet_parser.ops.index import build_index_for_column

    cold_scan(r, "s", "w1")
    build_index_for_column(r, "s")  # PS_INDEX emission + native plan sweep


@pytest.mark.parametrize("seed", range(40))
def test_random_byte_flips_never_crash(tmp_path, base_file, seed):
    rng = np.random.default_rng(9000 + seed)
    data = bytearray(base_file)
    for _ in range(int(rng.integers(1, 4))):
        pos = int(rng.integers(0, len(data)))
        data[pos] ^= int(rng.integers(1, 256))
    path = tmp_path / f"c{seed}.parquet"
    path.write_bytes(bytes(data))
    try:
        _exercise(str(path))
    except (NativeError, OSError, ValueError, KeyError, IndexError,
            TypeError, OverflowError, RuntimeError) as e:
        assert str(e)  # clean, message-bearing failure


@pytest.mark.parametrize("region", ["magic", "footer_len", "footer", "header"])
def test_targeted_corruption(tmp_path, base_file, region):
    data = bytearray(base_file)
    if region == "magic":
        data[-4:] = b"XXXX"
    elif region == "footer_len":
        data[-8:-4] = (2 ** 31 - 1).to_bytes(4, "little")
    elif region == "footer":
        mid = len(data) - 40
        for i in range(8):
            data[mid + i] ^= 0xFF
    else:  # first page header region
        for i in range(4, 12):
            data[i] ^= 0xA5
    path = tmp_path / f"{region}.parquet"
    path.write_bytes(bytes(data))
    try:
        _exercise(str(path))
    except (NativeError, OSError, ValueError, KeyError, IndexError,
            TypeError, OverflowError, RuntimeError):
        pass


@pytest.fixture(scope="module")
def delta_file(tmp_path_factory):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(5)
    base = np.cumsum(rng.integers(-5, 9, 3000)).astype(np.int64)
    vals = [None if rng.random() < 0.1 else int(v) for v in base]
    path = tmp_path_factory.mktemp("corrupt") / "delta.parquet"
    pq.write_table(pa.table({"x": pa.array(vals, type=pa.int64())}), path,
                   use_dictionary=False,
                   column_encoding={"x": "DELTA_BINARY_PACKED"},
                   data_page_version="2.0", data_page_size=700)
    return path.read_bytes()


@pytest.mark.parametrize("seed", range(25))
def test_delta_byte_flips_never_crash(tmp_path, delta_file, seed):
    """Byte flips on a DELTA_BINARY_PACKED file: the PS_DELTA_RAW structure
    parse (round 5) and the host delta decoder must decode or raise
    cleanly — never crash (strict-bounds cursors over untrusted input)."""
    from duckdb_parquet_parser.ops.delta import read_delta_column

    rng = np.random.default_rng(7000 + seed)
    data = bytearray(delta_file)
    for _ in range(int(rng.integers(1, 4))):
        pos = int(rng.integers(0, len(data)))
        data[pos] ^= int(rng.integers(1, 256))
    path = tmp_path / f"d{seed}.parquet"
    path.write_bytes(bytes(data))
    try:
        r = ParquetReader(str(path))
        r.read_column("x")                       # host delta decode
        read_delta_column(r, "x", engine="numpy")  # structure planes
    except (NativeError, OSError, ValueError, KeyError, IndexError,
            TypeError, OverflowError, RuntimeError) as e:
        assert str(e)
