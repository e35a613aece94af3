"""FIXED_LEN_BYTE_ARRAY: a deliberate capability extension.

The reference reader REJECTS the type ("Unsupported type for plain
decoding", src/reader/column_reader.cpp:254-255) — pinned below against the
compiled oracle — while the engine writes and decodes it through the
fixed-width machinery at the declared type_length."""

from __future__ import annotations

import subprocess

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter


def _write(path, n=700, w=5, null_p=0.2, uniques=None, seed=3):
    rng = np.random.default_rng(seed)
    if uniques:
        pool = rng.integers(0, 256, (uniques, w)).astype(np.uint8)
        vals = pool[rng.integers(0, uniques, n)]
    else:
        vals = rng.integers(0, 256, (n, w)).astype(np.uint8)
    valid = (rng.random(n) > null_p).astype(np.uint8)
    writer = ParquetWriter(
        str(path),
        [ColumnSpec("f", ParquetType.FIXED_LEN_BYTE_ARRAY, optional=True,
                    type_length=w)],
        key_value={"pad": "x" * 512},
    )
    writer.write_row_group({"f": (vals, valid)})
    writer.close()
    return vals, valid


@pytest.mark.parametrize("uniques", [None, 7])  # PLAIN and dict-encoded
def test_flba_roundtrip(tmp_path, uniques):
    path = tmp_path / "flba.parquet"
    vals, valid = _write(path, uniques=uniques)
    r = ParquetReader(str(path))
    info = r.column("f")
    assert info.type == ParquetType.FIXED_LEN_BYTE_ARRAY
    assert info.type_length == 5
    col = r.read_column("f")
    np.testing.assert_array_equal(col.valid, valid.astype(bool))
    for i in range(len(col)):
        if valid[i]:
            assert col.values[i] == vals[i].tobytes(), i
        else:
            assert col.values[i] is None


def test_reference_rejects_flba(tmp_path):
    from tests.oracle.build_oracle import build_oracle

    exe = build_oracle()
    if exe is None:
        pytest.skip("oracle unavailable")
    path = tmp_path / "flba.parquet"
    _write(path)
    proc = subprocess.run(
        [str(exe), str(path), "column", "f"], capture_output=True, text=True
    )
    # the reference throws in read_plain_value (column_reader.cpp:254-255)
    assert proc.returncode != 0 or "Unsupported" in (proc.stderr + proc.stdout)
