"""Column-chunk Statistics exposure (engine extension).

The reference parses the Statistics struct only to discard it (reference:
src/reader/metadata.cpp:26-32).  The engine keeps null_count /
distinct_count / min / max and decodes them to typed values
(ParquetReader.column_stats).  Oracle: pyarrow-written statistics.
"""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader

pa = pytest.importorskip("pyarrow")


@pytest.fixture(scope="module")
def stats_file(tmp_path_factory):
    import pyarrow.parquet as pq

    rng = np.random.default_rng(11)
    n = 4000
    ints = rng.integers(-(1 << 40), 1 << 40, n)
    floats = rng.random(n) * 100 - 50
    svals = [None if rng.random() < 0.15 else
             f"key-{int(rng.integers(0, 999)):03d}" for _ in range(n)]
    f32 = rng.random(n).astype(np.float32)
    i32 = rng.integers(-99999, 99999, n).astype(np.int32)
    bools = rng.integers(0, 2, n).astype(bool)
    table = pa.table({
        "i64": pa.array(ints, type=pa.int64()),
        "i32": pa.array(i32, type=pa.int32()),
        "f64": pa.array(floats, type=pa.float64()),
        "f32": pa.array(f32, type=pa.float32()),
        "s": pa.array(svals, type=pa.binary()),
        "b": pa.array(bools, type=pa.bool_()),
    })
    path = tmp_path_factory.mktemp("stats") / "stats.parquet"
    pq.write_table(table, path, write_statistics=True, row_group_size=1500)
    return str(path), table


def test_stats_match_pyarrow(stats_file):
    import pyarrow.parquet as pq

    path, _ = stats_file
    r = ParquetReader(path)
    md = pq.ParquetFile(path).metadata
    names = ["i64", "i32", "f64", "f32", "s", "b"]
    for rg in range(md.num_row_groups):
        for ci, name in enumerate(names):
            ref = md.row_group(rg).column(ci).statistics
            got = r.column_stats(name)[rg]
            assert got.get("null_count") == ref.null_count, (name, rg)
            exp_min, exp_max = ref.min, ref.max
            if isinstance(exp_min, bytes):
                assert got["min"] == exp_min and got["max"] == exp_max
            elif isinstance(exp_min, float):
                assert got["min"] == pytest.approx(exp_min, abs=0)
                assert got["max"] == pytest.approx(exp_max, abs=0)
            else:
                assert got["min"] == exp_min and got["max"] == exp_max


def test_stats_absent_when_not_written(tmp_path):
    import pyarrow.parquet as pq

    table = pa.table({"x": pa.array(np.arange(100), type=pa.int64())})
    path = tmp_path / "nostats.parquet"
    pq.write_table(table, path, write_statistics=False)
    r = ParquetReader(str(path))
    assert r.column_stats("x") == [{}]


def test_own_writer_stats_roundtrip_and_pyarrow(tmp_path):
    # engine extension on the WRITE side too: our writer emits Statistics
    # (+ column_orders, without which readers must ignore min/max); both our
    # reader and pyarrow see the same typed values
    import pyarrow.parquet as pq

    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    rng = np.random.default_rng(3)
    n = 500
    valid = (rng.random(n) > 0.3).astype(np.uint8)
    ints = rng.integers(-(1 << 40), 1 << 40, n)
    words = [b"kiwi", b"apple", b"zebra-fruit"]
    vals = [words[int(rng.integers(3))] for _ in range(n)]
    offs = np.zeros(n + 1, np.int64)
    offs[1:] = np.cumsum([len(v) for v in vals])
    chars = np.frombuffer(b"".join(vals), np.uint8)
    path = tmp_path / "own.parquet"
    w = ParquetWriter(str(path), [
        ColumnSpec("i", ParquetType.INT64, optional=True),
        ColumnSpec("s", ParquetType.BYTE_ARRAY),
        ColumnSpec("d", ParquetType.DOUBLE),
    ])
    d = rng.random(n)
    w.write_row_group({"i": (ints, valid), "s": (offs, chars, None), "d": d})
    w.close()

    r = ParquetReader(str(path))
    live = ints[valid.astype(bool)]
    got = r.column_stats("i")[0]
    assert got["min"] == live.min() and got["max"] == live.max()
    assert got["null_count"] == int((~valid.astype(bool)).sum())
    gs = r.column_stats("s")[0]
    assert gs["min"] == min(vals) and gs["max"] == max(vals)
    gd = r.column_stats("d")[0]
    assert gd["min"] == d.min() and gd["max"] == d.max()

    md = pq.ParquetFile(str(path)).metadata.row_group(0)
    assert md.column(0).statistics.min == live.min()
    assert md.column(0).statistics.max == live.max()
    assert md.column(0).statistics.null_count == got["null_count"]
    assert md.column(1).statistics.min == min(vals)
    assert md.column(2).statistics.max == d.max()


def test_stats_unknown_column_raises(stats_file):
    path, _ = stats_file
    with pytest.raises(KeyError):
        ParquetReader(path).column_stats("nope")
