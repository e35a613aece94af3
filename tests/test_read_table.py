"""read_table: one-call whole-file read with per-shape reconstruction."""

from __future__ import annotations

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from duckdb_parquet_parser.host.reader import ParquetReader  # noqa: E402


@pytest.fixture(scope="module")
def table_file(tmp_path_factory):
    rng = np.random.default_rng(17)
    n = 400

    def maybe(v):
        return None if rng.random() < 0.15 else v

    t = pa.table({
        "i": pa.array([maybe(int(rng.integers(1000))) for _ in range(n)],
                      type=pa.int64()),
        "f": pa.array([maybe(float(rng.standard_normal())) for _ in range(n)],
                      type=pa.float64()),
        "s": pa.array([maybe(f"v{i}".encode()) for i in range(n)],
                      type=pa.binary()),
        "l": pa.array([maybe([int(x) for x in rng.integers(0, 9, rng.integers(0, 4))])
                       for _ in range(n)], type=pa.list_(pa.int64())),
        "st": pa.array([maybe({"a": maybe(int(rng.integers(9))),
                               "b": maybe(b"x")}) for _ in range(n)],
                       type=pa.struct([("a", pa.int64()), ("b", pa.binary())])),
        "m": pa.array([maybe([(f"k{j}".encode(), maybe(int(rng.integers(9))))
                              for j in range(int(rng.integers(0, 3)))])
                       for _ in range(n)],
                      type=pa.map_(pa.binary(), pa.int64())),
    })
    d = tmp_path_factory.mktemp("read_table")
    path = d / "t.parquet"
    pq.write_table(t, path, compression="snappy", data_page_size=512,
                   row_group_size=150)
    return str(path), t


def test_read_table_all_shapes(table_file):
    path, t = table_file
    tab = ParquetReader(path).read_table()
    assert set(tab) == set(t.column_names)
    for f in t.column_names:
        assert len(tab[f]) == t.num_rows
        assert tab[f].to_pylist() == t.column(f).to_pylist(), f


def test_read_table_subset_and_errors(table_file):
    path, _t = table_file
    r = ParquetReader(path)
    sub = r.read_table(columns=["i", "m"])
    assert set(sub) == {"i", "m"}
    with pytest.raises(KeyError):
        r.read_table(columns=["nope"])


def test_single_leaf_list_shapes(tmp_path):
    """read_table dispatch: single-LEAF list columns whose element is a
    struct (list<struct<a>>) must assemble generically — only lists of
    bare leaves take the SoA read_list_column fast path (regression: the
    round-3 CLI smoke caught list<struct<a>> reading back as bare ints)."""
    rng = np.random.default_rng(3)

    def maybe(v, prob=0.2):
        return None if rng.random() < prob else v

    n = 150
    t = pa.table({
        "a": pa.array([maybe([maybe({"a": maybe(1)})
                              for _ in range(int(rng.integers(0, 3)))])
                       for _ in range(n)],
                      type=pa.list_(pa.struct([("a", pa.int64())]))),
        "b": pa.array([maybe([maybe([maybe(2)])
                              for _ in range(int(rng.integers(0, 3)))])
                       for _ in range(n)],
                      type=pa.list_(pa.list_(pa.int64()))),
        "c": pa.array([maybe([maybe(3)
                              for _ in range(int(rng.integers(0, 3)))])
                       for _ in range(n)],
                      type=pa.list_(pa.int64())),
        "d": pa.array([maybe([maybe([maybe({"z": maybe(b"q")})])])
                       for _ in range(n)],
                      type=pa.list_(pa.list_(pa.struct([("z", pa.binary())])))),
    })
    path = tmp_path / "sls.parquet"
    pq.write_table(t, path, compression="NONE", data_page_size=512)
    tab = ParquetReader(str(path)).read_table()
    for f in t.column_names:
        assert tab[f].to_pylist() == t.column(f).to_pylist(), f


def test_to_arrow_bridge(tmp_path):
    """DecodedColumn.to_arrow(): fixed-width columns keep dtype + nulls;
    BYTE_ARRAY becomes binary — round-trips through pyarrow equality."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(19)
    n = 700
    tbl = pa.table({
        "i": pa.array([None if rng.random() < 0.2 else int(v)
                       for v in rng.integers(-10**9, 10**9, n)],
                      type=pa.int64()),
        "f": pa.array([None if rng.random() < 0.2 else float(v)
                       for v in rng.standard_normal(n)], type=pa.float64()),
        "b": pa.array([None if rng.random() < 0.2 else bool(v)
                       for v in rng.integers(0, 2, n)], type=pa.bool_()),
        "s": pa.array([None if rng.random() < 0.2 else b"v%d" % (v % 37)
                       for v in rng.integers(0, 10**6, n)],
                      type=pa.binary()),
    })
    path = tmp_path / "arrow.parquet"
    pq.write_table(tbl, path, data_page_size=600)
    r = ParquetReader(str(path))
    for name in ("i", "f", "b", "s"):
        arr = r.read_column(name).to_arrow()
        assert arr.to_pylist() == tbl.column(name).to_pylist(), name
