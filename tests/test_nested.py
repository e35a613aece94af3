"""Nested (repeated) columns: v1 level sections in spec order.

The reference reads def levels before rep levels — wrong for real nested
files (docs/reference_bugs.md #5).  The engine follows the spec when
max_rep > 0; the decoded LEAF stream (flat values, def<max_def slots as
nulls — the reference's decoded-and-ignored rep contract) must match
pyarrow's flattened view.
"""

from __future__ import annotations

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from duckdb_parquet_parser.host.reader import ParquetReader  # noqa: E402


def _flat_leaf_oracle(lists, max_def):
    """pyarrow list column -> expected (valid, values) leaf stream: one slot
    per leaf value, plus one NULL slot for each null/empty list."""
    valid, values = [], []
    for lst in lists:
        if lst is None or len(lst) == 0:
            valid.append(False)
            values.append(None)
            continue
        for v in lst:
            valid.append(v is not None)
            values.append(v)
    return valid, values


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("use_dict", [False, True], ids=["plain", "dict"])
def test_list_int64(tmp_path, version, use_dict):
    rng = np.random.default_rng(11)
    lists = []
    for i in range(800):
        x = rng.random()
        if x < 0.1:
            lists.append(None)
        elif x < 0.2:
            lists.append([])
        else:
            pool = rng.integers(0, 9, rng.integers(1, 6)).tolist()
            lists.append([None if rng.random() < 0.1 else int(v) for v in pool])
    t = pa.table({"l": pa.array(lists, type=pa.list_(pa.int64()))})
    path = tmp_path / "l.parquet"
    pq.write_table(t, path, compression="NONE", use_dictionary=use_dict,
                   data_page_version=version, data_page_size=512,
                   row_group_size=300)
    r = ParquetReader(str(path))
    col = r.read_column("element")
    want_valid, want_values = _flat_leaf_oracle(lists, max_def=3)
    assert len(col) == len(want_valid)
    np.testing.assert_array_equal(np.asarray(col.valid), want_valid)
    for i, (ok, w) in enumerate(zip(want_valid, want_values)):
        if ok:
            assert int(col.values[i]) == w, i


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("elem_type,gen", [
    (pa.int64(), lambda rng: int(rng.integers(-1000, 1000))),
    (pa.float64(), lambda rng: float(rng.standard_normal())),
    (pa.binary(), lambda rng: bytes(rng.integers(97, 123, rng.integers(0, 8))
                                    .astype(np.uint8))),
], ids=["int64", "float64", "binary"])
def test_list_reconstruction(tmp_path, version, elem_type, gen):
    """read_list_column == pyarrow to_pylist: null lists, empty lists, null
    elements, multi-page, multi-row-group, random codec."""
    rng = np.random.default_rng(31)
    lists = []
    for _ in range(700):
        x = rng.random()
        if x < 0.1:
            lists.append(None)
        elif x < 0.2:
            lists.append([])
        else:
            lists.append([None if rng.random() < 0.15 else gen(rng)
                          for _ in range(int(rng.integers(1, 7)))])
    t = pa.table({"l": pa.array(lists, type=pa.list_(elem_type))})
    path = tmp_path / "lr.parquet"
    pq.write_table(t, path, compression=["NONE", "snappy"][int(rng.integers(2))],
                   data_page_version=version, data_page_size=600,
                   row_group_size=250)
    r = ParquetReader(str(path))
    lc = r.read_list_column("element")
    assert len(lc) == len(lists)
    assert lc.to_pylist() == t.column("l").to_pylist()


def test_dotted_path_lookup(tmp_path):
    """Nested leaves resolve by dotted schema path or unique path segment
    (bare leaf names like 'element' repeat across lists)."""
    t = pa.table({
        "a": pa.array([[1], [2, 3], None], type=pa.list_(pa.int64())),
        "b": pa.array([[4], None, [5]], type=pa.list_(pa.int64())),
    })
    path = tmp_path / "two.parquet"
    pq.write_table(t, path, compression="NONE")
    r = ParquetReader(str(path))
    assert r.read_list_column("a.list.element").to_pylist() == \
        t.column("a").to_pylist()
    assert r.read_list_column("b").to_pylist() == t.column("b").to_pylist()
    assert r.find_column("nope") == -1


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_struct_reconstruction(tmp_path, version):
    """read_struct_column == pyarrow to_pylist: null structs, null inner
    structs (struct<struct>), null fields, required fields, multi-page /
    multi-row-group."""
    rng = np.random.default_rng(5)
    rows = []
    for i in range(600):
        if rng.random() < 0.15:
            rows.append(None)
            continue
        inner = None if rng.random() < 0.2 else {
            "a": None if rng.random() < 0.2 else int(rng.integers(100)),
            "b": None if rng.random() < 0.2 else f"s{i}".encode(),
        }
        rows.append({"x": None if rng.random() < 0.2 else float(i),
                     "req": i,
                     "inner": inner})
    typ = pa.struct([
        ("x", pa.float64()),
        ("req", pa.field("req", pa.int64(), nullable=False)).type
        if False else ("req", pa.int64()),
        ("inner", pa.struct([("a", pa.int64()), ("b", pa.binary())])),
    ])
    t = pa.table({"s": pa.array(rows, type=typ)})
    path = tmp_path / "st.parquet"
    pq.write_table(t, path, compression="NONE", data_page_version=version,
                   data_page_size=512, row_group_size=250)
    r = ParquetReader(str(path))
    sc = r.read_struct_column("s")
    assert sc.fields == ["x", "req", "inner.a", "inner.b"]
    assert sc.to_pylist() == t.column("s").to_pylist()


def test_struct_with_lists(tmp_path):
    """Lists inside structs (incl. inside inner structs) reconstruct in
    place: struct-null vs list-null vs empty-list all distinguished."""
    rng = np.random.default_rng(9)
    rows = []
    for i in range(600):
        if rng.random() < 0.15:
            rows.append(None)
            continue
        lst = None if rng.random() < 0.2 else (
            [] if rng.random() < 0.2 else
            [None if rng.random() < 0.2 else int(rng.integers(50))
             for _ in range(int(rng.integers(1, 4)))])
        rows.append({
            "x": None if rng.random() < 0.2 else float(i),
            "l": lst,
            "inner": None if rng.random() < 0.25 else
                     {"ll": None if rng.random() < 0.3 else
                            [f"t{i % 7}".encode()] * int(rng.integers(0, 3))},
        })
    typ = pa.struct([
        ("x", pa.float64()),
        ("l", pa.list_(pa.int64())),
        ("inner", pa.struct([("ll", pa.list_(pa.binary()))])),
    ])
    t = pa.table({"s": pa.array(rows, type=typ)})
    path = tmp_path / "sl.parquet"
    pq.write_table(t, path, compression="NONE", row_group_size=200)
    r = ParquetReader(str(path))
    assert r.read_struct_column("s").to_pylist() == t.column("s").to_pylist()


def test_struct_errors(tmp_path):
    t = pa.table({
        "s": pa.array([{"m": [(b"k", 1)]}],
                      type=pa.struct([("m", pa.map_(pa.binary(),
                                                    pa.int64()))])),
        "flat": pa.array([7], type=pa.int64()),
    })
    path = tmp_path / "serr.parquet"
    pq.write_table(t, path, compression="NONE")
    r = ParquetReader(str(path))
    # maps inside structs assemble generically (round 3: the old
    # NotImplementedError guard is gone)
    assert r.read_struct_column("s").to_pylist() == t.column("s").to_pylist()
    with pytest.raises(KeyError):
        r.read_struct_column("nope")
    # the map itself still reads via its own API
    assert r.read_map_column("s.m").to_pylist() == [[(b"k", 1)]]


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_map_reconstruction(tmp_path, version):
    """read_map_column == pyarrow to_pylist: null maps, empty maps, null
    values, string keys."""
    rng = np.random.default_rng(8)
    rows = []
    for i in range(500):
        x = rng.random()
        if x < 0.12:
            rows.append(None)
        elif x < 0.24:
            rows.append([])
        else:
            rows.append([
                (f"k{j}".encode(),
                 None if rng.random() < 0.2 else int(rng.integers(100)))
                for j in range(int(rng.integers(1, 5)))
            ])
    t = pa.table({"m": pa.array(rows, type=pa.map_(pa.binary(), pa.int64()))})
    path = tmp_path / "m.parquet"
    pq.write_table(t, path, compression="NONE", data_page_version=version,
                   data_page_size=512, row_group_size=200)
    r = ParquetReader(str(path))
    got = r.read_map_column("m")
    assert got.to_pylist() == t.column("m").to_pylist()
    with pytest.raises(KeyError):
        r.read_map_column("nope")


def test_list_reconstruction_rejects_flat(tmp_path):
    t = pa.table({"flat": pa.array([1, 2, 3], type=pa.int64())})
    path = tmp_path / "err.parquet"
    pq.write_table(t, path, compression="NONE")
    with pytest.raises(TypeError):
        ParquetReader(str(path)).read_list_column("flat")


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_deep_list_reconstruction(tmp_path, version):
    """max_rep > 1: generic Dremel assembly — list<list<int64>> and
    list<list<list<binary>>> with nulls/empties at EVERY level."""
    rng = np.random.default_rng(7)

    def gen(depth):
        x = rng.random()
        if x < 0.12:
            return None
        if x < 0.24:
            return []
        if depth == 1:
            return [None if rng.random() < 0.15 else int(rng.integers(100))
                    for _ in range(int(rng.integers(1, 4)))]
        return [gen(depth - 1) for _ in range(int(rng.integers(1, 4)))]

    ll = [gen(2) for _ in range(400)]
    lll = [gen(3) for _ in range(400)]
    t = pa.table({
        "ll": pa.array(ll, type=pa.list_(pa.list_(pa.int64()))),
        "lll": pa.array(lll, type=pa.list_(pa.list_(pa.list_(pa.int64())))),
    })
    path = tmp_path / "deep.parquet"
    pq.write_table(t, path, compression="NONE", data_page_version=version,
                   data_page_size=500, row_group_size=150)
    r = ParquetReader(str(path))
    # leaf names collide ("element") — read_list_column takes column indices
    assert [c.name for c in r._columns].count("element") == 2
    for col_idx, key in ((0, "ll"), (1, "lll")):
        got = r.read_list_column(col_idx)
        assert got.to_pylist() == t.column(key).to_pylist(), key


def test_scan_nested_string_leaf(tmp_path):
    """Regex scans (numpy engine + native cold path) over a list<binary>
    leaf count matching non-null leaf values — oracle: iterator + re."""
    import re

    from duckdb_parquet_parser.models.scan import ScanEngine

    rng = np.random.default_rng(13)
    lists = [None if rng.random() < 0.1 else
             [f"w{int(rng.integers(40))}".encode()
              for _ in range(int(rng.integers(0, 4)))]
             for _ in range(1200)]
    t = pa.table({"tags": pa.array(lists, type=pa.list_(pa.binary()))})
    path = tmp_path / "tags.parquet"
    pq.write_table(t, path, compression="snappy", data_page_size=600)
    eng = ScanEngine(str(path))
    r = ParquetReader(str(path))
    for pat in ["w1", "w[12]$"]:
        rx = re.compile(pat.encode())
        it = r.column_iterator("element")
        want = 0
        while it.has_next():
            _p, _l, s = it.next()
            want += bool(rx.search(s))
        got_np = int(eng.scan("element", pat, engine="numpy").match_counts.sum())
        got_cold = int(eng.cold_scan("element", pat,
                                     exact_counts=True).match_counts.sum())
        assert got_np == want == got_cold, (pat, got_np, got_cold, want)


def test_list_strings_iterator(tmp_path):
    rng = np.random.default_rng(12)
    words = [b"alpha", b"bravo", b"charlie", b""]
    lists = []
    for _ in range(500):
        x = rng.random()
        if x < 0.15:
            lists.append(None)
        else:
            lists.append([words[int(rng.integers(len(words)))]
                          for _ in range(int(rng.integers(0, 4)))])
    t = pa.table({"l": pa.array(lists, type=pa.list_(pa.binary()))})
    path = tmp_path / "s.parquet"
    pq.write_table(t, path, compression="NONE", data_page_version="1.0",
                   data_page_size=400)
    r = ParquetReader(str(path))
    col = r.read_column("element")
    want_valid, want_values = _flat_leaf_oracle(lists, max_def=3)
    np.testing.assert_array_equal(np.asarray(col.valid), want_valid)
    got = [bytes(col.values[i]) for i, ok in enumerate(want_valid) if ok]
    assert got == [w for w in want_values if w is not None]

    # the streaming iterator emits the same flat non-null stream
    it = r.column_iterator("element")
    emitted = []
    while it.has_next():
        _pos, _ln, s = it.next()
        emitted.append(s)
    assert emitted == got


def test_key_value_named_struct_is_not_a_map(tmp_path):
    """ADVICE round 2 #1: a struct (or list<struct>) whose leaves happen to
    be named key/value must read back as dicts, not map tuples — MAP
    detection keys on the converted-type annotation, not leaf names."""
    t = pa.table({
        "s": pa.array(
            [{"key": 1, "value": b"a"}, None, {"key": 2, "value": None}],
            type=pa.struct([("key", pa.int64()), ("value", pa.binary())])),
        "ls": pa.array(
            [[{"key": 1, "value": b"x"}], [], None],
            type=pa.list_(pa.struct([("key", pa.int64()),
                                     ("value", pa.binary())]))),
        "m": pa.array([[(b"k", 7)], None, []],
                      type=pa.map_(pa.binary(), pa.int64())),
    })
    path = tmp_path / "kv.parquet"
    pq.write_table(t, path, compression="NONE")
    tab = ParquetReader(str(path)).read_table()
    for f in t.column_names:
        assert tab[f].to_pylist() == t.column(f).to_pylist(), f
