"""Differential fuzz vs pyarrow: random schemas x codecs x page versions x
dictionary modes x page/row-group sizes, read back column-by-column.

The per-feature oracle tests (test_codecs / test_datapage_v2 /
test_v2_encodings / test_stats) each pin one axis; this sweep exercises the
CROSS PRODUCT with randomized data — the integration surface where layout
interactions (dict pages under V2 under zstd with 300-byte pages...) would
hide.  pyarrow is both the writer and the value oracle.
"""

from __future__ import annotations

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from duckdb_parquet_parser.host.bindings import lib  # noqa: E402
from duckdb_parquet_parser.host.reader import ParquetReader  # noqa: E402

# codecs our build supports (runtime-gated: brotli/lz4 .so may be absent)
_CODEC_IDS = {"NONE": 0, "SNAPPY": 1, "GZIP": 2, "LZ4": 5, "ZSTD": 6}
CODECS = [name for name, cid in _CODEC_IDS.items()
          if cid == 0 or lib().dpq_codec_supported(cid)]


def _rand_column(rng, kind: str, n: int, null_p: float):
    mask = rng.random(n) < null_p

    def nullable(vals):
        return [None if m else v for v, m in zip(vals, mask)]

    if kind == "int32":
        return pa.array(nullable(rng.integers(-(1 << 31), 1 << 31, n).tolist()),
                        type=pa.int32())
    if kind == "int64":
        return pa.array(nullable(rng.integers(-(1 << 62), 1 << 62, n).tolist()),
                        type=pa.int64())
    if kind == "float32":
        return pa.array(nullable(rng.standard_normal(n).astype(np.float32).tolist()),
                        type=pa.float32())
    if kind == "float64":
        return pa.array(nullable((rng.standard_normal(n) * 1e6).tolist()),
                        type=pa.float64())
    if kind == "bool":
        return pa.array(nullable((rng.random(n) < 0.5).tolist()), type=pa.bool_())
    # binary: mixed cardinality drives dict vs plain; empties included
    uniq = int(rng.integers(2, 40)) if rng.random() < 0.5 else None
    pool = None
    if uniq:
        pool = [bytes(rng.integers(32, 127, rng.integers(0, 30)).astype(np.uint8))
                for _ in range(uniq)]
    vals = []
    for _ in range(n):
        if pool is not None:
            vals.append(pool[int(rng.integers(uniq))])
        else:
            vals.append(bytes(rng.integers(32, 127, rng.integers(0, 40))
                              .astype(np.uint8)))
    return pa.array(nullable(vals), type=pa.binary())


KINDS = ["int32", "int64", "float32", "float64", "bool", "binary"]
NESTED_KINDS = ["list", "struct", "map"]


def _rand_nested(rng, kind: str, n: int):
    def prim(i):
        return None if rng.random() < 0.2 else int(rng.integers(1000))

    rows = []
    for i in range(n):
        x = rng.random()
        if x < 0.12:
            rows.append(None)
        elif kind == "list":
            rows.append([prim(i) for _ in range(int(rng.integers(0, 5)))])
        elif kind == "struct":
            rows.append({"a": prim(i),
                         "b": None if rng.random() < 0.2 else f"s{i}".encode()})
        else:
            rows.append([(f"k{j}".encode(), prim(i))
                         for j in range(int(rng.integers(0, 4)))])
    typ = {
        "list": pa.list_(pa.int64()),
        "struct": pa.struct([("a", pa.int64()), ("b", pa.binary())]),
        "map": pa.map_(pa.binary(), pa.int64()),
    }[kind]
    return pa.array(rows, type=typ)


def _check_column(col, want_list, kind):
    got_valid = np.asarray(col.valid)
    want_valid = np.array([v is not None for v in want_list])
    np.testing.assert_array_equal(got_valid, want_valid)
    for i, w in enumerate(want_list):
        if w is None:
            continue
        g = col.values[i]
        if kind == "binary":
            assert bytes(g) == w, (kind, i)
        elif kind in ("float32", "float64"):
            assert g == np.float32(w) if kind == "float32" else g == w, (kind, i)
        elif kind == "bool":
            assert bool(g) == w, (kind, i)
        else:
            assert int(g) == w, (kind, i)


@pytest.mark.parametrize("seed", range(24))
def test_pyarrow_cross_product(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(50, 1200))
    kinds = list(rng.choice(KINDS, size=int(rng.integers(2, 5)), replace=True))
    names = [f"c{i}_{k}" for i, k in enumerate(kinds)]
    null_ps = [float(rng.choice([0.0, 0.1, 0.5])) for _ in kinds]
    arrays = {nm: _rand_column(rng, k, n, p)
              for nm, k, p in zip(names, kinds, null_ps)}
    nested_kind = NESTED_KINDS[seed % len(NESTED_KINDS)]
    arrays["nested"] = _rand_nested(rng, nested_kind, n)
    table = pa.table(arrays)

    codec = CODECS[int(rng.integers(len(CODECS)))]
    version = ["1.0", "2.0"][int(rng.integers(2))]
    use_dict = bool(rng.integers(2))
    path = tmp_path / f"fuzz_{seed}.parquet"
    pq.write_table(
        table, path,
        compression=codec if codec != "NONE" else "NONE",
        use_dictionary=use_dict,
        data_page_version=version,
        data_page_size=int(rng.integers(256, 4096)),
        row_group_size=max(int(rng.integers(20, n + 1)), 20),
        write_statistics=bool(rng.integers(2)),
    )

    r = ParquetReader(str(path))
    for nm, k in zip(names, kinds):
        got = r.read_column(nm)
        want = table.column(nm).to_pylist()
        _check_column(got, want, k)

    # device DELTA route over the same table's integer columns (when the
    # random layout axes allow: delta pages written by pyarrow, any codec)
    int_cols = [nm for nm, k in zip(names, kinds) if k in ("int32", "int64")]
    if int_cols and seed % 2 == 0:
        from duckdb_parquet_parser.host.bindings import NativeError
        from duckdb_parquet_parser.ops.delta import read_delta_column

        dpath = tmp_path / f"fuzz_{seed}_delta.parquet"
        pq.write_table(
            table.select(int_cols), dpath,
            compression=codec if codec != "NONE" else "NONE",
            use_dictionary=False,
            column_encoding={nm: "DELTA_BINARY_PACKED" for nm in int_cols},
            data_page_version="2.0",
            data_page_size=int(rng.integers(256, 4096)),
            row_group_size=max(int(rng.integers(20, n + 1)), 20),
        )
        rd = ParquetReader(str(dpath))
        for nm in int_cols:
            try:
                got_d = read_delta_column(rd, nm, engine="numpy")
            except NativeError:
                continue  # mixed-geometry layout: host route covers it
            want_d = table.column(nm).to_pylist()
            got_l = [int(v) if ok else None
                     for v, ok in zip(np.asarray(got_d.values),
                                      np.asarray(got_d.valid))]
            assert got_l == want_d, nm

    # nested reconstruction parity on the same randomized layout axes
    want_nested = table.column("nested").to_pylist()
    if nested_kind == "list":
        got_n = r.read_list_column("nested").to_pylist()
    elif nested_kind == "struct":
        got_n = r.read_struct_column("nested").to_pylist()
    else:
        got_n = r.read_map_column("nested").to_pylist()
    assert got_n == want_nested, nested_kind

    # scan + row-level matches over the first binary column (count oracle =
    # Python re over the pyarrow values; exercises the matcher on
    # pyarrow-written page layouts: V2 levels, dict pages, tiny pages)
    import re

    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops.scan import match_rows

    bin_cols = [nm for nm, k in zip(names, kinds) if k == "binary"]
    if bin_cols:
        nm = bin_cols[0]
        vals = table.column(nm).to_pylist()
        pattern = ["[0-9]", "a.*z", "^[!-9]", ".{5,20}$"][seed % 4]
        rx = re.compile(pattern.encode())
        want_hits = sum(1 for v in vals if v is not None and rx.search(v))
        eng = ScanEngine(str(path))
        res = eng.scan(nm, pattern, engine="numpy")
        assert int(res.match_counts.sum()) == want_hits, (pattern, nm)
        cold = eng.cold_scan(nm, pattern, exact_counts=True)
        assert int(cold.match_counts.sum()) == want_hits, (pattern, nm)
        rows = match_rows(r.prescan(nm, pad_strings=8), pattern)
        assert len(rows) == want_hits and all(
            vals[i] is not None and rx.search(vals[i]) for i in rows
        ), (pattern, nm)


# ── random nested schema TREES (generic Dremel assembly fuzz) ────────────────

_PRIMS = [pa.int64(), pa.int32(), pa.float64(), pa.binary(), pa.bool_()]


def _rand_type(rng, depth: int):
    """A random nested pyarrow type, nesting depth ≤ 4."""
    if depth >= 4 or rng.random() < 0.35:
        return _PRIMS[int(rng.integers(len(_PRIMS)))]
    x = rng.random()
    if x < 0.40:
        return pa.list_(_rand_type(rng, depth + 1))
    if x < 0.78:
        nf = int(rng.integers(1, 4))
        return pa.struct([(f"f{i}", _rand_type(rng, depth + 1))
                          for i in range(nf)])
    return pa.map_(pa.binary(), _rand_type(rng, depth + 1))


def _rand_value(rng, typ, nullable: bool = True):
    if nullable and rng.random() < 0.18:
        return None
    if pa.types.is_list(typ):
        return [_rand_value(rng, typ.value_type)
                for _ in range(int(rng.integers(0, 4)))]
    if pa.types.is_struct(typ):
        return {f.name: _rand_value(rng, f.type) for f in typ}
    if pa.types.is_map(typ):
        return [(f"k{j}".encode(), _rand_value(rng, typ.item_type))
                for j in range(int(rng.integers(0, 3)))]
    if pa.types.is_boolean(typ):
        return bool(rng.integers(2))
    if pa.types.is_integer(typ):
        return int(rng.integers(-1000, 1000))
    if pa.types.is_floating(typ):
        return float(rng.standard_normal())
    return bytes(rng.integers(32, 127, rng.integers(0, 12)).astype(np.uint8))


@pytest.mark.parametrize("seed", range(20))
def test_random_nested_trees(tmp_path, seed):
    """read_table == pyarrow to_pylist on RANDOM schema trees (depth ≤4):
    list<struct>, structs in lists, maps with nested values, and every
    other composition the type generator reaches — the generic Dremel
    assembler (host/assembly.py) must be total over them."""
    rng = np.random.default_rng(7000 + seed)
    n = int(rng.integers(80, 400))
    fields = {}
    for c in range(int(rng.integers(1, 4))):
        typ = _rand_type(rng, 1)
        fields[f"n{c}"] = pa.array(
            [_rand_value(rng, typ) for _ in range(n)], type=typ)
    table = pa.table(fields)

    codec = CODECS[int(rng.integers(len(CODECS)))]
    path = tmp_path / f"tree_{seed}.parquet"
    pq.write_table(
        table, path,
        compression=codec if codec != "NONE" else "NONE",
        use_dictionary=bool(rng.integers(2)),
        data_page_version=["1.0", "2.0"][int(rng.integers(2))],
        data_page_size=int(rng.integers(256, 4096)),
        row_group_size=max(int(rng.integers(20, n + 1)), 20),
    )

    tab = ParquetReader(str(path)).read_table()
    for f in table.column_names:
        assert tab[f].to_pylist() == table.column(f).to_pylist(), (seed, f)


# ── BIG-PAGE lane: pyarrow-DEFAULT page sizes, end to end ────────────────────
# Everything above uses tiny pages (256-4096 B) to maximize page-boundary
# coverage; real pyarrow files default to ~1 MB pages, which exercise the
# value-boundary SPLIT layout on device scans (ops/scan.split_payload_pages)
# and the big-value shapes of every host path.  This lane runs the cross
# product (codec x page version x dict) on default-page files and checks
# read_column, the scan paths (incl. the split-rerouted batched scan),
# read_rows spans, and the index build, against pyarrow / re / host goldens.


@pytest.mark.parametrize("seed", range(6))
def test_pyarrow_bigpage_end_to_end(tmp_path, seed):
    import re

    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops.index import build_index_for_column
    from duckdb_parquet_parser.ops.scan import SPLIT_TRIGGER

    rng = np.random.default_rng(9100 + seed)
    n = 40_000
    words = [b"alpha", b"bravo", b"charlie", b"delta", b"needle", b"quartz"]
    vals = []
    for i in range(n):
        if rng.random() < 0.03:
            vals.append(None)
        else:
            k = int(rng.integers(2, 6))
            vals.append(b" ".join(words[int(rng.integers(len(words)))]
                                  for _ in range(k)))
    table = pa.table({
        "s": pa.array(vals, type=pa.binary()),
        "v": pa.array(rng.integers(0, 1 << 40, n).tolist(), type=pa.int64()),
    })
    codec = CODECS[seed % len(CODECS)]
    version = ["1.0", "2.0"][seed % 2]
    use_dict = seed % 3 == 0  # low-cardinality strings dict-encode well
    path = tmp_path / f"big_{seed}.parquet"
    pq.write_table(
        table, path,
        compression=codec if codec != "NONE" else "NONE",
        use_dictionary=use_dict,
        data_page_version=version,
        row_group_size=n,  # default ~1 MB pages, one big row group
    )

    r = ParquetReader(str(path))
    # the lane only means something if pages really are big
    if not use_dict:
        plens = r.prescan("s", pad_strings=0).arrays["page_payload_len"]
        assert int(np.max(plens)) > SPLIT_TRIGGER, "fixture pages too small"

    got = r.read_column("s")
    want = table.column("s").to_pylist()
    _check_column(got, want, "binary")

    rx = re.compile(b"needle.*quartz")
    want_hits = sum(1 for v in want if v is not None and rx.search(v))
    eng = ScanEngine(str(path))
    res_np = eng.scan("s", "needle.*quartz", engine="numpy")
    assert int(res_np.match_counts.sum()) == want_hits
    cold = eng.cold_scan("s", "needle.*quartz", exact_counts=True)
    np.testing.assert_array_equal(cold.match_counts, res_np.match_counts)
    np.testing.assert_array_equal(cold.value_counts, res_np.value_counts)
    # batched device scan reroutes big-page files through the split layout
    batched = eng.scan_batched("s", "needle.*quartz")
    np.testing.assert_array_equal(
        np.sort(batched.surviving_pages()), np.sort(res_np.surviving_pages())
    )

    # read_rows: page-granular row spans inside a big page
    lo, hi = 17_500, 17_650
    span = r.read_rows("s", lo, hi)
    want_span = want[lo:hi]
    assert len(span.values) == hi - lo
    for i, w in enumerate(want_span):
        g = span.values[i]
        assert (g is None) == (w is None) and (w is None or bytes(g) == w)

    # index build (host emission path) matches the numpy golden model
    idx_native = build_index_for_column(r, "s", chunk_size=2048,
                                        engine="native")
    idx_numpy = build_index_for_column(r, "s", chunk_size=2048,
                                       engine="numpy")
    np.testing.assert_array_equal(idx_native.chunk_starts,
                                  idx_numpy.chunk_starts)
    np.testing.assert_array_equal(idx_native.positions, idx_numpy.positions)


def test_bigpage_distributed_index_build(tmp_path):
    """Device-emission index build on a pyarrow-default big-page file (the
    [N, vmax] decode planes get ~page-sized trailing dims): received entry
    sets must match the host-native build."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from duckdb_parquet_parser.ops.index import build_index_for_column
    from duckdb_parquet_parser.parallel.index_build import (
        distributed_index_build,
    )
    from duckdb_parquet_parser.parallel.mesh import make_mesh

    rng = np.random.default_rng(9200)
    n = 12_000
    vals = [None if rng.random() < 0.05 else
            bytes(rng.integers(97, 123, 24).astype(np.uint8))
            for _ in range(n)]
    path = tmp_path / "bigidx.parquet"
    pq.write_table(
        pa.table({"s": pa.array(vals, type=pa.binary())}), path,
        compression="NONE", use_dictionary=False, row_group_size=n,
    )
    reader = ParquetReader(str(path))
    golden = build_index_for_column(reader, "s", chunk_size=1024)
    res = distributed_index_build(make_mesh(8), reader, "s", chunk_size=1024)
    got = np.concatenate([r for r in res.received if len(r)])
    np.testing.assert_array_equal(np.sort(got[:, 0]),
                                  np.sort(golden.positions))
    np.testing.assert_array_equal(res.index.chunk_starts,
                                  golden.chunk_starts)
