"""Bit-exact parity of the engine against the reference binary (oracle).

The oracle is the reference parser compiled unmodified from /root/reference
(see tests/oracle/).  Every decoded value, iterator emission, page-index
entry, and schema line must match exactly (BASELINE.json: "Outputs must match
the reference's decoded values and surviving-page sets exactly").
"""

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from tests import fixtures


@pytest.fixture(scope="module")
def mixed_path(tmp_path_factory):
    rng = np.random.default_rng(42)
    return fixtures.mixed_file(tmp_path_factory.mktemp("parity") / "mixed.parquet", rng)


def test_schema_string_parity(mixed_path, oracle):
    r = ParquetReader(mixed_path)
    assert r.schema_string() == oracle(mixed_path, "schema")


@pytest.mark.parametrize(
    "col", ["i64", "i64_opt", "i32", "f32", "f64", "flag", "city", "comment", "code"]
)
def test_read_column_parity(mixed_path, oracle, col):
    r = ParquetReader(mixed_path)
    mine = r.read_column(col).to_strings()
    ref = oracle(mixed_path, "column", col).splitlines()
    assert len(mine) == len(ref)
    assert mine == ref


def test_read_column_single_rg_parity(mixed_path, oracle):
    r = ParquetReader(mixed_path)
    for rg in range(r.num_row_groups()):
        mine = r.read_column("city", rg).to_strings()
        ref = oracle(mixed_path, "column-rg", "city", str(rg)).splitlines()
        assert mine == ref


@pytest.mark.parametrize("col", ["city", "comment"])
def test_string_iterator_parity(mixed_path, oracle, col):
    # (pos, len) from the oracle — the reference's next() hands out a pointer
    # its own auto-refill invalidates (use-after-free on the last string of a
    # page), so contents are cross-checked against read_column (itself
    # oracle-verified) rather than the dangling reference pointer.
    r = ParquetReader(mixed_path)
    emitted = list(r.column_iterator(col))
    mine = [f"{pos} {ln}" for pos, ln, _ in emitted]
    ref = oracle(mixed_path, "iter", col).splitlines()
    assert mine == ref
    col_vals = r.read_column(col)
    for pos, ln, s in emitted:
        assert col_vals.valid[pos] and col_vals.values[pos] == s and len(s) == ln


def test_page_index_parity(mixed_path, oracle):
    r = ParquetReader(mixed_path)
    ref = [tuple(map(int, ln.split())) for ln in oracle(mixed_path, "pages").splitlines()]
    mine = [
        (i, e.data_offset, e.data_size, e.row_group_idx, e.column_idx)
        for i in range(r.num_pages())
        for e in [r.page_index_entry(i)]
    ]
    assert mine == ref


def test_plain_high_cardinality_strings(tmp_path, oracle):
    rng = np.random.default_rng(7)
    path = fixtures.strings_file(tmp_path / "plain.parquet", rng, n=2000, null_p=0.3)
    r = ParquetReader(path)
    assert r.read_column("s").to_strings() == oracle(path, "column", "s").splitlines()
    mine = [f"{p} {ln}" for p, ln, _ in r.column_iterator("s")]
    assert mine == oracle(path, "iter", "s").splitlines()


def test_dict_strings_many_rgs(tmp_path, oracle):
    rng = np.random.default_rng(8)
    path = fixtures.strings_file(
        tmp_path / "dict.parquet", rng, n=800, n_unique=12, null_p=0.2, rgs=4
    )
    r = ParquetReader(path)
    assert r.read_column("s").to_strings() == oracle(path, "column", "s").splitlines()


def test_all_null_column(tmp_path, oracle):
    # NOTE: the filler column keeps the file big enough for the reference to
    # read.  The reference's read_range never clears the ifstream failbit
    # after its 256-byte header probe crosses EOF (src/reader/
    # parquet_reader.cpp:173-178), so on tiny files (last page + footer < 256
    # bytes) all its subsequent reads return zeros and read_column dies on
    # bad_optional_access.  This engine uses stateless pread and reads such
    # files fine (see test_tiny_file_robustness).
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = str(tmp_path / "allnull.parquet")
    w = ParquetWriter(
        path,
        [
            ColumnSpec("x", ParquetType.DOUBLE, optional=True),
            ColumnSpec("filler", ParquetType.INT64),
        ],
    )
    w.write_row_group(
        {"x": (np.zeros(300), np.zeros(300, np.uint8)), "filler": np.arange(300)}
    )
    w.close()
    r = ParquetReader(path)
    vals = r.read_column("x")
    assert len(vals) == 300 and not vals.valid.any()
    assert vals.to_strings() == oracle(path, "column", "x").splitlines()


def test_tiny_file_robustness(tmp_path):
    # Tiny all-null single-column file: the reference crashes on this
    # (failbit poisoning, see note above); the engine must decode it.
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = str(tmp_path / "tiny.parquet")
    w = ParquetWriter(path, [ColumnSpec("x", ParquetType.DOUBLE, optional=True)])
    w.write_row_group({"x": (np.zeros(300), np.zeros(300, np.uint8))})
    w.close()
    r = ParquetReader(path)
    vals = r.read_column("x")
    assert len(vals) == 300 and not vals.valid.any()


def test_no_nulls_required(tmp_path, oracle):
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = str(tmp_path / "req.parquet")
    w = ParquetWriter(path, [ColumnSpec("x", ParquetType.INT32)])
    w.write_row_group({"x": np.arange(5000, dtype=np.int32)})
    w.close()
    r = ParquetReader(path)
    vals = r.read_column("x")
    assert vals.valid.all()
    assert np.array_equal(np.asarray(vals.values), np.arange(5000, dtype=np.int32))
    assert vals.to_strings() == oracle(path, "column", "x").splitlines()


@pytest.mark.parametrize("seed", [11, 22, 33, 44, 55, 66, 77, 88, 99, 110])
def test_fuzz_roundtrip_parity(tmp_path, oracle, seed):
    """Randomized schema/data sweeps: every column of every generated file
    must decode identically in the engine and the reference binary."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    rng = np.random.default_rng(seed)
    types = [
        ParquetType.INT32, ParquetType.INT64, ParquetType.FLOAT,
        ParquetType.DOUBLE, ParquetType.BOOLEAN, ParquetType.BYTE_ARRAY,
    ]
    n_cols = int(rng.integers(1, 5))
    specs = []
    for i in range(n_cols):
        specs.append(
            ColumnSpec(
                f"c{i}",
                types[int(rng.integers(len(types)))],
                optional=bool(rng.random() < 0.6),
            )
        )
    path = str(tmp_path / f"fuzz{seed}.parquet")
    w = ParquetWriter(path, specs, key_value={"pad": "x" * 512})
    n_rgs = int(rng.integers(1, 4))
    for _ in range(n_rgs):
        n = int(rng.integers(1, 900))
        cols = {}
        for spec in specs:
            valid = (rng.random(n) > rng.choice([0.0, 0.1, 0.5, 0.95])).astype(np.uint8)
            if spec.type == ParquetType.BYTE_ARRAY:
                uniq = int(rng.choice([0, 5, 50]))
                vals = fixtures.random_strings(
                    rng, n, n_unique=uniq or None, min_len=0, max_len=40
                )
                if spec.optional:
                    vals = [None if not v_ok else v for v, v_ok in zip(vals, valid)]
                cols[spec.name] = vals
                continue
            if spec.type == ParquetType.BOOLEAN:
                data = (rng.random(n) > 0.5).astype(np.uint8)
            elif spec.type in (ParquetType.INT32, ParquetType.INT64):
                lo_card = rng.random() < 0.5  # exercise dict-encoded ints
                data = rng.integers(0, 7 if lo_card else 2**31 - 1, n)
            else:
                data = rng.random(n) * rng.choice([1, 1e6])
            cols[spec.name] = (data, valid) if spec.optional else data
        w.write_row_group(cols)
    w.close()

    r = ParquetReader(path)
    for spec in specs:
        mine = r.read_column(spec.name).to_strings()
        ref = oracle(path, "column", spec.name).splitlines()
        assert mine == ref, f"seed={seed} col={spec.name}"


def test_int96_parity(tmp_path, oracle, rng):
    """INT96 (spark-style timestamps): 12-byte values decode and format
    identically to the reference (reference: src/reader/column_reader.cpp:257-263)."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = str(tmp_path / "i96.parquet")
    n = 400
    raw = rng.integers(0, 256, (n, 12)).astype(np.uint8)
    valid = (rng.random(n) > 0.2).astype(np.uint8)
    w = ParquetWriter(
        path,
        [
            ColumnSpec("ts", ParquetType.INT96, optional=True),
            ColumnSpec("filler", ParquetType.INT64),
        ],
        key_value={"pad": "x" * 512},
    )
    w.write_row_group({"ts": (raw, valid), "filler": np.arange(n)})
    w.close()
    r = ParquetReader(path)
    col = r.read_column("ts")
    assert col.to_strings() == oracle(path, "column", "ts").splitlines()

    # low-cardinality INT96 -> dictionary-encoded path
    path2 = str(tmp_path / "i96d.parquet")
    pool = rng.integers(0, 256, (4, 12)).astype(np.uint8)
    data = pool[rng.integers(0, 4, n)]
    w = ParquetWriter(
        path2,
        [
            ColumnSpec("ts", ParquetType.INT96),
            ColumnSpec("filler", ParquetType.INT64),
        ],
        key_value={"pad": "x" * 512},
    )
    w.write_row_group({"ts": data, "filler": np.arange(n)})
    w.close()
    r2 = ParquetReader(path2)
    assert r2.read_column("ts").to_strings() == oracle(path2, "column", "ts").splitlines()


def test_cli_column_matches_oracle(mixed_path, oracle, capsys):
    """`python -m ...cli column <file> <col>` prints exactly the reference
    dump binary's `column` mode output (Value::to_string lines)."""
    from duckdb_parquet_parser.cli import main

    r = ParquetReader(mixed_path)
    for col in [c["name"] for c in r._meta["columns"]]:
        rc = main(["column", mixed_path, col])
        assert rc == 0
        got = capsys.readouterr().out.splitlines()
        want = oracle(mixed_path, "column", col).splitlines()
        assert got == want, col
