"""Host library surface: writer/reader roundtrip, error paths, page API."""

import struct

import numpy as np
import pytest

from duckdb_parquet_parser.host import bindings
from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
from tests import fixtures


def test_open_rejects_bad_files(tmp_path):
    p1 = tmp_path / "bad_magic"
    p1.write_bytes(b"XXXX" + b"\0" * 64 + b"PAR1")
    p2 = tmp_path / "tiny"
    p2.write_bytes(b"PAR1")
    r = ParquetReader()
    assert r.open(str(p1)) is False
    assert r.open(str(p2)) is False
    assert r.open(str(tmp_path / "missing")) is False


def test_open_rejects_bogus_footer_len(tmp_path, rng):
    path = fixtures.strings_file(tmp_path / "ok.parquet", rng, n=50)
    data = open(path, "rb").read()
    bad = data[:-8] + struct.pack("<I", 2**30) + b"PAR1"
    p = tmp_path / "badfoot"
    p.write_bytes(bad)
    assert ParquetReader().open(str(p)) is False


def test_schema_surface(tmp_path, rng):
    path = fixtures.mixed_file(tmp_path / "m.parquet", rng)
    r = ParquetReader(path)
    assert r.num_columns() == 9
    assert r.num_row_groups() == 2
    assert r.num_rows() == 1200
    assert r.column_names()[0] == "i64"
    assert r.column("city").type == ParquetType.BYTE_ARRAY
    assert r.column("city").is_optional()
    assert r.column(0).is_required()
    assert r.find_column("nope") == -1
    with pytest.raises(KeyError):
        r.column("nope")
    with pytest.raises(IndexError):
        r.column(99)


def test_page_api(tmp_path, rng):
    path = fixtures.mixed_file(tmp_path / "m.parquet", rng)
    r = ParquetReader(path)
    n = r.num_pages()
    assert n > 0
    e0 = r.page_index_entry(0)
    assert e0.data_size > 0
    raw = r.read_page_data(0)
    assert len(raw) == e0.data_size

    # read_pages_chunk truncates at the byte budget (inclusive page range)
    chunk = r.read_pages_chunk(0, min(3, n - 1), 100)
    assert len(chunk) == 100
    full = r.read_pages_chunk(0, 0, 10**9)
    assert full == raw

    with pytest.raises(IndexError):
        r.page_index_entry(n)
    with pytest.raises(IndexError):
        r.read_pages_chunk(1, 0, 10)

    it = r.page_iterator(0, 3)
    seen = [p.page_id for p in it]
    assert seen == [0, 1, 2]
    assert not it.has_next()
    it.reset()
    assert it.has_next() and it.next().page_id == 0


def test_iterator_skips_nulls(tmp_path, rng):
    path = fixtures.strings_file(tmp_path / "s.parquet", rng, n=400, null_p=0.5)
    r = ParquetReader(path)
    col = r.read_column("s")
    n_valid = int(col.valid.sum())
    emitted = list(r.column_iterator("s"))
    assert len(emitted) == n_valid
    # positions are global row indices of the non-null rows
    rows = np.nonzero(col.valid)[0]
    assert [p for p, _, _ in emitted] == rows.tolist()
    for (pos, ln, s) in emitted:
        assert col.values[pos] == s and len(s) == ln


def test_column_iterator_type_check(tmp_path, rng):
    path = fixtures.mixed_file(tmp_path / "m.parquet", rng)
    r = ParquetReader(path)
    with pytest.raises(TypeError):
        r.column_iterator("i64")


def test_writer_rejects_ragged_and_unknown(tmp_path):
    w = ParquetWriter(
        str(tmp_path / "x.parquet"),
        [ColumnSpec("a", ParquetType.INT64), ColumnSpec("b", ParquetType.INT64)],
    )
    with pytest.raises(ValueError):
        w.write_row_group({"a": np.arange(5)})
    with pytest.raises(bindings.NativeError):
        w.write_row_group({"a": np.arange(5), "b": np.arange(6)})


def test_empty_strings_roundtrip(tmp_path):
    path = str(tmp_path / "empty.parquet")
    vals = [b"", b"x", None, b"", b"yy"] * 50
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)])
    w.write_row_group({"s": vals})
    w.close()
    r = ParquetReader(path)
    col = r.read_column("s")
    assert col.to_pylist() == vals


def test_multi_rg_row_positions(tmp_path, rng):
    path = fixtures.strings_file(tmp_path / "s.parquet", rng, n=600, null_p=0.2, rgs=3)
    r = ParquetReader(path)
    emitted = list(r.column_iterator("s"))
    # positions must be strictly increasing and within [0, num_rows)
    pos = [p for p, _, _ in emitted]
    assert all(b > a for a, b in zip(pos, pos[1:]))
    assert 0 <= pos[0] and pos[-1] < r.num_rows()


def test_writer_rejects_nulls_on_required_column(tmp_path):
    """Nulls fed to a REQUIRED column must raise, not write a file whose
    page value counts disagree with the payload (found via a round-4
    verify drive: the silent file made every reader — ours, the oracle,
    pyarrow — fail mid-page)."""
    import numpy as np
    import pytest

    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = str(tmp_path / "req.parquet")
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY),
                             ColumnSpec("i", ParquetType.INT64)])
    with pytest.raises(ValueError, match="REQUIRED"):
        w.write_row_group({"s": ["a", None, "c"], "i": np.arange(3)})
    w2 = ParquetWriter(str(tmp_path / "req2.parquet"),
                       [ColumnSpec("i", ParquetType.INT64)])
    with pytest.raises(ValueError, match="REQUIRED"):
        w2.write_row_group({
            "i": (np.arange(4), np.array([1, 0, 1, 1], np.uint8))})
    # all-valid explicit masks on REQUIRED columns stay allowed
    w3 = ParquetWriter(str(tmp_path / "req3.parquet"),
                       [ColumnSpec("i", ParquetType.INT64)])
    w3.write_row_group({"i": (np.arange(4), np.ones(4, np.uint8))})
    w3.close()
