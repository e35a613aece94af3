"""Auxiliary subsystems: read_pages parity, checkpoints, elastic recovery,
config, metrics."""

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.host.schema import PageType
from duckdb_parquet_parser.ops.index import build_index_for_column
from duckdb_parquet_parser.parallel.elastic import FleetState
from duckdb_parquet_parser.utils import checkpoints, metrics
from duckdb_parquet_parser.utils.config import EngineConfig
from tests import fixtures


@pytest.fixture(scope="module")
def mixed_path(tmp_path_factory):
    rng = np.random.default_rng(123)
    return fixtures.mixed_file(tmp_path_factory.mktemp("aux") / "m.parquet", rng)


@pytest.mark.parametrize("col", ["i64", "city", "f64", "comment"])
def test_read_pages_parity(mixed_path, oracle, col):
    r = ParquetReader(mixed_path)
    for rg in range(r.num_row_groups()):
        pages = r.read_pages(col, rg)
        ref_lines = oracle(mixed_path, "read-pages", col, str(rg)).splitlines()
        mine_lines = []
        for p in pages:
            mine_lines.append(f"page {p.page_num} type {int(p.type)} n {p.num_values}")
            if p.values is not None:
                mine_lines.extend(p.values.to_strings())
        assert mine_lines == ref_lines


def test_read_pages_structure(mixed_path):
    r = ParquetReader(mixed_path)
    pages = r.read_pages("city", 0)
    assert pages[0].type == PageType.DICTIONARY_PAGE
    assert pages[0].values is None
    assert all(p.type == PageType.DATA_PAGE for p in pages[1:])
    total = sum(p.num_values for p in pages[1:])
    assert total == r.metadata()["row_groups"][0]["num_rows"]


def test_index_checkpoint_roundtrip(tmp_path, rng):
    path = fixtures.strings_file(tmp_path / "s.parquet", rng, n=500)
    r = ParquetReader(path)
    idx = build_index_for_column(r, "s", 1024)
    ck = checkpoints.save_index(str(tmp_path / "ck"), path, "s", idx)
    assert ck.exists()
    loaded = checkpoints.load_index(str(tmp_path / "ck"), path, "s", 1024)
    assert loaded is not None
    assert loaded.num_chunks == idx.num_chunks
    assert np.array_equal(loaded.tuple_to_chunk, idx.tuple_to_chunk)
    assert checkpoints.load_index(str(tmp_path / "ck"), path, "s", 2048) is None


def test_elastic_reassignment(rng):
    weights = rng.integers(100, 2000, 64)
    fleet = FleetState(weights=weights, n_devices=8)
    before = fleet.loads()
    assert before.sum() == weights.sum()

    orphans = fleet.mark_failed(3)
    assert len(orphans) > 0
    after = fleet.loads()
    assert after[3] == 0
    assert after.sum() == weights.sum()  # nothing lost
    # still reasonably balanced across the 7 survivors
    live = after[after > 0]
    assert live.max() / live.mean() < 1.5

    # double-failure is a no-op; cascade failure keeps total
    assert len(fleet.mark_failed(3)) == 0
    fleet.mark_failed(0)
    assert fleet.loads().sum() == weights.sum()
    with pytest.raises(RuntimeError):
        for d in range(8):
            fleet.mark_failed(d)


def test_config_env_overrides(monkeypatch):
    monkeypatch.setenv("DPQ_INDEX_CHUNK_SIZE", "8192")
    monkeypatch.setenv("DPQ_SCAN_ENGINE", "numpy")
    monkeypatch.setenv("DPQ_EMIT_METRICS", "false")
    cfg = EngineConfig.from_env()
    assert cfg.index_chunk_size == 8192
    assert cfg.scan_engine == "numpy"
    assert cfg.emit_metrics is False


def test_metrics_stages(capsys):
    m = metrics.Metrics()
    with m.timed("decode", pages=10) as box:
        box["rows"] = 1000
    rec = m.records[-1]
    assert rec["stage"] == "decode" and rec["rows"] == 1000 and rec["seconds"] >= 0
    assert metrics.skew_factor([10, 10, 10, 10]) == 1.0
    assert metrics.skew_factor([40, 0, 0, 0]) == 4.0


def test_former_package_name_aliases_modules():
    """The package's former name (a sibling alias package) still imports,
    and every submodule under it is the module object of the new name."""
    import importlib
    import pkgutil
    from pathlib import Path

    import duckdb_parquet_parser
    import duckdb_parquet_parser.ops.scan as new_scan

    root = Path(duckdb_parquet_parser.__file__).parents[1]
    aliases = [m.name for m in pkgutil.iter_modules([str(root)])
               if m.name.startswith("duckdb_parquet_parser_")]
    assert len(aliases) == 1
    old = importlib.import_module(aliases[0])
    assert old is duckdb_parquet_parser
    assert importlib.import_module(aliases[0] + ".ops.scan") is new_scan
    from_old = importlib.import_module(aliases[0] + ".models.scan")
    assert from_old.ScanEngine is importlib.import_module(
        "duckdb_parquet_parser.models.scan").ScanEngine
    # the modules keep their own spec, so their relative imports still work
    for mod in (new_scan, from_old):
        assert mod.__spec__.name == mod.__name__
        assert mod.__spec__.parent == mod.__package__
