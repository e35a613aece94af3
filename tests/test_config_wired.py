"""EngineConfig knobs change engine behavior (they are consumed, not
decorative), and tracing produces a profile under profile_dir."""

from __future__ import annotations

import os

import numpy as np
import pytest

from duckdb_parquet_parser.models.scan import ScanEngine
from duckdb_parquet_parser.ops.regex import UnsupportedPattern, compile_pattern
from duckdb_parquet_parser.utils.config import EngineConfig, set_config

from .fixtures import strings_file


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    set_config(None)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    rng = np.random.default_rng(31)
    return strings_file(tmp_path_factory.mktemp("cfg") / "s.parquet", rng, n=400)


def test_max_dfa_states_limits_compilation():
    # a pattern whose subset construction needs more than a handful of states
    pat = "a.{6}b"
    compile_pattern(pat)  # fine with the default budget
    cfg = EngineConfig(max_dfa_states=4)
    set_config(cfg)
    with pytest.raises(UnsupportedPattern, match="state blow-up"):
        compile_pattern(pat)
    assert compile_pattern(pat, max_states=4096) is not None  # explicit wins


def test_scan_engine_default_is_config(path, monkeypatch):
    set_config(EngineConfig(scan_engine="numpy"))
    eng = ScanEngine(path)

    # if the engine consulted the config, the device path is never touched
    import duckdb_parquet_parser.ops.scan as S

    def boom(*a, **k):  # pragma: no cover - would mean config was ignored
        raise AssertionError("device path used despite scan_engine=numpy")

    monkeypatch.setattr(S, "scan_batch_device", boom)
    res = eng.scan("s", "alpha")
    assert (res.match_counts >= 0).all()


def test_exchange_capacity_slack_consumed(path):
    if len(__import__("jax").devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from duckdb_parquet_parser.host.reader import ParquetReader
    from duckdb_parquet_parser.parallel.index_build import (
        distributed_index_build,
    )
    from duckdb_parquet_parser.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    reader = ParquetReader(path)
    # padded mode: a slack below 1 must surface as an overflow error, not
    # silent drops
    set_config(EngineConfig(exchange_capacity_slack=0.3,
                            exchange_mode="padded"))
    with pytest.raises(ValueError, match="overflow"):
        distributed_index_build(mesh, reader, "s", chunk_size=512)
    set_config(EngineConfig(exchange_capacity_slack=1.0,
                            exchange_mode="padded"))
    res = distributed_index_build(mesh, reader, "s", chunk_size=512)
    assert sum(len(r) for r in res.received) > 0
    # ragged mode sizes buckets exactly: slack is irrelevant, nothing drops
    set_config(EngineConfig(exchange_capacity_slack=0.3))
    res2 = distributed_index_build(mesh, reader, "s", chunk_size=512)
    assert res2.exchange_mode == "ragged"
    assert sum(len(r) for r in res2.received) == sum(
        len(r) for r in res.received
    )


def test_profile_dir_produces_trace(path, tmp_path):
    trace_dir = tmp_path / "prof"
    set_config(EngineConfig(profile_dir=str(trace_dir)))
    eng = ScanEngine(path)
    eng.scan_batched("s", "alpha")
    files = [
        os.path.join(r, f) for r, _d, fs in os.walk(trace_dir) for f in fs
    ]
    assert files, "no profiler trace written under profile_dir"


def test_compile_cache_dir(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and no directory is set in code;
    without it the cache sits at one fixed path inside the checkout."""
    import jax

    from duckdb_parquet_parser.utils import jax_setup

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))

    monkeypatch.setattr(jax_setup, "_done", False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jax_setup.enable_compile_cache()
    assert "jax_compilation_cache_dir" not in updates

    monkeypatch.setattr(jax_setup, "_done", False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    jax_setup.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == want
