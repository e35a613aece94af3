"""GPU lane: the compiled device routes on the card against the numpy
golden model.  Marked `gpu`; skips where the backend is not a GPU.  Run on
the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_parity.py
"""

from __future__ import annotations

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

PATTERNS = ["alpha.*bravo", "al[pb]ha", "alpha|bravo|charlie", "^alpha",
            "bravo$", "^alpha.*o$", "[a-z]{3,35}o$",
            # empty-match / never-match / wide counted families
            "a?", "al$pha", "[a-z]{3,40}",
            # rejected by bitprog: the table-DFA walk
            "(al)+p"]
SERVE = ["alpha.*bravo", "al[pb]ha", "alpha|bravo|charlie"]


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    from duckdb_parquet_parser.models.scan import ScanEngine

    from .fixtures import strings_file

    rng = np.random.default_rng(41)
    path = strings_file(tmp_path_factory.mktemp("gpu") / "s.parquet", rng,
                        n=1200, null_p=0.1, n_unique=10, rgs=2)
    return ScanEngine(path)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_device_scan_matches_golden(gpu, engine, pattern):
    a = engine.scan("s", pattern, engine="jax")
    b = engine.scan("s", pattern, engine="numpy")
    np.testing.assert_array_equal(a.match_counts, b.match_counts)
    np.testing.assert_array_equal(a.value_counts, b.value_counts)


def test_resident_scan_matches_golden(gpu, engine):
    rc = engine.resident("s")
    many = rc.scan_many(SERVE)
    for pat, m in zip(SERVE, many):
        b = engine.scan("s", pat, engine="numpy")
        np.testing.assert_array_equal(rc.scan(pat).match_counts,
                                      b.match_counts)
        np.testing.assert_array_equal(m.match_counts, b.match_counts)


def test_ragged_all_to_all_hlo_on_card(gpu, monkeypatch):
    """The real jax.lax.ragged_all_to_all HLO (never executable on XLA:CPU)
    runs on the card as a 1-device self-exchange, with the receive layout
    bit-identical to the portable emulation."""
    import jax
    from jax.sharding import Mesh

    from duckdb_parquet_parser.parallel import pipeline as PL
    from duckdb_parquet_parser.parallel.shuffle import RaggedExchangePlan

    assert PL.ragged_use_hlo()
    mesh = Mesh(np.array(jax.devices()[:1]), ("pages",))
    rng = np.random.default_rng(3)
    for n in (1, 37, 200):
        plan = RaggedExchangePlan.plan(np.zeros(n, np.int64),
                                       np.zeros(n, np.int64), 1)
        payload = rng.integers(0, 10**6, (n, 3)).astype(np.int32)
        got = np.asarray(PL.ragged_exchange_entries(mesh, plan, payload))
        monkeypatch.setenv("DPQ_RAGGED_EMULATE", "1")
        emu = np.asarray(PL.ragged_exchange_entries(mesh, plan, payload))
        monkeypatch.delenv("DPQ_RAGGED_EMULATE")
        np.testing.assert_array_equal(got, emu)
        k = int(plan.recv_total[0])
        np.testing.assert_array_equal(
            got[0, :k], plan.build_send_buffer(payload, fill=-1)[0, :k])
