"""Two-process jax.distributed smoke test on localhost (VERDICT r3 #8).

Spawns two REAL processes that form a jax.distributed group over CPU
(4 virtual devices each -> 8 global), then run the launch entrypoint's
distributed scan and index build unmodified — the same code path a
multi-host launch takes, minus the backend.  Asserts the distributed totals
match a single-process golden run.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch_two(args: list[str], port: int, timeout=240):
    """Runs `python -m duckdb_parquet_parser.launch <args>` as two
    coordinated processes; returns process 0's stdout."""
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            DPQ_COORDINATOR=f"127.0.0.1:{port}",
            DPQ_NUM_PROCESSES="2",
            DPQ_PROCESS_ID=str(pid),
            DPQ_PLATFORM="cpu",
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            PYTHONPATH=REPO,
        )
        # keep the subprocesses off any inherited test-session device flags
        env.pop("DPQ_SCALING_PLATFORM", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "duckdb_parquet_parser.launch"] + args,
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"launch process failed (rc={rc}):\n{err[-3000:]}"
    return outs[0][1]


@pytest.fixture(scope="module")
def fixture_file(tmp_path_factory):
    rng = np.random.default_rng(31)
    return str(fixtures.strings_file(
        tmp_path_factory.mktemp("mh") / "mh.parquet", rng,
        n=1200, n_unique=None, null_p=0.1, rgs=2,
    ))


def test_two_process_scan_matches_single(fixture_file):
    from duckdb_parquet_parser.models.scan import ScanEngine

    golden = ScanEngine(fixture_file).scan("s", "alpha", engine="numpy")
    out = _launch_two(["scan", fixture_file, "s", "alpha"], _free_port())
    res = json.loads(out.strip().splitlines()[-1])
    assert res["processes"] == 2 and res["devices"] == 8
    assert res["total_matches"] == int(golden.match_counts.sum())
    assert res["total_values"] == int(golden.value_counts.sum())


def test_two_process_index_build(fixture_file):
    from duckdb_parquet_parser.host.reader import ParquetReader
    from duckdb_parquet_parser.ops.index import build_index_for_column

    golden = build_index_for_column(ParquetReader(fixture_file), "s",
                                    chunk_size=512)
    out = _launch_two(["index", fixture_file, "s", "--chunk-size", "512"],
                      _free_port())
    res = json.loads(out.strip().splitlines()[-1])
    assert res["processes"] == 2 and res["devices"] == 8
    assert res["tuples"] == int(len(golden.positions))
    assert res["exchange_mode"] == "ragged"
    assert res["capacity_ratio"] <= 1.2
