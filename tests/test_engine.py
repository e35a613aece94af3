"""ScanEngine facade + CLI end-to-end (CPU backend)."""

import subprocess
import sys

import numpy as np
import pytest

from duckdb_parquet_parser.models.scan import ScanEngine, build_example_batch
from duckdb_parquet_parser.ops.scan import scan_batch
from tests import fixtures


@pytest.fixture(scope="module")
def strings_path(tmp_path_factory):
    rng = np.random.default_rng(77)
    return fixtures.strings_file(
        tmp_path_factory.mktemp("eng") / "s.parquet", rng, n=2000, null_p=0.15
    )


def test_engine_scan_matches_reference_impl(strings_path):
    eng = ScanEngine(strings_path)
    res = eng.scan("s", "alpha|q[aeiou]")
    host = scan_batch(eng.reader.prescan("s", pad_strings=8), "alpha|q[aeiou]")
    assert np.array_equal(res.match_counts, host.match_counts)
    assert np.array_equal(np.sort(res.pruned_pages()), np.sort(host.pruned_pages()))


def test_engine_like_and_negate(strings_path):
    eng = ScanEngine(strings_path)
    res = eng.scan("s", "%alpha%", like=True)
    res2 = eng.scan("s", "alpha", negate=True)
    assert int(res.match_counts.sum()) + int(res2.match_counts.sum()) == int(
        res.value_counts.sum()
    )


def test_engine_fallback_pattern(strings_path):
    # backreference -> host re fallback, same survivor semantics
    eng = ScanEngine(strings_path)
    res = eng.scan("s", r"([a-m])\1")
    assert res.value_counts.sum() > 0


def test_engine_batched_overlap(strings_path):
    eng = ScanEngine(strings_path)
    a = eng.scan("s", "alpha")
    b = eng.scan_batched("s", "alpha", batch_pages=16)
    assert np.array_equal(a.match_counts, b.match_counts)


def test_engine_index_checkpoint(strings_path, tmp_path):
    eng = ScanEngine(strings_path)
    r1 = eng.build_index("s", 2048, checkpoint_dir=str(tmp_path))
    r2 = eng.build_index("s", 2048, checkpoint_dir=str(tmp_path))
    assert np.array_equal(r1.index.tuple_to_chunk, r2.index.tuple_to_chunk)


def test_example_batch_builder(tmp_path):
    reader, batch = build_example_batch(str(tmp_path), rows=50)
    assert reader.num_rows() == 100
    assert batch.n_pages > 0


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "duckdb_parquet_parser.cli", *args],
        capture_output=True, text=True, timeout=300,
    )


def test_cli_schema_mode(strings_path):
    r = _run_cli(str(strings_path))
    assert r.returncode == 0
    assert "Schema:" in r.stdout and "Total data pages:" in r.stdout


def test_cli_regex_mode(strings_path):
    r = _run_cli(str(strings_path), "--regex-column", "s", "--regex", "zz",
                 "--engine", "numpy")
    assert r.returncode == 0
    assert "Pages with no matching values" in r.stdout
    r2 = _run_cli(str(strings_path), "--regex-column", "s", "--regex", "zz",
                  "--neg-regex", "--engine", "numpy")
    assert "NOT matching" in r2.stdout


def test_cli_index_mode(strings_path):
    r = _run_cli("index", str(strings_path), "s")
    assert r.returncode == 0
    assert r.stdout.startswith("Total tuples:")


def test_cli_errors(strings_path, tmp_path):
    assert _run_cli(str(tmp_path / "missing.parquet")).returncode == 1
    assert _run_cli(str(strings_path), "--regex-column", "s").returncode == 2


def test_resident_column_repeated_scans(strings_path):
    eng = ScanEngine(strings_path)
    res = eng.resident("s")
    for pattern, like in [("alpha", False), ("%echo%", True), ("a.*z", False)]:
        want = eng.scan("s", pattern, like=like)
        got = res.scan(pattern, like=like)
        assert np.array_equal(got.match_counts, want.match_counts), pattern
        assert np.array_equal(
            np.sort(got.pruned_pages()), np.sort(want.pruned_pages())
        )
    neg = res.scan("alpha", negate=True)
    pos = res.scan("alpha")
    assert np.array_equal(
        neg.match_counts + pos.match_counts, pos.value_counts
    )
