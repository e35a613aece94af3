"""Materialized level/index planes (pre-scan default) vs the device
run-expansion fallback (PS_RUNS_ONLY): identical decode outputs."""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.host import bindings
from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.ops import decode as D

from .fixtures import mixed_file, strings_file


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    rng = np.random.default_rng(21)
    return mixed_file(tmp_path_factory.mktemp("mat") / "m.parquet", rng)


@pytest.mark.parametrize("col", ["i64_opt", "city", "code", "flag", "f32"])
def test_planes_match_run_expansion(path, col):
    r = ParquetReader(path)
    a = r.prescan(col)
    b = r.prescan(col, flags=bindings.PS_RUNS_ONLY)
    assert "def_levels" in a.arrays or a.max_def == 0
    assert "def_levels" not in b.arrays

    nn_a, idx_a = D.decode_levels(np, a.arrays, a.max_def, a.vmax)
    nn_b, idx_b = D.decode_levels(np, b.arrays, b.max_def, b.vmax)
    np.testing.assert_array_equal(nn_a, nn_b)
    np.testing.assert_array_equal(idx_a, idx_b)

    if bool((a.arrays["page_kind"] == 1).any()):
        assert "idx_vals" in a.arrays
        da, ok_a = D.decode_dict_indices(np, a.arrays, idx_a, a.nn_cap)
        db, ok_b = D.decode_dict_indices(np, b.arrays, idx_b, b.nn_cap)
        # ok (and the index) is only meaningful at non-null positions — the
        # paths hold different garbage at nulls, masked by every consumer
        np.testing.assert_array_equal(np.where(ok_a & nn_a, da, -1),
                                      np.where(ok_b & nn_b, db, -1))
        np.testing.assert_array_equal(ok_a & nn_a, ok_b & nn_b)


def test_full_decode_matches(path):
    r = ParquetReader(path)
    for col in ["i64_opt", "city", "code"]:
        a = r.read_column(col)
        # runs-only batch through the same materialization helpers
        from duckdb_parquet_parser.host.reader import (
            _materialize_fixed,
            _materialize_strings,
        )

        idx = r.find_column(col)
        b = r.prescan(idx, flags=bindings.PS_RUNS_ONLY, pad_strings=0)
        if r.column(col).type.name == "BYTE_ARRAY":
            got = _materialize_strings(b)
            assert list(got.values) == list(a.values)
        else:
            got = _materialize_fixed(b, engine="numpy")
            np.testing.assert_array_equal(got.values, a.values)
        np.testing.assert_array_equal(got.valid, a.valid)


def test_string_values_slicing(path):
    r = ParquetReader(path)
    c = r.read_column("comment")
    n = len(c)
    sl = c.values[2 : n // 2]
    assert len(sl) == n // 2 - 2
    assert sl[0] == c.values[2]
    assert list(sl) == [c.values[i] for i in range(2, n // 2)]
