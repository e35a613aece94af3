"""Row-level match API (ops/scan.match_rows, ScanEngine.matching_rows).

Oracle: the streaming string iterator (itself reference-parity tested)
drives Python `re` per value — the row set must be identical, and its size
must equal the page scan's match_counts total (shared participation and
negate semantics).
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.models.scan import ScanEngine
from duckdb_parquet_parser.ops.scan import match_rows, scan_batch

from .fixtures import strings_file

PATTERNS = ["alpha", "a.*o", "^br", "o$", "gamma|delta", "[ab]l", "x{2}"]


@pytest.fixture(scope="module", params=[None, 12], ids=["plain", "dict"])
def rows_file(request, tmp_path_factory):
    rng = np.random.default_rng(23)
    d = tmp_path_factory.mktemp("match_rows")
    return strings_file(d / "f.parquet", rng, n=900, n_unique=request.param,
                        null_p=0.15, rgs=2)


def _oracle_rows(path, pattern, negate):
    rx = re.compile(pattern.encode())
    reader = ParquetReader(path)
    it = reader.column_iterator("s")
    keep = []
    while it.has_next():
        pos, _ln, s = it.next()
        if bool(rx.search(s)) ^ negate:
            keep.append(pos)
    return np.asarray(keep, np.int64)


@pytest.mark.parametrize("negate", [False, True], ids=["like", "not-like"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_match_rows_oracle(rows_file, pattern, negate):
    eng = ScanEngine(rows_file)
    got = eng.matching_rows("s", pattern, negate=negate)
    want = _oracle_rows(rows_file, pattern, negate)
    np.testing.assert_array_equal(got, want)


def test_match_rows_totals_agree_with_scan(rows_file):
    reader = ParquetReader(rows_file)
    batch = reader.prescan("s", pad_strings=8)
    for pattern in PATTERNS:
        rows = match_rows(batch, pattern)
        counts = scan_batch(batch, pattern, xp=np)
        assert len(rows) == int(counts.match_counts.sum()), pattern


def test_match_rows_fallback_pattern(rows_file):
    """Patterns outside the DFA subset route through the host re fallback
    and produce the same row sets."""
    pattern = r"(al)\1?pha|alpha"  # backreference -> UnsupportedPattern
    eng = ScanEngine(rows_file)
    got = eng.matching_rows("s", pattern)
    want = _oracle_rows(rows_file, pattern, False)
    np.testing.assert_array_equal(got, want)


def test_match_rows_like_mode(rows_file):
    eng = ScanEngine(rows_file)
    got = eng.matching_rows("s", "%alpha%", like=True)
    want = _oracle_rows(rows_file, "alpha", False)
    np.testing.assert_array_equal(got, want)


def test_matching_rows_rejects_non_strings(tmp_path):
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    p = tmp_path / "ints.parquet"
    w = ParquetWriter(str(p), [ColumnSpec("i", ParquetType.INT64)],
                      key_value={"pad": "x" * 512})
    w.write_row_group({"i": list(range(600))})
    w.close()
    with pytest.raises(TypeError):
        ScanEngine(str(p)).matching_rows("i", "x")
