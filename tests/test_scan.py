"""Regex page-pruning scan: survivor-set correctness on plain and dictionary
pages (ground truth: Python `re` over decoded values), DFA vs host fallback,
numpy vs jax backends."""

import re

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.ops.scan import scan_batch, scan_batch_fallback
from tests import fixtures


def truth_pruned(reader, col, pattern, negate):
    """Pages with no (non-null, emitted) value accepted, via re.search."""
    batch = reader.prescan(col)
    decoded = reader.read_column(col)
    rx = re.compile(pattern.encode(), re.DOTALL)
    row_start = batch.arrays["page_row_start"]
    counts = np.zeros(batch.n_pages, np.int64)
    for pos in np.nonzero(decoded.valid)[0]:
        p = np.searchsorted(row_start, pos, "right") - 1
        counts[p] += (rx.search(decoded.values[pos]) is not None) ^ negate
    return np.sort(batch.arrays["page_gid"][counts == 0])


@pytest.fixture(scope="module", params=["plain", "dict", "mixed_rgs"])
def strings_path(request, tmp_path_factory):
    rng = np.random.default_rng(hash(request.param) % 2**32)
    d = tmp_path_factory.mktemp("scan")
    if request.param == "plain":
        return fixtures.strings_file(d / "p.parquet", rng, n=2500, null_p=0.15)
    if request.param == "dict":
        return fixtures.strings_file(d / "d.parquet", rng, n=2500, n_unique=11, null_p=0.15)
    # one dict rg + one plain rg in the same column
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = d / "m.parquet"
    w = ParquetWriter(
        str(path),
        [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    w.write_row_group({"s": fixtures.random_strings(rng, 1000, n_unique=8, null_p=0.1)})
    w.write_row_group({"s": fixtures.random_strings(rng, 1000, null_p=0.1)})
    w.close()
    return str(path)


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("pattern", ["alpha", "^x", "a.*z", "q[aeiou]", "([a-m])\\1*o"])
def test_scan_survivors(strings_path, pattern, negate):
    r = ParquetReader(strings_path)
    batch = r.prescan("s", pad_strings=8)
    want = truth_pruned(r, "s", pattern, negate)
    got = np.sort(scan_batch(batch, pattern, negate=negate).pruned_pages())
    # backreference pattern goes through the fallback automatically
    assert np.array_equal(got, want)
    got_fb = np.sort(scan_batch_fallback(batch, pattern, negate=negate).pruned_pages())
    assert np.array_equal(got_fb, want)


def test_scan_jax_backend(strings_path):
    import jax.numpy as jnp

    r = ParquetReader(strings_path)
    batch = r.prescan("s", pad_strings=8)
    a = scan_batch(batch, "alpha|echo", xp=np)
    b = scan_batch(batch, "alpha|echo", xp=jnp)
    assert np.array_equal(a.match_counts, np.asarray(b.match_counts))
    assert np.array_equal(a.pruned_pages(), np.asarray(b.pruned_pages()))


def test_scan_counts_values(strings_path):
    r = ParquetReader(strings_path)
    batch = r.prescan("s", pad_strings=8)
    res = scan_batch(batch, "alpha")
    decoded = r.read_column("s")
    assert int(res.value_counts.sum()) == int(decoded.valid.sum())
    # match everything -> zero pruned; match nothing -> all pruned
    assert len(scan_batch(batch, "").pruned_pages()) == 0
    assert len(scan_batch(batch, "^\\x00$").pruned_pages()) == batch.n_pages


def test_resident_scan_many_parity(tmp_path):
    """scan_many == per-pattern scan() for fused (bitprog/chain) patterns,
    solo table-DFA fallbacks, and both polarities."""
    import numpy as np

    from duckdb_parquet_parser.models.scan import ScanEngine

    from .fixtures import strings_file

    rng = np.random.default_rng(19)
    path = strings_file(tmp_path / "many.parquet", rng, n=1200, null_p=0.1,
                        n_unique=None, rgs=2)
    res = ScanEngine(path).resident("s")
    pats = ["alpha", "a.*o", "gamma|delta", "^br", "(al|br)*avo",
            "[a-z]{4,9}a"]  # lead-run counter machine rides the fused walk
    for negate in (False, True):
        many = res.scan_many(pats, negate=negate)
        for p, m in zip(pats, many):
            s = res.scan(p, negate=negate)
            np.testing.assert_array_equal(m.match_counts, s.match_counts, p)
            np.testing.assert_array_equal(m.value_counts, s.value_counts, p)


def test_dict_accept_localization_multi_rg(tmp_path):
    """Device scan over a multi-row-group dict STRING column (distinct
    chunk dictionaries -> two-stage local accept mapping) must match the
    numpy golden for plain and negated patterns."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
    from duckdb_parquet_parser.models.scan import ScanEngine

    rng = np.random.default_rng(23)
    path = str(tmp_path / "mrg_scan.parquet")
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                        optional=True)])
    for rg in range(3):
        keys = [f"city_{rg}_{k:02d}".encode() for k in range(20)]
        vals = [keys[i] for i in rng.integers(0, 20, 2500)]
        mask = (rng.random(2500) > 0.1).astype(np.uint8)
        w.write_row_group({"s": (vals, mask)})
    w.close()
    eng = ScanEngine(path)
    for pat, neg in [("city_1_.*", False), ("city_.*_0[0-5]", False),
                     ("city_1_.*", True)]:
        a = eng.scan("s", pat, engine="jax", negate=neg)
        g = eng.scan("s", pat, engine="numpy", negate=neg)
        np.testing.assert_array_equal(a.match_counts, g.match_counts,
                                      err_msg=pat)
        np.testing.assert_array_equal(a.value_counts, g.value_counts)


def test_dict_4096_scan_parity(tmp_path):
    """A 4,096-entry string dictionary maps its accept bits through the
    gather route; the device scan equals the numpy golden model."""
    from duckdb_parquet_parser.models.scan import ScanEngine

    rng = np.random.default_rng(96)
    path = fixtures.strings_file(tmp_path / "d4096.parquet", rng,
                                 n=7 * 4096, n_unique=4096, rgs=1)
    eng = ScanEngine(path)
    assert int(eng.reader.prescan("s", pad_strings=8).dims["dict_n"]) > 512
    for pat in ("alpha_.*_1[0-9]$", "kilo|mike"):
        a = eng.scan("s", pat, engine="jax")
        b = eng.scan("s", pat, engine="numpy")
        np.testing.assert_array_equal(a.match_counts, b.match_counts)
        np.testing.assert_array_equal(a.value_counts, b.value_counts)
        r = eng.resident("s").scan(pat)
        np.testing.assert_array_equal(r.match_counts, b.match_counts)


@pytest.mark.parametrize("pattern", ["q.{33,}z$", "a.{40}b"])
def test_no_dfa_pattern_keeps_re_semantics(tmp_path, pattern):
    """A pattern whose table DFA blows up is answered with the host `re`
    fallback on every page, PLAIN and dictionary alike, so values holding
    a newline (where `re`'s `.` and `$` differ from the register machine's)
    get the numpy golden's answer; resident serving refuses the pattern."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops.bitprog import compile_bitprog
    from duckdb_parquet_parser.ops.regex import (
        UnsupportedPattern,
        compile_pattern,
    )

    with pytest.raises(UnsupportedPattern):
        compile_pattern(pattern)
    compile_bitprog(pattern)  # a register machine exists all the same

    tricky = [b"q" + b"3" * 40 + b"z\n", b"q" + b"3" * 40 + b"z",
              b"a" + b"x" * 20 + b"\n" + b"x" * 19 + b"b",
              b"a" + b"x" * 40 + b"b", b"plain value"]
    rng = np.random.default_rng(5)
    path = str(tmp_path / "nl.parquet")
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                        optional=True)],
                      key_value={"pad": "x" * 512})
    # one dictionary row group (few distinct values), one PLAIN row group
    w.write_row_group({"s": [tricky[i] for i in rng.integers(0, 5, 600)]})
    w.write_row_group({"s": [b"%d " % i + tricky[i % 5]
                             for i in range(600)]})
    w.close()

    eng = ScanEngine(path)
    kinds = set(eng.reader.prescan("s", pad_strings=8)
                .arrays["page_kind"].tolist())
    assert kinds == {0, 1}, kinds
    rx = re.compile(pattern.encode())
    for neg in (False, True):
        a = eng.scan("s", pattern, engine="jax", negate=neg)
        g = eng.scan("s", pattern, engine="numpy", negate=neg)
        np.testing.assert_array_equal(a.match_counts, g.match_counts)
        np.testing.assert_array_equal(a.value_counts, g.value_counts)
        want = sum((rx.search(v) is not None) ^ neg
                   for v in eng.reader.read_column("s").to_pylist()
                   if v is not None)
        assert int(a.match_counts.sum()) == want
    with pytest.raises(UnsupportedPattern):
        eng.resident("s").scan(pattern)
