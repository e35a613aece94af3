"""Value-boundary payload splitting for big pages (ops/scan.split_payload_
pages + dpq_scan.hpp::split_payload_plan).

pyarrow's default data_page_size is ~1 MB; without splitting, the device
streaming matcher walks ONE ~1M-step sequential lane per page (measured
minutes per scan).  Splitting re-chunks PLAIN pages at value starts — no
matcher state crosses a value start, so per-segment walks are exact and a
per-page segment-sum reproduces the unsplit counts bit-for-bit."""

from __future__ import annotations

import re

import numpy as np
import pytest

from duckdb_parquet_parser.host import bindings as B
from duckdb_parquet_parser.ops.scan import split_payload_pages


def _payload_matrix(pages):
    """pages: list of (values list | None-for-dict, kind).  Returns arrays
    dict shaped like a PS_PAYLOAD prescan batch."""
    rows, plens, nns, kinds = [], [], [], []
    for vals, kind in pages:
        buf = bytearray()
        for v in vals:
            buf += len(v).to_bytes(4, "little") + v
        rows.append(bytes(buf))
        plens.append(len(buf))
        nns.append(len(vals))
        kinds.append(kind)
    pitch = max(plens) + 8
    pm = np.zeros((len(rows), pitch), np.uint8)
    for i, b in enumerate(rows):
        pm[i, : len(b)] = np.frombuffer(b, np.uint8)
    return {
        "payload": pm,
        "page_payload_len": np.array(plens, np.int32),
        "page_nn": np.array(nns, np.int32),
        "page_kind": np.array(kinds, np.int32),
    }


def test_split_plan_properties():
    rng = np.random.default_rng(11)
    vals = [bytes(rng.integers(97, 123, int(rng.integers(0, 40))).astype(np.uint8))
            for _ in range(400)]
    arrays = _payload_matrix([(vals, 0), (vals[:3], 0), ([], 1)])
    sp = split_payload_pages(arrays, trigger=256, target=256)
    sub, slen, snn, spage = sp
    # segments partition each page's values and bytes, in page order
    assert snn.sum() == 403
    assert np.all(np.diff(spage) >= 0)
    for page in (0, 1, 2):
        sel = spage == page
        assert snn[sel].sum() == arrays["page_nn"][page]
        assert slen[sel].sum() == arrays["page_payload_len"][page]
    # page 1 (small) and page 2 (dict) stay single segments
    assert (spage == 1).sum() == 1 and (spage == 2).sum() == 1
    # every segment starts at a value start: walking its prefixes consumes
    # exactly snn values inside slen bytes (except a possible truncated tail)
    off = 0
    for s in range(len(spage)):
        if spage[s] != 0:
            continue
        row = arrays["payload"][0]
        pos = 0
        for _ in range(int(snn[s])):
            ln = int.from_bytes(row[off + pos: off + pos + 4], "little")
            pos += 4 + ln
        assert pos == slen[s]
        off += int(slen[s])


def test_split_plan_truncation_and_blowup():
    # truncated value mid-page: the tail segment inherits everything left
    vals = [b"x" * 60] * 20
    arrays = _payload_matrix([(vals, 0)])
    arrays["page_payload_len"][0] -= 30  # cut into the last value
    sub, slen, snn, spage = split_payload_pages(arrays, trigger=128,
                                                target=128)
    assert snn.sum() == 20 and slen.sum() == arrays["page_payload_len"][0]
    # one giant value forces the pitch: plan reports not-ok -> None
    arrays = _payload_matrix([
        ([b"y" * 40] * 200, 0), ([b"z" * 100_000], 0),
    ])
    assert split_payload_pages(arrays, trigger=128, target=128) is None


@pytest.mark.parametrize("pattern", ["special.*requests", "[a-z ]{30,45}requests",
                                     "carefully|quickly"])
def test_split_walk_parity(pattern):
    """Split-walk counts == unsplit walk == re, numpy path."""
    from duckdb_parquet_parser.ops.bitprog import compile_bitprog
    from duckdb_parquet_parser.ops.strings import match_payload_stream

    rng = np.random.default_rng(3)
    words = [b"carefully", b"quickly", b"special", b"requests", b"deposits"]
    pages = []
    for _ in range(4):
        vals = [b" ".join(rng.choice(words, int(rng.integers(1, 8))))
                for _ in range(300)]
        pages.append((vals, 0))
    arrays = _payload_matrix(pages)
    prog = compile_bitprog(pattern)
    h0, s0 = match_payload_stream(
        np, arrays["payload"], arrays["page_payload_len"], arrays["page_nn"],
        None, None, prog=prog)
    sub, slen, snn, spage = split_payload_pages(arrays, trigger=512,
                                                target=512)
    h1, s1 = match_payload_stream(np, sub, slen, snn, None, None, prog=prog)
    hp = np.zeros(len(pages), h1.dtype)
    sp_ = np.zeros(len(pages), s1.dtype)
    np.add.at(hp, spage, h1)
    np.add.at(sp_, spage, s1)
    np.testing.assert_array_equal(hp, h0, err_msg=pattern)
    np.testing.assert_array_equal(sp_, s0, err_msg=pattern)


def test_engine_scan_big_pages(tmp_path):
    """End-to-end: pyarrow-default big pages through the device scan path
    (engine=jax) and the resident serving path, both polarities, vs re."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    from duckdb_parquet_parser.models.scan import ScanEngine

    rng = np.random.default_rng(9)
    words = [b"carefully", b"quickly", b"special", b"requests", b"deposits"]
    vals = [b" ".join(rng.choice(words, 5)) if rng.random() > 0.05 else None
            for _ in range(4000)]
    f = str(tmp_path / "big.parquet")
    pq.write_table(pa.table({"s": vals}), f, compression="none",
                   use_dictionary=False)  # one ~150 KB page per row group
    eng = ScanEngine(f)
    res_dev = eng.scan("s", "special.*requests", engine="jax")
    assert res_dev is not None
    want = sum(1 for v in vals if v is not None
               and re.search(b"special.*requests", v))
    assert int(np.asarray(res_dev.match_counts).sum()) == want
    # exercised the split path, not a degenerate single-segment layout
    from duckdb_parquet_parser.host.reader import ParquetReader

    batch = ParquetReader(f).prescan("s", flags=B.PS_PAYLOAD)
    sp = split_payload_pages(batch.arrays)
    assert sp is not None and len(sp[3]) > batch.n_pages

    rc = eng.resident("s")
    for negate in (False, True):
        r = rc.scan("special.*requests", negate=negate)
        w = sum(1 for v in vals if v is not None
                and bool(re.search(b"special.*requests", v)) ^ negate)
        assert int(r.match_counts.sum()) == w, f"negate={negate}"
    many = rc.scan_many(["special.*requests", "carefully|quickly"])
    solo = [rc.scan(p) for p in ["special.*requests", "carefully|quickly"]]
    for m, s in zip(many, solo):
        np.testing.assert_array_equal(m.match_counts, s.match_counts)


def test_batched_and_streaming_reroute_big_pages(tmp_path):
    """scan_batched / scan_streaming reroute big-page files through the
    split path instead of walking mega-page lanes."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    from duckdb_parquet_parser.models.scan import ScanEngine

    rng = np.random.default_rng(4)
    words = [b"carefully", b"quickly", b"special", b"requests"]
    vals = [b" ".join(rng.choice(words, 4)) for _ in range(3000)]
    f = str(tmp_path / "big2.parquet")
    pq.write_table(pa.table({"s": vals}), f, compression="none",
                   use_dictionary=False)
    want = sum(1 for v in vals if re.search(b"special.*requests", v))
    eng = ScanEngine(f)
    r1 = eng.scan_batched("s", "special.*requests")
    assert int(np.asarray(r1.match_counts).sum()) == want
    r2 = eng.scan_streaming("s", "special.*requests")
    assert int(np.asarray(r2.match_counts).sum()) == want
