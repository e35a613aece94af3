#!/usr/bin/env python3
"""Smoke run of the scan engine's main path on an NVIDIA GPU.

Writes a lineitem-like file at TPC-H SF1 size (6,001,215 rows) from --seed
with the repo's ParquetWriter, drives the user entry points on the card and
compares every result exactly with the numpy golden model:

  scan      ScanEngine.scan(engine="jax"): LIKE, NOT LIKE, the five bench
            pattern families and one table-DFA pattern; also against
            cold_scan(exact_counts=True).  The interior-run family has no
            table DFA, so the engine answers it with the host `re` fallback
  resident  ScanEngine.resident("l_comment"): .scan per family (a pattern
            with no table DFA must be refused), .scan_many on three fused
            patterns
  decode    device decode of l_quantity, l_tax and the 4,096-entry
            dictionary column, against read_column and the numpy decode
  index     ScanEngine.build_index("l_comment") against the numpy build
  bigpage   the value-boundary split layout over a ~1 MB-page file written
            with pyarrow (not run when pyarrow is absent)

Usage:
    python chip_smoke.py [--rows N] [--seed S]    # one card
    python chip_smoke.py --four-cards             # sharded scan and
                                                  # distributed index build

Each phase prints one line with its result, its set-up (compile) time and
its wall time.  The last line is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; it
is printed only when every phase passed.  Without a GPU the script exits
non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SF1_LINEITEM_ROWS = 6_001_215
TABLE_DFA_PATTERN = "(re|de)+quests"  # bitprog rejects it: one-hot matmul DFA


class Mismatch(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Mismatch(what)


def same_result(a, b, what: str) -> None:
    """Exact equality of two page-result objects, keyed by page id."""
    ka, kb = np.argsort(a.page_gid, kind="stable"), np.argsort(b.page_gid,
                                                               kind="stable")
    check(np.array_equal(np.asarray(a.page_gid)[ka],
                         np.asarray(b.page_gid)[kb]), f"{what}: page ids")
    for f in ("match_counts", "value_counts"):
        check(np.array_equal(np.asarray(getattr(a, f))[ka],
                             np.asarray(getattr(b, f))[kb]), f"{what}: {f}")


def same_index(a, b, what: str) -> None:
    for f in ("num_rows", "chunk_size"):
        check(getattr(a, f) == getattr(b, f), f"{what}: {f}")
    for f in ("positions", "lens", "chunk_of_entry", "tuple_to_chunk",
              "chunk_starts"):
        check(np.array_equal(np.asarray(getattr(a, f)),
                             np.asarray(getattr(b, f))), f"{what}: {f}")


def real_pages(res):
    """A sharded result without its pad pages (page id -1)."""
    from duckdb_parquet_parser.ops.scan import PageMatchResult

    keep = np.asarray(res.page_gid) >= 0
    return PageMatchResult(np.asarray(res.page_gid)[keep],
                           np.asarray(res.match_counts)[keep],
                           np.asarray(res.value_counts)[keep])


def timed_twice(fn):
    """(result, set-up seconds, wall seconds): the first call compiles and
    runs, the second runs; set-up is the difference."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    t2 = time.perf_counter()
    return out, max((t1 - t0) - (t2 - t1), 0.0), t2 - t1


@contextlib.contextmanager
def count_calls(module, name: str):
    """Counts calls of module.<name> (the routes look it up at call time)."""
    real = getattr(module, name)
    calls = []

    def wrapper(*a, **k):
        calls.append(1)
        return real(*a, **k)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def phase_line(name: str, setup: float, wall: float, detail: str) -> None:
    print(f"phase {name}: ok setup_s={setup:.3f} wall_s={wall:.3f} {detail}",
          flush=True)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


# ── one-card phases ─────────────────────────────────────────────────────────


def has_dfa(pattern: str) -> bool:
    """Whether the table DFA exists; without it the engine answers with the
    host `re` fallback and resident serving refuses the pattern."""
    from duckdb_parquet_parser.ops.regex import (
        UnsupportedPattern,
        compile_pattern,
    )

    try:
        compile_pattern(pattern)
        return True
    except UnsupportedPattern:
        return False


def scan_queries(bench):
    """(name, pattern, like, negate) of the scan phase."""
    return [
        ("like", "%special%requests%", True, False),
        ("not_like", "%special%requests%", True, True),
        ("chain", bench.PATTERN, False, False),
        ("classes", bench.PATTERN_GENERAL, False, False),
        ("alternation", bench.PATTERN_ALT, False, False),
        ("wide", bench.PATTERN_WIDE, False, False),
        ("interior_run", bench.PATTERN_INTERIOR, False, False),
        ("table_dfa", TABLE_DFA_PATTERN, False, False),
    ]


def phase_scan(path, bench, golden: dict) -> None:
    from duckdb_parquet_parser.models import scan as engine_mod
    from duckdb_parquet_parser.ops import mxu_dfa
    from duckdb_parquet_parser.ops.bitprog import (
        BitprogUnsupported,
        compile_bitprog,
    )
    from duckdb_parquet_parser.ops.pallas import stream_matcher
    from duckdb_parquet_parser.ops.regex import substring_chain

    try:
        compile_bitprog(TABLE_DFA_PATTERN)
        raise Mismatch(f"{TABLE_DFA_PATTERN!r} compiled to a register machine")
    except BitprogUnsupported:
        check(substring_chain(TABLE_DFA_PATTERN) is None,
              f"{TABLE_DFA_PATTERN!r} has a bitap chain")

    eng = engine_mod.ScanEngine(str(path))
    setup = wall = gold_s = 0.0
    routes = []
    for name, pat, like, neg in scan_queries(bench):
        t0 = time.perf_counter()
        gold = eng.scan("l_comment", pat, like=like, negate=neg,
                        engine="numpy")
        gold_s += time.perf_counter() - t0
        golden[(pat, like, neg)] = gold
        with count_calls(stream_matcher, "match_stream_kernel") as kern, \
                count_calls(mxu_dfa, "make_mxu_transition") as onehot, \
                count_calls(engine_mod, "scan_batch_fallback") as host:
            res, s, w = timed_twice(lambda: eng.scan(
                "l_comment", pat, like=like, negate=neg, engine="jax"))
        setup, wall = setup + s, wall + w
        route = ("host" if host else "onehot" if onehot else
                 "kernel" if kern else "none")
        want = ("onehot" if name == "table_dfa" else
                "host" if not has_dfa(pat) else "kernel")
        check(route == want and bool(host) + bool(onehot) + bool(kern) == 1,
              f"{name}: route {route}, expected {want}")
        routes.append(f"{name}={route}")
        same_result(res, gold, f"scan {name} vs numpy")
        cold = eng.cold_scan("l_comment", pat, like=like, negate=neg,
                             exact_counts=True)
        same_result(res, cold, f"scan {name} vs cold_scan")
        check(int(res.match_counts.sum()) > 0 or neg, f"{name}: no matches")
    phase_line("scan", setup, wall,
               f"queries={len(routes)} golden_s={gold_s:.3f} "
               + " ".join(routes))


def kernel_walk(rc, pattern: str):
    """Per-page accept counts of `pattern`'s register machine walked by the
    stream kernel over the resident buckets (every page of the fixture's
    comment column is PLAIN)."""
    import jax.numpy as jnp

    from duckdb_parquet_parser.ops.bitprog import compile_bitprog
    from duckdb_parquet_parser.ops.pallas import stream_matcher
    from duckdb_parquet_parser.ops.scan import PageMatchResult
    from duckdb_parquet_parser.ops.strings import match_payload_stream

    prog = compile_bitprog(pattern)
    counts = np.zeros(rc.n_pages, np.int64)
    values = np.zeros(rc.n_pages, np.int64)
    with count_calls(stream_matcher, "match_stream_kernel") as kern:
        for idx, steps, core, payload, plen in rc._buckets:
            check(not np.asarray(core["page_kind"]).any(),
                  "resident comment column has dictionary pages")
            hits, seen = match_payload_stream(
                jnp, payload, plen, core["page_nn"], None, None,
                max_steps=steps, prog=prog, transposed=True)
            counts[idx] = np.asarray(hits)
            values[idx] = np.asarray(seen)
    check(len(kern) == len(rc._buckets), f"{pattern!r}: not on the kernel")
    return PageMatchResult(rc._gid.copy(), counts, values)


def phase_resident(path, bench, golden: dict) -> None:
    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops.regex import UnsupportedPattern

    eng = ScanEngine(str(path))
    t0 = time.perf_counter()
    rc = eng.resident("l_comment")
    residency = time.perf_counter() - t0
    setup = wall = 0.0
    refused = []
    for name, pat, like, neg in scan_queries(bench):
        if not has_dfa(pat):
            try:
                rc.scan(pat, like=like, negate=neg)
            except UnsupportedPattern:
                refused.append(name)
            else:
                raise Mismatch(f"resident {name}: served a pattern with no DFA")
            res, s, w = timed_twice(lambda: kernel_walk(rc, pat))
            setup, wall = setup + s, wall + w
            same_result(res, golden[(pat, like, neg)],
                        f"stream kernel {name} vs host re")
            continue
        res, s, w = timed_twice(lambda: rc.scan(pat, like=like, negate=neg))
        setup, wall = setup + s, wall + w
        same_result(res, golden[(pat, like, neg)], f"resident {name}")
    fused = [bench.PATTERN, bench.PATTERN_GENERAL, bench.PATTERN_ALT]
    many, s, w = timed_twice(lambda: rc.scan_many(fused))
    setup, wall = setup + s, wall + w
    for pat, res in zip(fused, many):
        same_result(res, golden[(pat, False, False)], f"scan_many {pat!r}")
    phase_line("resident", setup, wall,
               f"residency_s={residency:.3f} pages={rc.n_pages} "
               f"buckets={[s for _, s, *_ in rc._buckets]} fused=3 "
               f"refused_no_dfa={','.join(refused) or 'none'}")


def phase_decode(path) -> None:
    from duckdb_parquet_parser.host.reader import (
        DEVICE_DECODE_MIN_ROWS,
        ParquetReader,
        _materialize_fixed,
    )
    from duckdb_parquet_parser.ops.dict_lookup import SELECT_DICT_MAX

    reader = ParquetReader(str(path))
    setup = wall = 0.0
    notes = []
    for col in ("l_quantity", "l_tax", "l_dictkey"):
        batch = reader.prescan(col)
        dev, s, w = timed_twice(lambda: _materialize_fixed(batch, "jax"))
        setup, wall = setup + s, wall + w
        gold = _materialize_fixed(batch, "numpy")
        host = reader.read_column(col)
        for other, what in ((gold, "numpy decode"), (host, "read_column")):
            check(np.array_equal(np.asarray(dev.valid),
                                 np.asarray(other.valid)),
                  f"decode {col} vs {what}: validity")
            v = np.asarray(dev.valid)
            check(np.array_equal(np.asarray(dev.values)[v],
                                 np.asarray(other.values)[v]),
                  f"decode {col} vs {what}: values")
        if col == "l_dictkey":
            dn = int(batch.dims.get("dict_n", 0))
            dn_max = max(int(np.max(batch.arrays["page_dict_size"])), 0)
            check(batch.mode in ("dict", "mixed") and dn_max > SELECT_DICT_MAX,
                  f"{col}: not on the dictionary gather route")
            notes.append(f"dict_entries={dn} page_dict_max={dn_max}")
        notes.append(f"{col}_rows={len(dev)}"
                     f"{'' if len(dev) >= DEVICE_DECODE_MIN_ROWS else '(small)'}")
    phase_line("decode", setup, wall, " ".join(notes))


def phase_index(path) -> None:
    from duckdb_parquet_parser.host.reader import ParquetReader
    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops.index import build_index_for_column

    eng = ScanEngine(str(path))
    res, s, w = timed_twice(lambda: eng.build_index("l_comment"))
    gold = build_index_for_column(ParquetReader(str(path)), "l_comment",
                                  engine="numpy")
    same_index(res.index, gold, "build_index vs numpy")
    phase_line("index", s, w, f"chunks={res.index.num_chunks}")


def phase_bigpage(tmp: Path, rows: int, seed: int, bench) -> None:
    import importlib.util

    if importlib.util.find_spec("pyarrow") is None:
        print("phase bigpage: not run: pyarrow absent", flush=True)
        return
    from duckdb_parquet_parser.models.scan import ScanEngine

    path = bench.gen_bigpage_fixture(rows, tmp / "bigpages.parquet", seed)
    eng = ScanEngine(str(path))
    rc = eng.resident("l_comment")
    check(rc._split is not None, "big pages did not take the split layout")
    setup = wall = 0.0
    for pat in (bench.PATTERN, bench.PATTERN_GENERAL, TABLE_DFA_PATTERN):
        gold = eng.scan("l_comment", pat, engine="numpy")
        res, s, w = timed_twice(lambda: eng.scan("l_comment", pat,
                                                 engine="jax"))
        res_r, s2, w2 = timed_twice(lambda: rc.scan(pat))
        setup, wall = setup + s + s2, wall + w + w2
        same_result(res, gold, f"bigpage scan {pat!r}")
        same_result(res_r, gold, f"bigpage resident {pat!r}")
        same_result(res, eng.cold_scan("l_comment", pat, exact_counts=True),
                    f"bigpage cold_scan {pat!r}")
    phase_line("bigpage", setup, wall,
               f"rows={rows} pages={rc.n_pages} "
               f"segments={int(rc._split[1].shape[0])}")


# ── four-card phase ─────────────────────────────────────────────────────────


def phase_four_cards(path, bench) -> None:
    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops.index import build_index_for_column
    from duckdb_parquet_parser.parallel import pipeline
    from duckdb_parquet_parser.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    one = ScanEngine(str(path))
    four = ScanEngine(str(path), mesh=mesh)
    setup = wall = 0.0
    for pat in (bench.PATTERN, bench.PATTERN_GENERAL):
        res, s, w = timed_twice(lambda: four.scan("l_comment", pat))
        setup, wall = setup + s, wall + w
        res = real_pages(res)
        same_result(res, one.scan("l_comment", pat, engine="jax"),
                    f"sharded scan {pat!r} vs one card")
        same_result(res, one.scan("l_comment", pat, engine="numpy"),
                    f"sharded scan {pat!r} vs numpy")
    phase_line("sharded_scan", setup, wall, "cards=4 patterns=2")

    hlo = pipeline.ragged_use_hlo()
    res, s, w = timed_twice(lambda: four.build_index("l_comment"))
    gold = build_index_for_column(one.reader, "l_comment", engine="numpy")
    same_index(res.index, one.build_index("l_comment").index,
               "distributed index vs one card")
    same_index(res.index, gold, "distributed index vs numpy")
    os.environ["DPQ_RAGGED_EMULATE"] = "1"
    try:
        emu, _, w_emu = timed_twice(lambda: four.build_index("l_comment"))
    finally:
        os.environ.pop("DPQ_RAGGED_EMULATE")
    same_index(res.index, emu.index, "ragged HLO vs emulation")
    phase_line("distributed_index", s, w,
               f"cards=4 chunks={res.index.num_chunks} "
               f"ragged_all_to_all={'hlo' if hlo else 'emulated'} "
               f"emulated_wall_s={w_emu:.3f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=SF1_LINEITEM_ROWS)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded scan and the distributed "
                         "index build on four cards")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX backend: {devs[0].platform})",
              file=sys.stderr)
        return 1
    n_cards = 4 if args.four_cards else 1
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 1
    for ln in card_lines()[:n_cards]:
        print(f"card: {ln}", flush=True)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import bench
    from duckdb_parquet_parser.utils.jax_setup import enable_compile_cache

    enable_compile_cache()
    with tempfile.TemporaryDirectory(prefix="dpq_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        path = bench.gen_fixture(args.rows, tmp / "lineitem.parquet",
                                 seed=args.seed, dict_column=True)
        print(f"fixture: rows={args.rows} bytes={path.stat().st_size} "
              f"write_s={time.perf_counter() - t0:.3f}", flush=True)
        if args.four_cards:
            phase_four_cards(path, bench)
        else:
            golden: dict = {}
            phase_scan(path, bench, golden)
            phase_resident(path, bench, golden)
            phase_decode(path)
            phase_index(path)
            phase_bigpage(tmp, args.rows, args.seed, bench)

    for i, d in enumerate(devs[:n_cards]):
        peak = d.memory_stats()["peak_bytes_in_use"]
        print(f"device {i}: peak_bytes_in_use={peak}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": n_cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
