"""Benchmark harness — measures the engine against the reference binary.

Workload (mirrors the reference's implied benchmark, SURVEY.md §6): a
TPC-H-lineitem-like file; the headline metric is sustained decode + regex
page-pruning scan rows/s on one chip versus the reference's single-CPU decode
rows/s over the same (page-cache-hot) file.  Both sides re-decode everything
per repetition from their resident copy (reference: OS page cache; engine:
HBM page buffers).

Methodology:
  * device work is timed as the MARGINAL cost of extra jit-internal
    repetitions (fori_loop), with results fetched to host;
  * per-iteration inputs are perturbed (nn + i%2) so XLA cannot hoist the
    body out of the repetition loop;
  * compiles are cached persistently (utils/jax_setup.py).

Needs a GPU: exits non-zero when JAX finds none.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rows/s", "vs_baseline": N,
   "device": {"platform", "kind", "count", "card"}}
Details go to stderr.  Fixtures are cached under build/bench in the checkout
(DPQ_BENCH_DIR overrides).

Usage: python bench.py [--rows N] [--quick]
       python bench.py --kernel-ab    # stream kernel vs lax.scan walk, take
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CACHE = Path(os.environ.get(
    "DPQ_BENCH_DIR",
    Path(os.path.dirname(os.path.abspath(__file__))) / "build" / "bench"))
PATTERN = "special.*requests"  # TPC-H Q13-style filter
PATTERN_GENERAL = "spe[cs]ial.*requ[ea]sts"  # classes: bit-parallel NFA path
PATTERN_ALT = "carefully|quickly|special"   # alternation: packed registers
PATTERN_WIDE = "[a-z ]{30,45}requests"      # 53 positions: carry-chained regs
PATTERN_INTERIOR = "carefully[a-z ]{32,}requests"  # interior run -> anchored
                                            # counter (_collapse_interior_runs)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


COMMENT_WORDS = [
    b"carefully", b"furiously", b"quickly", b"slyly", b"blithely", b"requests",
    b"deposits", b"packages", b"accounts", b"theodolites", b"pending", b"final",
    b"special", b"express", b"regular", b"ironic", b"unusual", b"bold",
    b"among", b"across", b"above", b"sleep", b"haggle", b"nag", b"wake",
]


def comment_strings(rng, n: int):
    """`n` lineitem-like comments of five words each: (offsets [n+1] i64,
    chars u8) — Arrow's binary layout."""
    words = COMMENT_WORDS
    pick = rng.integers(0, len(words), (n, 5))
    lens_of = np.array([len(x) for x in words])
    ln = lens_of[pick].sum(axis=1) + 4
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(ln, out=offs[1:])
    chars = np.full(offs[-1], ord(" "), np.uint8)
    at = offs[:-1].copy()
    for k in range(5):
        for wi in range(len(words)):
            sel = pick[:, k] == wi
            if not sel.any():
                continue
            word = np.frombuffer(words[wi], np.uint8)
            idx = at[sel][:, None] + np.arange(len(word))[None, :]
            chars[idx.ravel()] = np.tile(word, int(sel.sum()))
        at += lens_of[pick[:, k]] + 1
    return offs, chars


DICT_KEYS = 4096  # distinct values of the optional dictionary column


def gen_fixture(rows: int, path: Path | None = None, seed: int = 2026,
                dict_column: bool = False) -> Path:
    """lineitem-like fixture: comment strings (~27-60 chars), i64 (REQUIRED),
    f64 (REQUIRED), f64 (OPTIONAL, 10% null); 500k-row row groups, 1 KB
    pages.  `dict_column` adds `l_dictkey`, an optional INT64 column of
    DICT_KEYS distinct values (dictionary-encoded, 5% null)."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    if path is None:
        tag = "_dict" if dict_column else ""
        path = CACHE / f"lineitem_{rows}_{seed}{tag}.parquet"
        if path.exists():
            return path
        CACHE.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    specs = [
        ColumnSpec("l_quantity", ParquetType.INT64),
        ColumnSpec("l_extendedprice", ParquetType.DOUBLE),
        ColumnSpec("l_tax", ParquetType.DOUBLE, optional=True),
        ColumnSpec("l_comment", ParquetType.BYTE_ARRAY, optional=True),
    ]
    if dict_column:
        specs.append(ColumnSpec("l_dictkey", ParquetType.INT64, optional=True))
    w = ParquetWriter(str(path), specs, key_value={"pad": "x" * 512})
    rg_rows = 500_000
    done = 0
    while done < rows:
        n = min(rg_rows, rows - done)
        offs, chars = comment_strings(rng, n)
        valid = (rng.random(n) > 0.01).astype(np.uint8)
        valid_tax = (rng.random(n) > 0.10).astype(np.uint8)
        cols = {
            "l_quantity": rng.integers(1, 51, n),
            "l_extendedprice": rng.random(n) * 1e5,
            "l_tax": (rng.random(n) * 0.1, valid_tax),
            "l_comment": ((offs, chars, valid)),
        }
        if dict_column:
            cols["l_dictkey"] = (
                rng.integers(0, DICT_KEYS, n) * 1_000_003 - (1 << 40),
                (rng.random(n) > 0.05).astype(np.uint8))
        w.write_row_group(cols)
        done += n
    w.close()
    log(f"fixture {path} ({path.stat().st_size/1e6:.1f} MB) in {time.time()-t0:.1f}s")
    return path


def gen_sorted_fixture(rows: int) -> Path:
    """Key-ordered strings column (write-time clustering): 'user_NNNNNNN tail'
    keys in ascending order, 2% null — the layout where ColumnIndex min/max
    pruning pays (tight per-page ranges)."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = CACHE / f"sortedkeys_{rows}.parquet"
    if path.exists():
        return path
    CACHE.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    rng = np.random.default_rng(77)
    w = ParquetWriter(
        str(path),
        [ColumnSpec("s_key", ParquetType.BYTE_ARRAY, optional=True)],
    )
    rg_rows = 500_000
    done = 0
    while done < rows:
        n = min(rg_rows, rows - done)
        ids = np.arange(done, done + n)
        # vectorized "user_%07d extra" build (zero-padded => lexicographic
        # order == numeric order)
        digits = np.zeros((n, 7), np.uint8)
        v = ids.copy()
        for d in range(6, -1, -1):
            digits[:, d] = (v % 10) + ord("0")
            v //= 10
        pre = np.frombuffer(b"user_", np.uint8)
        post = np.frombuffer(b" extra", np.uint8)
        row = np.concatenate([
            np.tile(pre, (n, 1)), digits, np.tile(post, (n, 1))
        ], axis=1)
        ln = row.shape[1]
        offs = np.arange(n + 1, dtype=np.int64) * ln
        valid = (rng.random(n) > 0.02).astype(np.uint8)
        w.write_row_group({"s_key": ((offs, row.ravel(), valid))})
        done += n
    w.close()
    log(f"sorted fixture {path} ({path.stat().st_size/1e6:.1f} MB) "
        f"in {time.time()-t0:.1f}s")
    return path


def gen_dict_fixture(rows: int) -> Path:
    """Dictionary-heavy INT64 column (100 distinct values, 5% nulls)."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = CACHE / f"dictheavy_{rows}.parquet"
    if path.exists():
        return path
    CACHE.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    w = ParquetWriter(str(path), [ColumnSpec("k", ParquetType.INT64, optional=True)])
    done = 0
    while done < rows:
        n = min(500_000, rows - done)
        w.write_row_group({
            "k": (rng.integers(0, 100, n) * 1000003,
                  (rng.random(n) > 0.05).astype(np.uint8)),
        })
        done += n
    w.close()
    return path


def gen_bigpage_fixture(rows: int, path: Path | None = None,
                        seed: int = 13) -> Path:
    """pyarrow-DEFAULT layout: ~1 MB data pages (vs the reference writer's
    1 KB) of lineitem-like comments — exercises the value-boundary split
    path (ops/scan.split_payload_pages); real-world files look like this."""
    if path is None:
        path = CACHE / f"bigpages_{rows}_{seed}.parquet"
        if path.exists():
            return path
        CACHE.mkdir(parents=True, exist_ok=True)
    import pyarrow as pa
    import pyarrow.parquet as pq

    offs, chars = comment_strings(np.random.default_rng(seed), rows)
    col = pa.BinaryArray.from_buffers(
        pa.binary(), rows,
        [None, pa.py_buffer(offs.astype(np.int32)), pa.py_buffer(chars)])
    pq.write_table(pa.table({"l_comment": col}), str(path),
                   compression="none", use_dictionary=False)
    return path


def gen_delta_fixture(rows: int) -> Path:
    """DELTA_BINARY_PACKED INT64 column (pyarrow-written, 5% nulls, mixed
    miniblock widths: sorted runs + noise spikes)."""
    path = CACHE / f"deltai64_{rows}.parquet"
    if path.exists():
        return path
    CACHE.mkdir(parents=True, exist_ok=True)
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(21)
    base = np.cumsum(rng.integers(-50, 200, rows)).astype(np.int64)
    base[:: 131] += rng.integers(-(1 << 40), 1 << 40, (rows + 130) // 131)
    vals = [None if rng.random() < 0.05 else int(v) for v in base]
    pq.write_table(
        pa.table({"x": pa.array(vals, type=pa.int64())}), path,
        use_dictionary=False, column_encoding={"x": "DELTA_BINARY_PACKED"},
        data_page_version="2.0", data_page_size=64 << 10,
    )
    return path


def gen_dict_strings_fixture(rows: int) -> Path:
    """Low-cardinality BYTE_ARRAY column (city names, 2% nulls) — every data
    page dictionary-encoded (64 distinct <= non_null/5)."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = CACHE / f"dictstrings_{rows}.parquet"
    if path.exists():
        return path
    CACHE.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    bases = [b"san diego", b"san francisco", b"san antonio", b"new york",
             b"new orleans", b"chicago", b"boston", b"seattle", b"atlanta",
             b"houston", b"denver", b"miami", b"dallas", b"portland",
             b"phoenix", b"detroit"]
    cities = [b + f"-{k}".encode() for b in bases for k in range(4)]
    w = ParquetWriter(
        str(path), [ColumnSpec("city", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    done = 0
    while done < rows:
        n = min(500_000, rows - done)
        pick = rng.integers(0, len(cities), n)
        valid = rng.random(n) > 0.02
        vals = [cities[int(k)] if v else None
                for k, v in zip(pick, valid)]
        w.write_row_group({"city": vals})
        done += n
    w.close()
    return path


def bench_reference(path: Path, reps: int) -> dict:
    from tests.oracle.build_oracle import build_oracle

    exe = build_oracle()
    if exe is None:
        log("reference unavailable; baseline = NaN")
        return {}
    import subprocess

    out = {}
    r = subprocess.run(
        [str(exe), str(path), "bench-iter", "l_comment", str(reps)],
        capture_output=True, text=True, timeout=3600,
    )
    vals = r.stdout.split()
    n_values, secs = int(vals[1]), float(vals[5])
    out["ref_iter_rows_per_s"] = n_values / secs

    for col, key in (("l_quantity", "ref_column_i64_rows_per_s"),
                     ("l_tax", "ref_column_f64opt_rows_per_s")):
        r = subprocess.run(
            [str(exe), str(path), "bench-column", col, str(reps)],
            capture_output=True, text=True, timeout=3600,
        )
        vals = r.stdout.split()
        out[key] = int(vals[1]) / float(vals[3])

    r = subprocess.run(
        [str(exe), str(path), "bench-index", "l_comment", str(reps)],
        capture_output=True, text=True, timeout=3600,
    )
    vals = r.stdout.split()
    if len(vals) >= 4:  # older oracle builds lack the mode
        # n_values is the total across the SAME rep count, so the ratio is
        # already per-rep
        out["ref_index_rows_per_s"] = n_values / float(vals[3])

    log(f"reference: iter {out['ref_iter_rows_per_s']:.3g} rows/s, "
        f"read_column i64 {out['ref_column_i64_rows_per_s']:.3g}, "
        f"f64-opt {out['ref_column_f64opt_rows_per_s']:.3g} rows/s, "
        f"index {out.get('ref_index_rows_per_s', float('nan')):.3g} rows/s")
    return out


def _marginal(fn, args, reps_hi=6, tries=3, min_signal=0.03):
    """Marginal seconds per repetition (anti-hoisting handled by fn's body
    perturbation).  `fn(reps, *args)` takes the repetition count as a
    TRACED device scalar driving a dynamic fori_loop, so ONE compile
    serves every rep count.

    A fast body produces little signal at small rep counts against host
    jitter — reps grow (4x steps, capped at 513) until the total marginal
    signal clears `min_signal`; escalation is compile-free."""
    import jax.numpy as jnp

    def call(r):
        return float(np.asarray(fn(jnp.int32(r), *args)))

    call(1)
    t1s = []
    for _ in range(tries):
        t0 = time.time(); call(1); t1s.append(time.time() - t0)
    t1 = min(t1s)
    while True:
        trs = []
        for _ in range(tries):
            t0 = time.time(); call(reps_hi); trs.append(time.time() - t0)
        signal = min(trs) - t1
        if signal >= min_signal or reps_hi >= 513:
            if signal < min_signal:
                log(f"  [marginal] weak signal {signal*1000:.1f} ms even at "
                    f"{reps_hi} reps — treat as noise-bound")
            global LAST_BAND
            margs = sorted(max((tr - t1) / (reps_hi - 1), 1e-9) for tr in trs)
            LAST_BAND = {
                "n": len(margs),
                "min_s": margs[0],
                "med_s": margs[len(margs) // 2],
                "max_s": margs[-1],
            }
            return t1, max(signal / (reps_hi - 1), 1e-9)
        reps_hi = min((reps_hi - 1) * 4 + 1, 513)


LAST_BAND: dict | None = None


def _band(out: dict, key: str, total: float) -> None:
    """Record the variance band of the LAST _marginal call for `key`, in
    rows/s: {min, med, spread, n} — min = the worst-draw rate, spread =
    best/worst ratio.  The headline values stay min-of-N; the band lets
    a reader tell a noisy draw from a regression."""
    b = LAST_BAND
    if not b:
        return
    out.setdefault("bands", {})[key] = {
        "min": round(total / b["max_s"], 1),
        "med": round(total / b["med_s"], 1),
        "spread": round(b["max_s"] / b["min_s"], 3),
        "n": b["n"],
    }


def _host_band(out: dict, key: str, times_s: list, total: float) -> None:
    """Same band contract for host-side loops: `times_s` are per-run wall
    seconds of identical work."""
    ts = sorted(times_s)
    if not ts:
        return
    out.setdefault("bands", {})[key] = {
        "min": round(total / ts[-1], 1),
        "med": round(total / ts[len(ts) // 2], 1),
        "spread": round(ts[-1] / ts[0], 3),
        "n": len(ts),
    }


def bench_engine(path: Path, reps: int) -> dict:
    import jax
    import jax.numpy as jnp

    from duckdb_parquet_parser.host import bindings
    from duckdb_parquet_parser.host.reader import ParquetReader
    from duckdb_parquet_parser.ops import decode as D
    from duckdb_parquet_parser.ops.regex import compile_pattern
    from duckdb_parquet_parser.ops.strings import match_payload_stream

    out: dict = {}
    dev = jax.devices()[0]
    log(f"engine device: {dev}")
    dfa = compile_pattern(PATTERN)
    bc = dfa.byte_classes()
    log(f"pattern {PATTERN!r}: {dfa.n_states} states, {bc.n_classes} byte classes")

    # ── resident page buffers ───────────────────────────────────────────────
    t0 = time.time()
    reader = ParquetReader(str(path))
    t_open = time.time() - t0
    t0 = time.time()
    batch = reader.prescan("l_comment", flags=bindings.PS_PAYLOAD)
    t_prescan = time.time() - t0
    total = int(batch.arrays["page_num_values"].sum())

    from duckdb_parquet_parser.ops.scan import scan_steps

    steps = scan_steps(batch.arrays["page_payload_len"])
    t0 = time.time()
    pd_raw = jax.device_put(batch.arrays["payload"])
    pld = jax.device_put(batch.arrays["page_payload_len"])
    nnd = jax.device_put(batch.arrays["page_nn"])
    # resident serving layout: byte-column stream pre-transposed on device
    # (the layout ResidentColumn keeps; no per-query transpose)
    pd = jax.jit(lambda x: jnp.transpose(x[:, :steps]))(pd_raw)
    jax.block_until_ready((pd, pld, nnd))
    del pd_raw
    t_upload = time.time() - t0

    # ── steady-state scan (marginal cost of one full re-scan) ───────────────
    from duckdb_parquet_parser.ops.bitprog import (
        BitprogUnsupported,
        compile_bitprog,
    )
    from duckdb_parquet_parser.ops.regex import substring_chain

    log(f"scan steps: {steps} (payload pitch {batch.arrays['payload'].shape[1]})")

    def make_scan_for(pattern):
        try:
            prog = compile_bitprog(pattern)
            chain = None
        except BitprogUnsupported:
            prog = None
            chain = substring_chain(pattern)
        # the DFA table is only consumed when bitprog declines; interior-run
        # counter patterns can blow up the subset construction the register
        # machine never needs
        if prog is None:
            d_table, d_accept = (lambda d: (d.table, d.accept))(
                compile_pattern(pattern))
        else:
            d_table = d_accept = None

        @jax.jit
        def f(reps_n, p, pl, n):
            def body(i, acc):
                hits, _ = match_payload_stream(
                    jnp, p, pl, n + (i % 2), d_table, d_accept,
                    use_mxu=True, chain=chain, prog=prog,
                    transposed=True,
                )
                return acc + jnp.sum(hits)
            return jax.lax.fori_loop(0, reps_n, body, jnp.zeros((), jnp.int32))
        return f

    t_first, marg = _marginal(make_scan_for(PATTERN), (pd, pld, nnd),
                              reps_hi=1 + reps)
    out["rows"] = total
    out["scan_rows_per_s"] = total / marg
    _band(out, "scan_sustained", total)
    out["scan_single_call_rows_per_s"] = total / t_first
    out["t"] = dict(open=t_open, prescan=t_prescan, upload=t_upload,
                    single_call=t_first, marginal=marg)
    log(f"scan: sustained {out['scan_rows_per_s']:.3g} rows/s "
        f"(marginal {marg*1000:.1f} ms), single call {total/t_first:.3g} {out['t']}")

    # general-pattern scan (classes — the bit-parallel NFA path, not bitap)
    _, marg_gen = _marginal(make_scan_for(PATTERN_GENERAL), (pd, pld, nnd),
                            reps_hi=1 + reps)
    out["scan_general_rows_per_s"] = total / marg_gen
    _band(out, "scan_general", total)
    log(f"scan general {PATTERN_GENERAL!r}: {total/marg_gen:.3g} rows/s "
        f"(marginal {marg_gen*1000:.1f} ms)")

    # alternation scan (packed registers + bit-sliced masks)
    _, marg_alt = _marginal(make_scan_for(PATTERN_ALT), (pd, pld, nnd),
                            reps_hi=1 + reps)
    out["scan_alternation_rows_per_s"] = total / marg_alt
    _band(out, "scan_alternation", total)
    log(f"scan alternation {PATTERN_ALT!r}: {total/marg_alt:.3g} rows/s "
        f"(marginal {marg_alt*1000:.1f} ms)")

    # WIDE pattern (>31 positions — carry-chained register chunks)
    _, marg_wide = _marginal(make_scan_for(PATTERN_WIDE), (pd, pld, nnd),
                             reps_hi=1 + reps)
    out["scan_wide_rows_per_s"] = total / marg_wide
    _band(out, "scan_wide", total)
    log(f"scan wide {PATTERN_WIDE!r}: {total/marg_wide:.3g} rows/s "
        f"(marginal {marg_wide*1000:.1f} ms)")

    # INTERIOR counted run (prefix register -> anchored counter -> suffix):
    # the _collapse_interior_runs family — `a[0-9]{200}b`-class patterns
    _, marg_int = _marginal(make_scan_for(PATTERN_INTERIOR), (pd, pld, nnd),
                            reps_hi=1 + reps)
    out["scan_interior_run_rows_per_s"] = total / marg_int
    _band(out, "scan_interior_run", total)
    log(f"scan interior-run {PATTERN_INTERIOR!r}: {total/marg_int:.3g} rows/s "
        f"(marginal {marg_int*1000:.1f} ms)")

    # fused multi-pattern serving (ResidentColumn.scan_many): K patterns
    # ride one payload walk — stream + boundary control amortize
    from duckdb_parquet_parser.ops.strings import match_payload_multi

    multi_pats = (PATTERN, PATTERN_GENERAL, PATTERN_ALT)
    matchers = tuple((None, compile_bitprog(p)) for p in multi_pats)

    @jax.jit
    def make_multi(reps_n, p, pl, n):
        def body(i, acc):
            hits, _ = match_payload_multi(
                jnp, p, pl, n + (i % 2), matchers, transposed=True,
            )
            s = acc
            for h in hits:
                s = s + jnp.sum(h)
            return s
        return jax.lax.fori_loop(0, reps_n, body, jnp.zeros((), jnp.int32))

    _, marg_multi = _marginal(make_multi, (pd, pld, nnd), reps_hi=1 + reps)
    out["scan_multi3_pattern_rows_per_s"] = 3 * total / marg_multi
    _band(out, "scan_multi3", 3 * total)
    log(f"scan fused x3 patterns: {3*total/marg_multi:.3g} pattern-rows/s "
        f"(marginal {marg_multi*1000:.1f} ms vs "
        f"{(1/out['scan_rows_per_s']+1/out['scan_general_rows_per_s']+1/out['scan_alternation_rows_per_s'])*total*1000:.1f} ms separate)")

    # length-bucketed serving layout (ResidentColumn's): each bucket walks
    # only to its own max payload length
    from duckdb_parquet_parser.ops.scan import length_buckets

    plen_np = batch.arrays["page_payload_len"]
    kind_np = batch.arrays["page_kind"]
    buckets = length_buckets(np.where(kind_np == 1, 0, plen_np))
    if len(buckets) > 1:
        dev_buckets = []
        for idx, bsteps in buckets:
            dev_buckets.append((
                jax.device_put(np.ascontiguousarray(
                    batch.arrays["payload"][idx][:, :bsteps].T)),
                jax.device_put(np.ascontiguousarray(plen_np[idx])),
                jax.device_put(np.ascontiguousarray(batch.arrays["page_nn"][idx])),
                bsteps,
            ))
        dfa_b = compile_pattern(PATTERN)
        from duckdb_parquet_parser.ops.bitprog import compile_bitprog
        prog_b = compile_bitprog(PATTERN)

        @jax.jit
        def make_bucketed(reps_n, b1, b2):
            def body(i, acc):
                for p, pl, n in (b1, b2):
                    hits, _ = match_payload_stream(
                        jnp, p, pl, n + (i % 2), dfa_b.table, dfa_b.accept,
                        prog=prog_b, transposed=True,
                    )
                    acc = acc + jnp.sum(hits)
                return acc
            return jax.lax.fori_loop(0, reps_n, body, jnp.zeros((), jnp.int32))

        _, marg_b = _marginal(
            make_bucketed,
            (dev_buckets[0][:3], dev_buckets[1][:3]),
            reps_hi=1 + reps,
        )
        out["scan_bucketed_rows_per_s"] = total / marg_b
        _band(out, "scan_bucketed", total)
        log(f"scan bucketed ({[s for _, s in buckets]} steps): "
            f"{total/marg_b:.3g} rows/s (marginal {marg_b*1000:.1f} ms)")
        if out["scan_bucketed_rows_per_s"] > out["scan_rows_per_s"]:
            out["scan_rows_per_s"] = out["scan_bucketed_rows_per_s"]
            _band(out, "scan_sustained", total)  # headline now = this route

    # ── big-page files (pyarrow-default ~1 MB pages): split layout ──────────
    # Real-world files carry ~1 MB pages; the value-boundary split re-chunks
    # them at value starts (ops/scan.split_payload_pages).  Measures the
    # resident serving walk over the segment matrix.
    from duckdb_parquet_parser.ops.scan import split_payload_pages

    bp_batch = ParquetReader(str(gen_bigpage_fixture(out["rows"]))).prescan(
        "l_comment", flags=bindings.PS_PAYLOAD)
    sp_bp = split_payload_pages(bp_batch.arrays)
    if sp_bp is not None:
        sub_bp, slen_bp, snn_bp, _seg_bp = sp_bp
        bsteps = scan_steps(slen_bp)
        bp_payload = jax.jit(lambda x: jnp.transpose(x[:, :bsteps]))(
            jax.device_put(sub_bp))
        bp_len = jax.device_put(np.ascontiguousarray(slen_bp))
        bp_nn = jax.device_put(np.ascontiguousarray(snn_bp))
        jax.block_until_ready((bp_payload, bp_len, bp_nn))
        bp_total = int(bp_batch.arrays["page_num_values"].sum())
        prog_bp = compile_bitprog(PATTERN)
        dfa_bp = compile_pattern(PATTERN)

        @jax.jit
        def make_bp(reps_n, p, pl, n2):
            def body(i, acc):
                hits, _ = match_payload_stream(
                    jnp, p, pl, n2 + (i % 2), dfa_bp.table, dfa_bp.accept,
                    prog=prog_bp, transposed=True)
                return acc + jnp.sum(hits)
            return jax.lax.fori_loop(0, reps_n, body,
                                     jnp.zeros((), jnp.int32))

        _, marg_bp = _marginal(make_bp, (bp_payload, bp_len, bp_nn),
                               reps_hi=1 + reps)
        out["scan_bigpage_rows_per_s"] = bp_total / marg_bp
        _band(out, "scan_bigpage", bp_total)
        log(f"scan big-page split: {bp_total/marg_bp:.3g} rows/s "
            f"(marginal {marg_bp*1000:.2f} ms, "
            f"{sub_bp.shape[0]} segs x {bsteps} steps)")
        del bp_payload, bp_len, bp_nn

    # ── cold one-shot paths (fresh engine each run, min-of-3) ───────────────
    from duckdb_parquet_parser.models.scan import ScanEngine

    def cold_once_path(p, fn, env_off=False, times=None, reps=5):
        import os as _os

        if env_off:
            _os.environ["DPQ_NO_PRUNE"] = "1"
        try:
            best = float("inf")
            for _ in range(reps):
                time.sleep(0.05)
                t0 = time.time()
                fn(ScanEngine(str(p)))
                dt = time.time() - t0
                if times is not None:
                    times.append(dt)
                best = min(best, dt)
            return best
        finally:
            if env_off:
                _os.environ.pop("DPQ_NO_PRUNE", None)

    def cold_once(fn, times=None, reps=5):
        return cold_once_path(path, fn, times=times, reps=reps)

    cold_ts: list = []
    t_cold = cold_once(lambda e: e.cold_scan("l_comment", PATTERN),
                       times=cold_ts)
    out["scan_cold_e2e_rows_per_s"] = total / t_cold
    _host_band(out, "scan_cold_one_shot", cold_ts, total)
    log(f"cold one-shot (fused native): {total/t_cold:.3g} rows/s "
        f"({t_cold*1000:.0f} ms)")
    t_cold_dev = cold_once(lambda e: e.scan_streaming("l_comment", PATTERN),
                           reps=3)
    out["scan_cold_device_rows_per_s"] = total / t_cold_dev
    log(f"cold one-shot (streamed device): {total/t_cold_dev:.3g} rows/s "
        f"({t_cold_dev*1000:.0f} ms)")

    # measurement decomposition for the device cold path: host prescan,
    # host-to-device upload of the payload, and the resident scan marginal
    e = ScanEngine(str(path))
    t0 = time.time()
    cold_b = e.reader.prescan("l_comment", pad_strings=8,
                              flags=bindings.PS_PAYLOAD)
    t_pre = time.time() - t0
    t0 = time.time()
    up = jax.device_put(cold_b.arrays["payload"])
    jax.block_until_ready(up)
    t_up = time.time() - t0
    del up
    mb = cold_b.arrays["payload"].nbytes / 1e6
    out["scan_cold_device_decomp"] = {
        "prescan_ms": round(t_pre * 1000, 1),
        "upload_ms": round(t_up * 1000, 1),
        "payload_mb": round(mb, 1),
        "scan_marginal_ms": round(marg * 1000, 2),
        "ex_transfer_rows_per_s": round(total / max(t_pre + marg, 1e-9), 1),
    }
    log(f"cold device decomposition: prescan {t_pre*1000:.0f} ms + upload "
        f"{t_up*1000:.0f} ms ({mb:.0f} MB) + scan {marg*1000:.1f} ms; "
        f"ex-transfer "
        f"{out['scan_cold_device_decomp']['ex_transfer_rows_per_s']:.3g} rows/s")

    # pruned pages for the record (also validates the scan did real work)
    res_ck = ScanEngine(str(path)).cold_scan("l_comment", PATTERN,
                                             exact_counts=True)
    out["pruned_pages"] = int(len(res_ck.pruned_pages()))
    out["n_pages"] = batch.n_pages

    # ── ColumnIndex stats pruning (anchored-prefix scan on sorted keys) ─────
    # Real-world shape: a key-ordered column (write-time clustering) queried
    # with an anchored prefix; the ColumnIndex lets the cold scan skip pages
    # whose [min,max] cannot hold the prefix — before any decode.
    spath = gen_sorted_fixture(out["rows"])
    t_np = cold_once_path(spath, lambda e: e.cold_scan(
        "s_key", "^user_0009", exact_counts=True), env_off=True, reps=3)
    prune_ts: list = []
    t_pr = cold_once_path(spath, lambda e: e.cold_scan(
        "s_key", "^user_0009", exact_counts=True), times=prune_ts)
    rp = ScanEngine(str(spath)).cold_scan("s_key", "^user_0009",
                                          exact_counts=True)
    out["scan_stats_prune_rows_per_s"] = total / t_pr
    _host_band(out, "scan_stats_prune", prune_ts, total)
    out["scan_stats_prune_decomp"] = {
        "pages_skipped": int(rp.stats_pruned_pages),
        "n_pages": int(len(rp.page_gid)),
        "unpruned_ms": round(t_np * 1000, 1),
        "pruned_ms": round(t_pr * 1000, 1),
        "speedup": round(t_np / max(t_pr, 1e-9), 2),
    }
    log(f"stats-pruned anchored scan: {total/t_pr:.3g} rows/s "
        f"({t_pr*1000:.0f} ms vs {t_np*1000:.0f} ms unpruned; "
        f"{rp.stats_pruned_pages}/{len(rp.page_gid)} pages skipped)")

    # ── read_column (decoded column API, host path) ─────────────────────────
    # Host times vary with neighbours on shared cores: interleave the
    # columns in ROUNDS with breathers so every metric gets samples spread
    # over ~6 s of wall time, then take the per-column min across rounds.
    rc_cols = (("l_quantity", "read_column_i64_rows_per_s"),
               ("l_tax", "read_column_f64opt_rows_per_s"),
               ("l_comment", "read_column_strings_rows_per_s"))
    rc_best = {key: float("inf") for _, key in rc_cols}
    rc_times = {key: [] for _, key in rc_cols}
    rc_len = {}
    for rnd in range(6):
        for col, key in rc_cols:
            time.sleep(0.08)
            t0 = time.time()
            c = reader.read_column(col)
            dt = time.time() - t0
            rc_times[key].append(dt)
            rc_best[key] = min(rc_best[key], dt)
            rc_len[key] = len(c)
    for col, key in rc_cols:
        out[key] = rc_len[key] / rc_best[key]
        _host_band(out, key.replace("_rows_per_s", ""), rc_times[key],
                   rc_len[key])
        log(f"read_column {col}: {out[key]:.3g} rows/s "
            f"({rc_best[key]*1000:.0f} ms)")

    # ── chunked inverted index build (the reference main.cpp workload) ──────
    from duckdb_parquet_parser.ops.index import build_index_for_column

    best_idx = float("inf")
    idx_ts: list = []
    for _ in range(9):
        time.sleep(0.05)
        t0 = time.time()
        cidx = build_index_for_column(reader, "l_comment")
        dt = time.time() - t0
        idx_ts.append(dt)
        best_idx = min(best_idx, dt)
    out["index_build_rows_per_s"] = cidx.num_rows / best_idx
    _host_band(out, "index_build", idx_ts, cidx.num_rows)
    out["index_chunks"] = cidx.num_chunks
    log(f"index build: {out['index_build_rows_per_s']:.3g} rows/s "
        f"({best_idx*1000:.0f} ms, {cidx.num_chunks} chunks)")

    # ── decode: optional DOUBLE (real null materialization work) ────────────
    b2 = reader.prescan("l_tax")
    core2 = {k: jax.device_put(v) for k, v in b2.arrays.items()
             if k in D.DECODE_ARRAYS}
    planes2 = tuple(jax.device_put(p) for p in b2.plain_planes)
    kw = dict(max_def=b2.max_def, out_len=b2.vmax, nn_len=b2.nn_cap,
              mode="plain", def_literal=D.batch_has_literal(b2.arrays, "def"),
              max_null_shift=D.max_nulls_per_page(b2.arrays))

    @jax.jit
    def make_dec(reps_n, c, p):
        def body(i, acc):
            c2 = dict(c)
            # live perturbation (defeats loop hoisting): flips def levels
            # (the materialized plane — the run tables are the fallback)
            c2["def_levels"] = c["def_levels"] ^ (i % 2)
            planes, nonnull = D.decode_fixed(jnp, c2, list(p), [], None, **kw)
            return acc + jnp.sum(nonnull.astype(jnp.int32)) + jnp.sum(
                planes[0] & 1) + jnp.sum(planes[1] & 1)
        return jax.lax.fori_loop(0, reps_n, body, jnp.zeros((), jnp.int32))

    _, marg_dec = _marginal(make_dec, (core2, planes2), reps_hi=1 + reps)
    out["decode_f64opt_rows_per_s"] = total / marg_dec
    _band(out, "decode_f64opt", total)
    out["decode_f64opt_gb_per_s"] = total * 8 / marg_dec / 1e9
    log(f"decode f64-optional: {out['decode_f64opt_rows_per_s']:.3g} rows/s "
        f"({out['decode_f64opt_gb_per_s']:.2f} GB/s, marginal {marg_dec*1000:.1f} ms)")

    # ── dict-heavy decode (value lookup: select / take, ops/dict_lookup.py) ─
    dpath = gen_dict_fixture(out["rows"])
    rd = ParquetReader(str(dpath))
    bd = rd.prescan("k")
    total_d = int(bd.arrays["page_num_values"].sum())
    core_d = {k: jax.device_put(v) for k, v in bd.arrays.items()
              if k in D.DECODE_ARRAYS}
    dplanes = tuple(jax.device_put(p) for p in bd.dict_planes)
    dpp = tuple(jax.device_put(p) for p in bd.dict_planes_pp)
    kwd = dict(max_def=bd.max_def, out_len=bd.vmax, nn_len=bd.nn_cap,
               mode="dict", def_literal=D.batch_has_literal(bd.arrays, "def"),
               idx_literal=D.batch_has_literal(bd.arrays, "idx"),
               max_null_shift=D.max_nulls_per_page(bd.arrays))

    @jax.jit
    def make_dict(reps_n, c, dp, pp):
        def body(i, acc):
            c2 = dict(c)
            c2["idx_vals"] = c["idx_vals"] ^ (i % 2)  # live perturbation
            planes, nonnull = D.decode_fixed(jnp, c2, [], list(dp), None,
                                             dict_planes_pp=list(pp),
                                             **kwd)
            return acc + jnp.sum(nonnull.astype(jnp.int32)) + jnp.sum(
                planes[0] & 1) + jnp.sum(planes[1] & 1)
        return jax.lax.fori_loop(0, reps_n, body, jnp.zeros((), jnp.int32))

    _, marg_dict = _marginal(make_dict, (core_d, dplanes, dpp),
                             reps_hi=1 + reps)
    out["decode_dict_rows_per_s"] = total_d / marg_dict
    _band(out, "decode_dict", total_d)
    log(f"decode dict-heavy (DN=100): {out['decode_dict_rows_per_s']:.3g} "
        f"rows/s (marginal {marg_dict*1000:.1f} ms)")

    # ── dict-encoded STRING scan (low-cardinality column: match each dict
    # entry once on host, map per-row indices through the accept bits on
    # device — O(dict + values), no byte streaming) ──────────────────────────
    from duckdb_parquet_parser.ops.scan import dfa_match

    spath = gen_dict_strings_fixture(out["rows"])
    rs = ParquetReader(str(spath))
    bs = rs.prescan("city", pad_strings=8, flags=bindings.PS_PAYLOAD)
    total_s = int(bs.arrays["page_num_values"].sum())
    dict_pat = "^san.*o-[02]$"
    dfa_s = compile_pattern(dict_pat)
    dmatch = np.asarray(
        dfa_match(np, bs.arrays["dict_padded"], bs.arrays["dict_lens"],
                  dfa_s.table, dfa_s.accept)
    ).astype(np.int32)
    core_s = {k: jax.device_put(v) for k, v in bs.arrays.items()
              if k in D.DECODE_ARRAYS}
    dm_d = jax.device_put(dmatch)
    kws = dict(max_def=bs.max_def, out_len=bs.vmax, nn_len=bs.nn_cap)

    from duckdb_parquet_parser.ops.scan import _map_dict_accepts, batch_dn_max

    dn_max_s = batch_dn_max(bs.arrays)

    @jax.jit
    def make_dscan(reps_n, c, dmx):
        def body(i, acc):
            c2 = dict(c)
            c2["idx_vals"] = c["idx_vals"] ^ (i % 2)  # live perturbation
            nonnull, nn_idx = D.decode_levels(jnp, c2, kws["max_def"],
                                              kws["out_len"])
            dict_idx, ok = D.decode_dict_indices(jnp, c2, nn_idx,
                                                 kws["nn_len"])
            # production mapping (ops/scan._map_dict_accepts): two-stage
            # local accept select on multi-row-group tables
            dm = _map_dict_accepts(jnp, c2, [dmx], dict_idx, dn_max_s)[0] != 0
            return acc + jnp.sum(dm & ok & nonnull)
        return jax.lax.fori_loop(0, reps_n, body, jnp.zeros((), jnp.int32))

    _, marg_ds = _marginal(make_dscan, (core_s, dm_d), reps_hi=1 + reps)
    out["scan_dict_strings_rows_per_s"] = total_s / marg_ds
    _band(out, "scan_dict_strings", total_s)
    log(f"scan dict strings ({dict_pat!r}, DN={int(bs.dims.get('dict_n', 0))}): "
        f"{out['scan_dict_strings_rows_per_s']:.3g} rows/s "
        f"(marginal {marg_ds*1000:.1f} ms)")

    # ── DELTA_BINARY_PACKED: device bit-unpack + prefix-sum decode ──────────
    # (round 5; the reference REJECTS every non-PLAIN/dict encoding, so the
    # multipliers to read against are the engine's own PLAIN decode rates)
    from duckdb_parquet_parser.ops.delta import (
        decode_delta_planes, delta_bws, read_delta_column,
    )

    del_path = gen_delta_fixture(out["rows"])
    rdel = ParquetReader(str(del_path))
    db = rdel.prescan("x", flags=bindings.PS_DELTA_RAW)
    del_total = int(db.arrays["page_nn"].sum())
    del_bws = delta_bws(db.arrays)
    del_dims = {k: int(v) for k, v in db.dims.items()
                if str(k).startswith("delta_")}
    del_core = {k: jax.device_put(np.asarray(v))
                for k, v in db.arrays.items() if k.startswith("delta_")}
    del_nncap, del_np = db.nn_cap, 2

    @jax.jit
    def make_delta(reps_n, c):
        def body(i, acc):
            c2 = dict(c)
            # perturb the packed bytes so XLA cannot hoist the unpack
            c2["delta_bytes"] = c["delta_bytes"] ^ (i % 2).astype(jnp.uint8)
            planes = decode_delta_planes(jnp, c2, del_dims, del_bws,
                                         del_nncap, del_np)
            return acc + jnp.sum(planes[0] & 1) + jnp.sum(planes[1] & 1)
        return jax.lax.fori_loop(0, reps_n, body, jnp.zeros((), jnp.int32))

    _, marg_del = _marginal(make_delta, (del_core,), reps_hi=1 + reps)
    out["decode_delta_i64_rows_per_s"] = del_total / marg_del
    _band(out, "decode_delta_i64", del_total)
    log(f"decode delta-i64 (device unpack+cumsum, widths {list(del_bws)}): "
        f"{out['decode_delta_i64_rows_per_s']:.3g} rows/s "
        f"(marginal {marg_del*1000:.1f} ms)")
    best_drc, drc_ts = float("inf"), []
    for _ in range(5):
        time.sleep(0.05)
        t0 = time.time()
        c = ParquetReader(str(del_path)).read_column("x")
        dt = time.time() - t0
        drc_ts.append(dt)
        best_drc = min(best_drc, dt)
    out["read_column_delta_i64_rows_per_s"] = len(c) / best_drc
    _host_band(out, "read_column_delta_i64", drc_ts, len(c))
    log(f"read_column delta-i64 (host e2e): "
        f"{out['read_column_delta_i64_rows_per_s']:.3g} rows/s "
        f"({best_drc*1000:.0f} ms)")
    del del_core

    # ── selective dict pattern: all-miss short-circuit (cold path) ──────────
    # A positive pattern matching ZERO dictionary entries skips the per-page
    # index-run walk entirely (dpq_scan.hpp round 5); DPQ_NO_DICT_SKIP=1 is
    # the A/B control.
    sel_pat = "zurich"  # matches no city
    def cold_dict(env_off):
        import os as _os
        if env_off:
            _os.environ["DPQ_NO_DICT_SKIP"] = "1"
        try:
            best, ts = float("inf"), []
            for _ in range(5):
                time.sleep(0.05)
                t0 = time.time()
                ScanEngine(str(spath)).cold_scan("city", sel_pat)
                dt = time.time() - t0
                ts.append(dt)
                best = min(best, dt)
            return best, ts
        finally:
            if env_off:
                _os.environ.pop("DPQ_NO_DICT_SKIP", None)
    t_walk, _ = cold_dict(True)
    t_skip, skip_ts = cold_dict(False)
    res_sel = ScanEngine(str(spath)).cold_scan("city", sel_pat)
    out["scan_dict_selective_rows_per_s"] = total_s / t_skip
    _host_band(out, "scan_dict_selective", skip_ts, total_s)
    out["scan_dict_selective_decomp"] = {
        "pages_skipped": int(res_sel.dict_skipped_pages),
        "n_pages": int(len(res_sel.page_gid)),
        "walk_ms": round(t_walk * 1000, 1),
        "skip_ms": round(t_skip * 1000, 1),
        "speedup": round(t_walk / max(t_skip, 1e-9), 2),
    }
    log(f"selective dict cold scan ({sel_pat!r}): "
        f"{out['scan_dict_selective_rows_per_s']:.3g} rows/s "
        f"({t_skip*1000:.1f} ms skip vs {t_walk*1000:.1f} ms walk; "
        f"{res_sel.dict_skipped_pages}/{len(res_sel.page_gid)} pages "
        f"short-circuited)")
    return out


def gpu_device_info() -> dict:
    """Platform, device kind, device count and the card's name and power
    limit; exits when JAX finds no GPU (no CPU fallback)."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench: no GPU (JAX backend: {devs[0].platform})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[0].strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card}


def _best_ms(fn, reps: int) -> float:
    """Min host-clock ms of `fn()` over `reps` calls (each ends in
    block_until_ready); the first, compiling call is not counted."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def resident_pairs(rc, reps: int, pairs: int) -> dict:
    """The whole resident chain query (`rc.scan`: host pattern compile and
    dictionary match, dispatch, fetch) on the kernel route and on the walk
    route, in `pairs` pairs whose order alternates; each sample is the best
    of `reps`.  Run twice: as shipped, and with the host pattern compile
    (`device_matchers`) memoized, which shows the routes' gap without the
    compile's noise.  Returns medians, interquartile ranges and how many
    pairs the kernel route won."""
    import functools

    from duckdb_parquet_parser.ops import scan as S
    from duckdb_parquet_parser.ops import strings

    real_route, real_step = strings.use_stream_kernel, S._device_scan_step
    real_matchers = S.device_matchers
    build = real_step.__wrapped__

    def routed(route):
        # one compiled step per route; the route is read at trace time
        def use():
            strings.use_stream_kernel = lambda: route == "kernel"

        @functools.lru_cache(maxsize=None)
        def step(*a, **k):
            f = build(*a, **k)

            def call(*args):
                use()
                return f(*args)
            return call
        return use, step

    routes = {r: routed(r) for r in ("kernel", "walk")}
    out = {}
    try:
        for variant, matchers in (
                ("", real_matchers),
                ("_memo", functools.lru_cache(maxsize=None)(real_matchers))):
            S.device_matchers = matchers
            t = {"kernel": [], "walk": []}
            for i in range(pairs):
                order = ("kernel", "walk") if i % 2 == 0 else ("walk", "kernel")
                for route in order:
                    use, step = routes[route]
                    use()
                    S._device_scan_step = step
                    t[route].append(_best_ms(
                        lambda: rc.scan(PATTERN).match_counts, reps))
            k, w = np.asarray(t["kernel"]), np.asarray(t["walk"])
            key = f"resident_chain{variant}"
            for route, x in (("kernel", k), ("walk", w)):
                out[f"{key}_{route}_median_ms"] = float(np.median(x))
                out[f"{key}_{route}_iqr_ms"] = [
                    float(np.percentile(x, 25)), float(np.percentile(x, 75))]
            out[f"{key}_kernel_wins"] = int((k < w).sum())
            log(f"resident chain{variant} e2e: kernel {t['kernel']} ms, "
                f"walk {t['walk']} ms")
    finally:
        strings.use_stream_kernel = real_route
        S._device_scan_step = real_step
        S.device_matchers = real_matchers
    out["resident_pairs"] = pairs
    return out


def bench_kernel_ab(path: Path, reps: int, pairs: int = 20) -> dict:
    """The hand-written streaming kernel against what XLA makes of the
    plain lax.scan walk, on ResidentColumn's bucket layout of `path`, in
    turns (kernel, walk, walk, kernel); then the whole resident query on
    each route in `pairs` alternating pairs (resident_pairs); the kernel's
    launch shape and the walk's unroll; and `take` for the 4,096-entry
    dictionary column."""
    import jax
    import jax.numpy as jnp

    from duckdb_parquet_parser.host.reader import ParquetReader
    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops import scan as S
    from duckdb_parquet_parser.ops import strings
    from duckdb_parquet_parser.ops.bitprog import compile_bitprog
    from duckdb_parquet_parser.ops.pallas.stream_matcher import (
        match_stream_kernel,
    )

    out: dict = {}
    rc = ScanEngine(str(path)).resident("l_comment")
    buckets = [(steps, payload, plen, core["page_nn"])
               for _idx, steps, core, payload, plen in rc._buckets]
    out["buckets"] = [[int(p.shape[1]), st] for st, p, _, _ in buckets]

    def specs_of(patterns):
        return [strings._resolve_transition(jnp, None, None, False, None,
                                            compile_bitprog(p))
                for p in patterns]

    steps_of = [b[0] for b in buckets]
    arrays = [b[1:] for b in buckets]

    def walk_fn(specs, kernel, **kw):
        @jax.jit
        def f(arrs):
            tot = jnp.zeros((), jnp.int32)
            for steps, (p, pl, nn) in zip(steps_of, arrs):
                if kernel:
                    hits, _ = match_stream_kernel(p, steps, pl, nn, specs,
                                                  **kw)
                else:
                    hits, _ = strings._match_stream_multi(
                        jnp, p, pl, nn, specs, steps, True)
                for h in hits:
                    tot = tot + jnp.sum(h)
            return tot
        return lambda: f(arrays)

    for name, pats in (("chain", [PATTERN]), ("classes", [PATTERN_GENERAL]),
                       ("fused3", [PATTERN, PATTERN_GENERAL, PATTERN_ALT])):
        specs = specs_of(pats)
        k = walk_fn(specs, True)
        w = walk_fn(specs, False)
        times = {"kernel": [], "walk": []}
        for route, fn in (("kernel", k), ("walk", w), ("walk", w),
                          ("kernel", k)):
            times[route].append(_best_ms(fn, reps))
        if int(np.asarray(k())) != int(np.asarray(w())):
            raise SystemExit(f"kernel/walk disagree on {name}")
        out[f"stream_{name}_kernel_ms"] = min(times["kernel"])
        out[f"stream_{name}_walk_ms"] = min(times["walk"])
        log(f"stream {name}: kernel {times['kernel']} ms, "
            f"walk {times['walk']} ms")

    specs = specs_of([PATTERN])
    for block, warps in ((64, 2), (128, 4), (256, 4), (256, 8), (512, 8)):
        ms = _best_ms(walk_fn(specs, True, block=block, num_warps=warps),
                      reps)
        out[f"kernel_block{block}_warps{warps}_ms"] = ms
        log(f"kernel block={block} warps={warps}: {ms:.3f} ms")
    for unroll in (1, 8, 32):
        strings.SCAN_UNROLL = unroll
        ms = _best_ms(walk_fn(specs, False), reps)
        out[f"walk_unroll{unroll}_ms"] = ms
        log(f"walk unroll={unroll}: {ms:.3f} ms")
    strings.SCAN_UNROLL = 8

    out.update(resident_pairs(rc, reps, pairs))
    # host share of that query: compiling the pattern's matchers
    out["resident_chain_matchers_ms"] = _best_ms(
        lambda: S.device_matchers(PATTERN), reps)

    # dictionary value lookup above the select limit: take at the fixture's
    # [pages, values] index shape, over one row group's 4,096-entry
    # dictionary (local indices) and over the file's concatenated one
    b = ParquetReader(str(path)).prescan("l_dictkey")
    iv = np.asarray(b.arrays["idx_vals"]).astype(np.int32)
    local = np.clip(iv, 0, DICT_KEYS - 1)
    dn = int(b.dict_planes[0].shape[0])
    glob = np.clip(np.asarray(b.arrays["page_dict_base"])[:, None] + local,
                   0, dn - 1).astype(np.int32)
    take = jax.jit(lambda ps, g: [jnp.take(p, g) for p in ps])
    for key, planes, gidx in (
            ("dict_take_dn4096_ms", [p[:DICT_KEYS] for p in b.dict_planes],
             local),
            ("dict_take_global_ms", b.dict_planes, glob)):
        ps = [jax.device_put(np.ascontiguousarray(p)) for p in planes]
        g = jax.device_put(gidx)
        out[key] = _best_ms(lambda: take(ps, g), reps)
        log(f"{key}: DN={int(planes[0].shape[0])} over {gidx.size} values: "
            f"{out[key]:.3f} ms")
    out["dict_take_values"] = int(iv.size)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--kernel-ab", action="store_true",
                    help="only the kernel-vs-XLA timings (bench_kernel_ab)")
    ap.add_argument("--pairs", type=int, default=20,
                    help="--kernel-ab: alternating end-to-end query pairs")
    args = ap.parse_args()
    if args.quick:
        args.rows, args.reps = 200_000, 3

    device = gpu_device_info()
    from duckdb_parquet_parser.utils.jax_setup import enable_compile_cache

    enable_compile_cache()
    if args.kernel_ab:
        path = gen_fixture(args.rows, dict_column=True)
        ab = bench_kernel_ab(path, args.reps, args.pairs)
        print(json.dumps({"kernel_ab": ab, "rows": args.rows,
                          "device": device}), flush=True)
        return

    path = gen_fixture(args.rows)
    # warm the page cache so both sides measure decode work, not disk
    # (the reference's repetition loop benefits identically)
    with open(path, "rb") as f:
        while f.read(1 << 24):
            pass
    ref = bench_reference(path, max(args.reps, 1))
    eng = bench_engine(path, args.reps)

    value = eng.get("scan_rows_per_s", 0.0)
    baseline = ref.get("ref_iter_rows_per_s")
    vs = value / baseline if baseline else None
    line = {
        "metric": "decode_regex_scan_rows_per_s",
        "value": round(value, 1),
        "unit": "rows/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "device": device,
    }
    detail = {**ref, **{k: v for k, v in eng.items() if k != "t"}}
    if baseline:
        detail["vs_ref"] = {
            "scan_sustained": round(eng["scan_rows_per_s"] / baseline, 1),
            "scan_cold_one_shot": round(
                eng["scan_cold_e2e_rows_per_s"] / baseline, 1),
            "read_column_i64": round(
                eng["read_column_i64_rows_per_s"]
                / ref["ref_column_i64_rows_per_s"], 1),
            "read_column_f64opt": round(
                eng["read_column_f64opt_rows_per_s"]
                / ref["ref_column_f64opt_rows_per_s"], 1),
            "read_column_strings": round(
                eng["read_column_strings_rows_per_s"] / baseline, 1),
        }
        if "ref_index_rows_per_s" in ref:
            detail["vs_ref"]["index_build"] = round(
                eng["index_build_rows_per_s"] / ref["ref_index_rows_per_s"], 1)
    log(json.dumps({"detail": detail}))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
