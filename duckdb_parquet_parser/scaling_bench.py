"""Scaling-efficiency harness: the sharded scan step at N = 1/2/4/8 devices.

Runs the full distributed pipeline (byte-balanced shards, shard_map scan with
psum totals) per mesh size and emits one JSON line with rows/s and efficiency
per N — the BASELINE.md scaling table.  The harness is hardware-agnostic:

  * on the GPUs of a host, `jax.devices()` are cards and the numbers are
    device scaling (not measured yet);
  * on a VIRTUAL CPU mesh (DPQ_SCALING_PLATFORM=cpu +
    xla_force_host_platform_device_count) wall-clock efficiency is bounded
    by the physical core count, so the line also reports the load-balance
    skew and per-shard work split, which ARE meaningful there (the
    platform field says which regime ran).

Usage: python -m duckdb_parquet_parser.scaling_bench [--rows N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=60_000)
    ap.add_argument("--pattern", default="alpha.*bravo")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sizes", default="",
                    help="comma-separated mesh sizes (default 1,2,4,8 "
                         "clipped to the device count; multi-controller "
                         "launches must pass the full global count)")
    args = ap.parse_args()

    import os

    import jax

    # DPQ_SCALING_PLATFORM=cpu runs the harness on a virtual CPU mesh
    plat = os.environ.get("DPQ_SCALING_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)

    import numpy as np

    from .host import bindings
    from .host.reader import ParquetReader
    from .parallel.mesh import Mesh, PAGES_AXIS

    devs = jax.devices()
    if args.sizes:
        sizes = [int(x) for x in args.sizes.split(",") if x]
    else:
        sizes = [n for n in (1, 2, 4, 8) if n <= len(devs)]

    import tempfile

    from .host.schema import ParquetType
    from .host.writer import ColumnSpec, ParquetWriter

    rng = np.random.default_rng(1)
    words = [b"alpha", b"bravo", b"gamma", b"delta", b"kappa", b"sigma"]
    path = tempfile.mktemp(suffix=".parquet", prefix="dpq_scaling_")
    w = ParquetWriter(
        path, [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    done = 0
    while done < args.rows:
        n = min(20_000, args.rows - done)
        vals = [b" ".join(words[int(k)] for k in rng.integers(0, 6, 4))
                for _ in range(n)]
        w.write_row_group({"s": vals})
        done += n
    w.close()

    import jax.numpy as jnp

    from .ops.regex import compile_pattern, substring_chain
    from .parallel.partition import (
        assign_balanced_equal,
        pad_pages,
        reorder_pages,
    )
    from .parallel.pipeline import _make_scan_step, core_arrays
    from .ops.scan import dfa_match

    reader = ParquetReader(path)
    dfa = compile_pattern(args.pattern)
    rows = []
    base = None
    for n in sizes:
        mesh = Mesh(np.array(devs[:n]), (PAGES_AXIS,))
        batch = reader.prescan(
            "s", pad_strings=8,
            flags=bindings.PS_HOST_STRINGS | bindings.PS_PAYLOAD,
        )
        padded = pad_pages(batch, n)
        weights = padded.arrays["page_payload_len"].astype(np.int64) + 16
        weights = np.where(padded.arrays["page_num_values"] > 0, weights, 0)
        padded = reorder_pages(padded, assign_balanced_equal(weights, n).order)

        arrays = padded.arrays
        dict_match = np.zeros(1, bool)
        if int(padded.dims.get("dict_n", 0)) > 0 and "dict_padded" in arrays:
            dict_match = np.asarray(dfa_match(
                np, arrays["dict_padded"], arrays["dict_lens"],
                dfa.table, dfa.accept,
            ))
        core = {k: jnp.asarray(v) for k, v in core_arrays(padded).items()}
        payload = jnp.asarray(arrays["payload"])
        plen = jnp.asarray(arrays["page_payload_len"])
        dm = jnp.asarray(dict_match)
        chain = substring_chain(args.pattern)
        step = _make_scan_step(
            mesh, tuple(sorted(core)), padded.vmax, padded.nn_cap,
            padded.max_def, False,
            np.ascontiguousarray(dfa.table, np.int32).tobytes(),
            dfa.table.shape,
            np.ascontiguousarray(dfa.accept, bool).tobytes(),
            tuple(chain) if chain else None,
        )
        # device-step timing: data resident, min-of-reps wall per step
        counts, values, totals = step(core, payload, plen, dm)
        jax.block_until_ready(counts)
        t_best = float("inf")
        for _ in range(args.reps):
            t0 = time.time()
            counts, values, totals = step(core, payload, plen, dm)
            jax.block_until_ready(counts)
            t_best = min(t_best, time.time() - t0)
        total_rows = int(np.asarray(totals)[1])
        rate = total_rows / t_best
        if base is None:
            base = rate
        # per-shard value split (meaningful even on a virtual mesh)
        vc = np.asarray(values)
        shard = vc.reshape(n, -1).sum(axis=1)
        skew = float(shard.max() / max(shard.mean(), 1.0))
        # COMPUTE-based efficiency: what independent devices would deliver
        # given this sharding — per-device cost ∝ its shard's payload bytes
        # (the walk's work is proportional to its bytes), so efficiency =
        # total work / (n × slowest shard).  On the virtual CPU mesh the
        # WALL column is bounded by physical cores and reads low; this
        # column is the signal the sharding controls.
        sb = weights[assign_balanced_equal(weights, n).order].reshape(n, -1) \
            .sum(axis=1).astype(np.float64)
        eff_compute = float(sb.sum() / max(n * sb.max(), 1.0))
        rows.append({
            "devices": n,
            "rows_per_s": round(rate, 1),
            "efficiency_wall": round(rate / (base * n), 3),
            "efficiency_compute": round(eff_compute, 3),
            "shard_value_skew": round(skew, 3),
        })

    out = {
        "metric": "scan_scaling",
        "platform": jax.default_backend(),
        "note": (
            "virtual CPU mesh: efficiency_wall is bounded by physical cores "
            "— efficiency_compute (work balance across shards) and "
            "shard_value_skew are the signals the sharding controls"
            if jax.default_backend() == "cpu"
            else "real device mesh"
        ),
        "table": rows,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
