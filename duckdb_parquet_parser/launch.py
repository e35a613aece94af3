"""Multi-host launch entrypoint: one command that forms the process group,
builds the global mesh, and runs the distributed scan / index build /
scaling bench unmodified on a real slice.

One process drives every card of its host:

    python -m duckdb_parquet_parser.launch scan data.parquet comment 'a.*b'

Across hosts, run THE SAME command on every host with an explicit
rendezvous (any backend; the localhost CPU smoke test in
tests/test_multihost.py runs exactly this way; see the README "Multi-host
launch" runbook):

    DPQ_COORDINATOR=host0:8476 DPQ_NUM_PROCESSES=2 DPQ_PROCESS_ID=<i> \
        python -m duckdb_parquet_parser.launch index data.parquet comment

Every process must see the parquet file at the same path (shared FS or a
per-host copy).  Results print on process 0 only; the exit code is shared.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duckdb_parquet_parser.launch",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_scan = sub.add_parser("scan", help="distributed regex page scan")
    p_scan.add_argument("file")
    p_scan.add_argument("column")
    p_scan.add_argument("pattern")
    p_scan.add_argument("--negate", action="store_true")

    p_idx = sub.add_parser("index", help="distributed chunked-index build")
    p_idx.add_argument("file")
    p_idx.add_argument("column")
    p_idx.add_argument("--chunk-size", type=int, default=4096)

    p_sb = sub.add_parser("scaling-bench",
                          help="scaling harness over the global mesh")
    p_sb.add_argument("--rows", type=int, default=60_000)
    p_sb.add_argument("--pattern", default="alpha.*bravo")
    p_sb.add_argument("--reps", type=int, default=5)

    args = ap.parse_args(argv)

    import os

    import jax

    plat = os.environ.get("DPQ_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)

    from .parallel.mesh import distributed_init_from_env, make_mesh

    formed = distributed_init_from_env()
    n_proc = jax.process_count()
    pid = jax.process_index()
    devs = jax.devices()
    if pid == 0:
        print(
            f"[launch] processes={n_proc} (group={'yes' if formed else 'no'})"
            f" global_devices={len(devs)} backend={jax.default_backend()}",
            file=sys.stderr,
        )

    if args.cmd == "scaling-bench":
        from . import scaling_bench

        sb_argv = ["--rows", str(args.rows), "--pattern", args.pattern,
                   "--reps", str(args.reps)]
        if n_proc > 1:
            # multi-controller meshes must span every process: run the
            # full-mesh size only
            sb_argv += ["--sizes", str(len(devs))]
        old = sys.argv
        sys.argv = ["scaling_bench"] + sb_argv
        try:
            return scaling_bench.main()
        finally:
            sys.argv = old

    mesh = make_mesh(len(devs))
    from .models.scan import ScanEngine

    if args.cmd == "scan":
        eng = ScanEngine(args.file, mesh=mesh)
        res = eng.scan(args.column, args.pattern, negate=args.negate)
        if pid == 0:
            out = {
                "cmd": "scan",
                "devices": len(devs),
                "processes": n_proc,
                "pages": int(len(res.page_gid)),
                "surviving_pages": int(len(res.surviving_pages())),
                "total_matches": int(res.totals[0]),
                "total_values": int(res.totals[1]),
            }
            print(json.dumps(out))
        return 0

    if args.cmd == "index":
        from .host.reader import ParquetReader
        from .parallel.index_build import distributed_index_build

        reader = ParquetReader(args.file)
        res = distributed_index_build(mesh, reader, args.column,
                                      chunk_size=args.chunk_size)
        if pid == 0:
            n_entries = sum(len(r) for r in res.received)
            out = {
                "cmd": "index",
                "devices": len(devs),
                "processes": n_proc,
                "tuples": n_entries,
                "chunks": int(len(res.index.chunk_starts)),
                "skew": round(res.skew_factor, 3),
                "exchange_mode": res.exchange_mode,
                "capacity_ratio": round(
                    res.exchange_planned_slots / max(n_entries, 1), 3),
            }
            print(json.dumps(out))
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
