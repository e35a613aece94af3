"""Distributed chunked-index build: SHARDED device decode -> boundary plan ->
salted, block-pipelined all_to_all entry shuffle -> per-device chunk
ownership (BASELINE configs[4]; loop being parallelized:
reference src/main.cpp:21-32 over src/reader/parquet_reader.cpp:347-465).

Pipeline (mesh = 1-D 'pages' axis):
  1. PER-SHARD DECODE (device, shard_map): each device turns its page shard's
     raw payload into the (row, len) emission stream — definition levels,
     PLAIN length prefixes, and dictionary lengths (via the gather-free
     dict_lookup) all decode on-device; the host only compacts the fetched
     per-shard masks.  Page blocks pipeline: block i+1's decode is dispatched
     while block i's results transfer back (JAX async dispatch).
  2. chunk boundaries come from the greedy prefix-sum recurrence (exact
     reference flush-before-append semantics, ops/index.py) on the host;
  3. chunk -> device ownership is SALTED (parallel/shuffle.py): hot chunks
     split across devices so one key can neither overload a device nor
     inflate the padded all_to_all capacity;
  4. entries exchange to their owners in fixed-capacity blocks: the
     collective for block i is in flight while the host packs block i+1
     (decode/pack <-> exchange overlap, SURVEY.md §2.1);
  5. owners hold (row, len, chunk) triples for their chunks — chunk text
     materializes on demand via ChunkedIndex.materialize_chunk.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..ops.index import ChunkedIndex, build_index
from .mesh import PAGES_AXIS
from .mesh import to_global_numpy
from .shuffle import ExchangePlan, SaltedOwnership, salted_chunk_owners


@dataclass
class DistributedIndexResult:
    index: ChunkedIndex
    chunk_owners: np.ndarray          # [num_chunks] primary owner device
    salted: SaltedOwnership           # full (possibly multi-device) ownership
    received: list[np.ndarray]        # per device: [k, 3] (row, len, chunk)
    shuffle_bytes: int                # payload bytes moved by the exchange
    skew_factor: float                # max/mean device load (bytes)
    exchange_capacity: int            # rows per (src,dst) bucket (padded) or
                                      # per destination (ragged), per block
    n_exchange_blocks: int
    exchange_mode: str = "padded"     # "ragged" | "padded"
    exchange_planned_slots: int = 0   # total receive slots the compiled
                                      # shapes reserve (capacity-ratio
                                      # numerator vs true entry count)


@functools.lru_cache(maxsize=16)
def _emissions_step(mesh, core_keys, vmax, nn_cap, max_def, has_payload,
                    has_dict):
    """shard_map'd per-page emission decode: (lens [N, V] i32, emit [N, V]
    bool) with values addressed by position within the page."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops import decode as _decode
    from ..ops.expand import take2d
    from ..ops.dict_lookup import dict_lookup
    from ..ops.strings import string_offsets

    def local(core, payload, dict_lens):
        nonnull, nn_idx = _decode.decode_levels(jnp, core, max_def, vmax)
        gidx = jnp.clip(nn_idx, 0, nn_cap - 1)
        if has_payload:
            _offs, lens_rank = string_offsets(
                jnp, payload, core["page_nn"], nn_cap
            )
            plens = take2d(jnp, lens_rank, gidx)
        else:
            plens = jnp.zeros_like(nonnull, jnp.int32)
        is_dict = (core["page_kind"] == 1)[:, None]
        if has_dict:
            dict_idx, ok = _decode.decode_dict_indices(jnp, core, nn_idx,
                                                       nn_cap, nonnull=nonnull)
            dn = dict_lens.shape[0]
            g = jnp.clip(
                core["page_dict_base"][:, None] + jnp.clip(dict_idx, 0, None),
                0, dn - 1,
            )
            dlens = dict_lookup(jnp, [dict_lens], g)[0]
            emit = jnp.where(is_dict, nonnull & ok, nonnull)
            lens = jnp.where(is_dict, dlens, plens)
        else:
            emit = nonnull & ~is_dict
            lens = plens
        return lens.astype(jnp.int32), emit

    spec_pages = {k: P(PAGES_AXIS) for k in core_keys}
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec_pages, P(PAGES_AXIS), P()),
        out_specs=(P(PAGES_AXIS), P(PAGES_AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_emissions(mesh, batch, block_pages: int = 0,
                      fleet=None, fault_hook=None):
    """Decodes the (row, len) emission stream with per-shard device decode.

    Returns (pos [M] i64 absolute rows, lens [M] i64), in row order.
    `block_pages` > 0 splits the batch into fixed-shape page blocks whose
    decodes pipeline (block i+1 dispatched while block i transfers back).

    Elastic: `fault_hook(block_idx, lens, emit) -> iterable of failed
    device ids` is the detection seam (same contract as
    elastic_distributed_scan); a failed device's block shard re-decodes on
    the surviving devices — decode is stateless, so the recomputed block
    is bit-identical."""
    import jax.numpy as jnp

    from ..ops import decode as _decode
    from .partition import pad_pages

    n_dev = int(np.prod(list(mesh.shape.values())))
    if block_pages <= 0:
        block_pages = batch.n_pages
    block_pages = max(-(-block_pages // n_dev) * n_dev, n_dev)

    padded = pad_pages(batch, block_pages)
    arrays = padded.arrays
    has_payload = "payload" in arrays
    has_dict = int(padded.dims.get("dict_n", 0)) > 0
    dict_lens = jnp.asarray(
        arrays["dict_lens"] if has_dict else np.zeros(1, np.int32)
    )
    core_keys = tuple(sorted(
        k for k in _decode.DECODE_ARRAYS if k in arrays
    ))
    step = _emissions_step(
        mesh, core_keys, padded.vmax, padded.nn_cap, padded.max_def,
        has_payload, has_dict,
    )

    def block_inputs(lo, hi, pad_to):
        core = {k: arrays[k][lo:hi] for k in core_keys}
        payload = (arrays["payload"][lo:hi] if has_payload
                   else np.zeros((hi - lo, 8), np.uint8))
        if pad_to > hi - lo:
            pad = pad_to - (hi - lo)
            core = {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
                    for k, v in core.items()}
            payload = np.pad(payload, ((0, pad), (0, 0)))
        return ({k: jnp.asarray(v) for k, v in core.items()},
                jnp.asarray(payload))

    pending = []
    for lo in range(0, padded.n_pages, block_pages):
        hi = lo + block_pages
        core, payload = block_inputs(lo, hi, block_pages)
        pending.append((lo, step(core, payload, dict_lens)))

    pos_parts, len_parts = [], []
    row_start = arrays["page_row_start"]
    for blk, (lo, (lens_d, emit_d)) in enumerate(pending):
        lens = to_global_numpy(lens_d)
        emit = to_global_numpy(emit_d)
        if fault_hook is not None:
            failed = set(map(int, fault_hook(blk, lens, emit)))
            if failed and fleet is not None:
                for d in failed:
                    fleet.mark_failed(d)
                from .mesh import survivor_mesh

                live = fleet.live_devices
                sub_mesh = survivor_mesh(mesh, live)
                sub_bp = max(-(-block_pages // len(live)) * len(live),
                             len(live))
                sub_step = _emissions_step(
                    sub_mesh, core_keys, padded.vmax, padded.nn_cap,
                    padded.max_def, has_payload, has_dict,
                )
                core, payload = block_inputs(
                    lo, min(lo + block_pages, padded.n_pages), sub_bp)
                lens_d2, emit_d2 = sub_step(core, payload, dict_lens)
                lens = to_global_numpy(lens_d2)[:block_pages]
                emit = to_global_numpy(emit_d2)[:block_pages]
        pages, rows = np.nonzero(emit[:len(row_start) - lo])
        pos_parts.append(row_start[lo + pages] + rows)
        len_parts.append(lens[pages, rows].astype(np.int64))
    pos = np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.int64)
    lens = np.concatenate(len_parts) if len_parts else np.zeros(0, np.int64)
    order = np.argsort(pos, kind="stable")
    return pos[order], lens[order]


def distributed_index_build(mesh, reader, column: str,
                            chunk_size: int = 4096,
                            block_pages: int = 8192,
                            entry_block: int = 262144,
                            salt_threshold: float = 2.0,
                            fleet=None,
                            fault_hook=None) -> DistributedIndexResult:
    from ..host import bindings
    from .pipeline import exchange_entries

    n_devices = int(np.prod(list(mesh.shape.values())))
    batch = reader.prescan(column, pad_strings=8, flags=bindings.PS_PAYLOAD)

    if fault_hook is not None and fleet is None:
        from .elastic import FleetState

        fleet = FleetState(
            weights=np.ones(max(batch.n_pages, 1), np.int64),
            n_devices=n_devices,
        )

    # 1. sharded decode (device) -> emission stream (elastic: a failed
    # device's block shard re-decodes on the survivors — see
    # sharded_emissions)
    pos, lens = sharded_emissions(mesh, batch, block_pages=block_pages,
                                  fleet=fleet, fault_hook=fault_hook)

    # 2. boundary plan (host, exact reference semantics)
    index = build_index(pos, lens, reader.num_rows(), chunk_size)

    # 3. salted ownership (hot in bytes OR entry count)
    chunk_bytes = _chunk_bytes(index, lens)
    chunk_entries = np.zeros(index.chunk_starts.shape[0], np.int64)
    np.add.at(chunk_entries, index.chunk_of_entry, 1)
    salted = salted_chunk_owners(chunk_bytes, n_devices, salt_threshold,
                                 chunk_entries=chunk_entries)
    dst = salted.entry_destinations(index.chunk_of_entry)
    src = (np.arange(len(dst)) * n_devices) // max(len(dst), 1)
    payload = np.stack([pos, lens, index.chunk_of_entry], axis=1).astype(np.int64)

    # 4. block-pipelined exchange at ONE compiled capacity: the collective for
    # block i is in flight while the host packs block i+1.  Default mode is
    # the exact-size ragged exchange (planned slots ~= max/mean over
    # DESTINATIONS); "padded" keeps the dense [D, D, cap] buckets.
    from ..utils.config import get_config

    cfg = get_config()
    slack = cfg.exchange_capacity_slack
    ragged = cfg.exchange_mode != "padded"
    m = len(dst)
    blocks = [(lo, min(lo + entry_block, m)) for lo in range(0, m, entry_block)]
    in_flight = []
    shuffle_bytes = 0
    if ragged:
        from .pipeline import ragged_exchange_entries
        from .shuffle import RaggedExchangePlan

        plans = [
            RaggedExchangePlan.plan(dst[lo:hi], src[lo:hi], n_devices)
            for lo, hi in blocks
        ]
        send_cap = max((p.send_cap for p in plans), default=1)
        cap = max((p.recv_cap for p in plans), default=1)
        for (lo, hi), plan in zip(blocks, plans):
            plan.send_cap, plan.recv_cap = send_cap, cap
            shuffle_bytes += n_devices * send_cap * payload.shape[1] * 8
            in_flight.append(
                ragged_exchange_entries(mesh, plan, payload[lo:hi],
                                        fill=-1, block=False))
        received = [[] for _ in range(n_devices)]
        for recv, plan in zip(in_flight, plans):
            rows = to_global_numpy(recv)
            for d in range(n_devices):
                received[d].append(rows[d, : int(plan.recv_total[d])])
        planned_slots = n_devices * cap * len(blocks)
    else:
        plans = [
            ExchangePlan.plan(dst[lo:hi], src[lo:hi], n_devices,
                              capacity_slack=slack)
            for lo, hi in blocks
        ]
        cap = max((p.capacity for p in plans), default=1)
        for (lo, hi), plan in zip(blocks, plans):
            plan.capacity = cap
            send = plan.build_send_buffer(payload[lo:hi], src[lo:hi], fill=-1)
            shuffle_bytes += send.nbytes
            in_flight.append(exchange_entries(mesh, send, block=False))

        received = [[] for _ in range(n_devices)]
        for recv in in_flight:
            rows = to_global_numpy(recv).reshape(n_devices, -1, 3)
            for d in range(n_devices):
                got = rows[d]
                received[d].append(got[got[:, 0] >= 0])
        planned_slots = n_devices * n_devices * cap * len(blocks)
    received = [
        np.concatenate(parts) if parts else np.zeros((0, 3), np.int64)
        for parts in received
    ]

    loads = np.zeros(n_devices, np.int64)
    for d in range(n_devices):
        loads[d] = received[d][:, 1].sum() if len(received[d]) else 0
    mean = loads.mean() if loads.size else 0.0
    return DistributedIndexResult(
        index=index,
        chunk_owners=salted.primary,
        salted=salted,
        received=received,
        shuffle_bytes=int(shuffle_bytes),
        skew_factor=float(loads.max() / mean) if mean else 1.0,
        exchange_capacity=cap,
        n_exchange_blocks=len(blocks),
        exchange_mode="ragged" if ragged else "padded",
        exchange_planned_slots=int(planned_slots),
    )


def _chunk_bytes(index: ChunkedIndex, lens: np.ndarray) -> np.ndarray:
    """Per-chunk payload bytes (value bytes + ASCII length prefixes — the
    reference's chunk-string append, src/main.cpp:30)."""
    prefix = np.char.str_len(
        np.char.mod("%d", lens.astype(np.int64))
    ).astype(np.int64)
    entry_bytes = lens + prefix
    out = np.zeros(index.chunk_starts.shape[0], np.int64)
    np.add.at(out, index.chunk_of_entry, entry_bytes)
    return out