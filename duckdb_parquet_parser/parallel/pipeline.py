"""The sharded scan pipeline: decode + regex match + index exchange as one
jit-compiled SPMD program over a 1-D "pages" mesh.

Everything per-page shards along the mesh axis; dictionaries, the DFA table,
and per-dictionary-entry match bits replicate (they are small by
construction: pages are ~1 KB, dictionaries <= non-null/5 entries).  The only
collectives are a `psum` for global totals and the `all_to_all` of the
inverted-index entry exchange, which XLA hands to the collective library.

The local kernel is the same fast path as single-chip: the streaming matcher
over raw page payloads (ops/strings.py) for PLAIN pages and the replicated
dict-match + index-stream expansion for dictionary pages.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops import decode as _decode
from ..ops.scan import dfa_match
from ..ops.strings import match_payload_stream
from .mesh import PAGES_AXIS
from .shuffle import all_to_all_exchange

shard_map = jax.shard_map


def _local_match_counts(core, payload, plen, dict_match, *, table, accept,
                        chain, vmax, nn_cap, max_def, negate):
    """Per-page accept counts + totals on the local page shard (pure jnp)."""
    is_dict = core["page_kind"] == 1
    nn = core["page_nn"]

    # PLAIN pages: streaming DFA over raw payload (dict pages masked out)
    hits, _seen = match_payload_stream(
        jnp, payload, jnp.where(is_dict, 0, plen), jnp.where(is_dict, 0, nn),
        table, accept, use_mxu=True, chain=chain,
    )
    plain_counts = (nn - hits) if negate else hits

    # dictionary pages: replicated dict match bits through the idx stream
    # (ops/dict_lookup.py)
    from ..ops.dict_lookup import dict_lookup

    nonnull, nn_idx = _decode.decode_levels(jnp, core, max_def, vmax)
    dict_idx, ok = _decode.decode_dict_indices(jnp, core, nn_idx, nn_cap,
                                               nonnull=nonnull)
    dn = dict_match.shape[0]
    g = jnp.clip(core["page_dict_base"][:, None] + jnp.clip(dict_idx, 0, None), 0, dn - 1)
    dm = dict_lookup(jnp, [dict_match.astype(jnp.int32)], g)[0] != 0
    accept_d = (dm ^ negate) & ok & nonnull
    dict_counts = jnp.sum(accept_d, axis=1)

    counts = jnp.where(is_dict, dict_counts, plain_counts).astype(jnp.int32)
    values = jnp.where(is_dict, jnp.sum(ok & nonnull, axis=1), nn).astype(jnp.int32)
    totals = jax.lax.psum(jnp.stack([jnp.sum(counts), jnp.sum(values)]), PAGES_AXIS)
    return counts, values, totals


@functools.lru_cache(maxsize=64)
def _make_scan_step(mesh, core_keys, vmax, nn_cap, max_def, negate,
                    table_bytes, table_shape, accept_bytes, chain_key):
    # The DFA tables are COMPILE-TIME constants: the transition builder
    # (byte classes, intervals) needs concrete values, so the step function
    # is cached per (mesh, shapes, automaton).
    table = np.frombuffer(table_bytes, np.int32).reshape(table_shape)
    accept = np.frombuffer(accept_bytes, bool)
    spec_pages = {k: P(PAGES_AXIS) for k in core_keys}
    fn = shard_map(
        functools.partial(_local_match_counts, table=table, accept=accept,
                          chain=list(chain_key) if chain_key else None,
                          vmax=vmax, nn_cap=nn_cap, max_def=max_def,
                          negate=negate),
        mesh=mesh,
        in_specs=(spec_pages, P(PAGES_AXIS), P(PAGES_AXIS), P()),
        out_specs=(P(PAGES_AXIS), P(PAGES_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


@dataclass
class DistributedScanResult:
    page_gid: np.ndarray
    match_counts: np.ndarray
    value_counts: np.ndarray
    totals: np.ndarray  # [2] global (matches, values) via psum

    def pruned_pages(self) -> np.ndarray:
        keep = self.page_gid >= 0
        return self.page_gid[keep & (self.match_counts == 0)]

    def surviving_pages(self) -> np.ndarray:
        keep = self.page_gid >= 0
        return self.page_gid[keep & (self.match_counts > 0)]


def core_arrays(batch) -> dict:
    return {k: batch.arrays[k] for k in _decode.DECODE_ARRAYS if k in batch.arrays}


def distributed_scan(mesh, batch, dfa, *, negate: bool = False) -> DistributedScanResult:
    """Runs the regex page-pruning scan sharded over `mesh`.

    `batch` must be page-padded to a multiple of the device count
    (parallel.partition.pad_pages) and prescanned with PS_PAYLOAD
    (pad_strings > 0 so dictionary tables are packed)."""
    arrays = batch.arrays
    if "payload" not in arrays:
        raise ValueError("distributed_scan needs a PS_PAYLOAD batch")

    # replicated dictionary match bits
    if int(batch.dims.get("dict_n", 0)) > 0 and "dict_padded" in arrays:
        dict_match = np.asarray(
            dfa_match(np, arrays["dict_padded"], arrays["dict_lens"],
                      dfa.table, dfa.accept)
        )
    else:
        dict_match = np.zeros(1, bool)

    core = {k: jnp.asarray(v) for k, v in core_arrays(batch).items()}
    from ..ops.regex import substring_chain

    table = np.ascontiguousarray(dfa.table, np.int32)
    chain = substring_chain(dfa.pattern) if dfa.pattern else None
    step = _make_scan_step(
        mesh, tuple(sorted(core)), batch.vmax, batch.nn_cap, batch.max_def,
        negate, table.tobytes(), table.shape,
        np.ascontiguousarray(dfa.accept, bool).tobytes(),
        tuple(chain) if chain else None,
    )
    counts, values, totals = step(
        core, jnp.asarray(arrays["payload"]),
        jnp.asarray(arrays["page_payload_len"]), jnp.asarray(dict_match),
    )
    from .mesh import to_global_numpy

    return DistributedScanResult(
        page_gid=arrays["page_gid"].copy(),
        match_counts=to_global_numpy(counts).astype(np.int64),
        value_counts=to_global_numpy(values).astype(np.int64),
        totals=to_global_numpy(totals).astype(np.int64),
    )


# ── sharded column decode ────────────────────────────────────────────────────


@functools.lru_cache(maxsize=32)
def _make_decode_step(mesh, core_keys, n_plain, n_dict, n_pp, has_bool, vmax,
                      nn_cap, max_def, mode, def_lit, idx_lit, max_shift):
    def local(core, plain, dct, bits, pp):
        planes, nonnull = _decode.decode_fixed(
            jnp, core, list(plain), list(dct), bits if has_bool else None,
            max_def=max_def, out_len=vmax, nn_len=nn_cap, mode=mode,
            def_literal=def_lit, idx_literal=idx_lit,
            max_null_shift=max_shift,
            dict_planes_pp=list(pp) or None,
        )
        total = jax.lax.psum(
            jnp.sum(jnp.where(nonnull, planes[0], 0)), PAGES_AXIS)
        return tuple(planes), nonnull, total

    spec_pages = {k: P(PAGES_AXIS) for k in core_keys}
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec_pages, (P(PAGES_AXIS),) * n_plain, (P(),) * n_dict,
                  P(PAGES_AXIS), (P(PAGES_AXIS),) * n_pp),
        out_specs=((P(PAGES_AXIS),) * n_plain if n_plain else
                   (P(PAGES_AXIS),), P(PAGES_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_decode(mesh, batch):
    """Fixed-width column decode sharded over the 'pages' mesh: each device
    decodes its page shard (levels + dict/plain extraction, the same
    gather-free kernels as single-chip — ops/decode.py); a psum checksum
    validates the collective path.  Returns (planes [N, V] i32 page-major,
    nonnull [N, V] bool, checksum int)."""
    arrays = batch.arrays
    core = {k: jnp.asarray(v) for k, v in core_arrays(batch).items()}
    plain = tuple(jnp.asarray(p) for p in batch.plain_planes)
    dct = tuple(jnp.asarray(p) for p in batch.dict_planes)
    bool_bits = batch.bool_bits
    has_bool = bool_bits is not None
    bits = jnp.asarray(bool_bits if has_bool else np.zeros((batch.n_pages, 1),
                                                           np.uint8))
    pp = tuple(jnp.asarray(p) for p in batch.dict_planes_pp)
    step = _make_decode_step(
        mesh, tuple(sorted(core)), len(plain), len(dct), len(pp), has_bool,
        batch.vmax, batch.nn_cap, batch.max_def, batch.mode,
        _decode.batch_has_literal(arrays, "def") if batch.max_def > 0 else False,
        _decode.batch_has_literal(arrays, "idx") if batch.mode != "plain" else False,
        _decode.max_nulls_per_page(arrays) if batch.max_def > 0 else -1,
    )
    planes, nonnull, total = step(core, plain, dct, bits, pp)
    from .mesh import to_global_numpy

    return ([to_global_numpy(p) for p in planes], to_global_numpy(nonnull),
            int(to_global_numpy(total)))


# ── index entry exchange ─────────────────────────────────────────────────────


@functools.partial(jax.jit, static_argnames=("mesh",))
def _exchange_step(mesh, send):
    fn = shard_map(
        all_to_all_exchange,
        mesh=mesh,
        in_specs=P(PAGES_AXIS),
        out_specs=P(PAGES_AXIS),
        check_vma=False,
    )
    return fn(send)


def exchange_entries(mesh, send_buffer: np.ndarray, block: bool = True):
    """Runs the padded all_to_all: send_buffer [D, D, cap, ...] (src-major)
    -> received rows per destination (see shuffle.all_to_all_exchange).

    block=False returns the in-flight device array without synchronizing —
    the caller overlaps the collective with packing the next block."""
    from .mesh import to_global_numpy

    out = _exchange_step(mesh, jnp.asarray(send_buffer))
    return to_global_numpy(out) if block else out


@functools.partial(jax.jit, static_argnames=("mesh", "emulate"))
def _ragged_exchange_step(mesh, send, out0, io, ss, oo, rs, emulate):
    from .shuffle import ragged_exchange, ragged_exchange_emulated

    if emulate:
        fn = shard_map(
            ragged_exchange_emulated, mesh=mesh,
            in_specs=(P(PAGES_AXIS), P(PAGES_AXIS), P(), P(), P()),
            out_specs=P(PAGES_AXIS), check_vma=False,
        )
        return fn(send, out0, io, ss, oo)
    fn = shard_map(
        ragged_exchange, mesh=mesh,
        in_specs=(P(PAGES_AXIS),) * 6,
        out_specs=P(PAGES_AXIS), check_vma=False,
    )
    return fn(send, out0, io, ss, oo, rs)


def ragged_use_hlo() -> bool:
    """True when the backend implements the ragged-all-to-all HLO: the GPU
    (checked on four H100s against the emulation); XLA:CPU does not.
    DPQ_RAGGED_EMULATE=1 forces the portable emulation for A/B testing."""
    import os

    if os.environ.get("DPQ_RAGGED_EMULATE") == "1":
        return False
    return jax.default_backend() == "gpu"


def ragged_exchange_entries(mesh, plan, payload: np.ndarray, fill=-1,
                            block: bool = True):
    """Runs one exact-size exchange block per RaggedExchangePlan: packs
    `payload` rows into the destination-major send layout, moves them with
    jax.lax.ragged_all_to_all (or the portable emulation — same layout),
    and returns [D, recv_cap, ...]; rows [0, plan.recv_total[d]) of shard d
    are the valid receives, source-major."""
    send = plan.build_send_buffer(payload, fill=fill)
    out0 = np.full((plan.n_devices, plan.recv_cap) + payload.shape[1:], fill,
                   payload.dtype)
    out = _ragged_exchange_step(
        mesh, jnp.asarray(send), jnp.asarray(out0),
        jnp.asarray(plan.input_offsets, jnp.int32),
        jnp.asarray(plan.send_sizes, jnp.int32),
        jnp.asarray(plan.output_offsets, jnp.int32),
        jnp.asarray(plan.send_sizes.T.copy(), jnp.int32),
        emulate=not ragged_use_hlo(),
    )
    return np.asarray(out) if block else out
