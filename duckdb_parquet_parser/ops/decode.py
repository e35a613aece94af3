"""Vectorized page decode — the device replacement for the reference's scalar
`ColumnReader::read_data_page` loops (reference: src/reader/column_reader.cpp:140-225).

Values move through *int32 planes*: an INT64/DOUBLE value is two little-endian
i32 lanes, INT32/FLOAT one, INT96 three.  Gathers and selects on i32 planes
are accelerator-native (no x64 mode, no f64 emulation — the engine never does
arithmetic on decoded values, only data movement), and the host reassembles
dtypes by viewing the plane stack as little-endian bytes.

Decode pipeline per batch of N pages (V = padded values/page, K = padded
non-nulls/page):
  1. definition levels  <- expand_hybrid over the def-run descriptor table
  2. null bookkeeping   <- nonnull mask + prefix-sum rank (expand.py)
  3a. PLAIN fixed       <- gather plane[nn_idx]
  3b. PLAIN boolean     <- bit (nn_idx) of the page's packed bit stream
  3c. dictionary        <- expand idx runs, gather dict planes; an
                           out-of-range index decodes to NULL
                           (reference: src/reader/column_reader.cpp:190-194)
All functions are xp-generic (numpy = golden model, jnp = device path).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np

from .expand import expand_hybrid, nonnull_mask_and_index, take2d, take2d_shift

# Arrays the core decode consumes (subset of the pre-scan batch contract).
DECODE_ARRAYS = [
    "page_num_values", "page_nn", "page_kind", "page_def_bw", "page_idx_bw",
    "page_dict_base", "page_dict_size",
    "def_run_kind", "def_run_count", "def_run_value", "def_run_bitoff",
    "def_run_vstart", "def_bytes",
    "idx_run_kind", "idx_run_count", "idx_run_value", "idx_run_bitoff",
    "idx_run_vstart", "idx_bytes",
    # materialized planes (pre-scan default; absent under PS_RUNS_ONLY)
    "def_levels", "idx_vals",
]


def fixed_planes_from_bytes(raw: np.ndarray, width: int) -> list[np.ndarray]:
    """Host-side: [N, K*width] u8 -> list of [N, K] i32 little-endian planes."""
    n = raw.shape[0]
    k = raw.shape[1] // max(width, 1)
    if width == 0:
        return []
    i32 = raw.view("<i4").reshape(n, k, width // 4)
    return [np.ascontiguousarray(i32[:, :, j]) for j in range(width // 4)]


def dict_planes_from_bytes(raw: np.ndarray, width: int) -> list[np.ndarray]:
    """Host-side: [DN, width] u8 -> list of [DN] i32 planes (width==1: bool)."""
    if width == 1:  # boolean dictionary entries are stored one byte each
        return [raw.reshape(-1).astype(np.int32)]
    i32 = raw.view("<i4").reshape(raw.shape[0], width // 4)
    return [np.ascontiguousarray(i32[:, j]) for j in range(width // 4)]


def planes_to_array(planes, dtype: np.dtype) -> np.ndarray:
    """Reassemble i32 planes into the target little-endian dtype."""
    stack = np.stack([np.asarray(p, dtype="<i4") for p in planes], axis=-1)
    flat = stack.view(np.uint8).reshape(*stack.shape[:-1], stack.shape[-1] * 4)
    itemsize = np.dtype(dtype).itemsize
    return flat[..., :itemsize].copy().view(dtype).reshape(stack.shape[:-1])


def decode_levels(xp, arrays, max_def: int, out_len: int,
                  def_literal: bool = True):
    """Expanded definition levels + nonnull mask + non-null rank.

    When the pre-scan materialized `def_levels` (the default), the levels
    are consumed directly — the run-expansion path below is the fallback
    (PS_RUNS_ONLY batches, synthetic test batches).
    `def_literal=False` (host knows the batch has no bit-packed def runs —
    the common case for writer-produced files) skips bit extraction."""
    num_values = arrays["page_num_values"]
    if max_def > 0 and "def_levels" in arrays:
        lv = arrays["def_levels"]
        lv = lv[:, :out_len] if lv.shape[1] >= out_len else xp.concatenate(
            [lv, xp.zeros((lv.shape[0], out_len - lv.shape[1]), lv.dtype)],
            axis=1,
        )
        levels = lv.astype(xp.int32)
    elif max_def > 0:
        levels = expand_hybrid(
            xp,
            arrays["def_run_kind"], arrays["def_run_count"],
            arrays["def_run_value"], arrays["def_run_bitoff"],
            arrays["def_run_vstart"], arrays["def_bytes"],
            arrays["page_def_bw"], out_len, has_literal=def_literal,
        )
    else:
        levels = xp.zeros((num_values.shape[0], out_len), xp.int32)
    return nonnull_mask_and_index(xp, levels, num_values, max_def, out_len)


def decode_dict_indices(xp, arrays, nn_idx, nn_len: int,
                        idx_literal: bool = True, max_null_shift: int = -1,
                        nonnull=None):
    """Per-row dictionary index and its validity ([N, V] i32, [N, V] bool).

    The pre-scan's materialized `idx_vals` plane is VALUE-SPACE (the index
    already sits at its row position; -1 at nulls), so consuming it needs
    neither run expansion nor the null-rank mapping — the whole dict index
    decode is a slice.  Run expansion + rank mapping is the fallback.

    The idx_vals fast path is -1-filled at nulls and padding, so its `ok`
    is trustworthy standalone.  The FALLBACK path leaves garbage-but-
    spuriously-ok cells at null/pad positions (the rank mapping points
    them at a neighbouring valid index); pass `nonnull` so `ok` is bounded
    structurally there — callers that omit it MUST AND `ok` with their own
    nonnull mask before use."""
    if "idx_vals" in arrays:
        out_len = nn_idx.shape[1]
        iv = arrays["idx_vals"]
        dict_idx = iv[:, :out_len] if iv.shape[1] >= out_len else xp.concatenate(
            [iv, xp.full((iv.shape[0], out_len - iv.shape[1]), -1, iv.dtype)],
            axis=1,
        )
        dict_idx = dict_idx.astype(xp.int32) if dict_idx.dtype != xp.int32 else dict_idx
    else:
        idx_stream = expand_hybrid(
            xp,
            arrays["idx_run_kind"], arrays["idx_run_count"],
            arrays["idx_run_value"], arrays["idx_run_bitoff"],
            arrays["idx_run_vstart"], arrays["idx_bytes"],
            arrays["page_idx_bw"], nn_len, has_literal=idx_literal,
        )
        if 0 <= max_null_shift <= 64 and xp is not np:
            dict_idx = take2d_shift(xp, idx_stream, nn_idx, max_null_shift,
                                    nn_idx.shape[1])
        else:
            dict_idx = take2d(xp, idx_stream, xp.clip(nn_idx, 0, nn_len - 1))
        if nonnull is not None:
            # bound the fallback's garbage cells here (one AND, fallback
            # path only — the idx_vals fast path never needs it)
            dict_idx = xp.where(nonnull, dict_idx, -1)
    ok = (dict_idx >= 0) & (dict_idx < arrays["page_dict_size"][:, None])
    return dict_idx, ok


def _lookup_values(xp, arrays, dict_planes, dict_planes_pp, dict_idx):
    """Dictionary value lookup from the LOCAL in-page index.

    Prefers the per-page local-table select (dict_lookup_local — dn_max ops
    per value instead of the concatenated global table's DN) when the
    caller supplied `dict_planes_pp` and the local table is select-sized;
    else the global-table dispatcher (select / gather)."""
    from .dict_lookup import SELECT_DICT_MAX, dict_lookup, dict_lookup_local

    if not dict_planes:
        return []
    dn_max = dict_planes_pp[0].shape[1] if dict_planes_pp else 0
    if dict_planes_pp and xp is not np and dn_max <= SELECT_DICT_MAX:
        return dict_lookup_local(xp, list(dict_planes_pp), dict_idx, dn_max)
    dn = dict_planes[0].shape[0]
    base = arrays["page_dict_base"][:, None]
    gidx = xp.clip(base + xp.clip(dict_idx, 0, None), 0, dn - 1)
    return dict_lookup(xp, list(dict_planes), gidx)


def decode_fixed(
    xp,
    arrays: dict[str, Any],
    plain_planes,   # list of [N, K] i32 (may be empty)
    dict_planes,    # list of [DN] i32  (may be empty)
    bool_bits,      # [N, B] u8 or None
    *,
    max_def: int,
    out_len: int,
    nn_len: int,
    mode: str,      # "plain" | "dict" | "mixed"
    def_literal: bool = True,
    idx_literal: bool = True,
    max_null_shift: int = -1,  # host-known max nulls/page; >=0 enables the
                               # shift-based (gather-free) null scatter
    dict_planes_pp=None,  # per-page local tables [N, dn_max] (batch.
                          # dict_planes_pp) — select on the LOCAL index
):
    """Decode a batch of fixed-width (or boolean) pages.

    Returns (planes: list of [N, V] i32, nonnull: [N, V] bool).
    """
    if mode == "dict" and "idx_vals" in arrays:
        # Level-free dict fast path (round 4): the value-space idx plane is
        # -1-filled at nulls AND padding (dpq_prescan.hpp:738 memsets 0xFF;
        # only rank-mapped non-null rows < num_values are overwritten), so
        # validity == (idx >= 0) & (idx < dict_size) EQUALS nonnull & ok —
        # the def-level expansion and the null-rank prefix sum drop out of
        # the dict decode entirely.
        iv = arrays["idx_vals"]
        dict_idx = iv[:, :out_len] if iv.shape[1] >= out_len else xp.concatenate(
            [iv, xp.full((iv.shape[0], out_len - iv.shape[1]), -1, iv.dtype)],
            axis=1,
        )
        dict_idx = (dict_idx.astype(xp.int32)
                    if dict_idx.dtype != xp.int32 else dict_idx)
        ok = (dict_idx >= 0) & (dict_idx < arrays["page_dict_size"][:, None])
        vals = _lookup_values(xp, arrays, dict_planes, dict_planes_pp,
                              dict_idx)
        return [xp.where(ok, p, 0) for p in vals], ok

    nonnull, nn_idx = decode_levels(xp, arrays, max_def, out_len, def_literal)
    gather_idx = xp.clip(nn_idx, 0, max(nn_len - 1, 0))

    plain_vals = None
    if mode in ("plain", "mixed"):
        if bool_bits is not None:
            byte = take2d(xp, bool_bits.astype(xp.int32), gather_idx >> 3)
            plain_vals = [(byte >> (gather_idx & 7)) & 1]
        elif max_def == 0 and plain_planes and plain_planes[0].shape[1] >= out_len:
            # REQUIRED columns: the non-null rank IS the row index, so the
            # "gather" is the identity — pure reinterpret, zero gathers
            # (no gather at all; this path is memcpy-speed).
            plain_vals = [p[:, :out_len] for p in plain_planes]
        elif 0 <= max_null_shift <= 64 and xp is not np:
            plain_vals = [
                take2d_shift(xp, p, nn_idx, max_null_shift, out_len)
                for p in plain_planes
            ]
        else:
            plain_vals = [take2d(xp, p, gather_idx) for p in plain_planes]

    dict_vals = None
    dict_ok = None
    if mode in ("dict", "mixed"):
        dict_idx, dict_ok = decode_dict_indices(xp, arrays, nn_idx, nn_len,
                                                idx_literal,
                                                max_null_shift=max_null_shift,
                                                nonnull=nonnull)
        # value lookup: local/global select-accumulation for small tables,
        # a gather beyond (ops/dict_lookup.py)
        dict_vals = _lookup_values(xp, arrays, dict_planes, dict_planes_pp,
                                   dict_idx) or None

    # masked cells are zeroed so every decode method (gather / shift / select)
    # produces bit-identical outputs
    def finish(planes, valid):
        return [xp.where(valid, p, 0) for p in planes], valid

    if mode == "plain":
        return finish(plain_vals, nonnull)
    is_dict = arrays["page_kind"][:, None] == 1
    if mode == "dict":
        return finish(dict_vals, nonnull & dict_ok)
    # mixed: per-page select
    n_planes = len(plain_vals) if plain_vals else (len(dict_vals) if dict_vals else 0)
    planes = []
    for j in range(n_planes):
        p = plain_vals[j] if plain_vals else xp.zeros_like(nonnull, xp.int32)
        d = dict_vals[j] if dict_vals else xp.zeros_like(p)
        planes.append(xp.where(is_dict, d, p))
    nn = xp.where(is_dict, nonnull & dict_ok, nonnull) if dict_ok is not None else nonnull
    return finish(planes, nn)


# ── JAX entry point ─────────────────────────────────────────────────────────


@functools.partial(
    __import__("jax").jit,
    static_argnames=("max_def", "out_len", "nn_len", "mode", "has_bool",
                     "def_literal", "idx_literal", "max_null_shift"),
)
def _decode_fixed_jit(arrays, plain_planes, dict_planes, bool_bits,
                      dict_planes_pp,
                      max_def, out_len, nn_len, mode, has_bool,
                      def_literal, idx_literal, max_null_shift):
    import jax.numpy as jnp

    planes, nonnull = decode_fixed(
        jnp, arrays, plain_planes, dict_planes,
        bool_bits if has_bool else None,
        max_def=max_def, out_len=out_len, nn_len=nn_len, mode=mode,
        def_literal=def_literal, idx_literal=idx_literal,
        max_null_shift=max_null_shift,
        dict_planes_pp=dict_planes_pp or None,
    )
    return planes, nonnull


def batch_has_literal(arrays, prefix: str) -> bool:
    """Host-side: does any page carry a literal (bit-packed) run?"""
    kind = np.asarray(arrays[f"{prefix}_run_kind"])
    count = np.asarray(arrays[f"{prefix}_run_count"])
    return bool(((kind == 1) & (count > 0)).any())


def decode_fixed_jax(arrays, plain_planes, dict_planes, bool_bits, *,
                     max_def, out_len, nn_len, mode, dict_planes_pp=None):
    """jit-compiled device decode; accepts numpy or device arrays."""
    core = {k: arrays[k] for k in DECODE_ARRAYS if k in arrays}
    return _decode_fixed_jit(
        core, tuple(plain_planes), tuple(dict_planes),
        bool_bits if bool_bits is not None else np.zeros((1, 1), np.uint8),
        tuple(dict_planes_pp) if dict_planes_pp else (),
        max_def, out_len, nn_len, mode, bool_bits is not None,
        batch_has_literal(arrays, "def") if max_def > 0 else False,
        batch_has_literal(arrays, "idx") if mode != "plain" else False,
        max_nulls_per_page(arrays) if max_def > 0 else -1,
    )


def max_nulls_per_page(arrays) -> int:
    """Host-side: max nulls in any page (bounds the shift-based scatter)."""
    nv = np.asarray(arrays["page_num_values"])
    nn = np.asarray(arrays["page_nn"])
    return int((nv - nn).max()) if len(nv) else 0
