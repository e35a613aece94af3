"""Branch-free expansion of RLE/bit-packed hybrid run descriptors.

This is the device replacement for the reference's scalar
`RleDecoder::get_batch` loop (reference: include/reader/rle_decoder.hpp:17-74):
the host pre-scan (native/dpq_prescan.hpp) has already turned each page's
hybrid section into a *run descriptor table*; here the device expands those
descriptors into per-value levels/indices with only vectorized primitives:

  1. run assignment  — scatter-add run starts, prefix-sum, so each value v
     learns its run id (a segmented "searchsorted" with no search);
  2. attribute gather — per-value run kind/value/bit-offset via gather;
  3. bit extraction  — literal (bit-packed) values read a 4-byte little-endian
     window at bit offset `bitoff + (v - vstart) * bw`, shift and mask.
     Supports bit widths up to 24 (dictionary indices), plenty beyond the
     reference writer's own maximum.

Zero-fill on section exhaustion and literal-run 8-group padding are encoded by
the host pre-scan, so the device math stays affine.  Every function is
`xp`-generic: `xp=numpy` gives the golden reference used in tests, `xp=jnp`
the jit-compiled device path (identical math).
"""

from __future__ import annotations

from typing import Any

import numpy as np

MAX_BITWIDTH = 24  # 4-byte window, shift < 8  →  bw + 7 <= 31 bits


def _scatter_add(xp, target, rows, cols, values):
    if xp is np:
        out = target.copy()
        np.add.at(out, (rows, cols), values)
        return out
    return target.at[rows, cols].add(values)


def take2d_shift(xp, plane, nn_idx, max_shift: int, out_len: int):
    """Null-scatter gather as LOGARITHMIC per-cell shifts.

    For null-materialization gathers the index is `nn_idx[v] = v - nulls_
    before(v)`, so `plane[nn_idx]` equals a right-shift of the plane by the
    running null count s(v) = v - nn_idx[v].  MSB-first doubling with a
    carried applied-shift plane: stage b moves cell v's (value, applied)
    pair from v-b exactly when s(v) - applied(v) >= b.  Because s is
    non-decreasing with unit steps, s(v) - s(v-b) ∈ [0, b] keeps the source
    in the same 2b-aligned window, so the invariant applied(v) =
    floor(s(v)/2b)·2b holds into every stage and applied converges to s —
    log2(max_shift) contiguous-copy stages instead of one per possible
    null count (~80 on 512-value pages at 10% nulls; fuzzed on 3k+
    adversarial null patterns vs the gather).  No gather anywhere.  Cells
    whose s exceeds max_shift (only possible past a page's num_values)
    carry garbage-but-
    masked values, like the gather fallback — decode_fixed zeroes every
    masked cell before returning.
    """
    n = plane.shape[0]
    v_iota = xp.arange(out_len, dtype=xp.int32)[None, :]
    shift = v_iota - nn_idx  # [N, V] — nulls before v, in [0, max_shift]
    val = plane[:, :out_len] if plane.shape[1] >= out_len else xp.concatenate(
        [plane, xp.zeros((n, out_len - plane.shape[1]), plane.dtype)], axis=1
    )
    if max_shift <= 0:
        return val
    applied = xp.zeros((n, out_len), xp.int32)
    b = 1 << (int(max_shift).bit_length() - 1)
    while b >= 1:
        pad_v = xp.zeros((n, b), val.dtype)
        pad_a = xp.zeros((n, b), xp.int32)
        val_s = xp.concatenate([pad_v, val[:, :-b]], axis=1)
        app_s = xp.concatenate([pad_a, applied[:, :-b]], axis=1)
        can = (shift - applied) >= b
        val = xp.where(can, val_s, val)
        applied = xp.where(can, app_s + b, applied)
        b >>= 1
    return val


def take2d(xp, a, idx):
    """Gather along the last axis of a 2-D array via FLAT 1-D indexing.

    Equivalent to take_along_axis(a, idx, axis=1) for in-range idx; the
    flat form is one 1-D gather.  idx must already be clipped to
    [0, a.shape[1]-1].

    numpy path: take_along_axis — np.take's bounds-checked scalar loop is
    ~70x slower on 2M indices (measured).
    """
    if xp is np:
        return np.take_along_axis(a, idx, axis=1)
    n, m = a.shape
    base = xp.arange(n, dtype=xp.int32)[:, None] * m
    return xp.take(a.reshape(-1), base + idx)


# Run tables up to this width expand by select (R elementwise accumulation
# passes) instead of gathers.  The limit was tuned for an earlier target and
# is not measured on the H100 (ROADMAP Queue 1 item 5 re-decides it).
SELECT_RUNS_MAX = 512


def expand_hybrid(
    xp: Any,
    run_kind,   # [N, R] i32 : 0 = repeated, 1 = literal
    run_count,  # [N, R] i32 : values contributed (0 = padding)
    run_value,  # [N, R] i32 : repeated value
    run_bitoff, # [N, R] i32 : literal first-value bit offset in section
    run_vstart, # [N, R] i32 : first value index of the run within the page
    section,    # [N, S] u8  : raw section bytes (zero padded; S >= max+4)
    bw,         # [N]    i32 : bit width per page (0..24)
    out_len: int,
    *,
    has_literal: bool = True,   # any literal (bit-packed) runs in the batch?
    method: str = "auto",       # "gather" | "select" | "auto"
):
    """Expands hybrid runs to per-value integers. Returns [N, out_len] i32."""
    n_pages, n_runs = run_count.shape
    s_pad = section.shape[1]
    if method == "auto":
        method = "select" if (xp is not np and n_runs <= SELECT_RUNS_MAX) else "gather"

    v_iota = xp.arange(out_len, dtype=xp.int32)[None, :]
    active = run_count > 0

    if method == "select":
        # run assignment + attribute selection as R accumulation passes
        run_id = xp.zeros((n_pages, out_len), xp.int32)
        for r in range(1, n_runs):
            started = active[:, r : r + 1] & (v_iota >= run_vstart[:, r : r + 1])
            run_id = run_id + started.astype(xp.int32)
        kind_v = xp.zeros((n_pages, out_len), xp.int32)
        value_v = xp.zeros((n_pages, out_len), xp.int32)
        bitoff_v = xp.zeros((n_pages, out_len), xp.int32)
        vstart_v = xp.zeros((n_pages, out_len), xp.int32)
        for r in range(n_runs):
            here = run_id == r
            kind_v = xp.where(here, run_kind[:, r : r + 1], kind_v)
            value_v = xp.where(here, run_value[:, r : r + 1], value_v)
            if has_literal:
                bitoff_v = xp.where(here, run_bitoff[:, r : r + 1], bitoff_v)
                vstart_v = xp.where(here, run_vstart[:, r : r + 1], vstart_v)
    else:
        rows = xp.broadcast_to(
            xp.arange(n_pages, dtype=xp.int32)[:, None], (n_pages, n_runs)
        )
        cols = xp.where(active, xp.clip(run_vstart, 0, out_len - 1), 0)
        marks = _scatter_add(
            xp,
            xp.zeros((n_pages, out_len), xp.int32),
            rows,
            cols,
            active.astype(xp.int32),
        )
        run_id = xp.clip(xp.cumsum(marks, axis=1) - 1, 0, n_runs - 1)
        take = lambda a: take2d(xp, a, run_id)
        kind_v = take(run_kind)
        value_v = take(run_value)
        bitoff_v = take(run_bitoff)
        vstart_v = take(run_vstart)

    if not has_literal:
        return value_v

    bw_col = bw[:, None]
    bitpos = bitoff_v + (v_iota - vstart_v) * bw_col
    byte0 = bitpos >> 3
    shift = (bitpos & 7).astype(xp.uint32)

    in_range = (byte0 >= 0) & (byte0 <= s_pad - 4)
    b0 = xp.clip(byte0, 0, s_pad - 4)
    sec_i = section.astype(xp.int32)
    w = take2d(xp, sec_i, b0).astype(xp.uint32)
    w = w | (take2d(xp, sec_i, b0 + 1).astype(xp.uint32) << 8)
    w = w | (take2d(xp, sec_i, b0 + 2).astype(xp.uint32) << 16)
    w = w | (take2d(xp, sec_i, b0 + 3).astype(xp.uint32) << 24)
    mask = ((xp.uint32(1) << bw_col.astype(xp.uint32)) - xp.uint32(1))
    literal = ((w >> shift) & mask).astype(xp.int32)
    literal = xp.where(in_range, literal, 0)

    return xp.where(kind_v == 1, literal, value_v)


def nonnull_mask_and_index(xp, def_levels, num_values, max_def: int, out_len: int):
    """Null materialization bookkeeping.

    Given expanded definition levels, returns
      nonnull [N, V] bool : def == max_def AND v < num_values
      nn_idx  [N, V] i32  : rank of this value in the page's non-null stream
                            (exclusive prefix sum of nonnull; meaningful only
                            where nonnull)
    Matches the reference's null interleave rule
    (reference: src/reader/column_reader.cpp:167-196).
    """
    v_iota = xp.arange(out_len, dtype=xp.int32)[None, :]
    row_valid = v_iota < num_values[:, None]
    nonnull = (def_levels == max_def) & row_valid
    nn_idx = xp.cumsum(nonnull.astype(xp.int32), axis=1) - 1
    return nonnull, xp.clip(nn_idx, 0, None)
