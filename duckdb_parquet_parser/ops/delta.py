"""Device-side DELTA_BINARY_PACKED decode (round 5, VERDICT r4 #7).

The host pre-scan (PS_DELTA_RAW, native/dpq_prescan.hpp) emits STRUCTURE
planes only — per-miniblock bit widths, min-deltas, counts, and the raw
bit-packed bytes — and the value reconstruction runs on device as pure
elementwise work plus one prefix sum:

  * bit unpack is specialized PER DISTINCT BIT WIDTH (the widths present
    in a batch are a tiny static set — host passes them as a static jit
    arg): for a STATIC bw, delta j of a miniblock occupies bits
    [j*bw, (j+1)*bw), so its word index and shift are compile-time
    constants — extraction is `(w0 >> sh) | (w1 << (32-sh))` with NO
    gathers and no dynamic indexing, and rows of other widths are
    select-masked out;
  * 64-bit arithmetic without jax x64 runs on paired uint32 lo/hi planes:
    min-delta add, the running prefix sum, and the first-value add all
    propagate carries via the standard `(a + b) mod 2^32 < b` test — the
    lo plane is exact mod 2^32 by construction (int32 columns need
    nothing else), and the hi plane adds the carry prefix sum;
  * the per-page prefix sum is a single cumsum along the value axis of
    the [n_pages, 1 + mb_cap*mb_values] delta matrix (position 0 is the
    page's first value; deltas cover values [1, nn)).

The output is the decode pipeline's canonical nn-space plain planes
([n_pages, nn_cap] i32 per 4-byte lane), so null placement, validity, and
row accounting ride the UNCHANGED decode_fixed machinery.

Parity oracles: pyarrow-written DELTA_BINARY_PACKED files and the host
decoder (dpq_delta.hpp::delta_binary_values), tests/test_v2_encodings.py.

The per-distinct-width select passes re-extract every miniblock row, so a
column with many distinct widths pays one pass per width.  Width-BUCKETED
host layouts would avoid that but need a [MB, 32]-element permutation
gather to restore stream order for the prefix sum.  Neither has been timed
on the H100.
"""

from __future__ import annotations

import numpy as np


def delta_bws(arrays) -> tuple[int, ...]:
    """The static distinct-bit-width set of a PS_DELTA_RAW batch (host-side;
    becomes a static jit argument)."""
    bw = np.asarray(arrays["delta_bw"])
    cnt = np.asarray(arrays["delta_cnt"])
    return tuple(sorted(int(b) for b in np.unique(bw[cnt > 0])))


def _extract_static_bw(xp, words, bw: int, mbv: int):
    """[P, M, W] u32 words -> (lo, hi) [P, M, mbv] u32 deltas assuming every
    row is packed at the STATIC width `bw` (callers mask rows by width)."""
    P, M, W = words.shape
    los, his = [], []
    for j in range(mbv):
        if bw == 0:
            los.append(xp.zeros((P, M), xp.uint32))
            his.append(xp.zeros((P, M), xp.uint32))
            continue
        pos = j * bw

        def bits32(start, width):
            # `width` bits at absolute bit `start` (width <= 32): one or two
            # statically-indexed words
            w0 = start >> 5
            sh = start & 31
            v = words[:, :, w0] >> xp.uint32(sh) if w0 < W else xp.zeros(
                (P, M), xp.uint32)
            if sh and sh + width > 32 and w0 + 1 < W:
                v = v | (words[:, :, w0 + 1] << xp.uint32(32 - sh))
            if width < 32:
                v = v & xp.uint32((1 << width) - 1)
            return v

        lo_w = min(bw, 32)
        lo = bits32(pos, lo_w)
        hi = (bits32(pos + 32, bw - 32) if bw > 32
              else xp.zeros((P, M), xp.uint32))
        los.append(lo)
        his.append(hi)
    return xp.stack(los, axis=-1), xp.stack(his, axis=-1)


def decode_delta_planes(xp, arrays, dims, bws: tuple[int, ...],
                        out_len: int, n_planes: int):
    """PS_DELTA_RAW structure planes -> nn-space value planes
    ([P, out_len] i32 x n_planes; [lo] for INT32, [lo, hi] for INT64)."""
    mbv = int(dims["delta_mb_values"])
    mbc = int(dims["delta_mb_cap"])
    pitch = int(dims["delta_pitch"])
    raw = arrays["delta_bytes"]
    P = raw.shape[0]
    # u32 word view of the packed bytes, little-endian
    words = xp.asarray(raw).reshape(P, mbc, pitch // 4, 4).astype(xp.uint32)
    words = (words[..., 0] | (words[..., 1] << xp.uint32(8))
             | (words[..., 2] << xp.uint32(16))
             | (words[..., 3] << xp.uint32(24)))

    bw_rows = xp.asarray(arrays["delta_bw"])          # [P, mbc] i32
    cnt = xp.asarray(arrays["delta_cnt"])             # [P, mbc] i32
    md_lo = xp.asarray(arrays["delta_md_lo"]).astype(xp.uint32)
    md_hi = xp.asarray(arrays["delta_md_hi"]).astype(xp.uint32)

    d_lo = xp.zeros((P, mbc, mbv), xp.uint32)
    d_hi = xp.zeros((P, mbc, mbv), xp.uint32)
    for bw in bws:
        lo_b, hi_b = _extract_static_bw(xp, words, int(bw), mbv)
        sel = (bw_rows == bw)[:, :, None]
        d_lo = xp.where(sel, lo_b, d_lo)
        d_hi = xp.where(sel, hi_b, d_hi)

    # delta = min_delta + unpacked (u64 via lo/hi with carry), zeroed past
    # each miniblock's live count (padding must not accumulate min_delta)
    live = (xp.arange(mbv, dtype=xp.int32)[None, None, :] < cnt[:, :, None])
    s_lo = d_lo + md_lo[:, :, None]
    carry = (s_lo < d_lo).astype(xp.uint32)
    s_hi = d_hi + md_hi[:, :, None] + carry
    z = xp.uint32(0)
    s_lo = xp.where(live, s_lo, z)
    s_hi = xp.where(live, s_hi, z)

    # flatten to the value axis with a zero delta at position 0 (the page's
    # first value), then ONE prefix sum + carry recovery
    V = 1 + mbc * mbv
    flat_lo = xp.concatenate(
        [xp.zeros((P, 1), xp.uint32), s_lo.reshape(P, mbc * mbv)], axis=1)
    flat_hi = xp.concatenate(
        [xp.zeros((P, 1), xp.uint32), s_hi.reshape(P, mbc * mbv)], axis=1)
    cum_lo = xp.cumsum(flat_lo, axis=1, dtype=xp.uint32)
    # carry out of step j: (cum_j mod 2^32) < delta_j  (single-add wrap)
    carries = (cum_lo < flat_lo).astype(xp.uint32)
    cum_hi = (xp.cumsum(flat_hi, axis=1, dtype=xp.uint32)
              + xp.cumsum(carries, axis=1, dtype=xp.uint32))

    f_lo = xp.asarray(arrays["delta_first_lo"]).astype(xp.uint32)[:, None]
    f_hi = xp.asarray(arrays["delta_first_hi"]).astype(xp.uint32)[:, None]
    v_lo = cum_lo + f_lo
    v_hi = cum_hi + f_hi + (v_lo < f_lo).astype(xp.uint32)

    def crop(a):
        a = a[:, :out_len] if V >= out_len else xp.concatenate(
            [a, xp.zeros((P, out_len - V), xp.uint32)], axis=1)
        if xp is np:
            return a.view(np.int32)
        import jax

        return jax.lax.bitcast_convert_type(a, xp.int32)

    planes = [crop(v_lo)]
    if n_planes > 1:
        planes.append(crop(v_hi))
    return planes


def read_delta_column(reader, column: str, engine: str = "jax"):
    """End-to-end decoded column for a DELTA_BINARY_PACKED INT32/INT64
    column: PS_DELTA_RAW prescan -> device bit-unpack + prefix sum ->
    UNCHANGED decode_fixed null/validity machinery.  Raises NativeError on
    non-delta or mixed files (callers use read_column's host path there)."""
    from ..host import bindings

    batch = reader.prescan(column, flags=bindings.PS_DELTA_RAW)
    if "delta_bw" not in batch.arrays:
        raise bindings.NativeError("column carries no DELTA_BINARY_PACKED "
                                   "pages")
    n_planes = 2 if int(batch.dims["plain_w"]) == 8 else 1
    bws = delta_bws(batch.arrays)
    if engine == "jax":
        import jax.numpy as jnp

        planes = decode_delta_planes(jnp, batch.arrays, batch.dims, bws,
                                     batch.nn_cap, n_planes)
    else:
        planes = decode_delta_planes(np, batch.arrays, batch.dims, bws,
                                     batch.nn_cap, n_planes)
    return _materialize_fixed_with_planes(batch, planes, engine)


def _materialize_fixed_with_planes(batch, planes, engine):
    from ..host.reader import DecodedColumn
    from . import decode as D

    if engine == "jax":
        import jax.numpy as jnp

        dplanes, nonnull = D.decode_fixed_jax(
            batch.arrays, [p for p in planes], [], None,
            max_def=batch.max_def, out_len=batch.vmax, nn_len=batch.nn_cap,
            mode="plain")
        dplanes = [np.asarray(p) for p in dplanes]
        nonnull = np.asarray(nonnull)
    else:
        dplanes, nonnull = D.decode_fixed(
            np, batch.arrays, [np.asarray(p) for p in planes], [], None,
            max_def=batch.max_def, out_len=batch.vmax, nn_len=batch.nn_cap,
            mode="plain")
    nv = batch.arrays["page_num_values"]
    keep = np.arange(batch.vmax)[None, :] < nv[:, None]
    valid = nonnull[keep]
    values = D.planes_to_array([p[keep] for p in dplanes],
                               batch.value_dtype)
    return DecodedColumn(batch.type, values, valid)
