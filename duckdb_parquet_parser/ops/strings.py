"""Device-side BYTE_ARRAY parsing — length prefixes and regex over RAW page
payloads, with zero per-value host work.

This moves the reference's string hot loops onto the device
(reference: src/reader/parquet_reader.cpp:442-453 PLAIN prefix walk;
src/reader/column_reader.cpp:249-253): the host uploads each page's raw value
section (`payload` [N, P] u8, from the PS_PAYLOAD pre-scan) and the device
does the rest:

  * `string_offsets`  — per-value (offset, len) tables via a lax.scan over the
    per-page value chain: all pages advance in lockstep, one value per step
    (pages are ~1 KB ⇒ tens of values), each step a 4-byte gather per page.
  * `match_payload_stream` — a streaming DFA that consumes one byte column
    per step across all pages: each page lane tracks (prefix_left, ctr,
    dfa_state, values_done, accepts), where ctr double-serves as the length
    accumulator (inside a prefix) and the bytes-left countdown (inside a
    value).  Register machines (ops/bitprog, bitap) walk through the
    streaming kernel on the GPU (ops/pallas/stream_matcher.py); table DFAs
    use a gather-free one-hot matmul transition (mxu_dfa.py, use_mxu=True).
    No char matrix is ever materialized, so scan traffic equals the raw
    page bytes.

Both are xp-generic (numpy mirrors are the test oracle).
"""

from __future__ import annotations

import os

import numpy as np

# lax.scan unroll factor for the streaming walk (DPQ_SCAN_UNROLL overrides).
# Swept 1/8/32 on one H100 (400 W limit), SF1 lineitem comments, chain
# pattern: 15.0 / 3.1 / 3.9 ms per walk (PERF.md).
SCAN_UNROLL = int(os.environ.get("DPQ_SCAN_UNROLL", "8"))


def string_offsets(xp, payload, nn, cap: int):
    """Parse PLAIN BYTE_ARRAY length prefixes on device.

    payload: [N, P] u8 (raw value sections, zero-padded);
    nn: [N] i32 value counts.  Returns (offs [N, cap] i32 — first char byte,
    lens [N, cap] i32); entries beyond nn are zero.

    All memory access is flat 1-D gathers.
    """
    n, p = payload.shape
    flat = payload.reshape(-1).astype(xp.int32)
    base = xp.arange(n, dtype=xp.int32) * p

    def le32_at(off):  # absolute flat offsets [N] -> [N]
        o = xp.clip(off, 0, n * p - 4)
        b = lambda k: xp.take(flat, o + k)
        return b(0) | (b(1) << 8) | (b(2) << 16) | (b(3) << 24)

    if xp is np:
        offs = np.zeros((n, cap), np.int32)
        lens = np.zeros((n, cap), np.int32)
        off = base.copy()
        for k in range(cap):
            ln = le32_at(off)
            live = k < nn
            offs[:, k] = np.where(live, off - base + 4, 0)
            lens[:, k] = np.where(live, ln, 0)
            off = np.where(live, off + 4 + ln, off)
        return offs, lens

    import jax

    def step(off, k):
        ln = le32_at(off)
        live = k < nn
        out_off = xp.where(live, off - base + 4, 0)
        out_len = xp.where(live, ln, 0)
        return xp.where(live, off + 4 + ln, off), (out_off, out_len)

    _, (offs, lens) = jax.lax.scan(
        step, base, xp.arange(cap, dtype=xp.int32)
    )
    return xp.transpose(offs), xp.transpose(lens)


def make_bitap_transition(xp, needles: list[bytes]):
    """Shift-And (bitap) transition for substring-chain patterns
    ('%lit1%lit2%' / 'lit1.*lit2').

    Exact ordered-substring matching: register k is a bitset of the active
    prefix lengths of needle k (all prefixes tracked simultaneously, so
    self-overlapping needles are handled); needle k+1 starts seeding only
    after needle k has completed.  Per byte this costs a handful of [N] int32
    vector ops — an order of magnitude less intermediate traffic than the
    general DFA transition's [N, K]/[N, 2S] tensors.

    Returns (transition(state_tuple, c) -> (next_tuple, accept [N] i32),
    n_state_regs, accept_empty).
    """
    k_needles = len(needles)
    specs = []
    for nd in needles:
        masks: dict[int, int] = {}
        for pos, byte in enumerate(nd):
            masks[byte] = masks.get(byte, 0) | (1 << pos)
        specs.append((sorted(masks.items()), 1 << (len(nd) - 1)))

    def transition(state, c):
        regs, donebits = state[:-1], state[-1]
        new_regs = []
        new_done = donebits
        for k, (mask_items, top_bit) in enumerate(specs):
            mask = xp.zeros_like(c)
            for byte, m in mask_items:
                mask = mask | xp.where(c == byte, m, 0)
            seed = 1 if k == 0 else ((donebits >> (k - 1)) & 1)
            reg = ((regs[k] << 1) | seed) & mask
            hit = ((reg & top_bit) != 0).astype(xp.int32)
            new_done = new_done | (hit << k)
            new_regs.append(reg)
        accept = (new_done >> (k_needles - 1)) & 1
        return tuple(new_regs) + (new_done,), accept

    return transition, k_needles + 1, 0


def _resolve_transition(xp, table, accept, use_mxu=False,
                        chain: list[bytes] | None = None, prog=None):
    """(transition, n_state_regs, accept_empty) by the priority order:
    bit-parallel program (ops/bitprog.py), bitap chain, one-hot matmul
    (jnp), flat table gather (the numpy oracle)."""
    if prog is not None:
        from .bitprog import (
            BitprogUnsupported,
            make_bitprog_transition,
            make_bitprog_transition_pair,
        )

        trans, n, ae = make_bitprog_transition(xp, prog)
        try:
            # 2-bytes-per-step composed variant (no-smear packed/fused
            # family) — _match_stream_multi uses it when every matcher in
            # the walk carries one
            trans.pair2 = make_bitprog_transition_pair(xp, prog)[0]
        except BitprogUnsupported:
            pass
        return trans, n, ae
    if chain:
        return make_bitap_transition(xp, chain)

    tflat = xp.asarray(table, dtype=xp.int32).reshape(-1)
    acc_i = xp.asarray(accept).astype(xp.int32)
    acc0 = int(np.asarray(accept)[0])  # accept of the empty string

    def _wrap_scalar(trans):
        """Adapts a scalar-state transition to the tuple-state interface."""
        def transition(state, c):
            nxt, acc = trans(state[0], c)
            return (nxt,), acc
        return transition

    if use_mxu and xp is not np:
        from .mxu_dfa import make_transition

        return _wrap_scalar(make_transition(table, accept)), 1, acc0

    def gather_scalar(state, c):
        nxt = xp.take(tflat, xp.clip(state, 0, None) * 256 + c)
        return nxt, xp.take(acc_i, nxt)

    return _wrap_scalar(gather_scalar), 1, acc0


def _combined(specs, state, c):
    """Advances every matcher of `specs` by byte `c`; the registers of all
    patterns are one flat tuple."""
    news, accs = [], []
    i = 0
    for trans, nregs, _ae in specs:
        s2, a = trans(tuple(state[i:i + nregs]), c)
        i += nregs
        news.extend(s2)
        accs.append(a)
    return tuple(news), accs


def init_carry(xp, shape, specs):
    """Walk state before the first byte: (prefix_left, ctr, matcher
    registers, values_done, hits)."""
    total_regs = sum(s[1] for s in specs)
    zero = lambda: xp.zeros(shape, xp.int32)
    return (xp.full(shape, 4, xp.int32), zero(),
            tuple(zero() for _ in range(total_regs)), zero(),
            tuple(zero() for _ in range(len(specs))))


def byte_step(xp, specs, payload_len, nn):
    """One payload byte for every lane: `step(carry, b, c)` advances the
    matchers and the value-boundary state machine past byte `c` at offset
    `b`.  Shared by the lax.scan walk, the numpy mirror and the streaming
    kernel (ops/pallas/stream_matcher.py); all ops are elementwise int32.

    Carry layout: `ctr` serves double duty — inside a length prefix it
    accumulates the little-endian length; inside a value it counts bytes
    left.  They are never live simultaneously (at the prefix->value
    boundary the accumulated length IS the initial bytes-left).  Inactive
    lanes (past the section or the value count) may hold garbage
    ctr/state — harmless, since `active` gates every finalize.  Zeros are
    the per-value initial state for every transition kind."""

    def step(carry, b, c):
        prefix_left, ctr, state, done, hits = carry
        st2, accs = _combined(specs, state, c)
        active = (b < payload_len) & (done < nn)
        in_prefix = prefix_left > 0

        # prefix byte: accumulate little-endian length into ctr (the shift
        # is masked to 0..24: outside a prefix the value is discarded, and
        # a 32-bit shift is undefined in the kernel's lowering)
        la2 = ctr | (c << (8 * ((4 - prefix_left) & 3)))
        pl2 = prefix_left - 1
        prefix_done = in_prefix & (pl2 == 0) & active
        zero_len = prefix_done & (la2 == 0)

        # value byte: count down ctr
        bl2 = ctr - 1
        value_done = (~in_prefix) & (bl2 == 0) & active

        fin = zero_len | value_done
        hits = tuple(
            h + xp.where(fin, xp.where(zero_len, spec[2], a), 0)
            for h, spec, a in zip(hits, specs, accs)
        )
        done = done + fin.astype(xp.int32)

        new_prefix_left = xp.where(fin, 4, xp.where(in_prefix, pl2, prefix_left))
        new_ctr = xp.where(fin, 0, xp.where(in_prefix, la2, bl2))
        new_state = tuple(
            xp.where(prefix_done, 0, xp.where(in_prefix, old, new))
            for old, new in zip(state, st2)
        )
        return (new_prefix_left, new_ctr, new_state, done, hits)

    return step


def use_stream_kernel() -> bool:
    """Route choice for register-machine walks on device: the streaming
    kernel on the GPU, the lax.scan walk elsewhere (the CPU tests).  Table
    DFAs always take the lax.scan walk."""
    import jax

    return jax.default_backend() == "gpu"


def _match_stream_multi(xp, payload, payload_len, nn, specs,
                        max_steps: int | None, transposed: bool,
                        registers: bool = False):
    """Shared streaming core: K matcher transitions ride ONE payload walk
    (the per-byte boundary control and the byte stream itself amortize
    over every pattern).  `specs` is a list of
    (transition, n_state_regs, accept_empty); `registers` says every
    transition is an elementwise register machine (bitprog or bitap), which
    the streaming kernel can run.  Returns (hits: tuple of K [N] i32,
    values_seen [N] i32)."""
    if transposed:
        p, n = payload.shape
    else:
        n, p = payload.shape
    steps = min(int(max_steps or p), p)
    nn = xp.asarray(nn, dtype=xp.int32)
    payload_len = xp.asarray(payload_len, dtype=xp.int32)
    init = init_carry(xp, (n,), specs)

    if xp is np:
        payload_i = (payload.T if transposed else payload).astype(np.int32)
        step = byte_step(np, specs, payload_len, nn)
        carry = init
        for b in range(steps):
            carry = step(carry, b, payload_i[:, b])
        return carry[4], carry[3]

    # xs stay u8: lax.scan materializes its xs, so a pre-widened int32
    # [P, N] matrix would write+read 4x the payload bytes through HBM;
    # widening per step is one fused op on the sliced column instead.
    cols = payload if transposed else xp.transpose(payload[:, :steps])

    if registers and use_stream_kernel():
        from .pallas.stream_matcher import match_stream_kernel

        return match_stream_kernel(cols, steps, payload_len, nn, specs)

    import jax

    pair_ok = (
        steps % 2 == 0
        and all(getattr(s[0], "pair2", None) is not None for s in specs)
        and _pair_step_enabled()
    )
    if pair_ok:
        return _pair_scan(xp, cols, steps, payload_len, nn, specs, init, n)

    step = byte_step(xp, specs, payload_len, nn)

    def scan_step(carry, xs):
        b, c8 = xs
        return step(carry, b, c8.astype(xp.int32)), None

    carry, _ = jax.lax.scan(
        scan_step, init, (xp.arange(steps, dtype=xp.int32), cols[:steps]),
        unroll=SCAN_UNROLL,
    )
    return carry[4], carry[3]


def _pair_step_enabled() -> bool:
    from ..utils.config import get_config

    return get_config().pair_step


def _pair_scan(xp, cols, steps, payload_len, nn, specs, init, n):
    """2-bytes-per-step walk: composed matcher transitions (bitprog pair
    family — same dependent-chain depth as ONE byte) with the two-byte
    boundary control run inline.  Semantically
    identical to the per-byte walk; parity-pinned in test_bitprog."""
    import jax

    one = xp.ones((), xp.int32)

    def pair_step(carry, xs):
        b, c8 = xs                      # c8: [2, N] u8
        c1 = c8[0].astype(xp.int32)
        c2 = c8[1].astype(xp.int32)
        prefix_left, ctr, state, done, hits = carry

        # byte 1 control flags
        active1 = (b < payload_len) & (done < nn)
        ip1 = prefix_left > 0
        la1 = ctr | (c1 << (8 * (4 - prefix_left)))
        pl1 = prefix_left - 1
        pd1 = ip1 & (pl1 == 0) & active1
        zl1 = pd1 & (la1 == 0)
        bl1 = ctr - 1
        vd1 = (~ip1) & (bl1 == 0) & active1
        fin1 = zl1 | vd1
        done1 = done + fin1.astype(xp.int32)
        npl1 = xp.where(fin1, 4, xp.where(ip1, pl1, prefix_left))
        nctr1 = xp.where(fin1, 0, xp.where(ip1, la1, bl1))

        # byte 2 control flags (from byte 1's control outputs)
        active2 = (b + one < payload_len) & (done1 < nn)
        ip2 = npl1 > 0
        la2 = nctr1 | (c2 << (8 * (4 - npl1)))
        pl2 = npl1 - 1
        pd2 = ip2 & (pl2 == 0) & active2
        zl2 = pd2 & (la2 == 0)
        bl2 = nctr1 - 1
        vd2 = (~ip2) & (bl2 == 0) & active2
        fin2 = zl2 | vd2
        done2 = done1 + fin2.astype(xp.int32)
        npl2 = xp.where(fin2, 4, xp.where(ip2, pl2, npl1))
        nctr2 = xp.where(fin2, 0, xp.where(ip2, la2, bl2))

        # composed matcher advance (gating folded in)
        news = []
        acc1s, acc2s = [], []
        i = 0
        for trans, nregs, _ae in specs:
            s2, a1, a2 = trans.pair2(tuple(state[i:i + nregs]), c1, c2,
                                     pd1, ip1, pd2, ip2)
            i += nregs
            news.extend(s2)
            acc1s.append(a1)
            acc2s.append(a2)

        hits = tuple(
            h + xp.where(fin1, xp.where(zl1, spec[2], a1), 0)
              + xp.where(fin2, xp.where(zl2, spec[2], a2), 0)
            for h, spec, a1, a2 in zip(hits, specs, acc1s, acc2s)
        )
        return (npl2, nctr2, tuple(news), done2, hits), None

    xs_idx = xp.arange(0, steps, 2, dtype=xp.int32)
    xs_cols = cols[:steps].reshape(steps // 2, 2, n)
    carry, _ = jax.lax.scan(pair_step, init, (xs_idx, xs_cols),
                            unroll=max(SCAN_UNROLL // 2, 1))
    return carry[4], carry[3]


def match_payload_stream(xp, payload, payload_len, nn, table, accept,
                         max_steps: int | None = None, use_mxu: bool = False,
                         chain: list[bytes] | None = None, prog=None,
                         transposed: bool = False):
    """Streaming DFA over raw PLAIN BYTE_ARRAY payloads.

    Returns (accept_counts [N] i32, values_seen [N] i32): number of values per
    page whose bytes the DFA accepts, with value boundaries parsed from the
    4-byte length prefixes on the fly.

    Transition priority: `prog` (bit-parallel NFA program, ops/bitprog.py —
    bitap-class speed for classes/quantifiers/gaps/alternation/anchors),
    then `chain`
    (Shift-And bitap for pure substring chains), then the DFA table —
    one-hot matmuls with use_mxu=True (mxu_dfa.py), plain table gather
    otherwise (the numpy oracle).  The first two are register machines and
    take the streaming kernel on the GPU (use_stream_kernel).

    `transposed=True` means `payload` is ALREADY the [P, N] byte-column
    stream the scan consumes; resident serving layouts store the stream
    pre-transposed so no query pays the transpose.
    """
    specs = [_resolve_transition(xp, table, accept, use_mxu, chain, prog)]
    hits, seen = _match_stream_multi(xp, payload, payload_len, nn, specs,
                                     max_steps, transposed,
                                     registers=prog is not None or bool(chain))
    return hits[0], seen


def match_payload_multi(xp, payload, payload_len, nn, matchers,
                        max_steps: int | None = None,
                        transposed: bool = False):
    """K patterns in ONE payload walk — the multi-query serving fast path.

    `matchers` is a list of (chain, prog) pairs (register-machine
    transitions only: the byte stream, its per-step slice, and the
    boundary control amortize over every pattern, so K patterns cost far
    less than K walks).  Returns (hits: tuple of K [N] i32 accept counts,
    values_seen [N] i32).
    """
    specs = []
    for chain, prog in matchers:
        if prog is None and not chain:
            raise ValueError(
                "match_payload_multi needs register-machine matchers "
                "(prog or chain) — route table-DFA patterns separately"
            )
        specs.append(_resolve_transition(xp, None, None, False, chain, prog))
    hits, seen = _match_stream_multi(xp, payload, payload_len, nn, specs,
                                     max_steps, transposed, registers=True)
    return hits, seen


def match_values_by_offset(xp, payload, offs, lens, table, accept,
                           pitch: int):
    """Per-value DFA with chars gathered from the payload on the fly
    (pitch = max value length scan steps; all gathers flat 1-D).
    Values longer than `pitch` would be truncated — callers must size pitch
    from the true max length.  Returns [N, cap] bool accepts."""
    n, cap = offs.shape
    p = payload.shape[1]
    tflat = xp.asarray(table, dtype=xp.int32).reshape(-1)
    acc = xp.asarray(accept)
    flat = payload.reshape(-1).astype(xp.int32)
    gbase = (xp.arange(n, dtype=xp.int32) * p)[:, None] + offs  # [N, cap]
    top = n * p - 1

    if xp is np:
        state = np.zeros((n, cap), np.int32)
        for j in range(pitch):
            c = flat[np.clip(gbase + j, 0, top)]
            nxt = tflat[state * 256 + c]
            state = np.where(j < lens, nxt, state)
        return acc[state]

    import jax

    def step(state, j):
        c = xp.take(flat, xp.clip(gbase + j, 0, top))
        nxt = xp.take(tflat, state * 256 + c)
        return xp.where(j < lens, nxt, state), None

    state, _ = jax.lax.scan(
        step, xp.zeros((n, cap), xp.int32), xp.arange(pitch, dtype=xp.int32)
    )
    return xp.take(acc, state)
