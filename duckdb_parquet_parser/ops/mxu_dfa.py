"""One-hot DFA transitions — regex as matrix multiplication.

The table DFA (patterns the register machines of ops/bitprog reject) walks
without a per-byte table gather (`state = T[state, byte]`):

  1. byte -> class one-hot via interval compares (byte-class compression:
     bytes with identical transition columns collapse; real patterns need
     ~5-20 classes) — a handful of elementwise compares per lane;
  2. G = class_onehot @ [T^T | A^T]   (matmul, [L,C] @ [C,2S]): G[l,s]
     is the next state IF the lane were in state s, and the accept bit of
     that next state;
  3. select row `state` of G (compare + masked sum).

State values are small integers (S < 256), exact in bfloat16, and each
output sums exactly one nonzero product, so the bf16 matmul with float32
accumulation is exact.  Neither this nor a gather walk is timed on the
H100 yet (ROADMAP Queue 1 item 5).  Used by
ops/strings.match_payload_stream (streaming page form) and dfa_match_mxu
(per-value form).
"""

from __future__ import annotations

import numpy as np


def make_mxu_transition(table: np.ndarray, accept: np.ndarray):
    """Returns transition(state [L] i32, byte [L] i32) -> (next [L] i32,
    accept_of_next [L] i32), gather-free, for jnp tracing.

    The byte one-hot is built over the K byte-class INTERVALS with two
    broadcast compares (one vector op each) — no per-class mask assembly —
    and the interval->class mapping folds into the transition table
    (rows indexed by interval instead of class)."""
    import jax
    import jax.numpy as jnp

    from .regex import DFA

    t_np = np.asarray(table)
    acc_np = np.asarray(accept)
    n_states = t_np.shape[0]
    bc = DFA(t_np, acc_np, "").byte_classes()

    # interval-indexed tables: row k = class(interval k)'s transition column
    t_k = bc.table[:, bc.interval_class].T.astype(np.float32)        # [K, S]
    a_k = acc_np[bc.table][:, bc.interval_class].T.astype(np.float32)
    both = jnp.asarray(np.concatenate([t_k, a_k], axis=1), jnp.bfloat16)
    lo = jnp.asarray(bc.interval_lo, jnp.int32)[None, :]             # [1, K]
    hi = jnp.asarray(bc.interval_hi, jnp.int32)[None, :]
    state_iota = jnp.arange(n_states, dtype=jnp.int32)[None, :]

    def transition(state, c):
        cb = c[:, None]
        onehot = ((cb >= lo) & (cb <= hi)).astype(jnp.bfloat16)      # [L, K]
        g = jax.lax.dot_general(
            onehot, both, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)  # [L, 2S]
        sel = state[:, None] == state_iota
        nxt = jnp.sum(jnp.where(sel, g[:, :n_states], 0), axis=1)
        acc_next = jnp.sum(jnp.where(sel, g[:, n_states:], 0), axis=1)
        return nxt, acc_next

    return transition


# C*S bound for the select transition.  Disabled by default: the matmul
# transition was chosen for wide lane batches on an earlier target; not
# measured on the H100.
SELECT_TERMS_MAX = 0


def make_hypothesis_transition(table: np.ndarray, accept: np.ndarray):
    """Byte-batched matmul transition: returns (g_fn, select_fn, B).

    The expensive part of the transition — G[l, s] = "next state if the lane
    were in state s" — depends only on the BYTE, not the carried state, so
    consecutive bytes batch into ONE matmul with a block-diagonal table:
    [L, B*K] @ [B*K, B*2S], B = min(128//K, 128//2S) bytes per product so
    small tables fill a 128-wide matrix unit.  The sequential part (select
    + value-boundary control) stays per byte.

      g_fn(cols [B, N] i32) -> list of B arrays [N, 2S] i32
      select_fn(state [N], g [N, 2S]) -> (next [N], accept_of_next [N])
    """
    import jax
    import jax.numpy as jnp

    from .regex import DFA

    t_np = np.asarray(table)
    acc_np = np.asarray(accept)
    n_states = t_np.shape[0]
    bc = DFA(t_np, acc_np, "").byte_classes()

    t_k = bc.table[:, bc.interval_class].T.astype(np.float32)  # [K, S]
    a_k = acc_np[bc.table][:, bc.interval_class].T.astype(np.float32)
    both_np = np.concatenate([t_k, a_k], axis=1)  # [K, 2S]
    k_count = both_np.shape[0]
    two_s = both_np.shape[1]

    b_bytes = max(1, min(128 // max(k_count, 1), 128 // max(two_s, 1)))
    block = np.zeros((b_bytes * k_count, b_bytes * two_s), np.float32)
    for t in range(b_bytes):
        block[t * k_count:(t + 1) * k_count, t * two_s:(t + 1) * two_s] = both_np
    block_bf16 = jnp.asarray(block, jnp.bfloat16)

    lo = jnp.asarray(bc.interval_lo, jnp.int32)[None, :]  # [1, K]
    hi = jnp.asarray(bc.interval_hi, jnp.int32)[None, :]
    state_iota = jnp.arange(n_states, dtype=jnp.int32)[None, :]

    def g_fn(cols):
        onehots = []
        for t in range(b_bytes):
            cb = cols[t][:, None]
            onehots.append(((cb >= lo) & (cb <= hi)).astype(jnp.bfloat16))
        oh = jnp.concatenate(onehots, axis=1)  # [N, B*K]
        g = jax.lax.dot_general(
            oh, block_bf16, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)  # [N, B*2S]
        return [g[:, t * two_s:(t + 1) * two_s] for t in range(b_bytes)]

    def select_fn(state, g):
        sel = state[:, None] == state_iota
        nxt = jnp.sum(jnp.where(sel, g[:, :n_states], 0), axis=1)
        acc_next = jnp.sum(jnp.where(sel, g[:, n_states:], 0), axis=1)
        return nxt, acc_next

    return g_fn, select_fn, b_bytes


def make_select_transition(table: np.ndarray, accept: np.ndarray):
    """Pure-VPU transition for small automata: next = Σ_{c,s} (class==c &
    state==s) * T[s,c], unrolled over the (class, state) product with
    zero-target terms skipped.  No matmul per step; meant for small C*S
    (a few hundred terms)."""
    import jax.numpy as jnp

    from .regex import DFA

    t_np = np.asarray(table)
    acc_np = np.asarray(accept)
    n_states = t_np.shape[0]
    bc = DFA(t_np, acc_np, "").byte_classes()
    t2 = bc.table  # [S, C]
    intervals = list(
        zip(bc.interval_lo.tolist(), bc.interval_hi.tolist(),
            bc.interval_class.tolist())
    )
    acc_i = acc_np.astype(np.int32)

    def transition(state, c):
        cls_masks = [None] * bc.n_classes
        for lo, hi, cl in intervals:
            m = (c == lo) if lo == hi else ((c >= lo) & (c <= hi))
            cls_masks[cl] = m if cls_masks[cl] is None else (cls_masks[cl] | m)
        st_masks = [state == s for s in range(n_states)]
        nxt = jnp.zeros_like(state)
        for s in range(n_states):
            for cl in range(bc.n_classes):
                target = int(t2[s, cl])
                if target == 0:
                    continue  # state 0 contributes nothing
                nxt = nxt + jnp.where(st_masks[s] & cls_masks[cl], target, 0)
        acc_next = jnp.zeros_like(state)
        for s in range(1, n_states):
            if acc_i[s]:
                acc_next = acc_next + (nxt == s).astype(jnp.int32)
        if acc_i[0]:
            acc_next = acc_next + (nxt == 0).astype(jnp.int32)
        return nxt, acc_next

    return transition


def make_transition(table: np.ndarray, accept: np.ndarray):
    """Picks the best gather-free transition for the automaton size."""
    from .regex import DFA

    t_np = np.asarray(table)
    bc = DFA(t_np, np.asarray(accept), "").byte_classes()
    if bc.n_classes * t_np.shape[0] <= SELECT_TERMS_MAX:
        return make_select_transition(table, accept)
    return make_mxu_transition(table, accept)


def dfa_match_mxu(xp, chars, lens, table, accept, unroll: int = 8):
    """One-hot DFA over fixed-pitch char matrices.

    chars: [L, P] u8 (zero padded); lens: [L] i32;
    table: [S, 256] i32; accept: [S] bool.  Returns [L] bool.
    numpy path mirrors the table-walk math (used by tests).
    """
    if xp is np:
        state = np.zeros(chars.shape[0], np.int32)
        for j in range(chars.shape[1]):
            nxt = table[state, chars[:, j].astype(np.int32)]
            state = np.where(j < lens, nxt, state)
        return np.asarray(accept)[state]

    import jax
    import jax.numpy as jnp

    transition = make_mxu_transition(table, accept)
    acc = jnp.asarray(np.asarray(accept))
    lens = jnp.asarray(lens, dtype=jnp.int32)
    # xs stay u8 (lax.scan materializes them — int32 would stage 4x the
    # bytes through HBM); widen the sliced column per step instead
    cols = jnp.transpose(jnp.asarray(chars))  # [P, L] u8

    def step(state, xs):
        j, col = xs
        nxt, _ = transition(state, col.astype(jnp.int32))
        return jnp.where(j < lens, nxt, state), None

    state0 = jnp.zeros(chars.shape[0], jnp.int32)
    state, _ = jax.lax.scan(
        step, state0, (jnp.arange(cols.shape[0]), cols), unroll=unroll
    )
    return jnp.take(acc, state)  # one final gather of L elements
