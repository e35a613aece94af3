"""Streaming matcher kernel for the GPU — Pallas through Triton.

One program walks a block of adjacent lanes (pages, or split segments)
over every byte of the pre-transposed [steps, n] u8 stream that resident
serving keeps on device.  The carried walk state — value-boundary control
plus every pattern's matcher registers — stays in registers for the whole
walk; each byte row is one coalesced load of `block` adjacent bytes.  The
loads do not depend on the recurrence, so the `inner` rows of one loop step
are all issued before their arithmetic.  The payload is read once, and
there is no per-byte kernel launch or state round trip through device
memory, which is what the lax.scan walk pays on the GPU.

The per-byte work is ops/strings.byte_step with the register-machine
transitions (ops/bitprog, bitap) — elementwise int32 ops.  The lax.scan
walk in ops/strings is the reference; tests run this kernel in interpret
mode against the numpy mirror.
"""

from __future__ import annotations

BLOCK = 128      # lanes per program (power of two)
INNER = 8        # byte rows per loop step
NUM_WARPS = 4    # BLOCK / (32 * NUM_WARPS) lanes per thread


def match_stream_kernel(cols, steps: int, payload_len, nn, specs, *,
                        block: int = BLOCK, inner: int = INNER,
                        num_warps: int = NUM_WARPS,
                        interpret: bool = False):
    """Walks `steps` byte rows of `cols` ([P, N] u8, P >= steps) for every
    lane.  `specs` are (transition, n_state_regs, accept_empty) register
    machines.  Returns (hits: tuple of K [N] i32, values_seen [N] i32) —
    the ops/strings._match_stream_multi contract."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    from ..strings import byte_step, init_carry

    p, n = cols.shape
    steps = min(int(steps), p)
    k = len(specs)
    payload_len = jnp.asarray(payload_len, jnp.int32)
    nn = jnp.asarray(nn, jnp.int32)
    if n == 0:
        return tuple(jnp.zeros(0, jnp.int32) for _ in specs), jnp.zeros(0, jnp.int32)

    def kernel(pay_ref, plen_ref, nn_ref, hits_ref, seen_ref):
        lane = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
        live = lane < n
        plen = plgpu.load(plen_ref.at[:], mask=live, other=0)
        nnv = plgpu.load(nn_ref.at[:], mask=live, other=0)
        step = byte_step(jnp, specs, plen, nnv)

        def row(b):
            return plgpu.load(pay_ref.at[b, :], mask=live,
                              other=0).astype(jnp.int32)

        def body(i, carry):
            base = i * inner
            cs = [row(base + j) for j in range(inner)]
            for j in range(inner):
                carry = step(carry, base + j, cs[j])
            return carry

        carry = jax.lax.fori_loop(0, steps // inner, body,
                                  init_carry(jnp, (block,), specs))
        for b in range(steps - steps % inner, steps):
            carry = step(carry, b, row(b))
        hits, done = carry[4], carry[3]
        for kk in range(k):
            plgpu.store(hits_ref.at[kk, :], hits[kk], mask=live)
        plgpu.store(seen_ref.at[:], done, mask=live)

    lanes = lambda i: (i,)
    hits, seen = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, block),),
        in_specs=[
            pl.BlockSpec((p, block), lambda i: (0, i)),
            pl.BlockSpec((block,), lanes),
            pl.BlockSpec((block,), lanes),
        ],
        out_specs=[
            pl.BlockSpec((k, block), lambda i: (0, i)),
            pl.BlockSpec((block,), lanes),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((k, n), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="stream_matcher",
    )(cols, payload_len, nn)
    return tuple(hits[kk] for kk in range(k)), seen
