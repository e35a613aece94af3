"""Streaming matcher kernel (ops/pallas/stream_matcher.py) vs the numpy
mirror of the walk — interpret mode on CPU; the GPU lane
(tests/test_gpu_parity.py) and chip_smoke.py run the compiled kernel on the
card.  Also pins the route choice (kernel on the GPU, lax.scan elsewhere)."""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser.ops.bitprog import compile_bitprog
from duckdb_parquet_parser.ops.strings import (
    _resolve_transition,
    match_payload_multi,
    match_payload_stream,
)
from tests.test_bitprog import _pages


def _kernel(pm, pl_, nn, matchers, **kw):
    """Runs the kernel in interpret mode over the [P, N] stream of `pm`;
    `matchers` are (chain, prog) pairs."""
    import jax.numpy as jnp

    from duckdb_parquet_parser.ops.pallas.stream_matcher import (
        match_stream_kernel,
    )

    specs = [_resolve_transition(jnp, None, None, False, chain, prog)
             for chain, prog in matchers]
    hits, seen = match_stream_kernel(jnp.asarray(pm.T), pm.shape[1], pl_, nn,
                                     specs, interpret=True, **kw)
    return [np.asarray(h) for h in hits], np.asarray(seen)


@pytest.mark.parametrize("pattern", [
    "a.*z", "ab|cde|fg", "^ab", "q[ax]+x", "a?", "a{40}",
    "gr[ae]y|colou?r", "bc$",
    # lead-run counter machines (sticky, non-sticky residual, '$'-sampled)
    "[abq]{9}", "[a-gq-z]{9,12}x", "[abx ]{10}$",
])
def test_interpret_parity(pattern):
    rng = np.random.default_rng(12)
    pm, pl_, nn = _pages(rng, n_pages=300, vals_per_page=6, maxlen=18)
    prog = compile_bitprog(pattern)
    h0, s0 = match_payload_stream(np, pm, pl_, nn, None, None, prog=prog)
    # block=64 gives five programs over 300 pages, the last one partial
    (h1,), s1 = _kernel(pm, pl_, nn, [(None, prog)], block=64)
    np.testing.assert_array_equal(h1, h0, err_msg=pattern)
    np.testing.assert_array_equal(s1, s0, err_msg=pattern)


def test_multi_stream_padding_lanes_inactive():
    """Lanes past N in the last program's block are masked: they never load,
    store, or contribute hits or seen counts."""
    rng = np.random.default_rng(3)
    pm, pl_, nn = _pages(rng, n_pages=37, vals_per_page=3, maxlen=12)
    prog = compile_bitprog("a.*z")
    h0, s0 = match_payload_stream(np, pm, pl_, nn, None, None, prog=prog)
    (h1,), s1 = _kernel(pm, pl_, nn, [(None, prog)])
    assert h1.shape == (37,) and s1.shape == (37,)
    np.testing.assert_array_equal(h1, h0)
    np.testing.assert_array_equal(s1, s0)


@pytest.mark.parametrize("block", [32, 64, 128, 256])
def test_partial_block_lane_counts(block):
    """Lane counts that are not a multiple of the block, at every block
    size, and a step count that leaves a tail after the unrolled loop."""
    rng = np.random.default_rng(block)
    pm, pl_, nn = _pages(rng, n_pages=block * 2 + 7, vals_per_page=4,
                         maxlen=15)
    prog = compile_bitprog("q[ax]+x")
    steps = (pm.shape[1] - 8) // 4 * 4 + 3  # 3 tail rows after the loop
    h0, s0 = match_payload_stream(np, pm, pl_, nn, None, None, prog=prog,
                                  max_steps=steps)
    (h1,), s1 = _kernel(pm[:, :steps], pl_, nn, [(None, prog)], block=block,
                        inner=4)
    np.testing.assert_array_equal(h1, h0)
    np.testing.assert_array_equal(s1, s0)


def test_fused_k3_interpret_parity():
    """K=3 patterns (two bitprog machines and a bitap chain) in one kernel
    walk equal the numpy multi-pattern walk."""
    rng = np.random.default_rng(8)
    pm, pl_, nn = _pages(rng, n_pages=200, vals_per_page=5, maxlen=20)
    matchers = [(None, compile_bitprog("a.*z")),
                ([b"ab", b"q"], None),
                (None, compile_bitprog("gr[ae]y|colou?r"))]
    h0, s0 = match_payload_multi(np, pm, pl_, nn, matchers)
    h1, s1 = _kernel(pm, pl_, nn, matchers)
    for a, b in zip(h1, h0):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(s1, s0)


def test_split_layout_interpret_parity():
    """Pages re-chunked at value boundaries (ops/scan.split_payload_pages)
    walk as segments through the kernel; segment sums equal the per-page
    walk."""
    from duckdb_parquet_parser.ops.scan import split_payload_pages

    rng = np.random.default_rng(17)
    pm, pl_, nn = _pages(rng, n_pages=12, vals_per_page=40, maxlen=20)
    arrays = {"payload": pm, "page_payload_len": pl_, "page_nn": nn,
              "page_kind": np.zeros(len(nn), np.int32)}
    sp = split_payload_pages(arrays, trigger=128, target=64)
    assert sp is not None
    seg_payload, seg_len, seg_nn, seg_page = sp
    prog = compile_bitprog("[abq]{9}")
    h0, s0 = match_payload_stream(np, pm, pl_, nn, None, None, prog=prog)
    (h1,), s1 = _kernel(seg_payload, seg_len, seg_nn, [(None, prog)])
    np.testing.assert_array_equal(
        np.bincount(seg_page, weights=h1, minlength=len(nn)), h0)
    np.testing.assert_array_equal(
        np.bincount(seg_page, weights=s1, minlength=len(nn)), s0)


def test_route_choice(monkeypatch):
    """Register machines walk through the kernel when the backend is the
    GPU and through lax.scan otherwise; table DFAs always take lax.scan;
    a kernel that cannot compile raises instead of falling back."""
    import jax
    import jax.numpy as jnp

    from duckdb_parquet_parser.ops.pallas import stream_matcher as SM
    from duckdb_parquet_parser.ops.regex import compile_pattern

    rng = np.random.default_rng(4)
    pm, pl_, nn = _pages(rng, n_pages=40, vals_per_page=4, maxlen=12)
    prog = compile_bitprog("a.*z")
    h0, _ = match_payload_stream(np, pm, pl_, nn, None, None, prog=prog)

    real = SM.match_stream_kernel
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return real(*a, interpret=True, **k)

    monkeypatch.setattr(SM, "match_stream_kernel", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    h, _ = match_payload_stream(jnp, pm, pl_, nn, None, None, prog=prog)
    np.testing.assert_array_equal(np.asarray(h), h0)
    assert not calls

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    h, _ = match_payload_stream(jnp, pm, pl_, nn, None, None, prog=prog)
    np.testing.assert_array_equal(np.asarray(h), h0)
    assert calls == [1]

    dfa = compile_pattern("(ab)+c")
    match_payload_stream(jnp, pm, pl_, nn, dfa.table, dfa.accept,
                         use_mxu=True)
    assert calls == [1]

    # the compiled (non-interpret) kernel cannot build on this CPU: the
    # error surfaces to the caller
    monkeypatch.setattr(SM, "match_stream_kernel", real)
    with pytest.raises(Exception):
        match_payload_stream(jnp, pm, pl_, nn, None, None, prog=prog)
