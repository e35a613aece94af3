"""Regex page-pruning scan — vectorized DFA matching over packed string pages.

Implements the reference README's regex filtering mode (reference:
README.md:54-64): evaluate a pattern over every non-null value of a column and
report the data pages with NO matching values (`--neg-regex` inverts the
per-value accept first).  The reference names re2 but ships no implementation;
the contract here is re2-like *search* semantics, with Python `re` as the
test oracle and as the host fallback for patterns outside the DFA subset —
both paths produce identical survivor sets.

Device shape of the matcher: values are packed by the host pre-scan into a
fixed-pitch char matrix; the DFA advances all lanes one byte per step
(`state = table[state, byte]`, a flat-table gather), with padded tail bytes
holding the state.  Dictionary-encoded pages get the fast path: match each
dictionary entry once, then map per-value accepts through the expanded index
stream — O(dict + values) instead of O(bytes).
"""

from __future__ import annotations

import functools as _functools
import re as _re
from dataclasses import dataclass

import numpy as np

from . import decode as _decode
from .regex import UnsupportedPattern, compile_pattern


def dfa_match(xp, chars, lens, table, accept):
    """Match L values against the DFA.

    chars: [L, P] u8 fixed-pitch (zero-padded); lens: [L] i32;
    table: [S, 256] i32; accept: [S] bool.  Returns [L] bool.
    """
    tflat = xp.asarray(table, dtype=xp.int32).reshape(-1)
    acc = xp.asarray(accept)
    lens = xp.asarray(lens, dtype=xp.int32)
    n, pitch = chars.shape

    if xp is np:
        state = np.zeros(n, np.int32)
        for j in range(pitch):
            nxt = tflat[state * 256 + chars[:, j].astype(np.int32)]
            state = np.where(j < lens, nxt, state)
        return acc[state]

    import jax
    import jax.numpy as jnp

    # xs stay u8 (lax.scan materializes them); widen per step
    cols = jnp.transpose(xp.asarray(chars))  # [P, L] u8

    def step(state, xs):
        j, col = xs
        nxt = jnp.take(tflat, state * 256 + col.astype(jnp.int32))
        return jnp.where(j < lens, nxt, state), None

    state0 = jnp.zeros(n, jnp.int32)
    state, _ = jax.lax.scan(step, state0, (jnp.arange(pitch), cols))
    return jnp.take(acc, state)


def scan_steps(plen, quantum: int = 128) -> int:
    """Step bound for the streaming matcher: the true max payload length,
    rounded up to `quantum` so compiled shapes stay stable across batches.

    The payload matrix pitch carries +260 bytes of header-window slack
    (dpq_prescan.hpp), and the matcher's cost grows with the SEQUENTIAL
    step count — walking the pitch instead of the real max walks ~25% more
    bytes on 1 KB pages."""
    m = int(np.max(plen)) if len(plen) else 1
    return max(-(-m // quantum) * quantum, 1)


def length_buckets(plen: np.ndarray, max_buckets: int = 2,
                   min_bucket: int = 1024) -> list[tuple[np.ndarray, int]]:
    """Bucket pages by payload length to cut wasted scan steps.

    The streaming matcher walks every lane for `max_steps` byte columns, so
    a batch padded to the longest page wastes (pad - plen) steps per page.
    Sorting pages by length and splitting at the point minimizing
    sum(bucket_size x bucket_max) recovers most of it (~15-20% on the
    1 KB-page lineitem fixture).  Returns [(page_indices, max_steps), ...]
    in ascending length order; buckets below `min_bucket` pages are not
    worth a second compiled shape and are merged."""
    n = len(plen)
    order = np.argsort(plen, kind="stable")
    sorted_len = np.asarray(plen)[order].astype(np.int64)
    if n < 2 * min_bucket or max_buckets < 2:
        return [(order, max(int(sorted_len[-1]), 1) if n else 1)]
    # one split point k: cost = k * len[k-1] + (n-k) * len[-1]
    k = np.arange(1, n)
    cost = k * sorted_len[k - 1] + (n - k) * int(sorted_len[-1])
    best = int(k[np.argmin(cost)])
    if best < min_bucket or n - best < min_bucket:
        return [(order, max(int(sorted_len[-1]), 1))]
    return [
        (order[:best], max(int(sorted_len[best - 1]), 1)),
        (order[best:], max(int(sorted_len[-1]), 1)),
    ]


@dataclass
class PageMatchResult:
    """Per-page accept counts for one scanned column batch."""

    page_gid: np.ndarray        # [N] global data-page ids
    match_counts: np.ndarray    # [N] number of accepted (non-null) values
    value_counts: np.ndarray    # [N] number of participating values
    # pages skipped via ColumnIndex min/max before any decode (cold path
    # only; 0 when stats pruning did not apply)
    stats_pruned_pages: int = 0
    dict_skipped_pages: int = 0  # all-miss dict short-circuits (cold scan)

    def pruned_pages(self) -> np.ndarray:
        """Global ids of pages with NO accepted values (the reported set)."""
        return self.page_gid[self.match_counts == 0]

    def surviving_pages(self) -> np.ndarray:
        return self.page_gid[self.match_counts > 0]


def _value_accepts(batch, dfa, *, negate: bool = False, xp=np):
    """Per-value accept/participation matrices in VALUE space.

    Returns (emit [N, vmax] bool, participating [N, vmax] bool) — the single
    source of the scan semantics: PLAIN pages participate at their non-null
    slots, dictionary pages additionally require an in-range index
    (reference: src/reader/column_reader.cpp:190-194); `negate` inverts the
    per-value match among participating values.  scan_batch's page counts
    and match_rows' row sets both reduce from these, so the two stay
    consistent by construction."""
    arrays = batch.arrays
    if batch.dims.get("nn_total", 0) > 0 and "str_padded" not in arrays:
        raise ValueError("batch was prescanned without pad_strings")

    nonnull_x, nn_idx_x = _decode.decode_levels(
        xp, _as_xp(xp, arrays), batch.max_def, batch.vmax
    )
    nonnull = np.asarray(nonnull_x)
    is_dict = arrays["page_kind"] == 1
    emit = np.zeros((batch.n_pages, batch.vmax), bool)
    part = np.zeros((batch.n_pages, batch.vmax), bool)

    has_plain = "str_padded" in arrays and arrays["str_padded"].shape[0] > 0
    if has_plain and (~is_dict).any():
        match = np.asarray(dfa_match(
            xp, _xp_arr(xp, arrays["str_padded"]), arrays["str_lens"],
            dfa.table, dfa.accept,
        ))
        entry = np.clip(arrays["str_nn_start"][:-1, None] + np.asarray(nn_idx_x),
                        0, len(match) - 1)
        plain_part = nonnull & ~is_dict[:, None]
        emit |= (match[entry] ^ negate) & plain_part
        part |= plain_part

    has_dict = "dict_padded" in arrays and int(batch.dims.get("dict_n", 0)) > 0
    if has_dict and is_dict.any():
        dict_match = np.asarray(dfa_match(
            xp, _xp_arr(xp, arrays["dict_padded"]), arrays["dict_lens"],
            dfa.table, dfa.accept,
        ))
        dict_idx, ok = _decode.decode_dict_indices(
            xp, _as_xp(xp, arrays), nn_idx_x, batch.nn_cap,
            nonnull=nonnull_x,
        )
        g = np.clip(
            arrays["page_dict_base"][:, None] + np.clip(np.asarray(dict_idx), 0, None),
            0, len(dict_match) - 1,
        )
        dict_part = np.asarray(ok) & nonnull & is_dict[:, None]
        emit |= (dict_match[g] ^ negate) & dict_part
        part |= dict_part
    return emit, part


def scan_batch(batch, pattern: str, *, negate: bool = False, xp=np) -> PageMatchResult:
    """Evaluate `pattern` over a BYTE_ARRAY batch (prescanned with
    pad_strings>0) and count accepted values per page."""
    try:
        dfa = compile_pattern(pattern)
    except UnsupportedPattern:
        return scan_batch_fallback(batch, pattern, negate=negate)

    emit, part = _value_accepts(batch, dfa, negate=negate, xp=xp)
    return PageMatchResult(
        page_gid=batch.arrays["page_gid"].copy(),
        match_counts=emit.sum(axis=1).astype(np.int64),
        value_counts=part.sum(axis=1).astype(np.int64),
    )


SPLIT_TRIGGER = 4096  # engage the value-boundary split when any page's
                      # payload exceeds this (pyarrow defaults to ~1 MB
                      # pages — a 1M-step sequential walk without it)
SPLIT_TARGET = 2048   # aim per-segment payload bytes


def split_payload_pages(arrays, trigger: int = SPLIT_TRIGGER,
                        target: int = SPLIT_TARGET):
    """Re-chunk big PLAIN pages at VALUE boundaries for the streaming walk.

    The device matcher's cost is lanes x sequential steps; a pyarrow-default
    ~1 MB page makes steps ~1M with a handful of lanes.  No matcher state
    crosses a value start, so segments starting at value boundaries walk
    independently and a per-page segment-sum of
    hits/seen is exact (native plan: dpq_scan.hpp::split_payload_plan).

    Returns (seg_payload [M, seg_pitch] u8, seg_len i32, seg_nn i32,
    seg_page i32) or None when no page exceeds `trigger`, nothing actually
    split, or a giant single value would blow up the split matrix."""
    plen = np.asarray(arrays["page_payload_len"])
    if plen.size == 0 or int(plen.max()) <= trigger:
        return None
    from ..host import bindings

    dims, segs = bindings.native_split_plan(
        np.asarray(arrays["payload"]), plen, np.asarray(arrays["page_nn"]),
        np.asarray(arrays["page_kind"]), target,
    )
    if int(dims.get("split_ok", 0)) != 1 or int(dims["n_segs"]) <= plen.size:
        return None
    return (segs["seg_payload"], segs["seg_len"], segs["seg_nn"],
            segs["seg_page"])


def device_matchers(pattern: str):
    """How the device walks `pattern`: (dfa, prog_pattern, chain).

    `dfa` is the table DFA, which also matches the dictionary entries.
    `prog_pattern` is set when ops/bitprog compiles the pattern (the
    register-machine walk); otherwise `chain` is its bitap substring chain,
    if any, and the table DFA walks.  Raises UnsupportedPattern when the
    DFA subset construction fails — callers take the host fallback, so a
    query is answered with one semantics on every page."""
    from .bitprog import compile_bitprog
    from .regex import substring_chain

    dfa = compile_pattern(pattern)
    try:
        compile_bitprog(pattern)
        prog_pattern = pattern
    except UnsupportedPattern:  # incl. BitprogUnsupported
        prog_pattern = None
    chain = substring_chain(pattern) if prog_pattern is None else None
    return dfa, prog_pattern, chain


def dfa_key(dfa):
    """(table bytes, table shape, accept bytes) cache key of the step jit."""
    table = np.ascontiguousarray(dfa.table, np.int32)
    accept = np.ascontiguousarray(dfa.accept, bool)
    return table.tobytes(), table.shape, accept.tobytes()


def dict_entry_accepts(arrays, dfa) -> np.ndarray:
    """Accept bit of every dictionary entry (host, once per query)."""
    return np.asarray(dfa_match(np, arrays["dict_padded"], arrays["dict_lens"],
                                dfa.table, dfa.accept))


def batch_dn_max(arrays) -> int:
    """Host-side: max per-page dictionary size (bounds the local-table
    accept select in _map_dict_accepts)."""
    size = np.asarray(arrays.get("page_dict_size", ()))
    return int(size.max()) if size.size else 0


def _map_dict_accepts(jnp, core, tables, dict_idx, dn_max):
    """Per-row accept planes from global dict-entry accept tables.

    Cells outside the caller's ok & nonnull mask are ARBITRARY (callers
    AND them out).  With `dn_max` (host-known max page_dict_size) below
    the concatenated table size, the lookup runs in two stages: localize
    each table to [N, dn_max] per-page accept bits (select over DN on
    N*dn_max cells) then select on the LOCAL index (dn_max ops over the
    [N, V] cells) — a multi-row-group file pays sum(chunk sizes) ops per
    value on the one-stage path."""
    from .dict_lookup import (
        SELECT_DICT_MAX,
        dict_lookup,
        dict_lookup_local,
    )

    dn = tables[0].shape[0]
    base = core["page_dict_base"][:, None]
    if 0 < dn_max < dn and dn_max <= SELECT_DICT_MAX:
        iota = jnp.arange(dn_max, dtype=jnp.int32)[None, :]
        g2 = jnp.clip(base + iota, 0, dn - 1)
        local = dict_lookup(jnp, list(tables), g2)
        return dict_lookup_local(jnp, local, dict_idx, dn_max)
    g = jnp.clip(base + jnp.clip(dict_idx, 0, None), 0, dn - 1)
    return dict_lookup(jnp, list(tables), g)


@_functools.lru_cache(maxsize=64)
def _device_scan_step(table_bytes, table_shape, accept_bytes, vmax, nn_cap,
                      max_def, negate, use_mxu, chain_key, prog_pattern=None,
                      max_steps=None, transposed=False, split=False, dn_max=0):
    """jit-compiled single-device scan step, cached per automaton + batch
    shape class (the DFA tables must be compile-time constants for the
    gather-free transition builders).  `prog_pattern` selects the
    bit-parallel NFA transition (recompiled here — compile_bitprog is
    deterministic and cheap, and the pattern string is the natural cache
    key).  `transposed=True` takes `payload` as the resident [steps, n]
    stream; the walk's route (streaming kernel or lax.scan) is chosen in
    ops/strings."""
    import jax
    import jax.numpy as jnp

    from .strings import match_payload_stream

    table = np.frombuffer(table_bytes, np.int32).reshape(table_shape)
    accept = np.frombuffer(accept_bytes, bool)
    chain = list(chain_key) if chain_key else None
    prog = None
    if prog_pattern is not None:
        from .bitprog import compile_bitprog

        prog = compile_bitprog(prog_pattern)

    if split:
        # value-boundary split layout: `payload` rows are SEGMENTS of the
        # original pages (split_payload_pages); hits segment-sum back to
        # pages before merging with the dictionary path
        def step_split(core, payload, plen_sub, nn_sub, seg, dict_match_d):
            is_dict = core["page_kind"] == 1
            nn = core["page_nn"]
            is_dict_sub = jnp.take(is_dict, seg)
            hits_sub, _seen = match_payload_stream(
                jnp, payload, jnp.where(is_dict_sub, 0, plen_sub),
                jnp.where(is_dict_sub, 0, nn_sub), table, accept,
                use_mxu=use_mxu, chain=chain, prog=prog,
                max_steps=max_steps, transposed=transposed,
            )
            hits = jax.ops.segment_sum(
                hits_sub, seg, num_segments=nn.shape[0],
                indices_are_sorted=True,
            )
            plain_counts = (nn - hits) if negate else hits

            nonnull, nn_idx = _decode.decode_levels(jnp, core, max_def, vmax)
            dict_idx, ok = _decode.decode_dict_indices(
                jnp, core, nn_idx, nn_cap, nonnull=nonnull)
            dm = _map_dict_accepts(
                jnp, core, [dict_match_d.astype(jnp.int32)], dict_idx,
                dn_max)[0] != 0
            accept_d = (dm ^ negate) & ok & nonnull
            counts = jnp.where(is_dict, jnp.sum(accept_d, axis=1),
                               plain_counts)
            values = jnp.where(is_dict, jnp.sum(ok & nonnull, axis=1), nn)
            return counts, values

        return jax.jit(step_split)

    def step(core, payload, plen, dict_match_d):
        is_dict = core["page_kind"] == 1
        nn = core["page_nn"]
        hits, _seen = match_payload_stream(
            jnp, payload, jnp.where(is_dict, 0, plen),
            jnp.where(is_dict, 0, nn), table, accept, use_mxu=use_mxu,
            chain=chain, prog=prog, max_steps=max_steps,
            transposed=transposed,
        )
        plain_counts = (nn - hits) if negate else hits

        nonnull, nn_idx = _decode.decode_levels(jnp, core, max_def, vmax)
        dict_idx, ok = _decode.decode_dict_indices(jnp, core, nn_idx, nn_cap,
                                                   nonnull=nonnull)
        dm = _map_dict_accepts(
            jnp, core, [dict_match_d.astype(jnp.int32)], dict_idx,
            dn_max)[0] != 0
        accept_d = (dm ^ negate) & ok & nonnull
        dict_counts = jnp.sum(accept_d, axis=1)
        dict_values = jnp.sum(ok & nonnull, axis=1)

        counts = jnp.where(is_dict, dict_counts, plain_counts)
        values = jnp.where(is_dict, dict_values, nn)
        return counts, values

    return jax.jit(step)


@_functools.lru_cache(maxsize=32)
def _device_scan_multi_step(patterns_key, vmax, nn_cap, max_def, negate,
                            max_steps, transposed, dn_max=0):
    """jit-compiled MULTI-pattern scan step (cached per pattern tuple +
    batch shape class): K register-machine patterns ride one payload walk
    (ops/strings.match_payload_multi — the byte stream, per-step slices and
    boundary control amortize over every pattern); dictionary pages map
    each pattern's dict-entry accepts through the SHARED expanded index
    stream (one decode, K lookups)."""
    import jax
    import jax.numpy as jnp

    from .bitprog import compile_bitprog
    from .regex import UnsupportedPattern, substring_chain
    from .strings import match_payload_multi

    matchers = []
    for pat in patterns_key:
        try:
            matchers.append((None, compile_bitprog(pat)))
        except UnsupportedPattern:
            # the broad class, mirroring scan_many's fusable test exactly
            # (BitprogUnsupported extends it; a parse-level rejection that
            # still yields a substring chain must land here, not crash)
            chain = substring_chain(pat)
            if chain is None:
                raise ValueError(
                    f"pattern {pat!r} needs the DFA fallback — scan it "
                    "separately"
                )
            matchers.append((tuple(chain), None))

    def step(core, payload, plen, dict_match_d):
        is_dict = core["page_kind"] == 1
        nn = core["page_nn"]
        hits_k = match_payload_multi(
            jnp, payload, jnp.where(is_dict, 0, plen),
            jnp.where(is_dict, 0, nn), matchers, max_steps=max_steps,
            transposed=transposed,
        )[0]

        nonnull, nn_idx = _decode.decode_levels(jnp, core, max_def, vmax)
        dict_idx, ok = _decode.decode_dict_indices(jnp, core, nn_idx, nn_cap,
                                                   nonnull=nonnull)
        dms = _map_dict_accepts(
            jnp, core, [dict_match_d[k].astype(jnp.int32)
                        for k in range(len(matchers))], dict_idx, dn_max)
        dict_values = jnp.sum(ok & nonnull, axis=1)
        counts, values = [], []
        for k in range(len(matchers)):
            accept_d = ((dms[k] != 0) ^ negate) & ok & nonnull
            plain = (nn - hits_k[k]) if negate else hits_k[k]
            counts.append(jnp.where(is_dict, jnp.sum(accept_d, axis=1), plain))
            values.append(jnp.where(is_dict, dict_values, nn))
        return tuple(counts), tuple(values)

    return jax.jit(step)


def scan_batch_device(batch, pattern: str, *, negate: bool = False,
                      use_mxu: bool = True) -> PageMatchResult:
    """Fully device-side scan over a PS_PAYLOAD batch: PLAIN pages stream raw
    payload bytes through the matcher — no host string walk, no char-matrix
    materialization; dictionary pages match each dict entry once and map
    accepts through the expanded index stream."""
    import jax.numpy as jnp

    try:
        dfa, prog_pattern, chain = device_matchers(pattern)
    except UnsupportedPattern:
        return scan_batch_fallback(batch, pattern, negate=negate)

    arrays = batch.arrays
    if "payload" not in arrays:
        raise ValueError("batch was prescanned without PS_PAYLOAD")
    n = batch.n_pages
    is_dict_np = arrays["page_kind"] == 1
    has_dict = bool(is_dict_np.any())

    dict_match = (
        dict_entry_accepts(arrays, dfa)
        if has_dict and "dict_padded" in arrays
        else np.zeros(1, bool)
    )

    core = {k: jnp.asarray(v) for k, v in arrays.items() if k in _decode.DECODE_ARRAYS}
    # big pages (pyarrow-default ~1 MB) re-chunk at value boundaries so the
    # walk runs many short lanes instead of one ~1M-step page
    sp = split_payload_pages(arrays)
    step = _device_scan_step(
        *dfa_key(dfa),
        batch.vmax, batch.nn_cap, batch.max_def, bool(negate), bool(use_mxu),
        tuple(chain) if chain else None, prog_pattern,
        scan_steps(sp[1] if sp is not None else arrays["page_payload_len"]),
        split=sp is not None, dn_max=batch_dn_max(arrays),
    )
    if sp is not None:
        sub_payload, sub_len, sub_nn, seg = sp
        counts, values = step(
            core, jnp.asarray(sub_payload), jnp.asarray(sub_len),
            jnp.asarray(sub_nn), jnp.asarray(seg), jnp.asarray(dict_match),
        )
    else:
        counts, values = step(
            core, jnp.asarray(arrays["payload"]),
            jnp.asarray(arrays["page_payload_len"]), jnp.asarray(dict_match),
        )
    _ = n
    return PageMatchResult(
        page_gid=arrays["page_gid"].copy(),
        match_counts=np.asarray(counts, np.int64),
        value_counts=np.asarray(values, np.int64),
    )


def match_rows(batch, pattern: str, *, negate: bool = False) -> np.ndarray:
    """Global row ids of the NON-NULL values matching `pattern` — the
    row-level companion to the page-pruning scan (the 'WHERE col ~ pattern'
    primitive; value participation and negate semantics are exactly
    scan_batch's, so `len(match_rows(...))` == `scan_batch(...).match_
    counts.sum()`).  Rows are absolute file row indices, like the reference
    iterator's emission positions (reference: src/reader/
    parquet_reader.cpp:330-345); nulls never emit, matching the iterator's
    non-null-only stream.  Requires a pad_strings prescan.  Returns a
    sorted int64 array."""
    try:
        dfa = compile_pattern(pattern)
    except UnsupportedPattern:
        return match_rows_fallback(batch, pattern, negate=negate)

    emit, _part = _value_accepts(batch, dfa, negate=negate)
    rows = (batch.arrays["page_row_start"][:, None].astype(np.int64)
            + np.arange(batch.vmax, dtype=np.int64)[None, :])
    return np.sort(rows[emit])


def match_rows_fallback(batch, pattern: str, *, negate: bool = False) -> np.ndarray:
    """Host `re` fallback for patterns outside the DFA subset — identical
    row sets."""
    from ..host.reader import _string_stream  # late import to avoid cycle

    rx = _re.compile(pattern.encode("utf-8", "surrogateescape"))
    pos, lens, offs, chars = _string_stream(batch)
    keep = [
        int(p)
        for p, ln, off in zip(pos, lens, offs)
        if bool(rx.search(chars[off:off + ln].tobytes())) ^ negate
    ]
    return np.asarray(sorted(keep), np.int64)


def scan_batch_fallback(batch, pattern: str, *, negate: bool = False) -> PageMatchResult:
    """Host fallback (full `re` semantics) producing identical survivor sets
    for patterns the DFA subset cannot express."""
    from ..host.reader import _string_stream  # late import to avoid cycle

    rx = _re.compile(pattern.encode("utf-8", "surrogateescape"))
    pos, lens, offs, chars = _string_stream(batch)
    # page of each emission: recover from row positions via page row ranges
    row_start = batch.arrays["page_row_start"]
    nv = batch.arrays["page_num_values"]
    page_of = np.searchsorted(row_start, pos, side="right") - 1
    n = batch.n_pages
    counts = np.zeros(n, np.int64)
    participating = np.zeros(n, np.int64)
    for p, ln, off in zip(page_of, lens, offs):
        s = chars[off : off + ln].tobytes()
        m = (rx.search(s) is not None) ^ negate
        counts[p] += m
        participating[p] += 1
    _ = nv
    return PageMatchResult(batch.arrays["page_gid"].copy(), counts, participating)


def _xp_arr(xp, a):
    return a if xp is np else xp.asarray(a)


def _as_xp(xp, arrays: dict):
    if xp is np:
        return arrays
    return {k: xp.asarray(v) for k, v in arrays.items() if k in _decode.DECODE_ARRAYS}
