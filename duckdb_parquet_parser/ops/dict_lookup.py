"""Dictionary VALUE lookup — select-accumulation for small tables, a
gather beyond.

The reference's `dictionary[idx]` (src/reader/column_reader.cpp:177-196)
is dispatched on dictionary size DN:

* DN <= SELECT_DICT_MAX: select-accumulation — `sum_d (gidx == d) *
  plane[d]` unrolled over the table, O(DN) elementwise ops per value;
* larger tables: `take` (an XLA gather over the concatenated chunk
  dictionaries: one int32 plane per 4 value bytes, 192 KB per plane for
  twelve 4,096-entry chunks, which the GPU's L2 holds).

Whether select should also yield to `take` on the GPU is not decided
(the two have not been timed against each other on the H100).
"""

from __future__ import annotations

import numpy as np

SELECT_DICT_MAX = 512


def dict_lookup_select(xp, dict_planes, gidx, dn: int, ways: int = 8):
    """Select-accumulation lookup for small tables (exact, elementwise).

    The accumulation runs in `ways` INDEPENDENT partial sums (d strided)
    combined by a short tree at the end: a single `acc = acc + where(...)`
    chain would serialize DN dependent adds."""
    outs = []
    for plane in dict_planes:
        accs = [xp.zeros_like(gidx) for _ in range(min(ways, max(dn, 1)))]
        for d in range(dn):
            w = d % len(accs)
            accs[w] = accs[w] + xp.where(gidx == d, plane[d], 0)
        while len(accs) > 1:  # pairwise combine tree
            nxt = [a + b for a, b in zip(accs[0::2], accs[1::2])]
            if len(accs) % 2:
                nxt.append(accs[-1])
            accs = nxt
        outs.append(accs[0])
    return outs


def dict_lookup_local(xp, planes_pp, idx, dn_max: int, ways: int = 8):
    """Select-accumulation over PER-PAGE local tables.

    `planes_pp`: list of [N, dn_max] i32 — plane values of each page's OWN
    dictionary chunk (built once on host from page_dict_base/size; zero
    past dict_size).  `idx` is the LOCAL in-page index [N, V].  A multi-
    row-group file concatenates its chunk dictionaries into one global
    table, so the global select scans sum(chunk sizes) entries per value
    while each page can only ever hit its own chunk — selecting on the
    local index costs dn_max ops instead (4x fewer on a 4-row-group file).
    The value operand is a broadcast [N, 1] column."""
    outs = []
    for pp in planes_pp:
        accs = [xp.zeros_like(idx) for _ in range(min(ways, max(dn_max, 1)))]
        for d in range(dn_max):
            w = d % len(accs)
            accs[w] = accs[w] + xp.where(idx == d, pp[:, d][:, None], 0)
        while len(accs) > 1:
            nxt = [a + b for a, b in zip(accs[0::2], accs[1::2])]
            if len(accs) % 2:
                nxt.append(accs[-1])
            accs = nxt
        outs.append(accs[0])
    return outs


def dict_lookup(xp, dict_planes, gidx):
    """Dispatcher: numpy golden -> index; DN <= SELECT_DICT_MAX -> select;
    else take."""
    if not dict_planes:
        return []
    if xp is np:
        return [np.asarray(p)[gidx] for p in dict_planes]  # np.take is ~10x slower
    dn = int(dict_planes[0].shape[0])
    if dn <= SELECT_DICT_MAX:
        return dict_lookup_select(xp, dict_planes, gidx, dn)
    return [xp.take(p, gidx) for p in dict_planes]
