"""Device (jnp) decode kernels vs the numpy golden model, plus direct unit
tests of the hybrid run expansion against a scalar re-implementation of the
reference decoder's semantics."""

import numpy as np
import pytest

from duckdb_parquet_parser.host.reader import ParquetReader
from duckdb_parquet_parser.ops import decode as D
from duckdb_parquet_parser.ops.expand import expand_hybrid
from tests import fixtures


# ── scalar model of the reference RleDecoder (for direct expansion tests) ────


def scalar_rle_decode(data: bytes, bw: int, count: int) -> list[int]:
    """Literal re-statement of the reference decoder's get_batch semantics
    (reference: include/reader/rle_decoder.hpp) used as unit-test truth."""
    out = []
    pos = 0
    n = len(data)
    while len(out) < count:
        if pos >= n:
            out.extend([0] * (count - len(out)))
            break
        ind = 0
        shift = 0
        while pos < n:
            b = data[pos]
            pos += 1
            ind |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if ind & 1:
            groups = ind >> 1
            navail = groups * 8
            bit0 = pos * 8
            for i in range(min(navail, count - len(out))):
                v = 0
                for k in range(bw):
                    bitpos = bit0 + i * bw + k
                    byte = bitpos >> 3
                    if byte < n and (data[byte] >> (bitpos & 7)) & 1:
                        v |= 1 << k
                out.append(v)
            pos += (navail * bw + 7) // 8
        else:
            run = ind >> 1
            v = 0
            for i in range((bw + 7) // 8):
                if pos < n:
                    v |= data[pos] << (8 * i)
                    pos += 1
            if run == 0:
                continue
            out.extend([v] * min(run, count - len(out)))
    return out


def encode_hybrid(rng, values, bw):
    """Random mix of RLE and bit-packed runs encoding `values`."""
    out = bytearray()
    i = 0
    n = len(values)
    while i < n:
        if rng.random() < 0.5:
            # RLE run of identical values
            run = 1
            while i + run < n and values[i + run] == values[i] and run < 100:
                run += 1
            ind = run << 1
            while ind >= 0x80:
                out.append((ind & 0x7F) | 0x80)
                ind >>= 7
            out.append(ind)
            v = values[i]
            for _ in range((bw + 7) // 8):
                out.append(v & 0xFF)
                v >>= 8
            i += run
        else:
            groups = int(rng.integers(1, 4))
            take = min(groups * 8, ((n - i) // 8) * 8)
            if take == 0:
                continue
            groups = take // 8
            out.append((groups << 1) | 1)
            bits = bytearray((take * bw + 7) // 8)
            for j in range(take):
                v = values[i + j]
                for k in range(bw):
                    if (v >> k) & 1:
                        bitpos = j * bw + k
                        bits[bitpos >> 3] |= 1 << (bitpos & 7)
            out.extend(bits)
            i += take
    return bytes(out)


def prescan_py(data: bytes, bw: int, want: int):
    """Python mirror of the host pre-scan (native rle_prescan) for unit tests."""
    runs = []
    pos, got, n = 0, 0, len(data)
    while got < want:
        if pos >= n:
            runs.append((0, want - got, 0, 0, got))
            break
        ind, shift = 0, 0
        while pos < n:
            b = data[pos]
            pos += 1
            ind |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if ind & 1:
            adv = (ind >> 1) * 8
            take = min(adv, want - got)
            runs.append((1, take, 0, pos * 8, got))
            got += take
            pos += (adv * bw + 7) // 8
        else:
            cnt = ind >> 1
            v = 0
            for i in range((bw + 7) // 8):
                if pos < n:
                    v |= data[pos] << (8 * i)
                    pos += 1
            if cnt == 0:
                continue
            take = min(cnt, want - got)
            runs.append((0, take, v, 0, got))
            got += take
    return runs


@pytest.mark.parametrize("bw", [1, 2, 3, 5, 7, 8, 11, 16, 20, 24])
@pytest.mark.parametrize("xp_name", ["numpy", "jax"])
def test_expand_hybrid_matches_scalar_decoder(bw, xp_name, rng):
    if xp_name == "jax":
        import jax.numpy as xp
    else:
        xp = np
    n = 371
    values = rng.integers(0, 1 << bw, n).astype(np.int64)
    data = encode_hybrid(rng, list(values), bw)
    expect = scalar_rle_decode(data, bw, n)
    runs = prescan_py(data, bw, n)

    rmax = len(runs)
    pad = ((len(data) + 4 + 127) // 128) * 128
    section = np.zeros((1, pad), np.uint8)
    section[0, : len(data)] = np.frombuffer(data, np.uint8)
    cols = {name: np.zeros((1, rmax), np.int32) for name in
            ["kind", "count", "value", "bitoff", "vstart"]}
    for r, (k, c, v, b, s) in enumerate(runs):
        cols["kind"][0, r] = k
        cols["count"][0, r] = c
        cols["value"][0, r] = v
        cols["bitoff"][0, r] = b
        cols["vstart"][0, r] = s

    out = expand_hybrid(
        xp,
        xp.asarray(cols["kind"]), xp.asarray(cols["count"]),
        xp.asarray(cols["value"]), xp.asarray(cols["bitoff"]),
        xp.asarray(cols["vstart"]), xp.asarray(section),
        xp.asarray(np.array([bw], np.int32)), n,
    )
    assert np.asarray(out)[0].tolist() == expect


def test_expand_zero_fill_on_truncation(rng):
    """Section exhausted -> remaining values are zero (reference
    rle_decoder.hpp:20-24)."""
    bw = 4
    values = list(rng.integers(0, 16, 40))
    data = encode_hybrid(rng, values, bw)
    want = 80  # more than encoded
    runs = prescan_py(data, bw, want)
    expect = scalar_rle_decode(data, bw, want)
    assert expect[40:] == [0] * 40

    rmax = len(runs)
    pad = ((len(data) + 4 + 127) // 128) * 128
    section = np.zeros((1, pad), np.uint8)
    section[0, : len(data)] = np.frombuffer(data, np.uint8)
    arrs = {n_: np.zeros((1, rmax), np.int32) for n_ in
            ["kind", "count", "value", "bitoff", "vstart"]}
    for r, (k, c, v, b, s) in enumerate(runs):
        for name, val in zip(["kind", "count", "value", "bitoff", "vstart"], (k, c, v, b, s)):
            arrs[name][0, r] = val
    out = expand_hybrid(np, arrs["kind"], arrs["count"], arrs["value"],
                        arrs["bitoff"], arrs["vstart"], section,
                        np.array([bw], np.int32), want)
    assert out[0].tolist() == expect


# ── batch decode: jnp vs numpy on real fixtures ──────────────────────────────


@pytest.fixture(scope="module")
def mixed_path(tmp_path_factory):
    rng = np.random.default_rng(99)
    return fixtures.mixed_file(tmp_path_factory.mktemp("dec") / "m.parquet", rng)


@pytest.mark.parametrize(
    "col", ["i64", "i64_opt", "i32", "f32", "f64", "flag", "code"]
)
def test_jax_decode_matches_numpy(mixed_path, col):
    r = ParquetReader(mixed_path)
    b = r.prescan(col)
    kw = dict(max_def=b.max_def, out_len=b.vmax, nn_len=b.nn_cap, mode=b.mode)
    planes_np, nn_np = D.decode_fixed(
        np, b.arrays, b.plain_planes, b.dict_planes, b.bool_bits, **kw
    )
    planes_j, nn_j = D.decode_fixed_jax(
        b.arrays, b.plain_planes, b.dict_planes, b.bool_bits, **kw
    )
    assert np.array_equal(np.asarray(nn_j), nn_np)
    for pj, pn in zip(planes_j, planes_np):
        assert np.array_equal(np.asarray(pj), pn)


def test_batch_slice_pages(mixed_path):
    r = ParquetReader(mixed_path)
    b = r.prescan("i64")
    whole = r.read_column("i64")
    half = b.slice_pages(0, b.n_pages // 2)
    assert half.n_pages == b.n_pages // 2
    assert half.total_rows + b.slice_pages(b.n_pages // 2, b.n_pages).total_rows == len(whole)


@pytest.mark.parametrize("col", ["i64_opt", "flag", "code", "f64"])
def test_expand_select_matches_gather(mixed_path, col):
    """Select-based expansion (small run tables) must equal gather-based."""
    import jax.numpy as jnp

    r = ParquetReader(mixed_path)
    b = r.prescan(col)
    kw = dict(max_def=b.max_def, out_len=b.vmax, nn_len=b.nn_cap, mode=b.mode)
    from duckdb_parquet_parser.ops import expand as E

    planes_np, nn_np = D.decode_fixed(
        np, b.arrays, b.plain_planes, b.dict_planes, b.bool_bits, **kw
    )
    # force select path by lifting the threshold
    old = E.SELECT_RUNS_MAX
    try:
        E.SELECT_RUNS_MAX = 10**9
        arrays_j = {k: jnp.asarray(v) for k, v in b.arrays.items()
                    if k in D.DECODE_ARRAYS}
        planes_j, nn_j = D.decode_fixed(
            jnp, arrays_j,
            [jnp.asarray(p) for p in b.plain_planes],
            [jnp.asarray(p) for p in b.dict_planes],
            jnp.asarray(b.bool_bits) if b.bool_bits is not None else None,
            **kw,
        )
    finally:
        E.SELECT_RUNS_MAX = old
    assert np.array_equal(np.asarray(nn_j), nn_np)
    for pj, pn in zip(planes_j, planes_np):
        assert np.array_equal(np.asarray(pj), pn)


def test_heavy_nulls_gather_fallback(tmp_path, rng):
    """>64 nulls per page exceeds the shift-scatter bound; the jnp path must
    fall back to gathers and still match numpy."""
    import jax.numpy as jnp

    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    path = str(tmp_path / "heavy.parquet")
    n = 2000
    valid = (rng.random(n) > 0.9).astype(np.uint8)  # 90% null
    w = ParquetWriter(path, [ColumnSpec("x", ParquetType.DOUBLE, optional=True)])
    w.write_row_group({"x": (rng.random(n), valid)})
    w.close()
    r = ParquetReader(path)
    b = r.prescan("x")
    assert D.max_nulls_per_page(b.arrays) > 64
    kw = dict(max_def=b.max_def, out_len=b.vmax, nn_len=b.nn_cap, mode="plain")
    planes_np, nn_np = D.decode_fixed(np, b.arrays, b.plain_planes, [], None, **kw)
    planes_j, nn_j = D.decode_fixed_jax(b.arrays, b.plain_planes, [], None, **kw)
    assert np.array_equal(np.asarray(nn_j), nn_np)
    for pj, pn in zip(planes_j, planes_np):
        assert np.array_equal(np.asarray(pj), pn)


# ── masked-cell contract (VERDICT r3 #9) ─────────────────────────────────────
#
# expand.take2d_shift documents that cells past a page's values carry
# garbage-but-masked values and that decode_fixed zeroes every masked cell
# before returning.  This pins that contract across adversarial null
# patterns on BOTH backends and BOTH scatter routes (log-shift and gather),
# so any refactor that stops zeroing masked cells fails loudly here rather
# than surfacing as consumer-dependent garbage.


def _null_patterns(rng, n):
    yield np.zeros(n, np.uint8)                        # all null
    yield np.ones(n, np.uint8)                         # none null
    alt = np.zeros(n, np.uint8); alt[::2] = 1
    yield alt                                          # alternating
    blk = np.ones(n, np.uint8); blk[n // 4:3 * n // 4] = 0
    yield blk                                          # long null block
    yield (rng.random(n) > 0.9).astype(np.uint8)       # 90% null (gather path)
    yield (rng.random(n) > 0.05).astype(np.uint8)      # sparse nulls (shift)


@pytest.mark.parametrize("pat_i", range(6))
def test_masked_cells_decode_to_zero(tmp_path, rng, pat_i):
    import jax.numpy as jnp

    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    n = 1500
    valid = list(_null_patterns(rng, n))[pat_i]
    path = str(tmp_path / f"masked{pat_i}.parquet")
    w = ParquetWriter(path, [
        ColumnSpec("d", ParquetType.DOUBLE, optional=True),
        ColumnSpec("c", ParquetType.INT32, optional=True),  # dict-encoded
    ])
    w.write_row_group({
        "d": (rng.standard_normal(n), valid),
        "c": (rng.integers(0, 5, n).astype(np.int32), valid),
    })
    w.close()
    r = ParquetReader(path)
    for col in ("d", "c"):
        b = r.prescan(col)
        kw = dict(max_def=b.max_def, out_len=b.vmax, nn_len=b.nn_cap,
                  mode=b.mode)
        for planes, nn in (
            D.decode_fixed(np, b.arrays, b.plain_planes, b.dict_planes,
                           b.bool_bits, **kw),
            D.decode_fixed_jax(b.arrays, b.plain_planes, b.dict_planes,
                               b.bool_bits, **kw),
            # force both device scatter routes regardless of null density
            D.decode_fixed(jnp, {k: jnp.asarray(v) for k, v in b.arrays.items()
                                 if k in D.DECODE_ARRAYS},
                           [jnp.asarray(p) for p in b.plain_planes],
                           [jnp.asarray(p) for p in b.dict_planes],
                           None, max_null_shift=64, **kw),
            D.decode_fixed(jnp, {k: jnp.asarray(v) for k, v in b.arrays.items()
                                 if k in D.DECODE_ARRAYS},
                           [jnp.asarray(p) for p in b.plain_planes],
                           [jnp.asarray(p) for p in b.dict_planes],
                           None, max_null_shift=-1, **kw),
        ):
            masked = ~np.asarray(nn)
            assert masked.any() or valid.all()
            for p in planes:
                assert not np.asarray(p)[masked].any(), (
                    f"{col}: non-zero decoded value at a masked cell")


def test_local_table_dict_lookup_parity(tmp_path):
    """Per-page LOCAL dictionary select (dict_planes_pp) must equal the
    global-table lookup on a multi-row-group dict file whose chunk
    dictionaries DIFFER in entry order (page_dict_base offsets exercise
    the base+idx mapping)."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

    rng = np.random.default_rng(41)
    path = str(tmp_path / "multi_rg_dict.parquet")
    w = ParquetWriter(path, [ColumnSpec("k", ParquetType.INT64, optional=True)])
    expect = []
    for rg in range(3):
        n = 3000
        vals = (rng.permutation(40)[rng.integers(0, 40, n)] + rg * 1000) * 7
        mask = (rng.random(n) > 0.1).astype(np.uint8)
        w.write_row_group({"k": (vals, mask)})
        expect.extend(int(v) if m else None for v, m in zip(vals, mask))
    w.close()

    r = ParquetReader(path)
    b = r.prescan("k")
    assert b.mode == "dict" and len(b.dict_planes_pp) == 2
    # base offsets really differ across row groups
    assert len(set(np.asarray(b.arrays["page_dict_base"]).tolist())) > 1
    kw = dict(max_def=b.max_def, out_len=b.vmax, nn_len=b.nn_cap, mode="dict")
    planes_np, nn_np = D.decode_fixed(
        np, b.arrays, [], b.dict_planes, None, **kw)
    planes_j, nn_j = D.decode_fixed_jax(
        b.arrays, [], b.dict_planes, None,
        dict_planes_pp=b.dict_planes_pp, **kw)
    assert np.array_equal(np.asarray(nn_j), nn_np)
    for pj, pn in zip(planes_j, planes_np):
        assert np.array_equal(np.asarray(pj), pn)
    # The level-free fast path (idx_vals present) must ALSO agree with the
    # legacy def-level decode — drop idx_vals so decode_dict_indices takes
    # the run-expansion + null-rank route (the fast path is what both jax
    # and numpy used above, so without this the legacy path goes untested).
    legacy_arrays = {k: v for k, v in b.arrays.items() if k != "idx_vals"}
    planes_leg, nn_leg = D.decode_fixed(
        np, legacy_arrays, [], b.dict_planes, None, **kw)
    assert np.array_equal(nn_leg, nn_np)
    for pl_, pn in zip(planes_leg, planes_np):
        assert np.array_equal(pl_, pn)
    # end-to-end read parity too
    assert r.read_column("k").to_pylist() == expect


def test_dict_4096_decode_parity(tmp_path):
    """A 4,096-entry dictionary (above the select limit, so the device
    lookup is a gather) decodes identically on device and in numpy."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
    from duckdb_parquet_parser.ops.dict_lookup import SELECT_DICT_MAX

    rng = np.random.default_rng(4096)
    path = str(tmp_path / "dict4096.parquet")
    w = ParquetWriter(path, [ColumnSpec("k", ParquetType.INT64,
                                        optional=True)])
    n = 6 * 4096
    vals = rng.permutation(4096)[rng.integers(0, 4096, n)].astype(np.int64)
    vals = vals * 1_000_003 - (1 << 40)
    mask = (rng.random(n) > 0.05).astype(np.uint8)
    w.write_row_group({"k": (vals, mask)})
    w.close()

    b = ParquetReader(path).prescan("k")
    assert b.mode == "dict"
    assert b.dict_planes[0].shape[0] > SELECT_DICT_MAX
    kw = dict(max_def=b.max_def, out_len=b.vmax, nn_len=b.nn_cap, mode="dict")
    planes_np, nn_np = D.decode_fixed(np, b.arrays, [], b.dict_planes, None,
                                      **kw)
    planes_j, nn_j = D.decode_fixed_jax(b.arrays, [], b.dict_planes, None,
                                        dict_planes_pp=b.dict_planes_pp, **kw)
    assert np.array_equal(np.asarray(nn_j), nn_np)
    for pj, pn in zip(planes_j, planes_np):
        assert np.array_equal(np.asarray(pj), pn)
    got = ParquetReader(path).read_column("k").to_pylist()
    assert got == [int(v) if m else None for v, m in zip(vals, mask)]
