"""Multi-device sharding tests on the 8-way virtual CPU mesh (conftest forces
JAX_PLATFORMS=cpu + xla_force_host_platform_device_count=8 — the standard JAX
idiom for testing meshes without hardware)."""

import numpy as np
import pytest

import jax

from duckdb_parquet_parser.host.reader import ParquetReader, _string_stream
from duckdb_parquet_parser.ops.index import build_index
from duckdb_parquet_parser.ops.regex import compile_pattern
from duckdb_parquet_parser.ops.scan import scan_batch
from duckdb_parquet_parser.parallel.mesh import make_mesh
from duckdb_parquet_parser.parallel.partition import (
    assign_balanced,
    pad_pages,
    reorder_pages,
    strings_page_major,
)
from duckdb_parquet_parser.parallel.pipeline import (
    distributed_scan,
    exchange_entries,
)
from duckdb_parquet_parser.parallel.shuffle import (
    ExchangePlan,
    balanced_chunk_owners,
)
from tests import fixtures


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


@pytest.fixture(scope="module", params=["plain", "dict"])
def batch_and_path(request, tmp_path_factory):
    rng = np.random.default_rng(5 if request.param == "plain" else 6)
    d = tmp_path_factory.mktemp("dist")
    path = fixtures.strings_file(
        d / "f.parquet", rng, n=1800, null_p=0.2,
        n_unique=None if request.param == "plain" else 13,
    )
    from duckdb_parquet_parser.host import bindings

    r = ParquetReader(path)
    return r, r.prescan(
        "s", pad_strings=8, flags=bindings.PS_HOST_STRINGS | bindings.PS_PAYLOAD
    )


@pytest.mark.parametrize("pattern,negate", [("alpha", False), ("o[a-z]t", True)])
def test_distributed_scan_matches_single(mesh, batch_and_path, pattern, negate):
    _, batch = batch_and_path
    single = scan_batch(batch, pattern, negate=negate)
    padded = pad_pages(batch, 8)
    res = distributed_scan(mesh, padded, compile_pattern(pattern), negate=negate)
    assert np.array_equal(np.sort(res.pruned_pages()), np.sort(single.pruned_pages()))
    assert int(res.totals[0]) == int(single.match_counts.sum())
    n = batch.n_pages
    assert np.array_equal(res.match_counts[:n], single.match_counts)


def test_strings_page_major_layout(batch_and_path):
    _, batch = batch_and_path
    chars, lens = strings_page_major(batch)
    nn_start = batch.arrays["str_nn_start"]
    counts = np.diff(nn_start)
    for p in range(min(batch.n_pages, 5)):
        got = [bytes(chars[p, k, : lens[p, k]]) for k in range(counts[p])]
        lo = nn_start[p]
        want = [
            batch.arrays["str_chars"][
                batch.arrays["str_offs"][lo + k] :
                batch.arrays["str_offs"][lo + k] + batch.arrays["str_lens"][lo + k]
            ].tobytes()
            for k in range(counts[p])
        ]
        assert got == want


def test_exchange_roundtrip(mesh, batch_and_path):
    reader, batch = batch_and_path
    pos, lens, _offs, _chars = _string_stream(batch)
    index = build_index(pos, lens, reader.num_rows(), 1024)
    sizes = np.diff(np.concatenate([index.chunk_starts, [len(lens)]]))
    owners = balanced_chunk_owners(sizes, 8)
    dst = owners[index.chunk_of_entry]
    src = (np.arange(len(dst)) * 8) // max(len(dst), 1)
    plan = ExchangePlan.plan(dst, src, 8)
    payload = np.stack([pos, lens], axis=1).astype(np.int64)
    send = plan.build_send_buffer(payload, src, fill=-1)
    recv = exchange_entries(mesh, send)
    got = recv.reshape(-1, 2)
    got = got[got[:, 0] >= 0]
    # every entry arrives exactly once, with its payload intact
    assert got.shape[0] == len(pos)
    assert np.array_equal(np.sort(got[:, 0]), np.sort(pos))

    # and each entry landed on the device owning its chunk
    d = 8
    recv_by_dest = recv.reshape(d, -1, 2)
    for dest in range(d):
        rows = recv_by_dest[dest]
        rows = rows[rows[:, 0] >= 0]
        expect = np.sort(pos[dst == dest])
        assert np.array_equal(np.sort(rows[:, 0]), expect)


def test_ragged_exchange_roundtrip(mesh, batch_and_path):
    """Exact-size ragged exchange: every entry arrives exactly once at its
    owner, source-major contiguous, with zero interior padding (valid rows
    are exactly [0, recv_total[d]))."""
    from duckdb_parquet_parser.parallel.pipeline import (
        ragged_exchange_entries,
    )
    from duckdb_parquet_parser.parallel.shuffle import RaggedExchangePlan

    reader, batch = batch_and_path
    pos, lens, _offs, _chars = _string_stream(batch)
    index = build_index(pos, lens, reader.num_rows(), 1024)
    sizes = np.diff(np.concatenate([index.chunk_starts, [len(lens)]]))
    owners = balanced_chunk_owners(sizes, 8)
    dst = owners[index.chunk_of_entry]
    src = (np.arange(len(dst)) * 8) // max(len(dst), 1)
    plan = RaggedExchangePlan.plan(dst, src, 8)
    payload = np.stack([pos, lens], axis=1).astype(np.int64)
    recv = ragged_exchange_entries(mesh, plan, payload, fill=-1)

    got_all = []
    for d in range(8):
        rows = recv[d]
        n = int(plan.recv_total[d])
        # no interior padding; everything past recv_total is fill
        assert (rows[:n, 0] >= 0).all()
        assert (rows[n:] == -1).all()
        np.testing.assert_array_equal(
            np.sort(rows[:n, 0]), np.sort(pos[dst == d])
        )
        # source-major order within the destination shard
        expect = np.concatenate(
            [pos[(dst == d) & (src == s)] for s in range(8)]
        )
        np.testing.assert_array_equal(rows[:n, 0], expect)
        got_all.append(rows[:n])
    assert sum(len(g) for g in got_all) == len(pos)

    # planned slots: exact-size plan never exceeds the padded plan's
    padded = ExchangePlan.plan(dst, src, 8)
    assert plan.planned_slots() <= 8 * 8 * padded.capacity


def test_index_build_ragged_vs_padded_parity(mesh, batch_and_path):
    """distributed_index_build produces identical received entry sets and
    chunk maps through the ragged and padded exchanges."""
    from duckdb_parquet_parser.parallel.index_build import (
        distributed_index_build,
    )
    from duckdb_parquet_parser.utils.config import (
        EngineConfig,
        set_config,
    )

    reader, _ = batch_and_path
    try:
        set_config(EngineConfig(exchange_mode="ragged"))
        r1 = distributed_index_build(mesh, reader, "s", chunk_size=512)
        set_config(EngineConfig(exchange_mode="padded"))
        r2 = distributed_index_build(mesh, reader, "s", chunk_size=512)
    finally:
        set_config(None)
    assert r1.exchange_mode == "ragged" and r2.exchange_mode == "padded"
    np.testing.assert_array_equal(r1.index.chunk_starts, r2.index.chunk_starts)
    for d in range(len(r1.received)):
        a = r1.received[d][np.lexsort(r1.received[d].T)]
        b = r2.received[d][np.lexsort(r2.received[d].T)]
        np.testing.assert_array_equal(a, b)
    # exact-size planning: ragged reserves no more slots than padded
    assert r1.exchange_planned_slots <= r2.exchange_planned_slots
    n_entries = sum(len(r) for r in r1.received)
    assert r1.exchange_planned_slots / max(n_entries, 1) <= 1.1


def test_balanced_assignment_skew():
    weights = np.array([1000, 1, 1, 1, 1, 1, 1, 1000])
    a = assign_balanced(weights, 4)
    load = np.zeros(4, np.int64)
    np.add.at(load, a.device_of, weights)
    assert load.max() <= 1002  # two heavy pages land on different devices


def test_reorder_pages_preserves_decode(batch_and_path):
    _, batch = batch_and_path
    rng = np.random.default_rng(0)
    order = rng.permutation(batch.n_pages)
    re_batch = reorder_pages(batch, order)
    assert np.array_equal(
        re_batch.arrays["page_gid"], batch.arrays["page_gid"][order]
    )
    # string table stays consistent with the per-page prefix
    if "str_nn_start" in re_batch.arrays:
        counts = np.diff(re_batch.arrays["str_nn_start"])
        want = np.diff(batch.arrays["str_nn_start"])[order]
        assert np.array_equal(counts, want)


def test_salted_ownership_and_capacity():
    """Hot chunks (bytes or entry count) split across distinct devices so
    neither device load nor the exchange bucket capacity blows up."""
    from duckdb_parquet_parser.parallel.shuffle import (
        ExchangePlan,
        salted_chunk_owners,
    )

    d = 8
    # chunk 0: entry-hot (sets every bucket's capacity without salting);
    # chunk 1: byte-hot; the rest normal
    chunk_bytes = np.array([4000, 60000] + [500] * 30, np.int64)
    chunk_entries = np.array([4000, 10] + [12] * 30, np.int64)
    salted = salted_chunk_owners(chunk_bytes, d, 2.0, chunk_entries=chunk_entries)
    assert len(salted.owners[0]) > 1 and len(salted.owners[1]) > 1
    for devs in salted.owners:
        assert len(np.unique(devs)) == len(devs)  # distinct owners

    chunk_of_entry = np.repeat(
        np.arange(len(chunk_bytes)), chunk_entries
    )
    dst = salted.entry_destinations(chunk_of_entry)
    src = (np.arange(len(dst)) * d) // len(dst)
    plan = ExchangePlan.plan(dst, src, d)
    mean_bucket = len(dst) / (d * d)
    assert plan.capacity <= 2.0 * mean_bucket, (plan.capacity, mean_bucket)


def test_entry_destinations_match_per_chunk_round_robin():
    """Entries in stream order (chunks interleaved) go to their chunk's
    owner; a salted chunk's entries round-robin over its owners by rank."""
    from duckdb_parquet_parser.parallel.shuffle import salted_chunk_owners

    rng = np.random.default_rng(5)
    d = 4
    chunk_bytes = np.concatenate([[50_000, 30_000], rng.integers(100, 900, 40)])
    chunk_entries = np.concatenate([[900, 40], rng.integers(5, 30, 40)])
    salted = salted_chunk_owners(chunk_bytes, d, 2.0,
                                 chunk_entries=chunk_entries)
    assert any(len(devs) > 1 for devs in salted.owners)
    chunk_of_entry = rng.permutation(
        np.repeat(np.arange(len(chunk_bytes)), chunk_entries))
    want = np.empty(len(chunk_of_entry), np.int64)
    for c, devs in enumerate(salted.owners):
        idx = np.nonzero(chunk_of_entry == c)[0]
        want[idx] = devs[np.arange(len(idx)) % len(devs)]
    np.testing.assert_array_equal(
        salted.entry_destinations(chunk_of_entry), want)


def test_send_buffer_overflow_raises():
    from duckdb_parquet_parser.parallel.shuffle import ExchangePlan

    dst = np.zeros(10, np.int64)
    src = np.zeros(10, np.int64)
    plan = ExchangePlan.plan(dst, src, 2)
    plan.capacity = 4  # simulate an under-provisioned plan
    with pytest.raises(ValueError, match="overflow"):
        plan.build_send_buffer(np.ones((10, 3), np.int64), src)


def test_assign_balanced_equal_counts_and_load():
    from duckdb_parquet_parser.parallel.partition import assign_balanced_equal

    rng = np.random.default_rng(0)
    w = rng.integers(400, 600, 64).astype(np.int64)
    w[:8] = 5000  # hot pages — one per device is achievable
    asg = assign_balanced_equal(w, 8)
    counts = np.bincount(asg.device_of, minlength=8)
    assert (counts == 8).all()  # exactly n/8 pages per device
    loads = np.zeros(8, np.int64)
    np.add.at(loads, asg.device_of, w)
    assert loads.max() / loads.mean() < 1.3
    # hot pages land on distinct devices
    assert len(np.unique(asg.device_of[:8])) == 8


def test_sharded_emissions_matches_host_stream(mesh, batch_and_path):
    """The device-side sharded emission decode reproduces the host string
    stream (rows and lengths) exactly."""
    from duckdb_parquet_parser.host.reader import _string_stream
    from duckdb_parquet_parser.parallel.index_build import sharded_emissions

    _reader, batch = batch_and_path
    pos_host, lens_host, _offs, _chars = _string_stream(batch)
    pos_dev, lens_dev = sharded_emissions(mesh, batch, block_pages=16)
    np.testing.assert_array_equal(pos_dev, pos_host)
    np.testing.assert_array_equal(lens_dev, lens_host)


def test_distributed_init_from_env(monkeypatch):
    """Multi-host init parses the env contract and passes it to
    jax.distributed.initialize (mocked — no cluster here)."""
    from duckdb_parquet_parser.parallel import mesh as M

    calls = {}

    def fake_init(coordinator_address=None, num_processes=None,
                  process_id=None):
        calls.update(addr=coordinator_address, n=num_processes,
                     pid=process_id)

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    # no coordinator -> no-op
    monkeypatch.delenv("DPQ_COORDINATOR", raising=False)
    assert M.distributed_init_from_env() is False
    assert not calls

    # explicit rendezvous env wins
    monkeypatch.setenv("DPQ_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("DPQ_NUM_PROCESSES", "4")
    monkeypatch.setenv("DPQ_PROCESS_ID", "2")
    assert M.distributed_init_from_env() is True
    assert calls == {"addr": "10.0.0.1:1234", "n": 4, "pid": 2}


def test_scaling_bench_emits_table(tmp_path, capsys, monkeypatch):
    """The scaling harness runs end-to-end on the virtual mesh and emits the
    rows/s + efficiency + shard-skew table."""
    import json
    import sys

    from duckdb_parquet_parser import scaling_bench

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    monkeypatch.setattr(
        sys, "argv", ["scaling_bench", "--rows", "4000", "--reps", "4"]
    )
    assert scaling_bench.main() == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["metric"] == "scan_scaling"
    sizes = [row["devices"] for row in out["table"]]
    assert sizes == [1, 2, 4, 8]
    for row in out["table"]:
        assert row["rows_per_s"] > 0
        # wall efficiency on the 2-core virtual mesh is only sanity-checked
        # with headroom: even min-of-4 reps can catch this VM's CPU-steal
        # bursts on the N=1 baseline (the balanced-sharding invariant is
        # the skew bound below)
        assert 0 < row["efficiency_wall"] <= 2.0
        # compute-based efficiency (shard work balance) must be near-ideal
        # regardless of the host's core count
        assert row["efficiency_compute"] >= 0.8
        assert row["shard_value_skew"] < 1.5


def test_elastic_scan_failure_recovery(mesh, batch_and_path):
    """A device 'dies' mid-scan (its shard results dropped by the fault
    hook); orphaned pages re-run on the survivors; the merged result is
    bit-identical to a clean run (scan tasks are stateless)."""
    from duckdb_parquet_parser.parallel.elastic import (
        elastic_distributed_scan,
    )
    from duckdb_parquet_parser.parallel.partition import pad_pages as _pp

    reader, batch = batch_and_path
    dfa = compile_pattern("a[bc]+d|q")
    padded = _pp(batch, 8)

    clean = distributed_scan(mesh, padded, dfa)

    killed = {3}

    def hook(result, rnd):
        if rnd == 0:
            # simulate the failure: poison the dead device's shard results
            pp = len(result.match_counts) // 8
            for d in killed:
                result.match_counts[d * pp:(d + 1) * pp] = -999
            return killed
        return ()

    res, report = elastic_distributed_scan(mesh, padded, dfa, fault_hook=hook)
    assert report["failed"] == [3] and report["rounds"] == 1
    assert report["reruns"] > 0
    np.testing.assert_array_equal(res.match_counts, clean.match_counts)
    np.testing.assert_array_equal(res.value_counts, clean.value_counts)
    np.testing.assert_array_equal(res.totals, clean.totals)


def test_elastic_scan_cascade(mesh, batch_and_path):
    """Two successive failures (cascade): both orphan sets re-run, result
    still bit-identical; FleetState keeps re-partitioning over survivors."""
    from duckdb_parquet_parser.parallel.elastic import (
        elastic_distributed_scan,
    )
    from duckdb_parquet_parser.parallel.partition import pad_pages as _pp

    reader, batch = batch_and_path
    dfa = compile_pattern("[ab]x?")
    padded = _pp(batch, 8)
    clean = distributed_scan(mesh, padded, dfa)

    def hook(result, rnd):
        return {1} if rnd == 0 else ({5} if rnd == 1 else ())

    res, report = elastic_distributed_scan(mesh, padded, dfa, fault_hook=hook)
    assert report["failed"] == [1, 5] and report["rounds"] == 2
    np.testing.assert_array_equal(res.match_counts, clean.match_counts)
    np.testing.assert_array_equal(res.totals, clean.totals)


def test_elastic_via_scan_engine(mesh, tmp_path):
    """ScanEngine.scan(fault_hook=...) routes through elastic recovery and
    reports it."""
    from duckdb_parquet_parser.models.scan import ScanEngine

    rng = np.random.default_rng(11)
    path = fixtures.strings_file(tmp_path / "el.parquet", rng, n=900,
                                 null_p=0.1)
    eng = ScanEngine(str(path), mesh=mesh)
    clean = eng.scan("s", "a.*b")

    def hook(result, rnd):
        return {2} if rnd == 0 else ()

    res = eng.scan("s", "a.*b", fault_hook=hook)
    assert res.elastic_report["failed"] == [2]
    np.testing.assert_array_equal(
        np.sort(res.surviving_pages()), np.sort(clean.surviving_pages()))
    np.testing.assert_array_equal(res.totals, clean.totals)


def test_index_build_partial_resume(tmp_path):
    """Per-block (row-group) emission checkpoints: a build killed after k
    blocks resumes computing only the missing ones, and the final index is
    identical to an uninterrupted build."""
    from duckdb_parquet_parser.models.scan import ScanEngine
    from duckdb_parquet_parser.ops import index as I
    from duckdb_parquet_parser.utils import checkpoints as C

    rng = np.random.default_rng(21)
    path = fixtures.strings_file(tmp_path / "ck.parquet", rng, n=400,
                                 null_p=0.2, rgs=6)
    eng = ScanEngine(str(path))
    full = eng.build_index("s", chunk_size=800).index

    # simulate a kill after 3 of 6 blocks: precompute + save only those
    ck = tmp_path / "ckpt"
    for rg in range(3):
        pos, lens = I.emissions_for_rg(eng.reader, "s", rg)
        C.save_block(str(ck), str(path), "s", rg, pos, lens)

    calls = []
    orig = I.emissions_for_rg

    def spy(reader, column, rg):
        calls.append(rg)
        return orig(reader, column, rg)

    I.emissions_for_rg = spy
    try:
        import duckdb_parquet_parser.models.scan as MS
        resumed = eng.build_index("s", chunk_size=800,
                                  checkpoint_dir=str(ck)).index
    finally:
        I.emissions_for_rg = orig
    assert calls == [3, 4, 5], calls  # only the missing blocks recomputed
    for f in ("positions", "lens", "chunk_of_entry", "tuple_to_chunk",
              "chunk_starts"):
        np.testing.assert_array_equal(getattr(full, f), getattr(resumed, f),
                                      err_msg=f)


def test_elastic_index_build(mesh, batch_and_path):
    """A device fails during the index build's sharded decode; the orphaned
    block re-decodes on survivors and the final index is bit-identical."""
    from duckdb_parquet_parser.parallel.index_build import (
        distributed_index_build,
    )

    reader, _batch = batch_and_path
    clean = distributed_index_build(mesh, reader, "s", chunk_size=700)

    calls = []

    def hook(blk, lens, emit):
        calls.append(blk)
        return {2} if blk == 0 else ()

    res = distributed_index_build(mesh, reader, "s", chunk_size=700,
                                  fault_hook=hook)
    assert calls  # the detection hook ran
    for f in ("positions", "lens", "chunk_of_entry", "tuple_to_chunk",
              "chunk_starts"):
        np.testing.assert_array_equal(
            getattr(clean.index, f), getattr(res.index, f), err_msg=f)
    assert sum(len(r) for r in res.received) == \
        sum(len(r) for r in clean.received)


def test_distributed_decode_multi_rg_dict(mesh, tmp_path):
    """Sharded decode with per-page LOCAL dictionary tables: a multi-row-
    group dict column (distinct chunk dictionaries, nonzero page_dict_base
    offsets) must decode bit-identically to the numpy golden."""
    from duckdb_parquet_parser.host.schema import ParquetType
    from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter
    from duckdb_parquet_parser.ops import decode as D
    from duckdb_parquet_parser.parallel.partition import pad_pages
    from duckdb_parquet_parser.parallel.pipeline import distributed_decode

    rng = np.random.default_rng(17)
    path = str(tmp_path / "mrg.parquet")
    w = ParquetWriter(path, [ColumnSpec("k", ParquetType.INT64, optional=True)])
    for rg in range(3):
        n = 1200
        vals = (rng.permutation(30)[rng.integers(0, 30, n)] + rg * 100) * 11
        w.write_row_group({"k": (vals, (rng.random(n) > 0.15).astype(np.uint8))})
    w.close()
    b = ParquetReader(path).prescan("k")
    assert len(set(np.asarray(b.arrays["page_dict_base"]).tolist())) > 1
    golden_planes, golden_nn = D.decode_fixed(
        np, b.arrays, [], b.dict_planes, None,
        max_def=b.max_def, out_len=b.vmax, nn_len=b.nn_cap, mode=b.mode)
    padded = pad_pages(b, 8)
    planes, nonnull, _ = distributed_decode(mesh, padded)
    n_pages = b.n_pages
    assert np.array_equal(nonnull[:n_pages], golden_nn)
    for pj, pn in zip(planes, golden_planes):
        assert np.array_equal(pj[:n_pages], pn)


def test_ragged_use_hlo_selection(monkeypatch):
    """The ragged-all-to-all HLO is selected on the GPU only;
    DPQ_RAGGED_EMULATE=1 forces the emulation there too."""
    from duckdb_parquet_parser.parallel import pipeline as PL

    monkeypatch.delenv("DPQ_RAGGED_EMULATE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert PL.ragged_use_hlo() is True
    monkeypatch.setenv("DPQ_RAGGED_EMULATE", "1")
    assert PL.ragged_use_hlo() is False
    monkeypatch.delenv("DPQ_RAGGED_EMULATE")
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert PL.ragged_use_hlo() is False
