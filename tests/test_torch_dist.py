"""The port's distributed buildG (disco_tpu_torch.dist: mesh, overlap_shard,
builder) against disco_tpu's engines on the conftest's virtual CPU mesh
and against the reference's goldens.  The port runs on n x `cpu` shards
(`make_mesh(n, "cpu")`): every K1 check takes its plain version.
Tolerance: exact — integers, booleans, byte-identical files."""
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from conftest import GOLDEN
from disco_tpu.buildg import replay as jreplay
from disco_tpu.buildg.pipeline import run_buildg as jax_run_buildg
from disco_tpu.dist import builder as jbuilder
from disco_tpu.dist import overlap_shard as jshard
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.relation import compute_relation, window_codes
from disco_tpu.overlap.verify import make_packed_all as jax_packed_all
from disco_tpu_torch.buildg import replay
from disco_tpu_torch.buildg.pipeline import run_buildg
from disco_tpu_torch.convert import state_from_reference
from disco_tpu_torch.dist import builder, mesh as tmesh
from disco_tpu_torch.dist import overlap_shard as tshard
from disco_tpu_torch.overlap import relation as port_relation
from test_torch_native import private_native  # noqa: F401

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)

FIELDS = ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok")
GRAPH = ("_0_parGraph.txt", "_0_containedReads.txt", "_0_startRead.txt")
PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _jax_mesh(n):
    devs = jax.devices("cpu")[:n]
    assert len(devs) == n
    return JaxMesh(np.array(devs), ("dp",))


def _cpu_mesh(n):
    return tmesh.make_mesh(n, "cpu")


@pytest.fixture(scope="module")
def mini():
    """disco_tpu's store and table of golden mini, and the port's copies."""
    store = ReadStore.from_files([str(GOLDEN / "mini" / "reads.fasta")], [],
                                 30, reference_task_order=False)
    table = FingerprintTable.build(store, 29)
    return (store, table), state_from_reference(store, table)


@pytest.fixture(scope="module")
def contained():
    """A containment-rich set (500 reads of 40-120 bp from one 3 kb genome,
    tests/test_dist_mem.py's): short reads contained in long ones over the
    whole read range."""
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    seqs = []
    for _ in range(500):
        ln = int(rng.integers(40, 120))
        s = int(rng.integers(0, 3000 - ln))
        seqs.append(genome[s:s + ln])
    store = ReadStore.from_sequences(seqs)
    table = FingerprintTable.build(store, 29)
    return (store, table), state_from_reference(store, table)


def _assert_relation(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# binning and owners
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_bin_by_owner_matches_jax(n):
    """Slots and overflow over owners with the route-nowhere sentinel
    (owner n and above), caps below, at and above the bin loads."""
    rng = np.random.default_rng(n)
    for q in (1, 7, 300, 4096):
        owner = rng.integers(0, n + 2, q).astype(np.int32)
        owner[rng.random(q) < 0.3] = n                # the sentinel
        load = int(np.bincount(np.minimum(owner, n), minlength=n + 1)[:n]
                   .max())
        for cap in sorted({1, 8, max(load - 1, 1), load, load + 5}):
            want_slots, want_over = jshard._bin_by_owner(
                jax.numpy.asarray(owner), n, cap)
            slots, over = tshard._bin_by_owner(torch.from_numpy(owner), n,
                                               cap)
            assert slots.dtype == torch.int32
            np.testing.assert_array_equal(slots.numpy(),
                                          np.asarray(want_slots))
            assert int(over) == int(want_over), (q, cap)


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_owners_match_numpy(mini, n):
    """Query owners (the host's uint64 codes mod n) and the table shards'
    owners against numpy uint64 and Python integers, keys past 2^63 and the
    pad key included: an n that is not a power of two is where a sign-flip
    shortcut would go wrong."""
    (store, table), (pstore, ptable) = mini
    _, _, qcode = window_codes(store, table.k)
    extra = np.array([0, 1, 1 << 63, (1 << 63) + 5, (1 << 64) - 2,
                      PAD_KEY], np.uint64)
    codes = np.concatenate([qcode, table.keys, extra])
    got = tshard.key_owner(codes, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, codes % np.uint64(n))
    np.testing.assert_array_equal(
        tshard.key_owner(extra, n), [int(x) % n for x in extra.tolist()])
    eng = tshard.ShardedOverlapEngine.build(pstore, ptable, _cpu_mesh(n))
    for s in range(n):
        keys = eng.keys[s, :eng.sizes[s]]
        assert (keys % np.uint64(n) == s).all()
        assert (eng.keys[s, eng.sizes[s]:] == PAD_KEY).all()


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_shard_layout_matches_jax(mini, n):
    """keys, read, orient, typ, sizes and the dist-mem payload layout, as
    numpy arrays, against disco_tpu's engines on n virtual CPU devices."""
    (store, table), (pstore, ptable) = mini
    want = jshard.ShardedOverlapEngine.build(store, table, _jax_mesh(n))
    got = tshard.ShardedOverlapEngine.build(pstore, ptable, _cpu_mesh(n))
    for f in ("keys", "read", "orient", "typ", "sizes"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(tshard.DistMemOverlapEngine.shard_payload(pstore, n),
                    jshard.DistMemOverlapEngine.shard_payload(store, n)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the superstep
# ---------------------------------------------------------------------------
# (hit_cap, route_cap): prune with marks, no cap exceeded; and caps far
# below the load, so that both the route and the hit caps overflow
STEP_CASES = {"prune": (4, 256), "overflow": (2, 16)}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
@pytest.mark.parametrize("n", [4, 8])
def test_superstep_grids_match_jax(mini, n, dist_mem, case):
    """One superstep on two chunks of mini's windows (pad windows at the
    tail, about a tenth of the reads marked), against disco_tpu's
    make_step: r2, orient, typ, edge_ok, cont_ok, overflow and the marked
    unions."""
    (store, table), (pstore, ptable) = mini
    hit_cap, route_cap = STEP_CASES[case]
    chunk = 512 * n
    kw = dict(hit_cap=hit_cap, route_cap=route_cap, prune_marked=True)
    lengths = np.asarray(store.lengths, np.int32)
    if dist_mem:
        jeng = jshard.DistMemOverlapEngine.build(store, table, _jax_mesh(n),
                                                 **kw)
        jstep, payload = jeng.make_step(store, q_chunk=chunk)

        def want_step(*a):
            return jstep(*payload, lengths, *a)
        teng = tshard.DistMemOverlapEngine.build(pstore, ptable,
                                                 _cpu_mesh(n), **kw)
        step, _ = teng.make_step(pstore, q_chunk=chunk)
        assert tshard.fetch_cap_for(chunk, n, hit_cap) == jeng.fetch_cap
    else:
        jeng = jshard.ShardedOverlapEngine.build(store, table, _jax_mesh(n),
                                                 **kw)
        jstep = jeng.make_step()
        packed_all = jax_packed_all(store.packed, store.packed_rc)

        def want_step(*a):
            return jstep(packed_all, lengths, *a)
        step = tshard.ShardedOverlapEngine.build(
            pstore, ptable, _cpu_mesh(n), **kw).make_step(pstore)

    qread, qj, qcode = window_codes(store, table.k)
    rng = np.random.default_rng(n)
    n_pad = store.n_reads + (-store.n_reads) % n
    edge = cont = False
    for s in (0, len(qread) // 2):
        marked = (rng.random(n_pad) < 0.1).astype(np.int32)
        args = (qread[s:s + chunk].copy(), qj[s:s + chunk].copy(),
                qcode[s:s + chunk].copy(), marked)
        args[1][-7:] = -1                                 # pad windows
        args[2][-7:] = PAD_KEY
        got = tshard.gather(_cpu_mesh(n), step(*args))
        want = [np.asarray(x) for x in want_step(*args)]
        for name, a, b in zip(("r2", "orient", "typ", "edge_ok", "cont_ok",
                               "overflow", "unions"), got, want):
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert (got[5].sum() > 0) == (case == "overflow")
        edge, cont = edge or got[3].any(), cont or got[4].any()
    assert edge and (cont or case == "overflow")


@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
def test_supersteps_check_through_the_rows_route(mini, dist_mem,
                                                 monkeypatch):
    """Both supersteps verify through K1's rows route, once a shard and at
    the grid's size, and never reach the gathered-column route: with
    `_dual_check` and the column wrapper made to raise, one superstep of
    mini at n = 4 still gives disco_tpu's grids."""
    from disco_tpu_torch.overlap import device as dv

    def columns(*a, **kw):
        raise AssertionError("a superstep reached the column route")

    real = dv.fused_compare_dual_rows
    sizes = []

    def rows(*a):
        sizes.append(len(a[1]))
        return real(*a)

    monkeypatch.setattr(dv, "_dual_check", columns)
    monkeypatch.setattr(dv, "fused_compare_dual", columns)
    monkeypatch.setattr(dv, "fused_compare_dual_rows", rows)
    (store, table), (pstore, ptable) = mini
    n, chunk = 4, 2048
    kw = dict(hit_cap=4, route_cap=512, prune_marked=True)
    lengths = np.asarray(store.lengths, np.int32)
    if dist_mem:
        jeng = jshard.DistMemOverlapEngine.build(store, table, _jax_mesh(n),
                                                 **kw)
        jstep, payload = jeng.make_step(store, q_chunk=chunk)
        step, _ = tshard.DistMemOverlapEngine.build(
            pstore, ptable, _cpu_mesh(n), **kw).make_step(pstore,
                                                          q_chunk=chunk)
        want_args = (*payload, lengths)
    else:
        jstep = jshard.ShardedOverlapEngine.build(
            store, table, _jax_mesh(n), **kw).make_step()
        step = tshard.ShardedOverlapEngine.build(
            pstore, ptable, _cpu_mesh(n), **kw).make_step(pstore)
        want_args = (jax_packed_all(store.packed, store.packed_rc), lengths)
    qread, qj, qcode = window_codes(store, table.k)
    marked = np.zeros(store.n_reads + (-store.n_reads) % n, np.int32)
    args = (qread[:chunk], qj[:chunk], qcode[:chunk], marked)
    got = tshard.gather(_cpu_mesh(n), step(*args))
    want = [np.asarray(x) for x in jstep(*want_args, *args)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sizes == [chunk // n * kw["hit_cap"]] * n
    assert got[3].any() and got[5].sum() == 0


def test_sharded_superstep_matches_host_relation(mini):
    """tests/test_dist_overlap.py's check over one chunk of mini at n = 8,
    hit_cap 32 and route_cap 2^16: no overflow, and the step's edge hits
    are the native relation's edge rows of those windows."""
    (store, table), (pstore, ptable) = mini
    rel = compute_relation(store, table, backend="native")
    eng = tshard.ShardedOverlapEngine.build(pstore, ptable, _cpu_mesh(8),
                                            hit_cap=32, route_cap=1 << 16)
    qread, qj, qcode = window_codes(store, table.k)
    q = 8 * 512
    marked = np.zeros(store.n_reads + (-store.n_reads) % 8, np.int32)
    step = eng.make_step(pstore)
    r2, _, _, edge_ok, _, overflow, _ = tshard.gather(
        eng.mesh, step(qread[:q], qj[:q], qcode[:q], marked))
    assert overflow.sum() == 0
    qi, hi = np.nonzero(edge_ok)
    got = sorted(zip(qread[qi].tolist(), qj[qi].tolist(),
                     r2[qi, hi].tolist()))
    inside = rel.edge_ok & ((rel.r1 < qread[q]) | (
        (rel.r1 == qread[q]) & (rel.j < qj[q])))
    want = sorted(zip(rel.r1[inside].tolist(), rel.j[inside].tolist(),
                      rel.r2[inside].tolist()))
    assert len(got) > 100 and got == want


# ---------------------------------------------------------------------------
# relations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pruned", [False, True], ids=["unpruned", "pruned"])
@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
@pytest.mark.parametrize("n", [4, 8])
def test_relations_match_jax(contained, n, dist_mem, pruned):
    """sharded_relation and sharded_relation_pruned at a small budget (many
    chunks, so early marks prune later chunks): relation, superread,
    cont_lines and stats equal disco_tpu's on the virtual mesh."""
    (store, table), (pstore, ptable) = contained
    kw = dict(budget=1 << 12, dist_mem=dist_mem)
    want_stats, stats = {}, {}
    if pruned:
        want, want_sr, want_lines = jbuilder.sharded_relation_pruned(
            store, table, _jax_mesh(n), stats=want_stats, **kw)
        got, sr, lines = builder.sharded_relation_pruned(
            pstore, ptable, _cpu_mesh(n), stats=stats, **kw)
        np.testing.assert_array_equal(sr, want_sr)
        assert lines == want_lines and len(lines) > 0
    else:
        want = jbuilder.sharded_relation(store, table, _jax_mesh(n),
                                         stats=want_stats, **kw)
        got = builder.sharded_relation(pstore, ptable, _cpu_mesh(n),
                                       stats=stats, **kw)
    _assert_relation(got, want)
    assert stats == want_stats and stats["chunks"] > 3
    assert got.stats == stats


@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
def test_pruned_relation_skips_contained_work(contained, dist_mem):
    """tests/test_dist_mem.py's check: later supersteps skip candidates
    touching contained reads (fewer rows than the native relation), while
    superread, the contained-read lines and the graph files are unchanged."""
    (store, table), (pstore, ptable) = contained
    full = compute_relation(store, table, backend="native")
    rel, superread, lines = builder.sharded_relation_pruned(
        pstore, ptable, _cpu_mesh(8), budget=1 << 12, dist_mem=dist_mem)
    assert (superread != 0).any(), "fixture has contained reads"
    assert len(rel) < len(full), "pruning removed no rows"
    want_sr, want_lines = jreplay.containment_replay(full, store)
    np.testing.assert_array_equal(superread, want_sr)
    assert lines == want_lines
    got_blob = replay.build_graph_replay_native(rel, pstore, superread, 1000)
    want_blob = jreplay.build_graph_replay_native(full, store, want_sr, 1000)
    assert got_blob[:2] == want_blob[:2]


def test_dist_mem_relation_matches_native(mini):
    (store, table), (pstore, ptable) = mini
    want = compute_relation(store, table, backend="native")
    got = builder.sharded_relation(pstore, ptable, _cpu_mesh(8),
                                   dist_mem=True, budget=1 << 16)
    _assert_relation(got, want)


@pytest.mark.parametrize("min_ovl", [30, 40])
def test_sharded_relation_polyT_and_chunking(tmp_path, min_ovl):
    """tests/test_dist_overlap.py's case: a read with a run of 40 T, and a
    tiny budget, so that the relation is assembled from many supersteps.
    At MinOverlap 40 (codes of 32 bases) the windows in the run hash to the
    table shards' pad key (the int64 maximum once flipped): the clamped
    lookup must not sweep the pad run into their bucket."""
    import random

    rng = random.Random(5)
    base = "".join(rng.choice("ACGT") for _ in range(400))
    reads = [base[i:i + 100] for i in range(0, 280, 20)]
    polyt = base[:30] + "T" * 40 + base[30:60]
    reads += [polyt, polyt[:80]]
    fa = tmp_path / "r.fasta"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    store = ReadStore.from_files([str(fa)], [], min_ovl,
                                 reference_task_order=False)
    table = FingerprintTable.build(store, min_ovl - 1)
    assert (window_codes(store, table.k)[2] == PAD_KEY).any() == (
        min_ovl == 40)
    want = compute_relation(store, table, backend="native")
    pstore, ptable = state_from_reference(store, table)
    for dist_mem in (False, True):
        stats, want_stats = {}, {}
        got = builder.sharded_relation(pstore, ptable, _cpu_mesh(8),
                                       budget=1 << 8, dist_mem=dist_mem,
                                       stats=stats)
        _assert_relation(got, want)
        # the chunks of 16 windows a shard overflow dist-mem's fetch slots
        # where disco_tpu's do
        jbuilder.sharded_relation(store, table, _jax_mesh(8), budget=1 << 8,
                                  dist_mem=dist_mem, stats=want_stats)
        assert stats == want_stats and stats["chunks"] > 1


# ---------------------------------------------------------------------------
# buildG files
# ---------------------------------------------------------------------------
def _files(fix, tmp_path, monkeypatch):
    """Copies the golden's reads into tmp_path and runs from there
    (_ReadIDMap.txt records the path as given); (paired, single) as the
    goldens were made: micro with -se, mini with -pe."""
    shutil.copy(GOLDEN / fix / "reads.fasta", tmp_path / "reads.fasta")
    monkeypatch.chdir(tmp_path)
    return (["reads.fasta"], []) if fix == "mini" else ([], ["reads.fasta"])


def _assert_golden(tmp_path, name, fix, suffixes=GRAPH + ("_ReadIDMap.txt",)):
    for suffix in suffixes:
        assert ((tmp_path / f"{name}{suffix}").read_bytes()
                == (GOLDEN / fix / f"{fix}{suffix}").read_bytes()), suffix


@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
@pytest.mark.parametrize("fix", ["micro", "mini"])
def test_sharded_buildg_matches_reference(fix, dist_mem, tmp_path,
                                          monkeypatch):
    """buildg -n 4 (and -rma) on 4 CPU shards: every file equals the
    reference's golden."""
    paired, single = _files(fix, tmp_path, monkeypatch)
    stats = {}
    out = builder.run_buildg_sharded(paired, single, fix, 4, min_overlap=30,
                                     write_par_graph_size=1000,
                                     dist_mem=dist_mem, stats=stats,
                                     device="cpu")
    assert out[1].stats == stats and stats["fallback_chunks"] == 0
    _assert_golden(tmp_path, fix, fix)


@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
def test_sharded_buildg_overflow_fallback(dist_mem, tmp_path, monkeypatch):
    """A route_cap far below the per-peer load sends every chunk through
    the exact re-run (builder._chunk_fallback, K1 on the shards' device):
    the files stay the goldens and the fallback is counted, as disco_tpu's
    run_buildg_sharded counts it."""
    paired, single = _files("mini", tmp_path, monkeypatch)
    kw = dict(min_overlap=30, write_par_graph_size=1000, budget=1 << 15,
              route_cap=8, dist_mem=dist_mem)
    stats, want_stats = {}, {}
    builder.run_buildg_sharded(paired, single, "port", 4, stats=stats,
                               device="cpu", **kw)
    jbuilder.run_buildg_sharded(paired, single, "jax", _jax_mesh(4),
                                stats=want_stats, **kw)
    assert stats == want_stats
    assert stats["fallback_chunks"] >= 1 and stats["chunks"] >= 2
    _assert_golden(tmp_path, "port", "mini", GRAPH)


@pytest.mark.parametrize("run", ["replicated", "dist_mem", "overflow"])
def test_dryrun_multichip_runs(run, tmp_path):
    """__graft_entry__.py's dryrun_multichip at n = 4: mixed-length reads
    (half reverse-complemented, MinOverlap 13), a budget of 2^13 so the
    run takes several supersteps; each run's files equal the single-device
    run_buildg's (the port's, on the CPU, and disco_tpu's)."""
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    rc = dict(zip("ACGT", "TGCA"))
    recs = []
    for _ in range(600):
        ln = int(rng.integers(36, 57))
        s = int(rng.integers(0, len(genome) - ln))
        seq = genome[s:s + ln]
        if rng.random() < 0.5:
            seq = "".join(rc[c] for c in reversed(seq))
        recs.append(seq)
    fasta = tmp_path / "reads.fasta"
    fasta.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    kw = dict(min_overlap=13, write_par_graph_size=1000)
    run_buildg([str(fasta)], [], str(tmp_path / "REF"), backend="device",
               device="cpu", **kw)
    jax_run_buildg([str(fasta)], [], str(tmp_path / "JAX"), **kw)
    stats = {}
    builder.run_buildg_sharded(
        [str(fasta)], [], str(tmp_path / "RUN"), 4, budget=1 << 13,
        dist_mem=run == "dist_mem", route_cap=8 if run == "overflow" else None,
        stats=stats, device="cpu", **kw)
    assert stats["chunks"] >= 3, stats
    if run == "overflow":
        assert stats["fallback_chunks"] >= 1, stats
    else:
        assert stats["fallback_chunks"] == 0, stats
    for o in GRAPH:
        want = (tmp_path / f"REF{o}").read_bytes()
        assert want == (tmp_path / f"JAX{o}").read_bytes(), o
        assert (tmp_path / f"RUN{o}").read_bytes() == want, o
    assert (tmp_path / "REF_0_parGraph.txt").stat().st_size > 0
    assert (tmp_path / "REF_0_containedReads.txt").stat().st_size > 0


def test_payload_partitioned(mini):
    """Shard s holds exactly the reads r with r % n == s, forward rows over
    rc rows (its block of shard_payload), and nothing else: the property
    Disco's RMA window gives (reference:
    src/BuildGraphMPIRMA/src/HashTable.cpp:92-119,422-435)."""
    (_, _), (pstore, ptable) = mini
    n = 8
    eng = tshard.DistMemOverlapEngine.build(pstore, ptable, _cpu_mesh(n))
    seen = {}

    def spy(self, row_ids, payload, *rest):
        seen["payload"] = payload
        return real(self, row_ids, payload, *rest)

    real = tshard.DistMemOverlapEngine._fetch_rows
    step, (packed_sh, _) = eng.make_step(pstore, q_chunk=64 * n)
    block = -(-pstore.n_reads // n)
    assert packed_sh.shape[0] == n * block
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tshard.DistMemOverlapEngine, "_fetch_rows", spy)
        qread, qj, qcode = port_relation.window_codes(pstore, ptable.k)
        step(qread[:64 * n], qj[:64 * n], qcode[:64 * n],
             np.zeros(n * block, np.int32))
    rid = np.arange(pstore.n_reads)
    for s, pay in enumerate(seen["payload"]):
        assert tuple(pay.shape) == (2 * block, pstore.packed.shape[1])
        own = rid[rid % n == s]
        words = pay.numpy().view(np.uint32)
        np.testing.assert_array_equal(words[:len(own)], pstore.packed[own])
        np.testing.assert_array_equal(words[block:block + len(own)],
                                      pstore.packed_rc[own])
        assert not words[len(own):block].any()


RESUME_KW = dict(min_overlap=30, write_par_graph_size=20)


@pytest.fixture(scope="module")
def resume_state(tmp_path_factory):
    """An uninterrupted 4-shard run on mini with parGraph chunks of 20
    records, and the replay's chunk ends and start lines (to fabricate the
    state of a build killed mid-graph)."""
    files = [str(GOLDEN / "mini" / "reads.fasta")]
    full = tmp_path_factory.mktemp("full")
    builder.run_buildg_sharded(files, [], str(full / "P"), 4, device="cpu",
                               **RESUME_KW)
    store = ReadStore.from_files(files, [], 30)
    rel = compute_relation(store, FingerprintTable.build(store, 29),
                           backend="native")
    superread, _ = jreplay.containment_replay(rel, store)
    blob, starts_blob, chunk_ends = jreplay.build_graph_replay_native(
        rel, store, superread, 20)
    assert (full / "P_0_parGraph.txt").read_bytes() == blob
    return files, full, blob, starts_blob.decode().splitlines(), chunk_ends


@pytest.mark.parametrize("state", ["ccr", "partial"])
def test_resume(resume_state, state, tmp_path):
    """CCR=Complete seeds the pruning mask from _containedReads.txt; with a
    partial parGraph too (the build killed during chunk k: chunks [0, k)
    flushed, startRead lines [0, k]) the graph phase resumes and appends.
    Both end in the uninterrupted run's files and in the files of
    disco_tpu's run_buildg_sharded from the same state; then GC=Complete
    makes a rerun a no-op."""
    files, full, blob, start_lines, chunk_ends = resume_state
    k = len(chunk_ends) // 2
    assert k >= 2
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        shutil.copy(full / "P_0_containedReads.txt",
                    d / "K_0_containedReads.txt")
        (d / "K_CheckpointInfo.txt").write_text("CCR=Complete\n")
        if state == "partial":
            (d / "K_0_parGraph.txt").write_bytes(blob[:chunk_ends[k - 1]])
            (d / "K_0_startRead.txt").write_text(
                "".join(ln + "\n" for ln in start_lines[:k + 1]))
        if pkg == "port":
            builder.run_buildg_sharded(files, [], str(d / "K"), 4,
                                       device="cpu", **RESUME_KW)
        else:
            jbuilder.run_buildg_sharded(files, [], str(d / "K"),
                                        _jax_mesh(4), **RESUME_KW)
    port = tmp_path / "port"
    for name in ("K_0_parGraph.txt", "K_0_containedReads.txt",
                 "K_0_startRead.txt", "K_CheckpointInfo.txt"):
        assert (port / name).read_bytes() == (tmp_path / "jax" / name
                                              ).read_bytes(), name
    assert (port / "K_0_parGraph.txt").read_bytes() == blob
    assert (port / "K_0_containedReads.txt").read_bytes() == (
        full / "P_0_containedReads.txt").read_bytes()
    assert "GC=Complete" in (port / "K_CheckpointInfo.txt").read_text()
    if state == "partial":
        assert (port / "K_0_startRead.txt").read_text().splitlines()[0] == \
            start_lines[k]
    (port / "K_0_parGraph.txt").write_bytes(b"sentinel")
    assert builder.run_buildg_sharded(files, [], str(port / "K"), 4,
                                      device="cpu", **RESUME_KW) == (None,) * 3
    assert (port / "K_0_parGraph.txt").read_bytes() == b"sentinel"


def test_without_a_card_the_mesh_raises(tmp_path):
    """-n and -rma take the CUDA cards: without one, make_mesh and
    run_buildg_sharded raise before anything is written, unless the caller
    names device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the mesh takes it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmesh.make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        builder.run_buildg_sharded([str(GOLDEN / "micro" / "reads.fasta")],
                                   [], str(tmp_path / "x"), 4)
    assert not list(tmp_path.iterdir())
    mesh = tmesh.make_mesh(3, "cpu")
    assert mesh.size == 3 and mesh.distinct() == [torch.device("cpu")]


def test_collectives():
    """all_to_all is tiled on dim 0 (shard d gets block d of every shard,
    in shard order); all_gather concatenates and shares one tensor per
    device; split and replicate place P(AXIS) and P() inputs."""
    mesh = _cpu_mesh(3)
    xs = [torch.arange(6).view(6, 1) + 10 * s for s in range(3)]
    out = tmesh.all_to_all(mesh, xs)
    for d in range(3):
        want = torch.cat([xs[s][2 * d:2 * d + 2] for s in range(3)])
        assert torch.equal(out[d], want)
    g = tmesh.all_gather(mesh, xs)
    assert torch.equal(g[0], torch.cat(xs)) and g[0] is g[2]
    parts = mesh.split(np.arange(6))
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    r = mesh.replicate(np.arange(3))
    assert r[0] is r[1] and r[0].tolist() == [0, 1, 2]
    with pytest.raises(ValueError):
        mesh.split(np.arange(4))


# ---------------------------------------------------------------------------
# the scaling tool
# ---------------------------------------------------------------------------
def test_bench_scaling_model_matches_jax_tool():
    """superstep_bytes is tools/bench_scaling.py's model, unchanged, and
    the tool's chunk plan is dist.builder.chunk_plan."""
    from disco_tpu_torch.tools import bench_scaling as port_tool
    from tools import bench_scaling as jax_tool

    for args in ((1, 4096, 1024, 3, 5000, 9, False, 0),
                 (4, 1 << 20, 262144, 6, 552000, 17, True, 1835008),
                 (8, 99992, 12504, 32, 77, 5, True, 8)):
        assert port_tool.superstep_bytes(*args) == jax_tool.superstep_bytes(
            *args)
    store, table = port_tool.read_set(4, 2000, 120, 40)
    q = len(port_relation.window_codes(store, table.k)[0])
    hit_cap, chunk, route_cap = builder.chunk_plan(table, q, 4, None,
                                                   1 << 12)
    _, counts = np.unique(table.keys, return_counts=True)
    assert hit_cap == counts.max() and chunk % 4 == 0
    assert chunk * hit_cap <= (1 << 12) + 4 * hit_cap
    assert route_cap == builder._default_route_cap(chunk, 4)


def test_dist_walls_raises_without_a_card(monkeypatch):
    """tools/dist_walls.py measures a card: without one it raises before
    it reads anything."""
    from disco_tpu_torch.tools import dist_walls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        dist_walls.main(["--fasta", "missing.fasta"])


def test_bench_scaling_raises_without_a_card():
    from disco_tpu_torch.tools import bench_scaling

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool runs on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_scaling.main(["--shards", "2"])
    with pytest.raises(ValueError, match="CUDA card"):
        bench_scaling.main(["--shards", "2", "--device", "cpu"])
