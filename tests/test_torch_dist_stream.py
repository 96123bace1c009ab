"""The distributed relation streamed by chunk (disco_tpu_torch.dist.builder's
chunk loop; overlap_shard.shard_windows, code_owner and compact) on CPU
shards: against disco_tpu's sharded relations on the conftest's virtual
CPU mesh, against numpy's uint64 owners, against np.nonzero over the
gathered grids, and against closed formulas at window indices past 2^31.
The shards run the kernels' plain versions.  Tolerance: exact — every
output is an integer or boolean array, or a file."""
import subprocess
import sys
import tracemalloc

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from conftest import GOLDEN
from disco_tpu.buildg import replay as jreplay
from disco_tpu.dist import builder as jbuilder
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.relation import compute_relation, window_codes
from disco_tpu_torch.buildg import replay
from disco_tpu_torch.convert import state_from_reference
from disco_tpu_torch.dist import builder, mesh as tmesh
from disco_tpu_torch.dist import overlap_shard as tshard
from disco_tpu_torch.overlap import device as port_device
from disco_tpu_torch.overlap import relation as port_relation
from test_torch_native import private_native  # noqa: F401

torch.set_num_threads(1)

ROOT = GOLDEN.parent.parent
FIELDS = ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok")
MODES = {"replicated": False, "dist_mem": True}
# budgets of at least 3 chunks whose edges fall inside a read
BUDGET = {"mini": 1 << 16, "dense": 1 << 13}
N_BIG, LEN_BIG, K = 10_000_000, 250, 29   # the 100 Mb / 25x / 250 bp set


def _jax_mesh(n):
    return JaxMesh(np.array(jax.devices("cpu")[:n]), ("dp",))


def _cpu_mesh(n):
    return tmesh.make_mesh(n, "cpu")


def _state(store, min_ovl=30):
    table = FingerprintTable.build(store, min_ovl - 1)
    return (store, table), state_from_reference(store, table)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """disco_tpu's (store, table) and the port's copies of golden mini and
    of a dense seeded set (make_testdata.py: a 3 kb genome at 30x in
    100 bp pairs, so that buckets run deep)."""
    fasta = tmp_path_factory.mktemp("dense") / "reads.fasta"
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_testdata.py"),
                    str(fasta), "--genome-len", "3000", "--coverage", "30",
                    "--read-len", "100", "--insert", "250", "--seed", "3"],
                   check=True, stdout=subprocess.DEVNULL)
    out = {}
    for name, path in (("mini", GOLDEN / "mini" / "reads.fasta"),
                       ("dense", fasta)):
        out[name] = _state(ReadStore.from_files(
            [str(path)], [], 30, reference_task_order=False))
    return out


def _assert_relation(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _windows_a_read(store):
    return int(store.lengths.max()) - 29


# ---------------------------------------------------------------------------
# relations and files against disco_tpu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["mini", "dense"])
def test_streamed_relation_matches_jax(sets, name, mode, n):
    """sharded_relation (unpruned) at a budget of at least 3 chunks whose
    edges fall inside a read: disco_tpu's relation row for row, and its
    stats."""
    (store, table), (pstore, ptable) = sets[name]
    kw = dict(budget=BUDGET[name], dist_mem=MODES[mode])
    want_stats, stats, profile = {}, {}, {}
    want = jbuilder.sharded_relation(store, table, _jax_mesh(n),
                                     stats=want_stats, **kw)
    got = builder.sharded_relation(pstore, ptable, _cpu_mesh(n), stats=stats,
                                   profile=profile, **kw)
    _assert_relation(got, want)
    assert stats == want_stats and got.stats == stats
    assert stats["chunks"] >= 3 and stats["fallback_chunks"] == 0
    assert profile["chunk"] % _windows_a_read(store) != 0
    assert set(profile["host_s"]) == set(builder.HOST_STAGES)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["mini", "dense"])
def test_pruned_relation_files_match_jax(sets, name, mode, n):
    """sharded_relation_pruned: the relation (the same marks, lagging by
    the same one chunk), superread and the contained-read lines equal
    disco_tpu's, and the graph the replay writes from them equals
    disco_tpu's replay of its own relation and of the native one."""
    (store, table), (pstore, ptable) = sets[name]
    kw = dict(budget=BUDGET[name], dist_mem=MODES[mode])
    want, want_sr, want_lines = jbuilder.sharded_relation_pruned(
        store, table, _jax_mesh(n), **kw)
    got, sr, lines = builder.sharded_relation_pruned(pstore, ptable,
                                                     _cpu_mesh(n), **kw)
    _assert_relation(got, want)
    np.testing.assert_array_equal(sr, want_sr)
    assert lines == want_lines
    full = compute_relation(store, table, backend="native")
    nat_sr, nat_lines = jreplay.containment_replay(full, store)
    np.testing.assert_array_equal(sr, nat_sr)
    assert lines == nat_lines
    blob = replay.build_graph_replay_native(got, pstore, sr, 1000)[:2]
    assert blob == jreplay.build_graph_replay_native(want, store, want_sr,
                                                     1000)[:2]
    assert blob == jreplay.build_graph_replay_native(full, store, nat_sr,
                                                     1000)[:2]
    assert len(blob[0]) > 0


@pytest.mark.parametrize("caps", ["route_cap", "hit_cap"])
@pytest.mark.parametrize("mode", list(MODES))
def test_forced_overflow_rerun_in_place(sets, mode, caps):
    """route_cap 8 (every chunk overflows) and hit_cap 2 in chunks of 2048
    windows (those holding a deeper bucket): each such chunk is re-run
    exactly in its place, the relation and the stats equal disco_tpu's, in
    both the unpruned and the pruned relation."""
    (store, table), (pstore, ptable) = sets["mini"]
    kw = {"route_cap": dict(budget=BUDGET["mini"], route_cap=8),
          "hit_cap": dict(budget=1 << 12, hit_cap=2)}[caps]
    kw["dist_mem"] = MODES[mode]
    want_stats, stats = {}, {}
    want = jbuilder.sharded_relation(store, table, _jax_mesh(4),
                                     stats=want_stats, **kw)
    got = builder.sharded_relation(pstore, ptable, _cpu_mesh(4), stats=stats,
                                   **kw)
    _assert_relation(got, want)
    assert stats == want_stats and stats["fallback_chunks"] > 0
    if caps == "hit_cap":
        assert stats["fallback_chunks"] < stats["chunks"]
    want, want_sr, want_lines = jbuilder.sharded_relation_pruned(
        store, table, _jax_mesh(4), **kw)
    got, sr, lines = builder.sharded_relation_pruned(pstore, ptable,
                                                     _cpu_mesh(4), **kw)
    _assert_relation(got, want)
    np.testing.assert_array_equal(sr, want_sr)
    assert lines == want_lines


# ---------------------------------------------------------------------------
# the chunk step's pieces
# ---------------------------------------------------------------------------
def _host_inputs(store, k, s, e, chunk, n):
    """disco_tpu's chunk arrays, padded as the host front end pads them,
    split over n shards: the inputs `shard_windows` must make."""
    qread, qj, qcode = window_codes(store, k)
    pad = chunk - (e - s)
    qcode = np.pad(qcode[s:e], (0, pad), constant_values=tshard.PAD_KEY)
    return [np.split(x, n) for x in (
        np.pad(qread[s:e], (0, pad)),
        np.pad(qj[s:e], (0, pad), constant_values=-1),
        port_device.flip_keys(qcode), tshard.key_owner(qcode, n))]


@pytest.mark.parametrize("n", [3, 4, 8])
def test_chunk_windows_match_host_arrays(sets, n):
    """make_chunk_step's windows(s, e) on each shard equal the host front
    end's split of disco_tpu's window_codes slices: qread, qj, the flipped
    codes and the owners, pad lanes included, on a first chunk, a chunk
    that starts inside a read and the last, partial chunk (some shards of
    it all padding)."""
    (store, table), (pstore, ptable) = sets["mini"]
    eng = tshard.ShardedOverlapEngine.build(pstore, ptable, _cpu_mesh(n))
    windows, _ = eng.make_chunk_step(pstore, 600 * n)
    q = int(store.lengths.sum()) - store.n_reads * table.k
    for s in (0, 1000, q - 700):
        e = min(s + 600 * n, q)
        got = windows(s, e)
        want = _host_inputs(store, table.k, s, e, 600 * n, n)
        for name, g, w in zip(("qread", "qj", "code", "owner"), got, want):
            for d in range(n):
                assert g[d].dtype == torch.from_numpy(w[d]).dtype, name
                np.testing.assert_array_equal(g[d].numpy(), w[d],
                                              err_msg=f"{name} {d}")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8])
def test_code_owner_matches_key_owner(n):
    """The owners made on a device from the flipped codes' 32-bit halves
    equal numpy's uint64 code mod n, for window codes of 32 bases
    (MinOverlap 40: the top bit set on half of them), random 64-bit keys,
    and the keys at 0, 2^32, 2^63 and 2^64 - 1."""
    rng = np.random.default_rng(n)
    store = ReadStore.from_sequences(
        ["".join(rng.choice(list("ACGT"), 120)) for _ in range(200)])
    codes = np.concatenate([
        window_codes(store, 39)[2],
        rng.integers(0, 1 << 63, 5000, dtype=np.uint64) * np.uint64(2)
        + rng.integers(0, 2, 5000, dtype=np.uint64),
        np.array([0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
                  (1 << 63) + 1, (1 << 64) - 2, (1 << 64) - 1], np.uint64)])
    assert (codes >= np.uint64(1 << 63)).mean() > 0.3
    got = tshard.code_owner(torch.from_numpy(port_device.flip_keys(codes)),
                            n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tshard.key_owner(codes, n))


@pytest.mark.parametrize("where", ["below", "above", "across", "last"])
def test_shard_windows_past_2_31(where):
    """One shard's windows of 10M reads of 250 bp (2.21e9 windows), in a
    slice either side of 2^31, one across it and the last, padded: read =
    g // 221 and j = g % 221, the codes of those windows
    (`window_codes_at`) and their owners; the host hands over the offsets
    and rows of the reads the slice touches (the rows of read r are a
    small set's read r mod 300)."""
    rng = np.random.default_rng(11)
    small = ReadStore.from_sequences(
        ["".join(rng.choice(list("ACGT"), LEN_BIG)) for _ in range(300)])

    class Rows:          # the 10M reads' packed rows, sliced by read
        def __getitem__(self, sl):
            return small.packed[np.arange(sl.start, sl.stop) % 300]

    woff = port_device.window_offsets(np.full(N_BIG, LEN_BIG, np.int32), K)
    n_win, lanes = LEN_BIG - K, 5000
    a = {"below": (1 << 31) - lanes, "above": 1 << 31,
         "across": (1 << 31) - 777, "last": int(woff[-1]) - 1000}[where]
    b = min(a + lanes, int(woff[-1]))
    qread, qj, code, owner = tshard.shard_windows(woff, Rows(), a, b, lanes,
                                                  K, 3, "cpu")
    g = np.arange(a, b, dtype=np.int64)
    m = b - a
    np.testing.assert_array_equal(qread[:m].numpy(), g // n_win)
    np.testing.assert_array_equal(qj[:m].numpy(), g % n_win)
    want = port_relation.window_codes_at(small, (g // n_win) % 300,
                                         g % n_win, K)
    np.testing.assert_array_equal(code[:m].numpy(),
                                  port_device.flip_keys(want))
    np.testing.assert_array_equal(owner[:m].numpy(),
                                  tshard.key_owner(want, 3))
    assert (qj[m:] == -1).all() and (qread[m:] == 0).all()
    assert (m < lanes) == (where == "last")


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_compaction_equals_nonzero(sets, mode, n):
    """`compact`'s rows, pulled (`_pull`), equal np.nonzero over `gather`'s
    grids, order included (shard, window, slot): r1 and j of the window,
    r2, orient, typ and both flags; on a full chunk and the last, partial
    one, with a tenth of the reads marked."""
    (_, _), (pstore, ptable) = sets["dense"]
    mesh = _cpu_mesh(n)
    engine = tshard.DistMemOverlapEngine if MODES[mode] else \
        tshard.ShardedOverlapEngine
    chunk = 512 * n
    q = int(pstore.lengths.sum()) - pstore.n_reads * ptable.k
    hit_cap = builder.chunk_plan(ptable, q, n, None, 1 << 20)[0]
    eng = engine.build(pstore, ptable, mesh, hit_cap=hit_cap, route_cap=1024,
                       prune_marked=True)
    windows, run = eng.make_chunk_step(pstore, chunk)
    rng = np.random.default_rng(n)
    counts = []
    for s in (0, q - 300):
        marked = (rng.random(pstore.n_reads + (-pstore.n_reads) % n)
                  < 0.1).astype(np.int32)
        inputs = windows(s, min(s + chunk, q))
        out = run(inputs, marked)
        rows, metas = tshard.compact(inputs[0], inputs[1], out)
        got = builder._pull(mesh, rows, metas)
        r2, orient, typ, edge_ok, cont_ok, overflow, _ = tshard.gather(mesh,
                                                                       out)
        assert overflow.sum() == 0
        qi, hi = np.nonzero(edge_ok | cont_ok)
        qread = np.concatenate([x.numpy() for x in inputs[0]])
        qj = np.concatenate([x.numpy() for x in inputs[1]])
        code = (orient[qi, hi] | (typ[qi, hi] << 2)
                | (edge_ok[qi, hi].astype(np.int32) << 3)
                | (cont_ok[qi, hi].astype(np.int32) << 4))
        want = np.stack([qread[qi], qj[qi], r2[qi, hi], code], 1)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        counts.append(np.bincount(qi // (chunk // n), minlength=n))
        assert len(got) > 0 and edge_ok.any()
    assert any(len(set(c.tolist())) > 1 for c in counts)   # uneven shards


def test_pull_reports_an_overflow(sets):
    """A shard whose step overflowed makes `_pull` return None (the chunk is
    re-run), whatever the other shards kept."""
    (_, _), (pstore, ptable) = sets["mini"]
    mesh = _cpu_mesh(4)
    eng = tshard.ShardedOverlapEngine.build(pstore, ptable, mesh, hit_cap=2,
                                            route_cap=8)
    windows, run = eng.make_chunk_step(pstore, 2048)
    inputs = windows(0, 2048)
    out = run(inputs, np.zeros(pstore.n_reads, np.int32))
    assert tshard.gather(mesh, out)[5].sum() > 0
    assert builder._pull(mesh, *tshard.compact(inputs[0], inputs[1],
                                                out)) is None


# ---------------------------------------------------------------------------
# what the host never does
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(MODES))
def test_no_whole_set_codes_or_global_sort(sets, mode, monkeypatch):
    """With whole-set `window_codes` and `np.lexsort` made to raise, the
    unpruned and the pruned relation (some chunks re-run: hit_cap 2) still
    equal disco_tpu's."""
    (store, table), (pstore, ptable) = sets["mini"]
    kw = dict(budget=BUDGET["mini"], dist_mem=MODES[mode], hit_cap=2)
    want = jbuilder.sharded_relation(store, table, _jax_mesh(4), **kw)
    want_p, want_sr, _ = jbuilder.sharded_relation_pruned(
        store, table, _jax_mesh(4), **kw)

    def banned(*a, **k):
        raise AssertionError("a whole-set window array or a global sort")

    monkeypatch.setattr(port_relation, "window_codes", banned)
    monkeypatch.setattr(np, "lexsort", banned)
    stats = {}
    got = builder.sharded_relation(pstore, ptable, _cpu_mesh(4), stats=stats,
                                   **kw)
    got_p, sr, _ = builder.sharded_relation_pruned(pstore, ptable,
                                                   _cpu_mesh(4), **kw)
    monkeypatch.undo()
    _assert_relation(got, want)
    _assert_relation(got_p, want_p)
    np.testing.assert_array_equal(sr, want_sr)
    assert stats["fallback_chunks"] > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_no_host_array_a_window(mode):
    """Over 4000 reads of 250 bp (884,000 windows) in chunks of 4096 on 4
    shards, the pruned relation's numpy allocations peak below 2 B a
    window: no host array of one int16 or wider entry a window of the
    whole set exists at any time; the relation equals the native one's."""
    rng = np.random.default_rng(7)
    store = ReadStore.from_sequences(
        ["".join(rng.choice(list("ACGT"), LEN_BIG)) for _ in range(4000)])
    (store, table), (pstore, ptable) = _state(store)
    want = compute_relation(store, table, backend="native")
    n_win = int(store.lengths.sum()) - store.n_reads * table.k
    stats = {}
    tracemalloc.start()
    try:
        got, _, _ = builder.sharded_relation_pruned(
            pstore, ptable, _cpu_mesh(4), budget=1 << 12,
            dist_mem=MODES[mode], stats=stats)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    _assert_relation(got, want)
    assert stats["chunks"] >= -(-n_win // (1 << 12))
    assert peak < 2 * n_win, (peak, n_win)
