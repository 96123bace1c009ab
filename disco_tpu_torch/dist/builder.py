"""Distributed graph construction: the BuildGraphMPI / BuildGraphMPIRMA
equivalent (the counterpart of disco_tpu/dist/builder.py; reference:
src/BuildGraphMPI/, src/BuildGraphMPIRMA/).

The overlap relation is computed on a mesh of shards by the sharded
superstep (query axis cut over the shards, fingerprint table sharded by
key, all_to_all candidate routing) and assembled into the same relation
order as the single-device path, so the sequential replay writes files
byte-identical to a single-process reference run, whatever the shard
count.

The relation streams (as the single-device one does,
overlap/relation.py::_device_relation): each chunk's windows, codes and
owners are made on the shards' devices from the reads' int64 window
offsets (`ShardedOverlapEngine.make_chunk_step`), each shard lists its kept
lanes on its device (`overlap_shard.compact`) and only those come to the
host, 16 B a row, and each chunk's rows are put in relation order as they
arrive (`relation.relation_order`).  No host array holds an entry a window
of the whole set, and there is no global sort: what grows on the host is
the kept rows.

The mesh may span processes (dist/multiproc.py, one process per rank):
every rank runs this same loop, each step computes its local shards'
slice, and `_pull` gathers every shard's row count and overflow, then
every shard's kept rows padded to the largest count, to every rank
(`mesh.gather_host`), so every rank holds the same rows and takes the same
decision to re-run a chunk: ranks whose control flow diverged would wait
on different collectives.  disco_tpu's multiproc raises on an overflow
instead; here every rank re-runs the chunk exactly (`_chunk_fallback`) and
gets the same rows."""
import os
from typing import Optional, Sequence, Union

import numpy as np

from ..buildg import replay
from ..buildg.pipeline import load_contained_reads, read_checkpoint_info
from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..overlap.device import chunk_windows, window_offsets
from ..overlap.relation import (_COLUMNS, OverlapRelation, _xla_rows,
                                relation_order, window_codes_at)
from ..overlap.verify import make_packed_all
from ..utils.logging import RECORDER, clock, count, span
from .mesh import Mesh, gather_host, make_mesh
from .overlap_shard import DistMemOverlapEngine, ShardedOverlapEngine, compact

# the host's stages of the chunk loop, each the span "dist.<stage>"
# (utils/logging.py; the single-device loop's are "relation.<stage>"),
# whose seconds `_relation` adds up: the marked mask, the windows' inputs
# staged for the devices, the step and compaction enqueued, the count read
# and rows pulled (the wait for the devices included), the rows decoded and
# ordered, the containment replay, and the exact re-runs.  Outside the
# loop, the spans dist.build (the chunk plan and the engine, its table
# shards and payload put on the devices) and dist.join (the columns
# joined).  The counters: dist.chunks, dist.fallback_chunks, dist.rows
# (rows `_pull` brought to the host), and the exchanges' bytes
# (overlap_shard.py)
HOST_STAGES = ("marked", "windows", "step", "pull", "order", "replay",
               "fallback")


def _default_route_cap(chunk: int, n_dev: int) -> int:
    """Per-peer routing-slot capacity.  The worst case is chunk // n_dev
    (every query of a shard's slice landing on one key owner), but shipping
    it makes each all_to_all n_dev times larger than the real traffic.
    With uniform key hashing the per-peer load is Binomial(chunk/n, 1/n):
    4x the mean plus a floor covers any realistic skew, and a chunk that
    still overflows is re-run exactly (_chunk_fallback), so the cap is a
    performance knob, not a correctness bound."""
    per_dev = max(chunk // n_dev, 1)
    cap = min(per_dev, max(4 * per_dev // n_dev, 1024))
    return max(8, -(-cap // 8) * 8)


def _chunk_fallback(store, table, read, j, codes, *, device,
                    packed_all=None):
    """Exact recompute of one overflowed superstep chunk (hit, route or
    fetch cap exceeded) by `relation._xla_rows` over the chunk's own
    windows (read, j) and their codes: every candidate expanded on the
    host and checked through K1's column kernel on `device`.  Emits the
    chunk's kept rows in the (window, table-slot) order of the grid
    compaction.  Skipping the marked prune here is safe: pruned rows are
    exactly rows the replays skip.  The reference has no such path (an
    overflowing rank aborts)."""
    return _xla_rows(store, table, read, j, codes, device=device,
                     packed_all=packed_all)


def chunk_plan(table: FingerprintTable, q: int, n_dev: int,
               route_cap: Optional[int], budget: int,
               hit_cap: Optional[int] = None):
    """(hit_cap, chunk, route_cap) of a sharded relation over q windows.
    hit_cap defaults to the table's largest key bucket, so the hit grids
    are lossless (a smaller one overflows into the exact re-run); the chunk
    keeps chunk * hit_cap at the budget and is a multiple of the shard
    count."""
    if hit_cap is None:
        # largest bucket in the sorted table = max run of equal keys
        _, counts = np.unique(table.keys, return_counts=True)
        hit_cap = max(int(counts.max()) if len(counts) else 1, 1)
    chunk = max(budget // hit_cap, n_dev)
    chunk = min(chunk, -(-q // n_dev) * n_dev)
    chunk = -(-chunk // n_dev) * n_dev
    if route_cap is None:
        route_cap = _default_route_cap(chunk, n_dev)
    return hit_cap, chunk, route_cap


def _pull(mesh: Mesh, rows, metas):
    """The kept rows of a compacted step (`overlap_shard.compact`) on the
    host, (R, 4) int32 in shard, window, slot order, or None when a shard
    overflowed a cap.  One count read for every shard (across processes
    one `all_gather`), then each shard's rows padded to the largest count,
    so that every rank holds the same rows, counted as dist.rows."""
    meta = gather_host(mesh, metas).reshape(mesh.size, 2)
    if meta[:, 1].sum() != 0:
        return None
    top = int(meta[:, 0].max())
    count("dist.rows", int(meta[:, 0].sum()))
    if top == 0:
        return np.zeros((0, 4), np.int32)
    got = gather_host(mesh, [r[:top] for r in rows]).reshape(mesh.size, top,
                                                             4)
    return np.concatenate([got[d, :c] for d, c in enumerate(meta[:, 0])])


def _relation(store: ReadStore, table: FingerprintTable, mesh: Mesh, *,
              route_cap, budget, dist_mem, prune,
              superread_init=None, stats=None, hit_cap=None, profile=None):
    """The chunked sharded relation; with `prune`, in-loop containment
    marking.  Returns (relation, superread, cont_lines).  `profile`, a
    dict, receives the chunk plan (hit_cap, chunk, route_cap) and the
    host's seconds by stage (`host_s`, HOST_STAGES)."""
    n_dev = mesh.size
    k = table.k
    before = RECORDER.totals()

    def stage(name):
        return span("dist." + name)

    with stage("build"):
        woff = window_offsets(store.lengths, k)
        q = int(woff[-1])
        hit_cap, chunk, route_cap = chunk_plan(table, q, n_dev, route_cap,
                                               budget, hit_cap)
        engine = DistMemOverlapEngine if dist_mem else ShardedOverlapEngine
        eng = engine.build(store, table, mesh, hit_cap=hit_cap,
                           route_cap=route_cap, prune_marked=prune)
        windows, run = eng.make_chunk_step(store, chunk)

    n = store.n_reads
    superread = (superread_init.copy() if superread_init is not None
                 else np.zeros(n + 1, np.int64))
    cont_lines = []
    marked = np.zeros(n + (-n) % n_dev, np.int32)
    fidx = store.file_index
    parts = {name: [] for name in _COLUMNS}
    fallback = {}          # the fallback's packed rows, made at first use
    stats = stats if stats is not None else {}
    stats.setdefault("fallback_chunks", 0)
    stats.setdefault("chunks", 0)
    profile = profile if profile is not None else {}
    profile.update(hit_cap=hit_cap, chunk=chunk, route_cap=route_cap)

    def emit(r1, j, r2, orient, typ, edge_ok, cont_ok):
        """Append one chunk's rows in relation order."""
        order = relation_order(r1.astype(np.int64) * store.max_len + j,
                               fidx[r2], typ)
        for name, col in (("r1", r1), ("j", j), ("r2", r2),
                          ("orient", orient), ("typ", typ),
                          ("edge_ok", edge_ok), ("cont_ok", cont_ok)):
            parts[name].append(col[order].astype(_COLUMNS[name],
                                                 copy=False))

    def take(s, e, got):
        """Put chunk [s, e)'s pulled rows (None: re-run it) in relation
        order; with `prune`, advance the order-exact containment replay
        over its cont rows."""
        if got is None:
            # a cap was exceeded in this chunk: recompute it exactly, codes
            # made for its windows alone
            with stage("fallback"):
                stats["fallback_chunks"] += 1
                count("dist.fallback_chunks")
                if "packed_all" not in fallback:
                    fallback["packed_all"] = make_packed_all(
                        store.packed, store.packed_rc, mesh.devices[0])
                read, j = chunk_windows(woff, s, e)
                rows = _chunk_fallback(
                    store, table, read, j, window_codes_at(store, read, j, k),
                    device=mesh.devices[0],
                    packed_all=fallback["packed_all"])
            with stage("order"):
                emit(*(rows[name] for name in ("r1", "j", "r2", "orient",
                                               "typ", "edge_ok", "cont_ok")))
        else:
            with stage("order"):
                r1, j, r2, code = got.T
                emit(r1, j, r2, code & 3, (code >> 2) & 1, (code & 8) != 0,
                     (code & 16) != 0)
        if prune:
            with stage("replay"):
                cc = parts["cont_ok"][-1]
                replay.containment_step(
                    superread, cont_lines, store, k, parts["r1"][-1][cc],
                    parts["j"][-1][cc], parts["r2"][-1][cc],
                    parts["orient"][-1][cc])

    # 1-deep pipeline: chunk i's rows are pulled (the wait for the devices)
    # before chunk i+1 is enqueued, and taken on the host while the devices
    # run chunk i+1; the marks chunk i+1 sees lag by that one chunk, which
    # is safe (a late mark only means less pruning)
    pending = None
    for s in range(0, q, chunk):
        e = min(s + chunk, q)
        with stage("marked"):
            np.not_equal(superread[1:n + 1], 0, out=marked[:n],
                         casting="unsafe")
        if pending is not None:
            with stage("pull"):
                got = _pull(mesh, *pending[2])
        with stage("windows"):
            inputs = windows(s, e)
        with stage("step"):
            out = run(inputs, marked)
            compacted = compact(inputs[0], inputs[1], out)
            del out
        stats["chunks"] += 1
        count("dist.chunks")
        if pending is not None:
            take(*pending[:2], got)
        pending = (s, e, compacted)
    if pending is not None:
        with stage("pull"):
            got = _pull(mesh, *pending[2])
        take(*pending[:2], got)

    # one column at a time, each column's parts freed once it is joined
    with stage("join"):
        rows = {name: (np.concatenate(parts.pop(name)) if parts[name]
                       else np.zeros(0, dtype))
                for name, dtype in _COLUMNS.items()}
        rel = OverlapRelation(**rows, k=k, stats=dict(stats))
    after = RECORDER.totals()
    secs = profile.setdefault("host_s", dict.fromkeys(HOST_STAGES, 0.0))
    for name in HOST_STAGES:
        key = "dist." + name
        secs[name] += (after.get(key, (0, 0.0))[1]
                       - before.get(key, (0, 0.0))[1])
    return rel, superread, cont_lines


def sharded_relation(store: ReadStore, table: FingerprintTable, mesh: Mesh,
                     route_cap: Optional[int] = None,
                     budget: int = 1 << 25,
                     dist_mem: bool = False,
                     stats: Optional[dict] = None,
                     hit_cap: Optional[int] = None,
                     profile: Optional[dict] = None) -> OverlapRelation:
    """The verified overlap relation on the mesh.

    Queries run in chunks of a fixed size a superstep, so device memory
    stays bounded (grids of about `budget` words a mesh, whatever the data
    size); every chunk reuses one step (the reference's analog is its
    memory-bounded parGraph chunking, src/BuildGraph/src/
    OverlapGraph.cpp:67-81).  dist_mem=True partitions the packed read
    payload over the shards (DistMemOverlapEngine, the buildG-MPIRMA
    equivalent); False replicates it (buildG-MPI).  `stats` counts chunks
    and fallback_chunks; `hit_cap` defaults to the largest key bucket
    (`chunk_plan`); `profile` receives the chunk plan and the host's
    seconds by stage (`_relation`)."""
    rel, _, _ = _relation(store, table, mesh, route_cap=route_cap,
                          budget=budget, dist_mem=dist_mem, prune=False,
                          stats=stats, hit_cap=hit_cap, profile=profile)
    return rel


def sharded_relation_pruned(store: ReadStore, table: FingerprintTable,
                            mesh: Mesh,
                            route_cap: Optional[int] = None,
                            budget: int = 1 << 25,
                            dist_mem: bool = False,
                            superread_init: Optional[np.ndarray] = None,
                            stats: Optional[dict] = None,
                            hit_cap: Optional[int] = None,
                            profile: Optional[dict] = None):
    """The chunked sharded relation with in-loop containment marking: after
    each superstep the host advances the order-exact containment replay and
    feeds the contained-read mask into later supersteps, whose gathered
    union prunes candidates touching contained reads before verification
    (and, in dist-mem mode, before the payload fetch): the synchronous
    equivalent of Disco's superReadID gossip work pruning (reference:
    src/BuildGraphMPI/src/OverlapGraph.cpp:537-633,
    src/BuildGraph/src/OverlapGraph.cpp:435-436).

    The marks lag by the dispatch pipeline (one chunk stays pending), which
    is safe: a late mark only means less pruning, and pruned rows are rows
    the replays skip.  Returns (relation, superread, cont_lines); the
    relation omits pruned rows, so it is not row-comparable to the
    unpruned one, but every file derived from it is byte-identical.
    `stats`, `hit_cap` and `profile` as for `sharded_relation`."""
    return _relation(store, table, mesh, route_cap=route_cap,
                     budget=budget, dist_mem=dist_mem, prune=True,
                     superread_init=superread_init, stats=stats,
                     hit_cap=hit_cap, profile=profile)


def run_buildg_sharded(paired_files: Sequence[str],
                       single_files: Sequence[str], prefix: str,
                       mesh: Union[Mesh, int], min_overlap: int = 30,
                       write_par_graph_size: int = 1000,
                       dist_mem: bool = False,
                       budget: int = 1 << 25,
                       route_cap: Optional[int] = None,
                       stats: Optional[dict] = None, device=None):
    """Distributed buildG: the outputs of buildg.pipeline.run_buildg, with
    the overlap phase run over the mesh.  `mesh` is a Mesh or a shard
    count; a count is laid out by `make_mesh(n, device)`: over the CUDA
    cards (raising without one) unless the caller names a device ("cpu" in
    the tests).  dist_mem selects the partitioned-payload engine
    (buildG-MPIRMA, the CLI's -rma).  Returns (store, relation, superread),
    or Nones when the checkpoint says the graph is complete."""
    if not isinstance(mesh, Mesh):
        mesh = make_mesh(mesh, device)
    ccr_done, gc_done = read_checkpoint_info(prefix)
    if gc_done:
        return None, None, None
    with clock("readDataset"):
        store = ReadStore.from_files(paired_files, single_files, min_overlap,
                                     id_map_path=prefix + "_ReadIDMap.txt")
    with clock("insertDataset"):
        table = FingerprintTable.build(store, min_overlap - 1,
                                       device=mesh.devices[0])

    cont_path = prefix + "_0_containedReads.txt"
    superread_init = None
    if ccr_done and os.path.exists(cont_path):
        # resume: seed the in-loop pruning mask with the completed
        # contained-read phase (the reference rebroadcasts the bitmap on
        # restart, src/BuildGraphMPI/src/OverlapGraph.cpp:448-509)
        superread_init = load_contained_reads(cont_path, store)
    with clock("overlapRelation"):
        rel, superread, cont_lines = sharded_relation_pruned(
            store, table, mesh, dist_mem=dist_mem, budget=budget,
            route_cap=route_cap, superread_init=superread_init, stats=stats)
    if superread_init is None:
        with open(cont_path, "w") as f:
            for ln in cont_lines:
                f.write(ln + "\n")
        with open(prefix + "_CheckpointInfo.txt", "w") as f:
            f.write("CCR=Complete\n")

    # incremental parGraph restart, run_buildg's protocol
    # (reference: OverlapGraph.cpp:123-211)
    par_path = prefix + "_0_parGraph.txt"
    sr_path = prefix + "_0_startRead.txt"
    start_read = 1
    premarked = None
    mode = "wb"
    if os.path.exists(par_path) and os.path.getsize(par_path) > 0:
        premarked = replay.load_partial_marks(par_path, store)
        start_read = replay.read_start_read(sr_path)
        mode = "ab"
    with clock("buildOverlapGraphFromHashTable"):
        par_blob, start_blob, _ = replay.build_graph_replay_native(
            rel, store, superread, write_par_graph_size,
            start_read=start_read, premarked=premarked)
    with open(par_path, mode) as f:
        f.write(par_blob)
    with open(sr_path, "wb") as f:
        f.write(start_blob)
    with open(prefix + "_CheckpointInfo.txt", "a") as f:
        f.write("GC=Complete\n")
    return store, rel, superread
