"""Parity replay of the reference's graph-construction traversal (host
copy of disco_tpu/buildg/replay.py).  The traversal runs in
native/port/replay.cpp, laid out for the host's caches;
native/src/replay.cpp (the JAX package's) and `build_graph_replay`, its
single-threaded Python oracle, are what the tests hold it to.

The heavy work — verifying every candidate overlap — is done order-free
(disco_tpu_torch.overlap). What remains order-DEPENDENT in the reference is
cheap bookkeeping:

- containment marking is first-superread-wins in scan order
  (reference: src/BuildGraph/src/OverlapGraph.cpp:390-481);
- edge insertion caps 4 edges per k-mer window in bucket order and dedupes
  (read1,read2) pairs first-wins (reference: OverlapGraph.cpp:645-670);
- the BFS chunked traversal + Myers transitive reduction + the parGraph
  writer's twin-deletion side effects determine file order
  (reference: OverlapGraph.cpp:195-325,687-761,790-907).

This module replays those sequential rules exactly over the precomputed
relation, producing outputs bit-identical to a single-threaded reference run
(parity is only defined for -t 1, see SURVEY.md §4). Replay cost is
O(|relation|), with no string compares.
"""
from collections import deque
from typing import List, Tuple

import numpy as np

from ..io.readstore import ReadStore
from ..native import stdsort_permutation
from ..overlap.relation import OverlapRelation
from ..utils.logging import count, span

# hit orientation -> edge orientation (reference: OverlapGraph.cpp:660-666)
_EDGE_ORIENT = (3, 0, 2, 1)
# twin orientation (reference: OverlapGraph.cpp:770-784)
_TWIN_ORIENT = (3, 1, 2, 0)

# node states (reference: OverlapGraph.h nodeType)
_EXPLORED = 0
_MARKED = 1          # EXPLORED_AND_TRANSITIVE_EDGES_MARKED
_REMOVED = 2         # EXPLORED_AND_TRANSITIVE_EDGES_REMOVED
_WRITTEN = 3         # EXPLORED_AND_TRANSITIVE_EDGES_WRITTEN

MAX_EDGE_PER_KMER = 4  # reference: src/BuildGraph/src/Common.h:62


def _overlap_len(orient: int, j: int, len1: int, k: int) -> int:
    if orient in (0, 2):
        return len1 - j
    return k + j


# --------------------------------------------------------------------------
# containment replay
# --------------------------------------------------------------------------
def containment_replay(rel: OverlapRelation, store: ReadStore
                       ) -> Tuple[np.ndarray, List[str]]:
    """Returns (superread, lines): superread[i] (0-based index, value 1-based
    containing read ID or 0) and the _containedReads.txt lines in reference
    order (single thread)."""
    n = store.n_reads
    superread = np.zeros(n + 1, np.int64)  # 1-based
    lines: List[str] = []
    mask = rel.cont_ok
    containment_step(superread, lines, store, rel.k, rel.r1[mask],
                     rel.j[mask], rel.r2[mask], rel.orient[mask])
    return superread, lines


def containment_step(superread: np.ndarray, lines: List[str],
                     store: ReadStore, k: int, r1, j, r2, orient) -> None:
    """Incremental containment marking over one batch of cont_ok rows (in
    relation order), updating `superread`/`lines` in place (run_buildg's
    two-pass protocol feeds it the native containment-only pass)."""
    lens = store.lengths
    fidx = store.file_index
    r1s = np.asarray(r1) + 1
    js = np.asarray(j)
    r2s = np.asarray(r2) + 1
    orients = np.asarray(orient)

    for i1, j, i2, ho in zip(r1s.tolist(), js.tolist(), r2s.tolist(),
                             orients.tolist()):
        if superread[i1] != 0:
            continue
        if superread[i2] != 0:
            continue
        len1 = int(lens[i1 - 1])
        len2 = int(lens[i2 - 1])
        orientation = _EDGE_ORIENT[ho]
        ovl = _overlap_len(ho, j, len1, k)
        if len1 > len2:
            superread[i2] = i1
        elif len1 == len2 and i1 < i2:
            superread[i2] = i1
        else:
            continue
        # decuple format (reference: OverlapGraph.cpp:438-447, OUTPUT.md:10-33)
        lines.append(
            f"{fidx[i2-1]}\t{fidx[i1-1]}\t{orientation},{len2},0,0,"
            f"{len2},0,{len2},{len1},{len1-ovl},{len1-ovl+len2}")


# --------------------------------------------------------------------------
# graph replay
# --------------------------------------------------------------------------
class _Edge:
    __slots__ = ("src", "dst", "orient", "offset", "twin", "trans")

    def __init__(self, src, dst, orient, offset):
        self.src = src
        self.dst = dst
        self.orient = orient
        self.offset = offset
        self.twin = None
        self.trans = False


def _edge_hit_groups(rel: OverlapRelation, store: ReadStore,
                     superread: np.ndarray):
    """Edge-eligible hits (both endpoints uncontained) grouped by r1."""
    n = store.n_reads
    mask = rel.edge_ok & (superread[rel.r1 + 1] == 0) \
        & (superread[rel.r2 + 1] == 0)
    er1 = rel.r1[mask] + 1
    starts = np.searchsorted(er1, np.arange(1, n + 2))
    return starts, rel.j[mask], rel.r2[mask] + 1, rel.orient[mask]


def load_partial_marks(par_path: str, store: ReadStore) -> np.ndarray:
    """Rebuild the marked-read bitmap from an existing partial
    _parGraph.txt: each record's trailing markFlag says which endpoints the
    writing thread had marked (0=source, 1=dest, 2=both); file indices map
    back to read IDs, unknown indices are skipped
    (reference: src/BuildGraph/src/OverlapGraph.cpp:123-176)."""
    rid_of_fidx = {int(f): i + 1 for i, f in enumerate(store.file_index)}
    marked = np.zeros(store.n_reads + 1, np.uint8)
    with open(par_path) as f:
        for line in f:
            toks = line.rstrip("\n").split("\t")
            if len(toks) < 3:
                continue
            src = rid_of_fidx.get(int(toks[0]))
            dst = rid_of_fidx.get(int(toks[1]))
            if src is None or dst is None:
                continue
            flag = int(toks[2].rsplit(",", 1)[1])
            if flag == 0:
                marked[src] = 1
            elif flag == 1:
                marked[dst] = 1
            else:
                marked[src] = 1
                marked[dst] = 1
    return marked


def read_start_read(sr_path: str) -> int:
    """Last line of _startRead.txt = the BFS resume point
    (reference: OverlapGraph.cpp:178-192); 1 if blank/missing."""
    last = ""
    try:
        with open(sr_path) as f:
            for line in f:
                if line.strip():
                    last = line.strip()
    except OSError:
        return 1
    return int(last) if last else 1


def graph_replay_from_groups(store: ReadStore, k: int, starts, ej, er2, eo,
                             superread: np.ndarray,
                             write_par_graph_size: int = 1000,
                             start_read: int = 1,
                             premarked: "np.ndarray | None" = None):
    """Run the native traversal replay over pre-grouped edge-eligible hits
    (group of 1-based read r = [starts[r-1], starts[r]); er2 1-based).
    Returns (par_blob, start_blob, chunk_ends).  The walk is the span
    replay.traverse, the text replay.format; the counters replay.rows,
    .inserts, .edges and .lines count their work."""
    from .. import native
    n = store.n_reads
    with span("replay.traverse"):
        all_marked = (superread[:n + 1] != 0).astype(np.uint8)
        if premarked is not None:
            all_marked |= premarked
        all_marked[0] = 1
        walk = native.replay_walk(n, k, write_par_graph_size, starts, ej,
                                  er2, eo, store.lengths, all_marked,
                                  start_read=start_read)
        count("replay.rows", int(starts[n]))
        count("replay.inserts", walk.inserts)
        count("replay.edges", walk.edges)
        count("replay.lines", walk.lines)
    with span("replay.format"):
        return walk.text(store.file_index, store.lengths)


def build_graph_replay_native(rel: OverlapRelation, store: ReadStore,
                              superread: np.ndarray,
                              write_par_graph_size: int = 1000,
                              start_read: int = 1,
                              premarked: "np.ndarray | None" = None):
    """Native (C++) replay of the reference's traversal
    (`build_graph_replay` is its Python oracle).  Returns (par_blob,
    start_blob, chunk_ends): the parGraph content (from `start_read` on,
    for appending on restart), the _startRead.txt content, and the valid
    kill offsets."""
    from .. import native
    n = store.n_reads
    with span("replay.groups"):
        contained = (superread[:n + 1] != 0).astype(np.uint8)
        starts, ej, er2, eo = native.edge_hit_groups(
            rel.r1, rel.j, rel.r2, rel.orient, rel.edge_ok, contained, n)
    return graph_replay_from_groups(store, rel.k, starts, ej, er2, eo,
                                    superread, write_par_graph_size,
                                    start_read=start_read,
                                    premarked=premarked)


def build_graph_replay(rel: OverlapRelation, store: ReadStore,
                       superread: np.ndarray,
                       write_par_graph_size: int = 1000) -> List[str]:
    """Replays buildOverlapGraphFromHashTable with one thread
    (reference: OverlapGraph.cpp:100-325). Returns _0_parGraph.txt lines."""
    n = store.n_reads
    lens = store.lengths
    fidx = store.file_index
    k = rel.k

    # edge-eligible hits grouped by r1, already in (j, r2, typ) order
    mask = rel.edge_ok & (superread[rel.r1 + 1] == 0) & (superread[rel.r2 + 1] == 0)
    er1 = rel.r1[mask] + 1
    ej = rel.j[mask]
    er2 = rel.r2[mask] + 1
    eo = rel.orient[mask]
    # group starts per read id
    starts = np.searchsorted(er1, np.arange(1, n + 2))
    ej_l = ej.tolist()
    er2_l = er2.tolist()
    eo_l = eo.tolist()

    all_marked = (superread[:n + 1] != 0)
    all_marked = all_marked.copy()
    all_marked[0] = True  # index 0 unused; reference scans i from prevReadID>=1

    out_lines: List[str] = []

    def insert_all_edges(r1: int, explored: dict, adj: dict):
        len1 = int(lens[r1 - 1])
        lst = adj.get(r1)
        if lst is None:
            lst = []
            adj[r1] = lst
        inserted = set()
        cur_j = -1
        ctr = 0
        for idx in range(starts[r1 - 1], starts[r1]):
            j = ej_l[idx]
            if j != cur_j:
                cur_j = j
                ctr = 0
            if ctr >= MAX_EDGE_PER_KMER:
                continue
            r2 = er2_l[idx]
            if r2 in explored:
                continue
            if r2 in inserted:
                continue
            ho = eo_l[idx]
            len2 = int(lens[r2 - 1])
            ovl = _overlap_len(ho, j, len1, k)
            orient = _EDGE_ORIENT[ho]
            offset = len1 - ovl
            e = _Edge(r1, r2, orient, offset)
            te = _Edge(r2, r1, _TWIN_ORIENT[orient], len2 + offset - len1)
            e.twin = te
            te.twin = e
            lst.append(e)
            l2 = adj.get(r2)
            if l2 is None:
                l2 = []
                adj[r2] = l2
            l2.append(te)
            inserted.add(r2)
            ctr += 1
        if lst:
            # reference: OverlapGraph.cpp:676 — std::sort by overlap offset;
            # libstdc++ introsort is NOT stable >16 elements, so replicate its
            # exact tie order via the native helper.
            perm = stdsort_permutation(
                np.asarray([ed.offset for ed in lst], np.int64))
            lst[:] = [lst[p] for p in perm]

    def mark_transitive(r: int, explored: dict, adj: dict):
        lst = adj[r]
        marked = {}
        for e in lst:
            marked.setdefault(e.dst, 0)  # 0 = INPLAY
        for e in lst:
            r2 = e.dst
            if marked[r2] == 0:
                for e2 in adj[r2]:
                    r3 = e2.dst
                    if marked.get(r3) == 0:
                        t1, t2 = e.orient, e2.orient
                        if (t1 in (0, 2) and t2 in (0, 1)) or \
                           (t1 in (1, 3) and t2 in (2, 3)):
                            marked[r3] = 1  # ELIMINATED
        for e in lst:
            if marked[e.dst] == 1:
                e.trans = True
                e.twin.trans = True

    def _delete_twin(twin: _Edge, adj: dict):
        l2 = adj[twin.src]
        for i, ed in enumerate(l2):
            if ed is twin:
                l2[i] = l2[-1]
                l2.pop()
                break

    def remove_transitive(r: int, adj: dict):
        lst = adj[r]
        for e in list(lst):
            if e.trans:
                _delete_twin(e.twin, adj)
        adj[r] = [e for e in lst if not e.trans]

    def save_par_graph(explored: dict, adj: dict):
        # std::map iteration order = ascending read id
        for rid in sorted(adj.keys()):
            lst = adj.get(rid)
            if not lst or rid not in explored:
                continue
            if explored[rid] != _REMOVED:
                continue
            idx = 0
            while idx < len(lst):
                e = lst[idx]
                idx += 1
                te = e.twin
                src, dst = e.src, e.dst
                if src < dst:
                    src_len = int(lens[src - 1])
                    ovl = src_len - e.offset
                    flag = 2 if explored.get(dst) == _REMOVED else 0
                    rec = (fidx[src - 1], fidx[dst - 1], e.orient, ovl, 0, 0,
                           src_len, e.offset, src_len - 1,
                           int(lens[dst - 1]), 0, ovl - 1, flag)
                else:
                    src_len = int(lens[dst - 1])  # twin's source = e.dst
                    ovl = src_len - te.offset
                    flag = 2 if explored.get(dst) == _REMOVED else 1
                    rec = (fidx[dst - 1], fidx[src - 1], te.orient, ovl, 0, 0,
                           src_len, te.offset, src_len - 1,
                           int(lens[src - 1]), 0, ovl - 1, flag)
                out_lines.append(
                    f"{rec[0]}\t{rec[1]}\t" +
                    ",".join(str(v) for v in rec[2:12]) + f",NA,{rec[12]}")
                # delete twin from its holder (mutates lists being visited
                # later — intentional, matches reference: OverlapGraph.cpp:869-880)
                _delete_twin(te, adj)
            del adj[rid]
            explored[rid] = _WRITTEN

    # ---- main traversal (reference: OverlapGraph.cpp:195-320, 1 thread) ----
    start = prev = 1
    while start != 0:
        explored = {}
        adj = {start: []}
        q = deque()
        q.append(start)
        written = 0
        while q and written < write_par_graph_size:
            r1 = q.popleft()
            was_marked = bool(all_marked[r1])
            if not was_marked:
                all_marked[r1] = True
            if (not was_marked) or r1 == start:
                if r1 not in explored:
                    insert_all_edges(r1, explored, adj)
                    explored[r1] = _EXPLORED
                if adj[r1]:
                    if explored[r1] == _EXPLORED:
                        i1 = 0
                        while i1 < len(adj[r1]):
                            r2 = adj[r1][i1].dst
                            i1 += 1
                            if r2 not in explored:
                                q.append(r2)
                                insert_all_edges(r2, explored, adj)
                                explored[r2] = _EXPLORED
                        mark_transitive(r1, explored, adj)
                        explored[r1] = _MARKED
                    if explored[r1] == _MARKED:
                        i1 = 0
                        while i1 < len(adj[r1]):
                            r2 = adj[r1][i1].dst
                            i1 += 1
                            if explored[r2] == _EXPLORED:
                                i2 = 0
                                while i2 < len(adj[r2]):
                                    r3 = adj[r2][i2].dst
                                    i2 += 1
                                    if r3 not in explored:
                                        q.append(r3)
                                        insert_all_edges(r3, explored, adj)
                                        explored[r3] = _EXPLORED
                                mark_transitive(r2, explored, adj)
                                explored[r2] = _MARKED
                        remove_transitive(r1, adj)
                        explored[r1] = _REMOVED
                        written += 1
        save_par_graph(explored, adj)
        start = 0
        i = prev
        while i <= n:
            if not all_marked[i]:
                start = prev = i
                all_marked[i] = True
                break
            i += 1
    return out_lines
