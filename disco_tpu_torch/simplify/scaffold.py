"""Mate-pair edge merging + scaffolding.

Bit-parity port of the reference's scaffolding phase
(src/SimplifyGraph/src/OverlapGraph.cpp):
- calculateMeanAndSdOfInnerDistance  :3308-3421
- findSupportByMatepairsAndMerge     :2684-2886
- findPathBetweenMatepairs           :2896-3021
- exploreGraph                       :3034-3134
- scaffolder                         :3138-3222
- getListOfFeasibleEdges             :3229-3303
- checkForScaffold                   :3423-3506
- merge2Edges                        :2658-2678
- mergeEdgesDisconnected             :3528-3628

Single-thread semantics (parity mode).
"""
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..native import stdsort_permutation
from .core import Edge, Rope, add_edges, free_pair, twin_orient
from .engine import FullGraph, match_edge_type
from .params import EXPLORE_DEPTH, INSERT_SIZE_RANGE_SD, LOOP_LIMIT, \
    MAX_INNER_DIST_TRESH


def _edge_read_offset(e: Edge, idx: int) -> int:
    """Offset of the read at inner index `idx` from the edge source
    (reference's "little dance": getInnerOverlapSum(0, idx+1) unless last,
    then sum over all; OverlapGraph.cpp:3347-3359)."""
    if idx < e.inner.n - 1:
        return e.inner.offset_sum(0, idx + 1)
    return e.inner.offset_sum(0, e.inner.n)


def _iter_ints(a, chunk: int = 1 << 17):
    """Iterate a numpy index array as Python ints with bounded transient
    boxing (a whole-array tolist holds millions of int objects at once)."""
    for s in range(0, len(a), chunk):
        yield from a[s:s + chunk].tolist()


# ---------------------------------------------------------------------------
# insert-size estimation
# ---------------------------------------------------------------------------
def calculate_mean_sd_inner_distance(graph: FullGraph) -> None:
    d = graph.d
    longest = 0
    # per-edge cumulative link offsets: _edge_read_offset(e, idx) ==
    # cumsum(inner offsets)[idx] for every idx (the reference's "little
    # dance" last-index special case sums to the same value), so one
    # cached prefix scan replaces a rope walk per (pair, location)
    offs_cache: dict = {}

    def edge_offsets(e):
        a = offs_cache.get(id(e))
        if a is None:
            a = []
            t = 0
            for (_r, _o, off) in e.inner:
                t += off
                a.append(t)
            offs_cache[id(e)] = a
        return a

    ma = d.mate_array()
    bwd_cache: dict = {}

    def bwd(r2):
        lst = bwd_cache.get(r2)
        if lst is None:
            bwd_cache[r2] = lst = d.bwd_edges(r2)
        return lst

    for ds in d.datasets:
        if ds.is_paired:
            dists: List[int] = []
            locs = d.edge_locs
            con = d.con_reads
            head = locs.nat.head
            reg = (np.flatnonzero(head[ds.r1_start:ds.r1_end + 1] >= 0)
                   + ds.r1_start)  # skip unregistered reads in bulk
            for i in _iter_ints(reg):
                # mate_pair_list via the cached vectorized mate array
                # (identical semantics incl. contained-mate quirks)
                m = ma[i]
                mp = [m] if m else []
                cl = con[i]
                if cl:
                    for (cid, _s, _o) in cl:
                        cm = ma[cid]
                        if cm:
                            mp.append(cm)
                l1 = None  # computed lazily, invariant over the mate loop
                for r2 in mp:
                    if not locs[r2]:
                        continue  # bwd_edges(r2) empty -> no pairs
                    if d.dataset_number(r2) != ds.number:
                        continue
                    if l1 is None:
                        l1 = d.fwd_edges(i)
                        rl1 = d.read_len(i)
                    if not l1:
                        break
                    l2 = bwd(r2)
                    for (e1, i1) in l1:
                        o1 = edge_offsets(e1)
                        for (e2, i2) in l2:
                            if e1 is not e2:
                                continue
                            mp_dist = o1[i2] - (o1[i1] + rl1)
                            if 0 < mp_dist < MAX_INNER_DIST_TRESH:
                                dists.append(mp_dist)
        else:
            dists = []
        if not dists:
            ds.avg_inner_distance = 0.0
            ds.avg_inner_distance_sd = 0.0
            continue
        mean = sum(dists) / len(dists)
        ds.avg_inner_distance = mean
        var = 0.0
        for v in dists:
            var += (mean - v) * (mean - v)
        ds.avg_inner_distance_sd = math.sqrt(var / len(dists))
        if longest < mean:
            longest = int(mean)  # UINT64 member: C++ truncation
    graph.longest_mean_insert = longest


# ---------------------------------------------------------------------------
# path exploration
# ---------------------------------------------------------------------------
class _Explore:
    __slots__ = ("graph", "mean", "sd", "first_path", "flags", "path_found",
                 "edges", "lens", "last_edge", "dist_last")

    def __init__(self, graph: FullGraph, mean: float, sd: float):
        self.graph = graph
        self.mean = mean
        self.sd = sd
        self.first_path: List[Edge] = []
        self.flags: List[int] = []
        self.path_found = 0
        self.edges: List[Edge] = []
        self.lens: List[int] = []

    def run(self, first_edge: Edge, last_edge: Edge, dist_first: int,
            dist_last: int) -> None:
        self.path_found = 0
        self.first_path = []
        self.flags = []
        self.edges = []
        self.lens = []
        self.last_edge = last_edge
        self.dist_last = dist_last
        self._go(first_edge, dist_first, 0)

    def _go(self, edge: Edge, dist_on_edge: int, level: int) -> None:
        if level > 0:
            del self.edges[level:]
            del self.lens[level:]
        if level > EXPLORE_DEPTH:
            return
        lo = self.mean - INSERT_SIZE_RANGE_SD * self.sd
        hi = self.mean + INSERT_SIZE_RANGE_SD * self.sd
        if level == 0:
            self.edges.append(edge)
            self.lens.append(dist_on_edge)
        else:
            if edge is self.last_edge:
                plen = self.dist_last + self.lens[level - 1]
                if lo <= plen <= hi:
                    self.edges.append(edge)
                    self.lens.append(plen)
                    self.path_found += 1
                    if self.path_found == 1:
                        self.first_path = list(self.edges)
                        self.flags = [1] * (len(self.edges) - 1)
                    else:
                        fp, ed = self.first_path, self.edges
                        for i in range(len(fp) - 1):
                            ok = False
                            for j in range(len(ed) - 1):
                                if fp[i] is ed[j] and fp[i + 1] is ed[j + 1]:
                                    ok = True
                                    break
                            if not ok:
                                self.flags[i] = 0
                    return
                else:
                    self.edges.append(edge)
                    self.lens.append(dist_on_edge + self.lens[level - 1])
            else:
                self.edges.append(edge)
                self.lens.append(dist_on_edge + self.lens[level - 1])
        lst = self.graph.g.get(edge.dst)
        if lst is not None:
            cur_len = self.lens[level]
            for nxt in list(lst):
                if match_edge_type(edge, nxt) and cur_len < hi:
                    self._go(nxt, nxt.offset, level + 1)


def find_path_between_matepairs(graph: FullGraph, r1: int, r2: int,
                                ds_number: int,
                                copy_path: List[Edge],
                                copy_flags: List[int]) -> bool:
    """reference: findPathBetweenMatepairs (:2896-3021).  orient is always 2
    (illumina FR)."""
    d = graph.d
    info = d.datasets[ds_number]
    list1 = d.fwd_edges(r1)
    list2 = d.bwd_edges(r2)
    if not list1 or not list2:
        return False
    for (e1, _i) in list1:
        for (e2, _j) in list2:
            if e1 is e2 or e1 is e2.twin:
                return False
    ex = _Explore(graph, info.avg_inner_distance, info.avg_inner_distance_sd)
    hi = (info.avg_inner_distance
          + INSERT_SIZE_RANGE_SD * info.avg_inner_distance_sd)
    for (e1, i1) in list1:
        for (e2, i2) in list2:
            if e1 is e2 or e1 is e2.twin:
                continue
            r1_off = _edge_read_offset(e1, i1)
            r2_off = _edge_read_offset(e2, i2)
            dist_first = e1.offset - r1_off - d.read_len(r1)
            dist_last = r2_off
            if dist_first + dist_last < hi:
                ex.run(e1, e2, dist_first, dist_last)
                if ex.path_found > 0:
                    if not copy_path:
                        copy_path.extend(ex.first_path)
                        copy_flags.extend(ex.flags)
                    else:
                        for k in range(len(copy_path) - 1):
                            ok = False
                            for l in range(len(ex.first_path) - 1):
                                if (copy_path[k] is ex.first_path[l]
                                        and copy_path[k + 1]
                                        is ex.first_path[l + 1]
                                        and ex.flags[l] == 1):
                                    ok = True
                                    break
                            if not ok:
                                copy_flags[k] = 0
    return True


# ---------------------------------------------------------------------------
# merge2Edges (reference :2658-2678)
# ---------------------------------------------------------------------------
def merge2edges(graph: FullGraph, e1: Edge, e2: Edge) -> None:
    new_edge = add_edges(graph.alloc, e1, e2)
    flow = min(e1.flow, e2.flow) & 0xFFFF  # UINT16 truncation in reference
    new_edge.flow = flow
    new_edge.twin.flow = flow
    graph.insert_edge(new_edge)
    e1.flow -= flow
    e1.twin.flow = e1.flow
    e2.flow -= flow
    e2.twin.flow = e2.flow
    if e2 is not e1.twin and (e2.flow == 0 or flow == 0):
        graph.remove_edge(e2)
    if e1.flow == 0 or flow == 0:
        graph.remove_edge(e1)


# ---------------------------------------------------------------------------
# findSupportByMatepairsAndMerge (reference :2684-2886)
# ---------------------------------------------------------------------------
class _PairSupport:
    __slots__ = ("e1", "e2", "support", "distance", "freed")

    def __init__(self, e1: Edge, e2: Edge, support: int = 1,
                 distance: int = 0):
        self.e1 = e1
        self.e2 = e2
        self.support = support
        self.distance = distance
        self.freed = False


def find_support_and_merge(graph: FullGraph) -> int:
    d, p = graph.d, graph.p
    local: List[_PairSupport] = []
    for i in range(1, d.size() + 1):
        for r2 in d.mate_pair_list(i):
            if i > r2:
                continue
            copy_path: List[Edge] = []
            copy_flags: List[int] = []
            find_path_between_matepairs(graph, i, r2, d.dataset_number(r2),
                                        copy_path, copy_flags)
            if len(copy_path) > 1:
                for k in range(len(copy_flags)):
                    if copy_flags[k] != 1:
                        continue
                    for ps in local:
                        if (ps.e1 is copy_path[k]
                                and ps.e2 is copy_path[k + 1]):
                            ps.support += 1
                            break
                        if (ps.e2.twin is copy_path[k]
                                and ps.e1.twin is copy_path[k + 1]):
                            ps.support += 1
                            break
                    else:
                        ek, ek1 = copy_path[k], copy_path[k + 1]
                        if (ek.src != ek.dst or ek1.src != ek1.dst):
                            local.append(_PairSupport(ek, ek1))

    # single-thread final merge pass (reference :2783-2829): thread 0 keeps
    # pairs whose shared node id is in [1, size) — note the STRICT upper
    # bound excludes the last read id
    final: List[_PairSupport] = []
    end_index = d.size()
    for ps in local:
        com = ps.e1.dst
        if not (1 <= com < end_index):
            continue
        for fs in final:
            if fs.e1 is ps.e1 and fs.e2 is ps.e2:
                fs.support += ps.support
                break
            if fs.e2.twin is ps.e1 and fs.e1.twin is ps.e2:
                fs.support += ps.support
                break
        else:
            final.append(ps)

    return _merge_supported(graph, final, connected=True)


def _merge_supported(graph: FullGraph, pairs: List[_PairSupport],
                     connected: bool) -> int:
    p = graph.p
    if pairs:
        keys = np.fromiter((ps.support for ps in pairs), np.int64,
                           len(pairs))
        perm = stdsort_permutation(keys, descending=True)
        pairs = [pairs[i] for i in perm]
    merged = 0
    for i, ps in enumerate(pairs):
        if (not ps.freed and ps.support >= p.min_uniq_support
                and ps.e1.edge_length() >= p.min_size_short_branch
                and ps.e2.edge_length() >= p.min_size_short_branch):
            merged += 1
            e1f, e1r = ps.e1, ps.e1.twin
            e2f, e2r = ps.e2, ps.e2.twin
            if connected:
                merge2edges(graph, ps.e1, ps.e2)
            else:
                merge_edges_disconnected(graph, ps.e1, ps.e2, ps.distance)
            for j in range(i + 1, len(pairs)):
                q = pairs[j]
                if q.e1 in (e1f, e1r, e2f, e2r):
                    q.freed = True
                if q.e2 in (e1f, e1r, e2f, e2r):
                    q.freed = True
    return merged


# ---------------------------------------------------------------------------
# scaffolder (reference :3138-3222)
# ---------------------------------------------------------------------------
def scaffolder(graph: FullGraph) -> int:
    d = graph.d
    composites: List[Edge] = []
    for i in range(1, d.size() + 1):
        lst = graph.g.get(i)
        if not lst:
            continue
        for e in lst:
            if e.inner.n and e.last_offset() != 0:
                composites.append(e)
    pairs: List[_PairSupport] = []
    for e1 in composites:
        for e2 in _feasible_edges(graph, e1):
            support, gap = _check_for_scaffold(graph, e1, e2)
            if support > 0:
                pairs.append(_PairSupport(e1, e2, support, gap))
    return _merge_supported(graph, pairs, connected=False)


def _feasible_edges(graph: FullGraph, edge: Edge) -> List[Edge]:
    """reference: getListOfFeasibleEdges (:3229-3303)."""
    d = graph.d
    r_edge = edge.twin
    out: List[Edge] = []
    dist = 0
    for i in range(r_edge.inner.n):
        (mp1, _o, off) = r_edge.inner[i]
        dist += off
        if dist > 2 * graph.longest_mean_insert:
            break
        if len(d.fwd_edges(mp1)) != 1:
            continue
        for mp2 in d.mate_pair_list(mp1):
            lst = d.bwd_edges(mp2)
            if (not lst or len(lst) > 1 or lst[0][0] is edge
                    or lst[0][0] is edge.twin):
                continue
            r2_off = _edge_read_offset(lst[0][0], lst[0][1])
            if r2_off > 2 * graph.longest_mean_insert:
                continue
            if all(x is not lst[0][0] for x in out):
                out.append(lst[0][0])
    return out


def _check_for_scaffold(graph: FullGraph, edge1: Edge,
                        edge2: Edge) -> Tuple[int, int]:
    """reference: checkForScaffold (:3423-3506)."""
    d = graph.d
    r_edge1 = edge1.twin
    support = 0
    oppose = 0
    avg_gap = 0
    reads: List[int] = []
    dist = 0
    for i in range(r_edge1.inner.n):
        (rid, _o, off) = r_edge1.inner[i]
        dist += off
        if dist > 2 * graph.longest_mean_insert:
            break
        reads.append(rid)
    for r1 in reads:
        for r2 in d.mate_pair_list(r1):
            ds = d.dataset_number(r2)
            info = d.datasets[ds]
            l1 = d.bwd_edges(r1)
            l2 = d.bwd_edges(r2)
            if len(l1) != 1 or len(l2) != 1:
                continue
            r1_off = _edge_read_offset(l1[0][0], l1[0][1])
            r2_off = _edge_read_offset(l2[0][0], l2[0][1])
            hi = (info.avg_inner_distance
                  + INSERT_SIZE_RANGE_SD * info.avg_inner_distance_sd)
            if (l1[0][0] is edge1.twin and l2[0][0] is edge2
                    and (r1_off + r2_off) < hi):
                dd = r1_off + r2_off
                if l1[0][0] is l2[0][0] or l1[0][0] is l2[0][0].twin:
                    continue
                avg_gap += int(info.avg_inner_distance - dd)
                support += 1
            else:
                oppose += 1
    if support:
        # INT64 division truncates toward zero
        q = abs(avg_gap) // support
        avg_gap = -q if avg_gap < 0 else q
    return support - oppose, avg_gap


# ---------------------------------------------------------------------------
# disconnected merge (reference :3528-3628, mergeListDisconnected :3640-3684,
# mergedEdgeOrientationDisconnected :3692-3709)
# ---------------------------------------------------------------------------
def _merged_orient_disconnected(e1: Edge, e2: Edge) -> int:
    o1, o2 = e1.orient, e2.orient
    if o1 in (0, 1) and o2 in (0, 2):
        return 0
    if o1 in (0, 1) and o2 in (1, 3):
        return 1
    if o1 in (2, 3) and o2 in (0, 2):
        return 2
    if o1 in (2, 3) and o2 in (1, 3):
        return 3
    raise ValueError("unable to merge")


def _merge_list_disconnected(d, e1: Edge, e2: Edge,
                             overlap_offset: int) -> Tuple[Rope, int]:
    s = e1.inner_sum
    ori1 = 1 if e1.orient in (1, 3) else 0
    ori2 = 1 if e2.orient in (2, 3) else 0
    # O(1) rope concat (no flattening into tuples — scaffold merges chain
    # the biggest inner lists in the whole run)
    mid = Rope.of([(e1.dst, ori1, e1.offset - s),
                   (e2.src, ori2, overlap_offset)])
    rope = e1.inner.concat(mid).concat(e2.inner)
    inner_sum = e1.offset + overlap_offset + e2.inner_sum
    return rope, inner_sum


def merge_edges_disconnected(graph: FullGraph, e1: Edge, e2: Edge,
                             gap: int) -> bool:
    d = graph.d
    if e1.dst == e2.src and match_edge_type(e1, e2):
        merge2edges(graph, e1, e2)
        return True
    orient_f = _merged_orient_disconnected(e1, e2)
    orient_r = twin_orient(orient_f)
    if gap > 0:
        off1 = e1.dst_len + gap
        off2 = e2.src_len + gap
    else:
        off1 = e1.dst_len + 10
        off2 = e2.src_len + 10

    rope_f, sum_f = _merge_list_disconnected(d, e1, e2, off1)
    fwd = Edge(graph.alloc, e1.src, e1.src_len, e2.dst, e2.dst_len, orient_f,
               e1.offset + e2.offset + off1, inner=rope_f, inner_sum=sum_f)
    rope_r, sum_r = _merge_list_disconnected(d, e2.twin, e1.twin, off2)
    rev_off = e1.twin.offset + e2.twin.offset + off2
    rev = Edge(graph.alloc, e2.dst, e2.dst_len, e1.src, e1.src_len, orient_r,
               rev_off, inner=rope_r, inner_sum=sum_r)
    fwd.twin = rev
    rev.twin = fwd
    flow = min(e1.flow, e2.flow) & 0xFFFF
    fwd.flow = flow
    rev.flow = flow
    graph.insert_edge(fwd)
    e1.flow -= flow
    e1.twin.flow -= flow
    e2.flow -= flow
    e2.twin.flow -= flow
    if e2 is not e1.twin and (e2.flow == 0 or flow == 0):
        graph.remove_edge(e2)
    if e1.flow == 0 or flow == 0:
        graph.remove_edge(e1)
    return True


# ---------------------------------------------------------------------------
# full scaffold phase (reference: main.cpp:229-256)
# ---------------------------------------------------------------------------
def scaffold_phase(graph: FullGraph) -> None:
    calculate_mean_sd_inner_distance(graph)
    iteration = 0
    while True:
        iteration += 1
        counter = find_support_and_merge(graph)
        graph.simplify_scaffold_graph()
        if not (counter > 0 and iteration < LOOP_LIMIT):
            break
    iteration = 0
    while True:
        iteration += 1
        counter = scaffolder(graph)
        graph.simplify_scaffold_graph()
        if not (counter > 0 and iteration < LOOP_LIMIT):
            break
