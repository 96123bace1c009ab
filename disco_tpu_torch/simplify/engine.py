"""fullsimplify engine: composite-graph simplification operators.

Bit-parity port of src/SimplifyGraph/src/OverlapGraph.cpp (single-thread
semantics; parity is defined against the patched oracle build, see
tools/build_reference.sh).  Each public method cites its reference lines.

Known reference quirks replicated on purpose:
- Edge::breakEdge always returns an empty vector (the inner guard at
  Edge.cpp:166 is inverted), so clipBranches/removeLowOvlEdges DELETE the
  branch rather than splitting it.
- removeLowOvlEdges mutates the vector while indexing it (j not adjusted
  after removeEdge), skipping the element shifted into position j.
- merge2Edges flow arithmetic on UINT16 (min with 0 flow keeps 0).
"""
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..native import stdsort_permutation
from .core import (Alloc, Edge, NodeMap, Rope, add_edges, copy_pair,
                   free_pair, is_mergeable_o, merged_orient, twin_orient)
from .dataset import SimplifyDataset
from .params import (EXPLORE_DEPTH, INSERT_SIZE_RANGE_SD, LOOP_LIMIT,
                     MAX_INNER_DIST_TRESH, Params)


def match_edge_type(e1: Edge, e2: Edge) -> bool:
    """reference: matchEdgeType (OverlapGraph.cpp:26-33)."""
    if e1.orient in (1, 3) and e2.orient in (2, 3):
        return True
    if e1.orient in (0, 2) and e2.orient in (0, 1):
        return True
    return False


class FullGraph:
    """OverlapGraph equivalent over a SimplifyDataset."""

    def __init__(self, dataset: SimplifyDataset, params: Params,
                 alloc: Optional[Alloc] = None):
        self.d = dataset
        self.p = params
        self.alloc = alloc or Alloc()
        self.g = NodeMap()
        self.n_nodes = 0
        self.n_edges = 0
        self.flow_computed = False
        self.longest_mean_insert = 0
        # periodic in-loop checkpointing (reference: DISK_GRAPH_UPDATE
        # snapshots inside graphPathFindInitial/simplifyGraph,
        # OverlapGraph.cpp:1183-1188,1282-1289).  The driver sets
        # checkpoint_path to <prefix>_CurrGraph_.txt; on_disk_snapshot is a
        # test hook called after each periodic snapshot (it may raise to
        # simulate a mid-phase kill).
        self.checkpoint_path: Optional[str] = None
        self.on_disk_snapshot = None

    # ------------------------------------------------------------------
    # insert / remove (reference: OverlapGraph.cpp:69-149)
    # ------------------------------------------------------------------
    def _update_read_locations(self, e: Edge, insert: bool) -> None:
        # reference: updateReadsLocations + updateEdgeInfo (:3736-3776)
        if e.inner.n:
            # leaf-wise registration: never forces a top-level columns()
            # cache on composite ropes (orient_bit 0 <=> ori&1 == 1)
            if insert:
                self.d.edge_locs.register_rope(e, e.inner)
            else:
                self.d.edge_locs.unregister_rope(e, e.inner)

    def insert_fwd_edge(self, e: Edge) -> None:
        lst = self.g.ensure(e.src)
        if not lst:
            self.n_nodes += 1
        lst.append(e)
        self.n_edges += 1
        self._update_read_locations(e, True)

    def insert_edge(self, e: Edge) -> None:
        self.insert_fwd_edge(e)
        self.insert_fwd_edge(e.twin)

    def _remove_from_source(self, e: Edge) -> None:
        lst = self.g.at(e.src)
        lst[:] = [x for x in lst if x is not e]
        if not lst:
            self.n_nodes -= 1
        self.n_edges -= 1

    def remove_edge(self, e: Edge) -> None:
        # reference removeEdge: twin location-update+unlink first, then edge
        self._update_read_locations(e.twin, False)
        self._remove_from_source(e.twin)
        self._update_read_locations(e, False)
        self._remove_from_source(e)
        free_pair(self.alloc, e)

    def exists_edge(self, e: Edge) -> bool:
        lst = self.g.get(e.src)
        if lst is None:
            return False
        return any(x.same_as(e) for x in lst)

    def drop_empty_nodes(self) -> None:
        """Patched-oracle semantics: remove every empty node entry."""
        for k in [k for k in self.g.keys if not self.g.d[k]]:
            self.g.erase(k)

    # ------------------------------------------------------------------
    # edge-file load (reference: readParEdges, :2028-2094)
    # ------------------------------------------------------------------
    def read_par_edges(self, path: str) -> None:
        d = self.d
        import numpy as np
        mate_np = d.mate_array()
        # `used` is read-only during the parse; one bool snapshot turns the
        # per-inner-read used/mate counting into two vector ops per line
        used_np = np.zeros(len(d.used), bool)
        used_np[:] = d.used
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                tok = line.split("\t")
                src = int(tok[0])
                dst = int(tok[1])
                info = tok[2].split(",")
                orient = int(info[0])
                offset = int(info[1])
                flow = int(info[5]) if len(info) > 5 else 0

                n_inner = 0
                used_ctr = 0
                unused_mate = 0
                rope = Rope.EMPTY
                if len(tok) > 3 and tok[3]:
                    # text-mode fromstring: no transient list of per-number
                    # strings (an edge line can carry millions of triples)
                    flat = np.fromstring(
                        tok[3][1:-1].replace(")(", ","), dtype=np.int64,
                        sep=",")
                    n_inner = len(flat) // 3
                    rids = flat[0::3]
                    used_ctr = int(np.count_nonzero(used_np[rids]))
                    mates = mate_np[rids]
                    unused_mate = int(np.count_nonzero(
                        (mates > 0) & ~used_np[mates]))
                if self._is_used_edge(n_inner, used_ctr, unused_mate,
                                      src, dst):
                    continue
                if n_inner:
                    # columnar leaf: ~9 B per inner read instead of the
                    # tuple-of-tuples' ~120 B (docs/MEMORY_PLAN.md)
                    rope = Rope.of_arrays(rids, flat[1::3], flat[2::3])
                fwd = Edge(self.alloc, src, d.read_len(src), dst,
                           d.read_len(dst), orient, offset, inner=rope,
                           flow=flow)
                rev_inner = self._rev_list(fwd)
                rev_off = fwd.edge_length() - d.read_len(src)
                rev = Edge(self.alloc, dst, d.read_len(dst), src,
                           d.read_len(src), twin_orient(orient), rev_off,
                           inner=rev_inner, flow=flow)
                fwd.twin = rev
                rev.twin = fwd
                if not self.exists_edge(fwd):
                    self.insert_edge(fwd)
                else:
                    free_pair(self.alloc, fwd)

    def _rev_list(self, fwd: Edge) -> Rope:
        """reference: createRevList (Edge.cpp:456-487), vectorized over
        the columnar inner list.  With t_i = total - len(rid_i) -
        fwd_psum_i (in reverse order), the running-subtraction recurrence
        off_i = t_i - sum(off_{<i}) telescopes to off_i = t_i - t_{i-1}."""
        inner = fwd.inner
        if inner.n == 0:
            return Rope.EMPTY
        c = inner.columns()
        ps = inner.offset_prefix()
        total = fwd.edge_length()
        lens = self.d.read_len_array()
        rid_rev = c.rid[::-1]
        t = (total - lens[rid_rev]
             - np.asarray(ps[1:][::-1], np.int64))
        off = np.diff(t, prepend=0)
        return Rope.of_arrays(rid_rev, 1 - c.ori[::-1], off)

    def _is_used_edge(self, n_inner: int, used_ctr: int, unused_mate: int,
                      src: int, dst: int) -> bool:
        """reference: isUsedEdge (OverlapGraph.cpp:2098-2136)."""
        d, p = self.d, self.p
        if (n_inner > 0 and used_ctr > 0
                and used_ctr > n_inner * p.min_read_used
                and unused_mate < used_ctr * p.min_mate_read_unused):
            return True
        if n_inner == 0:
            sm = d.mate_pair(src)
            dm = d.mate_pair(dst)
            if sm == 0 and dm == 0:
                if d.used[src] and d.used[dst]:
                    return True
            elif sm > 0 and dm > 0:
                if (d.used[src] and d.used[dst] and d.used[sm]
                        and d.used[dm]):
                    return True
            elif sm > 0:
                if d.used[src] and d.used[dst] and d.used[sm]:
                    return True
            else:
                if d.used[src] and d.used[dst] and d.used[dm]:
                    return True
        return False

    # ------------------------------------------------------------------
    # sorting (reference: :1227-1238)
    # ------------------------------------------------------------------
    def sort_edges_by_dest(self) -> None:
        for k in list(self.g.keys):
            lst = self.g.at(k)
            if len(lst) > 1:
                keys = np.fromiter(
                    ((e.dst << 32) | e.edge_length() for e in lst),
                    np.uint64, len(lst))
                perm = stdsort_permutation(keys)
                lst[:] = [lst[p] for p in perm]

    # ------------------------------------------------------------------
    # contraction (reference: contractCompositeEdgesPar, :159-361)
    # 1-thread semantics; no markedNodes gate in the full engine.
    # ------------------------------------------------------------------
    def contract_composite_par(self) -> int:
        g, alloc = self.g, self.alloc
        add_list: List[Edge] = []
        consumed: Set[int] = set()

        for start in list(g.keys):
            if start in consumed:
                continue
            consumed.add(start)
            lst = g.at(start)
            if len(lst) != 2:
                continue
            edge1 = lst[0].twin
            edge2 = lst[1]
            if not (is_mergeable_o(edge1.orient, edge2.orient)
                    and not edge1.is_loop() and not edge2.is_loop()):
                continue
            edge1.invalid = True
            edge1.twin.invalid = True
            edge2.invalid = True
            edge2.twin.invalid = True

            visited = {edge2.src}
            cur_fwd = copy_pair(alloc, edge2)
            while True:
                nxt = cur_fwd.dst
                elist = g.at(nxt)
                if len(elist) != 2:
                    break
                nfe = elist[1]
                if nfe.dst in visited:
                    nfe = elist[0]
                if nfe.dst in visited:
                    break
                if (is_mergeable_o(cur_fwd.orient, nfe.orient)
                        and not nfe.is_loop() and not cur_fwd.is_loop()):
                    consumed.add(nxt)
                    visited.add(nxt)
                    nfe.invalid = True
                    nfe.twin.invalid = True
                    tmp = add_edges(alloc, cur_fwd, nfe)
                    free_pair(alloc, cur_fwd)
                    cur_fwd = tmp
                else:
                    break

            cur_rev = copy_pair(alloc, edge1)
            while True:
                nxt = cur_rev.src
                elist = g.at(nxt)
                if len(elist) != 2:
                    break
                nre = elist[0].twin
                if nre.src in visited:
                    nre = elist[1].twin
                if nre.src in visited:
                    break
                if (is_mergeable_o(nre.orient, cur_rev.orient)
                        and not nre.is_loop() and not cur_rev.is_loop()):
                    consumed.add(nxt)
                    visited.add(nxt)
                    nre.invalid = True
                    nre.twin.invalid = True
                    tmp = add_edges(alloc, nre, cur_rev)
                    free_pair(alloc, cur_rev)
                    cur_rev = tmp
                else:
                    break

            new_edge = add_edges(alloc, cur_rev, cur_fwd)
            free_pair(alloc, cur_rev)
            free_pair(alloc, cur_fwd)
            add_list.append(new_edge)

        # delete invalidated edges (map order, vector scan with restart-at-j)
        for k in list(g.keys):
            lst = g.at(k)
            i = 0
            while i < len(lst):
                if lst[i].invalid:
                    self.remove_edge(lst[i])
                else:
                    i += 1

        counter = 0
        for e in add_list:
            if not self.exists_edge(e):
                self.insert_edge(e)
                counter += 1
            else:
                free_pair(alloc, e)

        self.drop_empty_nodes()
        return counter

    # ------------------------------------------------------------------
    # dead ends (reference: removeDeadEndNodes, :591-694)
    # ------------------------------------------------------------------
    def remove_dead_end_nodes(self) -> int:
        p = self.p
        to_remove: List[int] = []
        # ascending live keys == the reference's 1..N scan restricted to
        # non-empty nodes (the `continue` below); skips the dict probe per
        # absent read ID
        for i in list(self.g.keys):
            lst = self.g.get(i)
            if not lst:
                continue
            is_dead_end = True
            in_e = out_e = 0
            for e in lst:
                if e.is_not_dead_end():
                    is_dead_end = False
                    break
                if e.inner.n and e.inner.n >= p.min_reads_not_dead_end:
                    e.mark_not_dead_end()
                    is_dead_end = False
                    break
                if e.edge_length() >= p.min_len_not_dead_end:
                    e.mark_not_dead_end()
                    is_dead_end = False
                    break
                if e.is_loop():
                    e.mark_not_dead_end()
                    is_dead_end = False
                    break
                if (e.orient >> 1) & 1:
                    out_e += 1
                else:
                    in_e += 1
            if is_dead_end and in_e * out_e == 0 and in_e + out_e > 0:
                to_remove.append(i)

        deleted = 0
        for nid in to_remove:
            lst = self.g.at(nid)
            while lst:
                self.remove_edge(lst[0])
                deleted += 1
        self.drop_empty_nodes()
        return deleted

    # ------------------------------------------------------------------
    # bubbles (reference: removeSimilarEdges, :503-582)
    # ------------------------------------------------------------------
    def remove_similar_edges(self) -> int:
        counter = 0
        for k in self.g:
            lst = self.g.at(k)
            if len(lst) <= 1:
                continue
            num = len(lst)
            for j in range(num):
                e1 = lst[j]
                dst1 = e1.dst
                if e1.is_loop() or e1.invalid:
                    continue
                for kk in range(j + 1, num):
                    e2 = lst[kk]
                    if dst1 == e2.dst:
                        if e1.orient == e2.orient:
                            if (abs(e1.offset - e2.offset)
                                    < e2.offset // 20):
                                c1 = self._cov_depth(e1)
                                c2 = self._cov_depth(e2)
                                e1_reads = e1.inner.n
                                e2_reads = e2.inner.n
                                if (c1 < c2 or (c1 == c2
                                                and e1_reads < e2_reads)):
                                    # reference breaks BEFORE ++counter
                                    e1.invalid = True
                                    break
                                else:
                                    e2.invalid = True
                                counter += 1
                    else:
                        break
            i = 0
            while i < len(lst):
                if lst[i].invalid:
                    self.remove_edge(lst[i])
                else:
                    i += 1
        return counter

    # ------------------------------------------------------------------
    # parallel edges (reference: removeParallelEdges, :1611-1648 — present
    # in the reference but not invoked by its main flow, main.cpp:176)
    # ------------------------------------------------------------------
    def remove_parallel_edges(self) -> int:
        """For every pair of edges at a node sharing a destination
        (orientation ignored), remove the shorter (reference keeps the
        edge with >= edgeLength, :1630-1633).  The reference can push the
        same pointer twice with >=3 parallel edges and would double-remove;
        we skip edges already scheduled."""
        removed = 0
        for k in self.g:
            lst = self.g.at(k)
            parallel: List[Edge] = []
            for j in range(len(lst)):
                ej = lst[j]
                for kk in range(j + 1, len(lst)):
                    ek = lst[kk]
                    if ej.dst == ek.dst:
                        loser = ek if (ej.edge_length()
                                       >= ek.edge_length()) else ej
                        if not loser.invalid:
                            loser.invalid = True
                            parallel.append(loser)
            for e in parallel:
                e.invalid = False
                lst_now = self.g.get(e.src)
                if lst_now and any(x is e for x in lst_now):
                    self.remove_edge(e)
                    removed += 1
        return removed

    def _cov_depth(self, e: Edge) -> float:
        """Mean base-by-base coverage (reference:
        Edge::updateBaseByBaseCoverageStat, Edge.cpp:259-290).  Sequential
        float32 accumulation like the C++ `float` get_mean (Edge.cpp:584-592):
        cumsum in float32 rounds every prefix exactly like `sum += v`."""
        vals = self.coverage_values(e)
        if not len(vals):
            return 0.0
        s = np.cumsum(vals.astype(np.float32), dtype=np.float32)[-1]
        return float(np.float32(s) / np.float32(len(vals)))

    def _cov_sd(self, e: Edge) -> float:
        """reference: get_sd (Edge.cpp:594-605), float32 accumulation."""
        vals = self.coverage_values(e)
        if not len(vals):
            return 0.0
        v32 = vals.astype(np.float32)
        mean = np.float32(np.cumsum(v32, dtype=np.float32)[-1]
                          / np.float32(len(vals)))
        dif = (mean - v32) * (mean - v32)
        var = np.cumsum(dif.astype(np.float32), dtype=np.float32)[-1]
        return float(np.sqrt(np.float32(var / np.float32(len(vals)))))

    def _read_cov_profile(self, rid: int) -> np.ndarray:
        """Per-base coverage of one read (reference: DataSet::getReadCoverage
        DataSet.cpp:365-381 — the condition reduces to
        cov[idx] = 1 + #{contained reads with ovlStart > idx})."""
        rl = self.d.read_len(rid)
        lst = self.d.con_reads[rid]
        if self.d.contained_flag[rid] or not lst:
            return np.ones(rl, np.int64)
        starts = np.sort(np.fromiter((s for (_c, s, _o) in lst), np.int64,
                                     len(lst)))
        idx = np.arange(rl)
        return 1 + (len(starts) - np.searchsorted(starts, idx, side="right"))

    def coverage_values(self, e: Edge) -> np.ndarray:
        """Per-base coverage of a composite edge.  Difference-array
        formulation of the per-read profile sum (the oracle loop is kept in
        _read_cov_profile): each inner read adds +1 over
        [ovl, min(ovl+len, L)) and, unless itself contained, +1 over
        [ovl, ovl+min(s, end-ovl)) per contained-read start s."""
        length = e.edge_length()
        if not e.inner.n:
            return np.zeros(length, np.int64)
        cols = e.inner.columns()
        n = e.inner.n
        rids = cols.rid.astype(np.int64)
        ovl = np.cumsum(cols.off.astype(np.int64))
        lens = self.d.read_len_array()[rids]
        ends = np.minimum(ovl + lens, length)
        # int32 diff + in-place cumsum: the largest edge's profile is
        # genome-scale (a 100 Mb scaffold = 800 MB as two int64 arrays)
        diff = np.zeros(length + 1, np.int32)
        base = ends > ovl
        np.add.at(diff, ovl[base], 1)
        np.add.at(diff, ends[base], -1)
        cflag = self.d.contained_flag
        creads = self.d.con_reads
        ca, cb = [], []
        for i in range(n):
            rid = int(rids[i])
            lst = creads[rid]
            if not lst or cflag[rid]:
                continue
            o, en = int(ovl[i]), int(ends[i])
            if en <= o:
                continue
            lim = en - o
            for (_c, s, _o2) in lst:
                ca.append(o)
                cb.append(o + (s if s < lim else lim))
        if ca:
            np.add.at(diff, np.asarray(ca, np.int64), 1)
            np.add.at(diff, np.asarray(cb, np.int64), -1)
        out = diff[:length]
        np.cumsum(out, out=out)
        return out

    # ------------------------------------------------------------------
    # branch clipping (reference: clipBranches, :704-771)
    # NOTE: breakEdge returns no sub-edges (reference bug) => pure deletion.
    # ------------------------------------------------------------------
    def clip_branches(self) -> int:
        p = self.p
        num_clipped = 0
        for k in self.g:
            lst = self.g.at(k)
            if len(lst) <= 1:
                continue
            in_edges: List[Edge] = []
            out_edges: List[Edge] = []
            in_ovls: List[int] = []
            out_ovls: List[int] = []
            max_in = max_out = 0
            for e in lst:
                ovl = e.overlap_len()
                if not e.is_loop():
                    if not ((e.orient >> 1) & 1):
                        in_edges.append(e)
                        in_ovls.append(ovl)
                        max_in = max(max_in, ovl)
                    else:
                        out_edges.append(e)
                        out_ovls.append(ovl)
                        max_out = max(max_out, ovl)
            if len(in_edges) > 1:
                for i, e in enumerate(in_edges):
                    if in_ovls[i] + p.min_ovl_diff_to_clip < max_in:
                        self.remove_edge(e)
                        num_clipped += 1
            if len(out_edges) > 1:
                for i, e in enumerate(out_edges):
                    if out_ovls[i] + p.min_ovl_diff_to_clip < max_out:
                        self.remove_edge(e)
                        num_clipped += 1
        return num_clipped

    # ------------------------------------------------------------------
    # low-overlap clip (reference: removeLowOvlEdges, :780-805)
    # ------------------------------------------------------------------
    def remove_low_ovl_edges(self) -> int:
        p = self.p
        num = 0
        for k in self.g:
            lst = self.g.at(k)
            if len(lst) <= 1:
                continue
            j = 0
            while j < len(lst):
                e = lst[j]
                if e.overlap_len() < p.min_ovl_to_clip:
                    self.remove_edge(e)
                    num += 1
                # reference does NOT adjust j after removal: the element
                # shifted into j is skipped (for-loop j++ regardless)
                j += 1
        return num

    # ------------------------------------------------------------------
    # short branches (reference: removeShortBranches, :433-495)
    # ------------------------------------------------------------------
    def remove_short_branches(self) -> int:
        if not self.flow_computed:
            return 0
        p = self.p
        removed = 0
        long_brlens: Dict[int, List[int]] = {}
        for k in self.g:
            lst = self.g.at(k)
            if len(lst) != 1 or lst[0].is_loop():
                continue
            one_edge = lst[0].twin
            neighbor = one_edge.src
            nb_list = self.g.at(neighbor)
            if len(nb_list) <= 1:
                continue
            one_len = one_edge.offset
            in_out = (one_edge.orient >> 1) & 1
            if neighbor not in long_brlens:
                brlens = [0, 0]
                brlens[in_out] = one_len
                for e in nb_list:
                    direction = (e.orient >> 1) & 1
                    if e.offset > brlens[direction]:
                        brlens[direction] = e.offset
                long_brlens[neighbor] = brlens
            if (one_len * p.min_fold_short_branch
                    < long_brlens[neighbor][in_out]
                    and one_len < p.min_size_short_branch):
                self.remove_edge(one_edge)
                removed += 1
        return removed

    # ------------------------------------------------------------------
    # loops (reference: reduceLoops, :817-914)
    # ------------------------------------------------------------------
    def reduce_loops(self) -> int:
        if not self.flow_computed:
            return 0
        counter = 0
        removed = 0
        for k in self.g:
            lst = self.g.at(k)
            if len(lst) != 4:
                continue
            loop_count = in_count = out_count = 0
            ab = bb = bc = None
            for e in lst:
                if e.is_loop():
                    loop_count += 1
                    bb = e
                elif ((e.orient >> 1) & 1) == 0:
                    in_count += 1
                    ab = e.twin
                else:
                    out_count += 1
                    bc = e
            if loop_count == 2 and in_count == 1 and out_count == 1:
                if bb.orient == 0:
                    counter += 1
                    new_edge = add_edges(self.alloc, ab, bb.twin)
                    self.insert_edge(new_edge)
                    self.remove_edge(ab)
                    self.remove_edge(bb)
                elif bb.orient == 3:
                    counter += 1
                    new_edge = add_edges(self.alloc, ab, bb)
                    self.insert_edge(new_edge)
                    self.remove_edge(ab)
                    self.remove_edge(bb)
                else:
                    removed += 1
                    self.remove_edge(bb)
            elif (loop_count == 2 and in_count == 2 and out_count == 0
                    and bb.orient == 2):
                counter += 1
                new_edge = add_edges(self.alloc, ab, bb)
                self.insert_edge(new_edge)
                self.remove_edge(ab)
                self.remove_edge(bb)
            elif (loop_count == 2 and in_count == 0 and out_count == 2
                    and bb.orient == 1):
                counter += 1
                new_edge = add_edges(self.alloc, bb, bc)
                self.insert_edge(new_edge)
                self.remove_edge(bc)
                self.remove_edge(bb)
            elif loop_count == 2:
                removed += 1
                self.remove_edge(bb)
        return counter + removed

    # ------------------------------------------------------------------
    # composite phases (reference: graphPathFindInitial :1169-1198,
    # simplifyGraph :1267-1292, simplifyScaffoldGraph :1246-1259)
    # ------------------------------------------------------------------
    def _periodic_checkpoint(self, prev: float) -> float:
        """Wall-clock-cadenced mid-loop graph snapshot (reference:
        OverlapGraph.cpp:1183-1188,1282-1289; cadence Config.h:53).  Returns
        the new timer origin."""
        import time
        now = time.monotonic()
        if self.checkpoint_path is None or \
                now - prev < self.p.disk_graph_update:
            return prev
        self.print_all_edges(self.checkpoint_path)
        if self.on_disk_snapshot is not None:
            self.on_disk_snapshot()
        return time.monotonic()

    def graph_path_find_initial(self) -> None:
        import time
        prev = time.monotonic()
        self.remove_low_ovl_edges()
        while True:
            self.remove_dead_end_nodes()
            counter = self.contract_composite_par()
            prev = self._periodic_checkpoint(prev)
            if counter <= 1000:
                break
        self.remove_similar_edges()
        self.clip_branches()

    def simplify_graph(self) -> None:
        import time
        prev = time.monotonic()
        while True:
            counter = self.contract_composite_par()
            counter += self.remove_similar_edges()
            counter += self.remove_dead_end_nodes()
            counter += self.remove_short_branches()
            counter += self.reduce_loops()
            prev = self._periodic_checkpoint(prev)
            if counter == 0:
                break

    def simplify_scaffold_graph(self) -> None:
        while True:
            counter = self.contract_composite_par()
            counter += self.remove_similar_edges()
            counter += self.remove_dead_end_nodes()
            counter += self.reduce_loops()
            if counter == 0:
                break

    # ------------------------------------------------------------------
    # flow (reference: calculateFlowStream :1313-1553,
    # removeAllEdgesWithoutFlow :1561-1603)
    # ------------------------------------------------------------------
    def calculate_flow(self, dimacs_dump: Optional[str] = None) -> None:
        from . import flow as _flow
        self.drop_empty_nodes()
        fp = _flow.build_flow_problem(self)
        if dimacs_dump:
            with open(dimacs_dump, "w") as f:
                f.write("\n".join(fp.lines) + "\n")
        # The empty graph yields just the lb=1 sink->source arc: infeasible.
        # The reference ABORTS here ("Error 2", exit(cc) at
        # CS2_stream/cs2.h:352, verified on a read set whose graph empties
        # before flow); we degrade gracefully instead: zero flows, so the
        # run completes with empty contig output (PARITY.md "Degenerate
        # inputs").
        # A non-degenerate infeasible problem is a graph-construction bug:
        # let the solver's error propagate (the reference aborts via CS2
        # "Error 2") rather than silently zeroing flows.
        if len(fp.arcs) <= 1:
            flows = [0] * len(fp.arcs)
        else:
            flows = _flow.solve_flow(fp)
        _flow.assign_flows(self, fp, flows)

    def remove_edges_without_flow(self) -> int:
        if not self.flow_computed:
            return 0
        p = self.p
        removed = 0
        for k in self.g:
            lst = self.g.at(k)
            j = 0
            while j < len(lst):
                e = lst[j]
                if (e.flow == 0 and not e.is_loop()
                        and e.inner.n <= p.min_reads_0_flow
                        and e.edge_length() <= p.min_len_0_flow):
                    self.remove_edge(e)
                    removed += 1
                # reference's for-loop increments j even after removal,
                # skipping the shifted-in element
                j += 1
        self.drop_empty_nodes()
        return removed

    # ------------------------------------------------------------------
    # output (reference: printAllEdges :1997-2020, printEdge :1742-1775)
    # ------------------------------------------------------------------
    def format_edge(self, e: Edge) -> str:
        return (f"{e.src}\t{e.dst}\t{e.orient},{e.offset},"
                f"{e.edge_length()},0,0,{e.flow}\t" + e.inner.fmt())

    def print_all_edges(self, path: str, *extra_paths: str) -> None:
        """Write the graph snapshot to `path` (and identical copies to
        `extra_paths` — the driver always snapshots each phase twice, once
        as the phase file and once as _CurrGraph_; format once).  Streams
        to the first file and OS-copies the rest — the joined blob was a
        file-sized transient at metagenome scale."""
        with open(path, "w") as f:
            for i in list(self.g.keys):
                lst = self.g.get(i)
                if not lst:
                    continue
                for e in lst:
                    if e.is_smaller():
                        f.write(self.format_edge(e))
                        f.write("\n")
        import shutil
        for p in extra_paths:
            shutil.copyfile(path, p)

    def get_edges(self) -> List[Edge]:
        """Length-sorted descending (reference: getEdges :1708-1733 —
        std::sort ascending by length then reverse)."""
        out: List[Edge] = []
        for i in list(self.g.keys):
            lst = self.g.get(i)
            if not lst:
                continue
            for e in lst:
                if e.is_smaller():
                    out.append(e)
        if out:
            keys = np.fromiter((e.edge_length() for e in out), np.int64,
                               len(out))
            perm = stdsort_permutation(keys)
            out = [out[p] for p in perm][::-1]
        return out
