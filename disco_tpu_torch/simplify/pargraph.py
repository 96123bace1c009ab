"""parsimplify equivalent: per-partition contraction + dead-end removal.

Mirrors the reference executable `parsimplify`
(src/SimplifyGraph/src/mainParSimplify.cpp:10-21,
 src/SimplifyGraph/src/OverlapGraphSimple.cpp), single-threaded parity mode:

  load edges >= minOvl -> sort by (dest, length) -> one chain-extending
  contraction pass -> fixpoint {single-step contraction; dead-end removal}
  -> print.

The reference's parallel pass with 1 thread degenerates to: scan nodes in
map order, claim-and-process each unclaimed node (OverlapGraphSimple.cpp:313-
500).  Dead-end thresholds are the Config.cpp DEFAULTS (parsimplify never
reads a parameter file): minReadsCountInEdgeToBeNotDeadEnd=5,
minEdgeLengthToBeNotDeadEnd=500 (src/SimplifyGraph/src/Config.cpp:42-43).
"""
from typing import List, Set, Tuple

import numpy as np

from ..native import stdsort_permutation
from .core import (Alloc, Edge, NodeMap, add_edges, copy_pair, free_pair,
                   is_mergeable_o, make_twin_pair)

MIN_READS_NOT_DEAD_END = 5   # reference: Config.cpp:42
MIN_LEN_NOT_DEAD_END = 500   # reference: Config.cpp:43


# ---------------------------------------------------------------------------
# graph primitives (reference: OverlapGraphSimple.cpp:20-60)
# ---------------------------------------------------------------------------
def insert_par_edge(g: NodeMap, e: Edge) -> None:
    g.ensure(e.src).append(e)
    g.ensure(e.twin.src).append(e.twin)


def remove_par_edge(g: NodeMap, alloc: Alloc, e: Edge) -> None:
    lst = g.at(e.src)
    lst[:] = [x for x in lst if x is not e]
    lst2 = g.at(e.twin.src)
    lst2[:] = [x for x in lst2 if x is not e.twin]
    free_pair(alloc, e)


def exists_par_edge(g: NodeMap, e: Edge) -> bool:
    lst = g.get(e.src)
    if lst is None:
        return False
    return any(x.same_as(e) for x in lst)


# ---------------------------------------------------------------------------
# load (reference: OverlapGraphSimple::loadParEdgesFromEdgeFile, :527-656)
# ---------------------------------------------------------------------------
def load_par_edges(path: str, min_ovl: int, alloc: Alloc, g: NodeMap,
                   marked: Set[int]) -> int:
    n = 0
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            tok = line.split("\t")
            src = int(tok[0])
            dst = int(tok[1])
            props = tok[2].split(",")
            orient = int(props[0])
            ovl_len = int(props[1])
            if ovl_len < min_ovl:
                continue
            len1 = int(props[4])
            start1 = int(props[5])
            len2 = int(props[7])
            mark_flag = int(props[11]) if len(props) > 11 else 2
            e = make_twin_pair(alloc, src, len1, dst, len2, orient, start1)
            insert_par_edge(g, e)
            if mark_flag == 0:
                marked.add(src)
            elif mark_flag == 1:
                marked.add(dst)
            else:
                marked.add(src)
                marked.add(dst)
            n += 1
    return n


def sort_edges_by_dest(g: NodeMap) -> None:
    """std::sort by (destID, edgeLength) per node — including libstdc++'s
    unstable tie order (reference: OverlapGraphSimple.cpp:278-303)."""
    for k in list(g.keys):
        lst = g.at(k)
        if len(lst) > 1:
            keys = np.fromiter(
                ((e.dst << 32) | e.edge_length() for e in lst),
                np.uint64, len(lst))
            perm = stdsort_permutation(keys)
            lst[:] = [lst[p] for p in perm]


# ---------------------------------------------------------------------------
# chain-extending contraction (reference: contractParCompositeEdges,
# OverlapGraphSimple.cpp:313-500; 1-thread semantics)
# ---------------------------------------------------------------------------
def contract_composite_par(g: NodeMap, alloc: Alloc, marked: Set[int],
                           check_marked: bool = True) -> int:
    add_list: List[Edge] = []
    consumed: Set[int] = set()  # reference's allMarked[] visit flags

    def node_ok(rid: int) -> bool:
        return (not check_marked) or (rid in marked)

    for start in list(g.keys):  # map order; nodes never added/removed here
        if start in consumed:   # claimed as a chain interior earlier
            continue
        consumed.add(start)
        lst = g.at(start)
        if len(lst) != 2 or not node_ok(start):
            continue
        edge1 = lst[0].twin
        edge2 = lst[1]
        if not (is_mergeable_o(edge1.orient, edge2.orient)
                and not edge1.is_loop() and not edge2.is_loop()
                and node_ok(edge1.src) and node_ok(edge2.dst)):
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
                    and not nfe.is_loop() and not cur_fwd.is_loop()
                    and node_ok(nfe.dst)):
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
                    and not nre.is_loop() and not cur_rev.is_loop()
                    and node_ok(nre.src)):
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

    # delete invalidated edges (vector scan order, swap-free removal exact:
    # removeParEdge uses std::remove => order-preserving compaction)
    for k in list(g.keys):
        lst = g.at(k)
        j = 0
        while j < len(lst):
            e = lst[j]
            if e.invalid:
                remove_par_edge(g, alloc, e)
            else:
                j += 1

    counter = 0
    for e in add_list:
        if not exists_par_edge(g, e):
            insert_par_edge(g, e)
            counter += 1
        else:
            free_pair(alloc, e)
    return counter


# ---------------------------------------------------------------------------
# single-step contraction (reference: contractParCompositeEdges_Serial, :69-109)
# ---------------------------------------------------------------------------
def contract_composite_serial(g: NodeMap, alloc: Alloc,
                              marked: Set[int]) -> int:
    counter = 0
    for rid in sorted(marked):
        lst = g.get(rid)
        if lst is None or len(lst) != 2:
            continue
        edge1 = lst[0].twin
        edge2 = lst[1]
        if edge1.src not in marked or edge2.dst not in marked:
            continue
        if (is_mergeable_o(edge1.orient, edge2.orient)
                and not edge1.is_loop() and not edge2.is_loop()):
            new_edge = add_edges(alloc, edge1, edge2)
            insert_par_edge(g, new_edge)
            if edge2 is not edge1.twin:
                remove_par_edge(g, alloc, edge2)
            remove_par_edge(g, alloc, edge1)
            counter += 1
    return counter


# ---------------------------------------------------------------------------
# dead-end removal (reference: removeParDeadEndNodes, :136-222)
# ---------------------------------------------------------------------------
def remove_par_dead_ends(g: NodeMap, alloc: Alloc, marked: Set[int],
                         node_list: List[int]) -> int:
    to_remove: List[int] = []
    for nid in node_list:
        lst = g.get(nid)
        if lst is None or not lst:
            continue
        is_dead_end = True
        in_e = out_e = 0
        for e in lst:
            if e.dst not in marked:
                is_dead_end = False
                break
            if e.is_not_dead_end():
                is_dead_end = False
                break
            if e.inner.n >= MIN_READS_NOT_DEAD_END:
                e.mark_not_dead_end()
                is_dead_end = False
                break
            if e.edge_length() >= MIN_LEN_NOT_DEAD_END:
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
            to_remove.append(nid)

    deleted = 0
    for nid in to_remove:
        lst = g.at(nid)
        while lst:
            remove_par_edge(g, alloc, lst[0])
            deleted += 1
    return deleted


# ---------------------------------------------------------------------------
# output (reference: printEdge/printParEdges, :658-720)
# ---------------------------------------------------------------------------
def format_par_edge(e: Edge) -> str:
    parts = [f"{e.src}\t{e.dst}\t{e.orient},{e.offset},{e.edge_length()},0,0\t"]
    for (rid, ori, off) in e.inner:
        parts.append(f"({rid},{ori},{off})")
    return "".join(parts)


def print_par_edges(g: NodeMap) -> List[str]:
    out = []
    for k in g:
        for e in g.at(k):
            if e.is_smaller():
                out.append(format_par_edge(e))
    return out


# ---------------------------------------------------------------------------
# driver (reference: OverlapGraphSimple ctor, :224-270)
# ---------------------------------------------------------------------------
def parsimplify(edge_file: str, out_file: str, min_ovl: int,
                threads: int = 1) -> None:
    """Bit-parity port of `parsimplify <edgeFile> <outFile> <minOvl> <threads>`
    (parity defined for threads == 1)."""
    alloc = Alloc()
    g = NodeMap()
    marked: Set[int] = set()
    load_par_edges(edge_file, min_ovl, alloc, g, marked)
    sort_edges_by_dest(g)
    node_list = sorted(marked)
    contract_composite_par(g, alloc, marked)
    while True:
        c = contract_composite_serial(g, alloc, marked)
        c += remove_par_dead_ends(g, alloc, marked, node_list)
        if c == 0:
            break
    with open(out_file, "w") as f:
        for line in print_par_edges(g):
            f.write(line + "\n")
