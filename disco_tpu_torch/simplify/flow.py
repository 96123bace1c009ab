"""Min-cost-flow analysis (reference: calculateFlowStream,
src/SimplifyGraph/src/OverlapGraph.cpp:1313-1553).

The reference converts the bidirected graph into a directed min-cost-flow
problem in DIMACS text and solves it with the license-encumbered CS2 solver
(CS2_stream/cs2.h:1-4).  We generate byte-identical DIMACS (testable against
the oracle's <prefix>_dimacs_dump.txt) and solve with our own
successive-shortest-path MCMF — clean-room, no CS2 code.

Solution-degeneracy note: min-cost-flow optima need not be unique.  What the
downstream pipeline consumes is the per-node-pair total flow (the reference
adds every nonzero arc flow onto the edge found between the two endpoint
nodes and its twin, OverlapGraph.cpp:1519-1549).  The strong convex costs
(1 / 50000 / 100000 / 500000) make the pairwise totals unique in practice;
parity is validated against the oracle's flow-phase snapshots.
"""
from typing import Dict, List, Optional, Tuple

from .core import Edge


def _bound_and_cost(e: Edge, p) -> Tuple[List[int], List[int], List[int]]:
    """reference: calculateBoundAndCost (OverlapGraph.cpp:923-961)."""
    lb = [0, 0, 0]
    ub = [10, 10, 10]
    cost = [500000, 500000, 500000]
    if e.inner.n > 0:
        if (e.inner.n >= p.min_reads_1_min_flow
                or e.edge_length() >= p.min_len_1_min_flow):
            lb = [1, 0, 0]
            ub = [1, 1, 8]
            cost = [1, 50000, 100000]
        else:
            lb = [0, 0, 0]
            ub = [1, 1, 8]
            cost = [1, 50000, 100000]
    return lb, ub, cost


def _w(v) -> str:
    return f"{v:>10}"


class FlowProblem:
    """DIMACS text + arc table for flow assignment."""

    def __init__(self):
        self.lines: List[str] = []
        # arcs in emission order: (tail, head, lb, ub, cost); ub=-1 => inf
        self.arcs: List[Tuple[int, int, int, int, int]] = []
        self.v = 0
        self.node_of_index: Dict[int, int] = {}  # cs2 idx-1 -> read id


def build_flow_problem(graph) -> FlowProblem:
    """Mirror of the DIMACS generation loop.  `graph` is a FullGraph whose
    empty nodes were dropped (the reference prunes them first,
    OverlapGraph.cpp:1320-1331)."""
    fp = FlowProblem()
    g = graph.g
    n_nodes = graph.n_nodes
    n_edges = graph.n_edges
    V = n_nodes * 2 + 2
    E = n_edges * 3 + n_nodes * 4 + 1
    SRC = 1
    SINK = V
    fp.v = V
    out = fp.lines
    out.append(f"p min {_w(V)} {_w(E)}")
    out.append(f"n {_w(SRC)}{_w(' 0')}")
    out.append(f"n {_w(SINK)}{_w(' 0')}")

    def arc(t, h, lb, ub, cost):
        out.append(f"a {_w(t)} {_w(h)} {_w(lb)} {_w(ub)} {_w(cost)}")
        fp.arcs.append((t, h, lb, ub, cost))

    # sink -> source, infinite capacity printed as -1
    # (UINT64::max assigned to INT64, reference: OverlapGraph.cpp:1351-1356)
    arc(SINK, SRC, 1, -1, 1000000)

    read_of_idx: Dict[int, int] = {}
    idx_of_read: Dict[int, int] = {}
    for i, k in enumerate(g.keys):
        read_of_idx[i] = k
        idx_of_read[k] = i
    fp.node_of_index = read_of_idx

    cur = 1
    for _k in g.keys:
        arc(SRC, 2 * cur, 0, 1000000, 0)
        arc(SRC, 2 * cur + 1, 0, 1000000, 0)
        arc(2 * cur, SINK, 0, 1000000, 0)
        arc(2 * cur + 1, SINK, 0, 1000000, 0)
        cur += 1

    for k in g.keys:
        for e in g.at(k):
            u = idx_of_read[e.src] + 1
            v = idx_of_read[e.dst] + 1
            if not (u < v or (u == v and e.addr < e.twin.addr)):
                continue
            lb, ub, cost = _bound_and_cost(e, graph.p)
            u1, u2, v1, v2 = 2 * u, 2 * u + 1, 2 * v, 2 * v + 1
            if e.orient == 0:
                pairs = [(v1, u1), (u2, v2)]
            elif e.orient == 1:
                pairs = [(v2, u1), (u2, v1)]
            elif e.orient == 2:
                pairs = [(u1, v2), (v1, u2)]
            else:
                pairs = [(u1, v1), (v2, u2)]
            for t in range(3):
                for (a, b) in pairs:
                    arc(a, b, lb[t], ub[t], cost[t])
    return fp


# ---------------------------------------------------------------------------
# MCMF solver (successive shortest paths with potentials, lower bounds via
# excess transformation — standard textbook construction, written fresh)
# ---------------------------------------------------------------------------
INF = 1 << 60


class _Net:
    def __init__(self, n: int):
        self.n = n
        self.head: List[int] = []
        self.to: List[int] = []
        self.cap: List[int] = []
        self.cost: List[int] = []
        self.first = [-1] * n
        self.nxt: List[int] = []

    def add(self, u: int, v: int, cap: int, cost: int) -> int:
        i = len(self.to)
        self.to.append(v)
        self.cap.append(cap)
        self.cost.append(cost)
        self.nxt.append(self.first[u])
        self.first[u] = i
        self.to.append(u)
        self.cap.append(0)
        self.cost.append(-cost)
        self.nxt.append(self.first[v])
        self.first[v] = i + 1
        return i


def solve_flow(fp: FlowProblem) -> List[int]:
    """Return flow per arc (same order as fp.arcs).

    Dispatches to the native C++ solver (native/src/mcmf.cpp, an
    exact operation-order port of _solve_flow_py below — both produce the
    same per-arc vector); set DISCO_TPU_TORCH_NO_NATIVE=1 to force the
    Python path."""
    import os
    import subprocess

    if fp.arcs and not os.environ.get("DISCO_TPU_TORCH_NO_NATIVE"):
        import numpy as np

        from ..native import mcmf_solve
        cols = list(zip(*fp.arcs))
        tail, head, lb, ub, cost = (np.array(c, np.int64) for c in cols)
        try:
            return mcmf_solve(fp.v, tail, head, lb, ub, cost).tolist()
        except (OSError, subprocess.CalledProcessError):
            pass  # toolchain unavailable: pure-Python solver
    return _solve_flow_py(fp)


def _solve_flow_py(fp: FlowProblem) -> List[int]:
    """Pure-Python reference implementation of solve_flow."""
    import heapq

    V = fp.v
    # transformed network: nodes 1..V, plus S=0 and T=V+1 for lower bounds
    S, T = 0, V + 1
    net = _Net(V + 2)
    excess = [0] * (V + 2)
    arc_ids: List[int] = []
    for (t, h, lb, ub, cost) in fp.arcs:
        cap = (1 << 40) if ub < 0 else ub
        aid = net.add(t, h, cap - lb, cost)
        arc_ids.append(aid)
        excess[t] -= lb
        excess[h] += lb
    total = 0
    for v in range(1, V + 1):
        if excess[v] > 0:
            net.add(S, v, excess[v], 0)
            total += excess[v]
        elif excess[v] < 0:
            net.add(v, T, -excess[v], 0)

    # SSP with Johnson potentials (Bellman-Ford init handles the residual
    # negative costs after the transformation)
    n = net.n
    pot = [0] * n
    # Bellman-Ford on original arcs only (all caps > 0 initially)
    for _ in range(n):
        changed = False
        for u in range(n):
            pu = pot[u]
            i = net.first[u]
            while i != -1:
                if net.cap[i] > 0 and pu + net.cost[i] < pot[net.to[i]]:
                    pot[net.to[i]] = pu + net.cost[i]
                    changed = True
                i = net.nxt[i]
        if not changed:
            break

    sent = 0
    while sent < total:
        dist = [INF] * n
        dist[S] = 0
        par = [-1] * n
        pq = [(0, S)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist[u]:
                continue
            i = net.first[u]
            while i != -1:
                if net.cap[i] > 0:
                    v = net.to[i]
                    nd = d + net.cost[i] + pot[u] - pot[v]
                    if nd < dist[v]:
                        dist[v] = nd
                        par[v] = i
                        heapq.heappush(pq, (nd, v))
                i = net.nxt[i]
        if dist[T] >= INF:
            raise RuntimeError("infeasible flow problem")
        for v in range(n):
            if dist[v] < INF:
                pot[v] += dist[v]
        # bottleneck
        push = INF
        v = T
        while v != S:
            i = par[v]
            push = min(push, net.cap[i])
            v = net.to[i ^ 1]
        v = T
        while v != S:
            i = par[v]
            net.cap[i] -= push
            net.cap[i ^ 1] += push
            v = net.to[i ^ 1]
        sent += push

    flows = []
    for (arc, (t, h, lb, ub, cost)) in zip(arc_ids, fp.arcs):
        cap = (1 << 40) if ub < 0 else ub
        flows.append(lb + (cap - lb - net.cap[arc]))
    return flows


def assign_flows(graph, fp: FlowProblem, flows: List[int]) -> None:
    """reference: the CS2-output loop (OverlapGraph.cpp:1515-1549): for each
    nonzero arc between real nodes, add its flow to the most-inner-reads edge
    between the two endpoint reads AND its twin."""
    import numpy as np

    from ..native import stdsort_permutation

    V = fp.v
    SRC, SINK = 1, V

    def find_edge(src_read: int, dst_read: int) -> Optional[Edge]:
        lst = graph.g.get(src_read)
        if lst is None:
            return None
        cands = [e for e in lst if e.dst == dst_read]
        if not cands:
            return None
        if len(cands) > 1:
            keys = np.fromiter((-e.inner.n for e in cands), np.int64,
                               len(cands))
            perm = stdsort_permutation(keys)
            cands = [cands[p] for p in perm]
        return cands[0]

    for ((t, h, _lb, _ub, _cost), fl) in zip(fp.arcs, flows):
        if t in (SRC, SINK) or h in (SRC, SINK) or fl == 0:
            continue
        # reference: ceil(source/2)-1 where source/2 is already INTEGER
        # division (OverlapGraph.cpp:1528-1536) => floor semantics
        s_idx = t // 2 - 1
        d_idx = h // 2 - 1
        my_src = fp.node_of_index[s_idx]
        my_dst = fp.node_of_index[d_idx]
        e = find_edge(my_src, my_dst)
        if e is not None:
            e.flow += fl
            e.twin.flow += fl
    graph.flow_computed = True
