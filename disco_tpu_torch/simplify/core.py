"""Core data model for the simplification graph.

Parity-critical semantics mirrored from the reference
(src/SimplifyGraph/src/{Edge,EdgeSimple}.{h,cpp}):

- Bidirected edges stored as twin pairs; orientation algebra
  (mergedEdgeOrientation, get_twin_orient, is_mergeable).
- Composite edges carry an ordered inner-read list (readID, orient, offset).
  The reference re-allocates and copies the packed array on every merge
  (Edge.cpp:381-409) — O(len) per step.  We use an immutable rope instead:
  O(1) concatenation, identical observable contents.
- Every edge has an allocation serial (`addr`) standing in for the C++ heap
  address: the reference compares `this < m_reverseEdge` to pick which twin
  of a self-loop to print (Edge.h isSmallerEdge, OverlapGraph.cpp:1747).
  Serials are monotonically increasing with a LIFO free-list, modeling glibc
  tcache reuse of the fixed-size Edge chunks.
- The node table emulates std::map<UINT64, vector<Edge*>*>: key-ordered
  iteration that tolerates concurrent insert/erase the way tree iterators do.
"""
from bisect import bisect_left, bisect_right, insort
from typing import Iterator, List, Optional, Tuple

import numpy as np


class _Cols:
    """Columnar bulk leaf payload: (rid int32, ori int8, off int32)
    arrays.  ~9 B per inner read instead of the ~120 B of a Python
    triple-tuple + ints — the simplify graph's dominant allocation at
    metagenome scale (docs/MEMORY_PLAN.md)."""
    __slots__ = ("rid", "ori", "off")

    def __init__(self, rid, ori, off):
        self.rid = rid
        self.ori = ori
        self.off = off

    def __len__(self):
        return len(self.rid)


# ---------------------------------------------------------------------------
# inner-read rope
# ---------------------------------------------------------------------------
class Rope:
    """Immutable sequence of (readID, orient, offset) triples with O(1)
    concat.  `orient` is 1 bit (1 = forward), `offset` the inner overlap
    offset (reference packing: Edge.h:28-39).

    Leaves are either small Python tuples (merge-path shared nodes) or
    columnar numpy triples (bulk edge-file loads); access goes through
    cached COLUMNS (`columns()`), with per-item tuples built transiently
    — the old tuple-of-tuples flat cache held ~85% of the graph's RSS in
    pure object overhead."""
    __slots__ = ("left", "right", "leaf", "n", "_cols", "_psum", "_fmt")

    def __init__(self, leaf=None, left: "Rope" = None, right: "Rope" = None):
        self.leaf = leaf
        self.left = left
        self.right = right
        self.n = (len(leaf) if leaf is not None
                  else (left.n if left else 0) + (right.n if right else 0))
        self._cols = leaf if isinstance(leaf, _Cols) else None
        self._psum = None
        self._fmt = None

    def fmt(self) -> str:
        """The edge-file "(rid,ori,off)..." rendering of this rope —
        cached (ropes are immutable) and composed from child caches, so
        repeated graph snapshots and merge chains reuse instead of
        reformatting every triple (print_all_edges was a top profile
        entry at 10 Mb)."""
        if self._fmt is None:
            # iterative left-to-right walk (concat chains can be thousands
            # deep — same reason columns() uses an explicit stack), reusing
            # any already-cached subtree strings
            parts = []
            stack = [self]
            while stack:
                r = stack.pop()
                if r._fmt is not None:
                    parts.append(r._fmt)
                elif r.leaf is not None:
                    if isinstance(r.leaf, _Cols):
                        c = r.leaf
                        r._fmt = "".join(
                            f"({a},{b},{c_})" for a, b, c_ in
                            zip(c.rid.tolist(), c.ori.tolist(),
                                c.off.tolist()))
                    else:
                        r._fmt = "".join(
                            f"({a},{b},{c})" for (a, b, c) in r.leaf)
                    parts.append(r._fmt)
                else:
                    if r.right is not None and r.right.n:
                        stack.append(r.right)
                    if r.left is not None and r.left.n:
                        stack.append(r.left)
            self._fmt = "".join(parts)
        return self._fmt

    # -- construction -------------------------------------------------------
    EMPTY: "Rope" = None  # set below

    @staticmethod
    def of(items) -> "Rope":
        items = tuple(items)
        return Rope(leaf=items) if items else Rope.EMPTY

    @staticmethod
    def of_arrays(rid, ori, off) -> "Rope":
        """Bulk columnar leaf (edge-file loads, vectorized rev lists)."""
        if len(rid) == 0:
            return Rope.EMPTY
        return Rope(leaf=_Cols(np.ascontiguousarray(rid, np.int32),
                               np.ascontiguousarray(ori, np.int8),
                               np.ascontiguousarray(off, np.int32)))

    def concat(self, other: "Rope") -> "Rope":
        if self.n == 0:
            return other
        if other.n == 0:
            return self
        return Rope(left=self, right=other)

    # -- access -------------------------------------------------------------
    def _leaves(self):
        parts = []
        stack = [self]
        while stack:
            r = stack.pop()
            if r._cols is not None:
                parts.append(r._cols)
            elif r.leaf is not None:
                parts.append(r.leaf)
            else:
                if r.right is not None:
                    stack.append(r.right)
                if r.left is not None:
                    stack.append(r.left)
        return parts

    def columns(self) -> _Cols:
        """Concatenated (rid, ori, off) columns — the CACHED accessor
        (9 B/item).  Tuple leaves convert transiently."""
        if self._cols is None:
            rid = np.empty(self.n, np.int32)
            ori = np.empty(self.n, np.int8)
            off = np.empty(self.n, np.int32)
            w = 0
            for p in self._leaves():
                m = len(p)
                if isinstance(p, _Cols):
                    rid[w:w + m] = p.rid
                    ori[w:w + m] = p.ori
                    off[w:w + m] = p.off
                else:
                    for i, (a, b, c) in enumerate(p):
                        rid[w + i] = a
                        ori[w + i] = b
                        off[w + i] = c
                w += m
            self._cols = _Cols(rid, ori, off)
        return self._cols

    def flat(self) -> Tuple:
        """Tuple-of-triples view — TRANSIENT (rebuilt per call, not
        cached); prefer columns()/iteration in anything hot."""
        c = self.columns()
        return tuple(zip(c.rid.tolist(), c.ori.tolist(), c.off.tolist()))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        c = self.columns()
        return (int(c.rid[i]), int(c.ori[i]), int(c.off[i]))

    def __iter__(self) -> Iterator:
        c = self.columns()
        return zip(c.rid.tolist(), c.ori.tolist(), c.off.tolist())

    def offset_prefix(self):
        """psum[i] = sum of offsets of items [0, i); length n+1
        (reference: Edge::getInnerOverlapSum, Edge.cpp:136-142)."""
        if self._psum is None:
            ps = np.zeros(self.n + 1, np.int64)
            np.cumsum(self.columns().off, out=ps[1:])
            self._psum = ps
        return self._psum

    def offset_sum(self, start: int, end: int) -> int:
        """Sum of inner offsets i in [start, min(end, n))."""
        ps = self.offset_prefix()
        end = min(end, self.n)
        if start >= end:
            return 0
        return int(ps[end] - ps[start])

    def first(self):
        """First triple without materializing (O(depth))."""
        r = self
        while r.leaf is None:
            r = r.left if (r.left is not None and r.left.n) else r.right
        if isinstance(r.leaf, _Cols):
            c = r.leaf
            return (int(c.rid[0]), int(c.ori[0]), int(c.off[0]))
        return r.leaf[0]


Rope.EMPTY = Rope(leaf=())


# ---------------------------------------------------------------------------
# orientation algebra (reference: Edge.cpp:496-527)
# ---------------------------------------------------------------------------
def is_mergeable_o(o1: int, o2: int) -> bool:
    return (o1 & 1) == ((o2 >> 1) & 1)


def merged_orient(o1: int, o2: int) -> int:
    return (o1 & 2) | (o2 & 1)


def twin_orient(o: int) -> int:
    return ((o >> 1) ^ 1) | (((o & 1) ^ 1) << 1)


# ---------------------------------------------------------------------------
# allocation-order model
# ---------------------------------------------------------------------------
class Alloc:
    """Serial numbers standing in for Edge heap addresses.  Fresh allocations
    get increasing serials; freed serials are reused LIFO (glibc tcache
    behavior for the fixed-size Edge chunks)."""
    __slots__ = ("next", "free")

    def __init__(self):
        self.next = 1
        self.free: List[int] = []

    def alloc(self) -> int:
        if self.free:
            return self.free.pop()
        a = self.next
        self.next += 1
        return a

    def dealloc(self, addr: int) -> None:
        self.free.append(addr)


# ---------------------------------------------------------------------------
# Edge
# ---------------------------------------------------------------------------
class Edge:
    """One direction of a bidirected overlap-graph edge.

    src/dst are 1-based read IDs; src_len/dst_len read lengths; orient 0..3
    (reference: Edge.h:51-55); offset the overlap offset from src start to
    dst start; inner the rope of (readID, orient1bit, offset) triples."""
    __slots__ = ("src", "dst", "src_len", "dst_len", "orient", "offset",
                 "inner", "inner_sum", "twin", "flags", "invalid", "flow",
                 "addr", "string")

    NOT_DEAD_END = 1
    LOOP = 2

    def __init__(self, alloc: Alloc, src: int, src_len: int, dst: int,
                 dst_len: int, orient: int, offset: int,
                 inner: Rope = Rope.EMPTY, flow: int = 0,
                 inner_sum: Optional[int] = None):
        self.src = src
        self.src_len = src_len
        self.dst = dst
        self.dst_len = dst_len
        self.orient = orient
        self.offset = offset
        self.inner = inner
        # running sum of inner offsets, kept O(1) across merges
        self.inner_sum = (inner.offset_sum(0, inner.n)
                          if inner_sum is None else inner_sum)
        self.twin: Optional["Edge"] = None
        # loop flag at construction (reference: Edge.cpp:46-47)
        self.flags = Edge.LOOP if src == dst else 0
        self.invalid = False
        self.flow = flow
        self.addr = alloc.alloc()
        self.string = None  # contig string buffer (bytearray) when loaded

    # -- flags --------------------------------------------------------------
    def is_loop(self) -> bool:
        return bool(self.flags & Edge.LOOP)

    def is_not_dead_end(self) -> bool:
        return bool(self.flags & Edge.NOT_DEAD_END)

    def mark_not_dead_end(self) -> None:
        # reference marks edge AND twin (Edge.h:105)
        self.flags |= Edge.NOT_DEAD_END
        self.twin.flags |= Edge.NOT_DEAD_END

    # -- geometry -----------------------------------------------------------
    def edge_length(self) -> int:
        return self.offset + self.dst_len

    def overlap_len(self) -> int:
        """Overlap length of the FIRST link (reference: Edge.cpp:127-134)."""
        if self.inner.n == 0:
            return self.src_len - self.offset
        return self.src_len - self.inner.first()[2]

    def first_offset(self) -> int:
        if self.inner.n == 0:
            return self.offset
        return self.inner.first()[2]

    def last_offset(self) -> int:
        """Offset of the final link (reference: Edge.cpp:145-151)."""
        if self.inner.n == 0:
            return self.offset
        return self.offset - self.inner_sum

    def is_smaller(self) -> bool:
        """reference: Edge.h isSmallerEdge (pointer tie-break on loops)."""
        if self.src < self.dst:
            return True
        if self.src > self.dst:
            return False
        return self.addr < self.twin.addr

    # -- identity (operator==, Edge.cpp:607-643) ----------------------------
    def same_as(self, other: "Edge") -> bool:
        if (self.src != other.src or self.dst != other.dst
                or self.offset != other.offset or self.orient != other.orient):
            return False
        a, b = self.inner, other.inner
        if a.n != b.n:
            return False
        if a.n == 0:
            return True
        return bool(np.array_equal(a.columns().rid, b.columns().rid))

    def __repr__(self):
        return (f"Edge({self.src}->{self.dst} o{self.orient} off{self.offset}"
                f" n{self.inner.n}{' L' if self.is_loop() else ''})")


def make_twin_pair(alloc: Alloc, src: int, src_len: int, dst: int,
                   dst_len: int, orient: int, offset: int,
                   flow: int = 0) -> Edge:
    """Simple (non-composite) edge + its reverse
    (reference: EdgeSimple::make_nonComposite_reverseEdge, EdgeSimple.cpp:107).
    Returns the forward edge (allocated FIRST, like the C++ `new` order)."""
    fwd = Edge(alloc, src, src_len, dst, dst_len, orient, offset)
    rev = Edge(alloc, dst, dst_len, src, src_len, twin_orient(orient),
               dst_len + offset - src_len, flow=flow)
    fwd.flow = flow
    fwd.twin = rev
    rev.twin = fwd
    return fwd


def merge_inner(e1: Edge, e2: Edge) -> Rope:
    """Inner list of merged edge e1+e2: e1.inner ++ [shared node] ++ e2.inner
    (reference: mergeList, Edge.cpp:381-409). The shared node's orientation is
    e1.orient&1 and its offset is e1's last overlap offset."""
    mid = Rope.of([(e1.dst, e1.orient & 1, e1.last_offset())])
    return e1.inner.concat(mid).concat(e2.inner)


def add_edges(alloc: Alloc, e1: Edge, e2: Edge) -> Edge:
    """Merge two mergeable edges into a new composite pair
    (reference: Add + merge_forward_edges, Edge.cpp:334-376).  Allocation
    order: forward edge first, then reverse."""
    assert e1.dst == e2.src and is_mergeable_o(e1.orient, e2.orient)
    fwd = Edge(alloc, e1.src, e1.src_len, e2.dst, e2.dst_len,
               merged_orient(e1.orient, e2.orient),
               e1.offset + e2.offset, inner=merge_inner(e1, e2),
               inner_sum=e1.offset + e2.inner_sum)
    rev = Edge(alloc, e2.twin.src, e2.twin.src_len, e1.twin.dst,
               e1.twin.dst_len, merged_orient(e2.twin.orient, e1.twin.orient),
               e2.twin.offset + e1.twin.offset,
               inner=merge_inner(e2.twin, e1.twin),
               inner_sum=e2.twin.offset + e1.twin.inner_sum)
    fwd.twin = rev
    rev.twin = fwd
    return fwd


def copy_pair(alloc: Alloc, e: Edge) -> Edge:
    """Copy an edge and its twin (reference: Edge copy ctor, Edge.cpp:92-98:
    the copy is allocated first, then its reverse).  Flags/invalid copied."""
    c = Edge(alloc, e.src, e.src_len, e.dst, e.dst_len, e.orient, e.offset,
             inner=e.inner, flow=e.flow, inner_sum=e.inner_sum)
    c.flags = e.flags
    c.invalid = e.invalid
    t = e.twin
    ct = Edge(alloc, t.src, t.src_len, t.dst, t.dst_len, t.orient, t.offset,
              inner=t.inner, flow=t.flow, inner_sum=t.inner_sum)
    ct.flags = t.flags
    ct.invalid = t.invalid
    c.twin = ct
    ct.twin = c
    return c


def free_pair(alloc: Alloc, e: Edge) -> None:
    """Model `delete e->getReverseEdge(); delete e;` — twin freed first
    (matches the reference's removeEdge/cleanup order)."""
    alloc.dealloc(e.twin.addr)
    alloc.dealloc(e.addr)


# ---------------------------------------------------------------------------
# ordered node table (std::map emulation)
# ---------------------------------------------------------------------------
class NodeMap:
    """map<UINT64, vector<Edge*>> with key-ordered iteration that behaves
    like std::map iterators: inserting a key > current position makes it
    visible later in the same sweep; erasing the current key advances.

    The sorted key list is maintained LAZILY: inserts append (O(1)) and
    erases only count, with compaction (one sort / rebuild from the dict)
    deferred to the next ordered access — bulk graph loads and phase-wise
    mutate-then-sweep patterns each pay one O(n log n) sort instead of the
    O(n^2) memmove of per-insert insort/per-erase del."""
    __slots__ = ("d", "_keys", "_dirty", "_nstale")

    def __init__(self):
        self.d = {}           # key -> list[Edge]
        self._keys: List[int] = []  # sorted iff not _dirty; may hold stale
        self._dirty = False   # appended keys not yet sorted in
        self._nstale = 0      # erased keys still present in _keys

    def _compact(self) -> None:
        self._keys = sorted(self.d)
        self._dirty = False
        self._nstale = 0

    @property
    def keys(self) -> List[int]:
        """Live keys in sorted order (compacts if needed)."""
        if self._dirty or self._nstale:
            self._compact()
        return self._keys

    def __contains__(self, k) -> bool:
        return k in self.d

    def __len__(self) -> int:
        return len(self.d)

    def get(self, k) -> Optional[List[Edge]]:
        return self.d.get(k)

    def at(self, k) -> List[Edge]:
        return self.d[k]

    def ensure(self, k) -> List[Edge]:
        lst = self.d.get(k)
        if lst is None:
            lst = []
            self.d[k] = lst
            self._keys.append(k)
            self._dirty = True
        return lst

    def erase(self, k) -> None:
        del self.d[k]
        self._nstale += 1

    def iter_from(self, k: Optional[int] = None) -> Iterator[int]:
        """Iterate live keys in order starting at the first key >= k (or
        the smallest).  Tolerates insert/erase during iteration: each step
        re-bisects (and re-sorts if a key was inserted mid-sweep), exactly
        like advancing a std::map iterator."""
        cur = None
        while True:
            if self._dirty:
                self._compact()
            elif self._nstale * 2 > len(self._keys):
                self._compact()
            ks = self._keys
            if cur is None:
                i = 0 if k is None else bisect_left(ks, k)
            else:
                i = bisect_right(ks, cur)
            while i < len(ks) and ks[i] not in self.d:  # skip stale
                i += 1
            if i >= len(ks):
                return
            cur = ks[i]
            yield cur

    def __iter__(self) -> Iterator[int]:
        return self.iter_from(None)
