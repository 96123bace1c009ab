"""Parity replay of the reference's graph-construction traversal (host
copy of disco_tpu/buildg/replay.py, without its pure-Python traversal
oracle; the traversal runs in native/src/replay.cpp).

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
from typing import List, Tuple

import numpy as np

from ..io.readstore import ReadStore
from ..overlap.relation import OverlapRelation

# hit orientation -> edge orientation (reference: OverlapGraph.cpp:660-666)
_EDGE_ORIENT = (3, 0, 2, 1)


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
    Returns (par_blob, start_blob, chunk_ends)."""
    from .. import native
    n = store.n_reads
    all_marked = (superread[:n + 1] != 0).astype(np.uint8)
    if premarked is not None:
        all_marked |= premarked
    all_marked[0] = 1
    return native.graph_replay(n, k, write_par_graph_size, starts,
                               ej, er2, eo, store.lengths,
                               store.file_index, all_marked,
                               start_read=start_read)


def build_graph_replay_native(rel: OverlapRelation, store: ReadStore,
                              superread: np.ndarray,
                              write_par_graph_size: int = 1000,
                              start_read: int = 1,
                              premarked: "np.ndarray | None" = None):
    """Native (C++) replay of the reference's traversal (disco_tpu's
    build_graph_replay is its Python oracle).  Returns (par_blob, start_blob,
    chunk_ends): the parGraph content (from `start_read` on, for appending
    on restart), the _startRead.txt content, and the valid kill offsets."""
    from .. import native
    n = store.n_reads
    contained = (superread[:n + 1] != 0).astype(np.uint8)
    starts, ej, er2, eo = native.edge_hit_groups(
        rel.r1, rel.j, rel.r2, rel.orient, rel.edge_ok, contained, n)
    return graph_replay_from_groups(store, rel.k, starts, ej, er2, eo,
                                    superread, write_par_graph_size,
                                    start_read=start_read,
                                    premarked=premarked)
