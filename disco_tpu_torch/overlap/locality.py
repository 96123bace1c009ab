"""Overlap-locality read relabeling (host side; the counterpart of
disco_tpu/overlap/locality.py, the same permutation).

Overlapping reads are genome neighbors, so a BFS layout over the candidate
graph gives overlapping reads adjacent labels.  Under that relabeling the
r2 rows of the r1-sorted candidate stream fall in narrow per-tile bands,
which lets the verify kernel fetch both rows of every pair from the table
(fused_kernel.verify_windows_fused_mxu_both16) with neighbouring pairs on
neighbouring rows.

Cost: one CSR build + BFS over the candidate pairs, O(pairs), in a Python
loop (a faster BFS must give the identical permutation); the relabeling
permutes the packed row table once.
"""
from collections import deque

import numpy as np

__all__ = ["bfs_labels", "relabel_workload"]


def bfs_labels(n_reads: int, r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """BFS order over the undirected candidate graph, component by
    component (neighbor order = ascending read id, seeds = ascending).
    Returns label: old read id -> new label (a permutation of 0..n-1)."""
    src = np.concatenate([r1, r2]).astype(np.int64)
    dst = np.concatenate([r2, r1]).astype(np.int64)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    starts = np.searchsorted(src, np.arange(n_reads + 1))
    label = np.full(n_reads, -1, np.int64)
    nxt = 0
    for seed in range(n_reads):
        if label[seed] >= 0:
            continue
        dq = deque([seed])
        label[seed] = nxt
        nxt += 1
        while dq:
            u = dq.popleft()
            for v in dst[starts[u]:starts[u + 1]]:
                if label[v] < 0:
                    label[v] = nxt
                    nxt += 1
                    dq.append(v)
    return label


def relabel_workload(n_reads: int, packed_all: np.ndarray, r1: np.ndarray,
                     rows2: np.ndarray, *arrays):
    """Relabel a verify workload for the both-sides-fetch kernel.

    packed_all: (2N, W) rows [fwd x N | rc x N]; r1: (P,) read ids of the
    sorted side; rows2: (P,) packed row ids (read + rc * N).  Returns
    (packed_relab, new_rows1, new_rows2, perm, label, *arrays[perm]) where
    packed_relab interleaves fwd/rc per NEW label (row = 2*label + rc) and
    perm re-sorts pairs by new r1 label (stable, preserving the window
    scan's tie order)."""
    r1 = np.asarray(r1, np.int64)
    rows2 = np.asarray(rows2, np.int64)
    r2 = rows2 % n_reads
    rc2 = rows2 // n_reads
    label = bfs_labels(n_reads, r1, r2)
    # interleaved relabeled table: row 2*label+o <- read with that label
    inv = np.empty(n_reads, np.int64)
    inv[label] = np.arange(n_reads)
    packed_relab = np.empty((2 * n_reads, packed_all.shape[1]),
                            packed_all.dtype)
    packed_relab[0::2] = packed_all[:n_reads][inv]
    packed_relab[1::2] = packed_all[n_reads:][inv]
    nrows1 = 2 * label[r1]
    nrows2 = 2 * label[r2] + rc2
    perm = np.argsort(nrows1, kind="stable")
    out = [packed_relab, nrows1[perm].astype(np.int32),
           nrows2[perm].astype(np.int32), perm, label]
    out.extend(np.asarray(a)[perm] for a in arrays)
    return tuple(out)
