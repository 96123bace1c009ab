"""Overlap-locality analysis (the counterpart of tools/exp_locality.py): if
reads are renumbered by a BFS over the candidate graph, do the read2 rows
of the read1-sorted candidate stream fall in narrow per-tile spans, so that
both sides of a verify pair can come from a staged window?

    python -m disco_tpu_torch.tools.exp_locality [--device cuda]

Prints per-tile span percentiles of read1 and read2 rows under the
original order and under the BFS relabel (`bfs_order`, `tile_stats`: the
tool's functions, copied exactly), and the share of pairs that would fall
outside a read2 window of 256, 512 and 1024 rows at the tile's median.
The BFS runs on the host; the window shares are counted on the card
(`spill_percent`) over the whole candidate stream.  --device must name a
CUDA device."""
import argparse
import sys
import time
from collections import deque

import numpy as np
import torch

from ..bench_verify import cuda_device
from ..overlap.fused_kernel import TILE
from .exp_fetch_variants import bench_batch


def bfs_order(n_reads: int, r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """Label reads by BFS over the candidate graph (component by
    component, neighbor order = read id).  Returns perm: old id -> new id.
    Linear-ish time via CSR adjacency."""
    # symmetrize
    src = np.concatenate([r1, r2])
    dst = np.concatenate([r2, r1])
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


def tile_stats(rows: np.ndarray, tile=TILE):
    nt = len(rows) // tile
    t = rows[:nt * tile].reshape(nt, tile)
    spans = t.max(axis=1) - t.min(axis=1)
    return {p: int(np.percentile(spans, p)) for p in (50, 90, 99, 100)}


def spill_percent(rows2: torch.Tensor, wb: int) -> float:
    """Percent of the pairs of whole tiles whose read2 row falls outside the
    tile's window of wb rows: the window starts at the tile's median row
    less wb // 2, rounded down to a multiple of 64 and at least 0 (the
    tool's accounting; numpy's median of an even tile is the mean of its two
    middle rows, cut to an integer).  rows2: (P,) int64 on any device."""
    nt = rows2.numel() // TILE
    t2 = rows2[:nt * TILE].reshape(nt, TILE)
    mid = t2.sort(dim=1).values[:, TILE // 2 - 1:TILE // 2 + 1]
    med = mid.sum(dim=1) // 2
    base = ((med - wb // 2) & ~63).clamp(min=0)[:, None]
    inside = (t2 >= base) & (t2 < base + wb)
    return 100 * (1 - int(inside.sum()) / inside.numel())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda)")
    args = ap.parse_args(argv)
    device = cuda_device(args.device)
    store, r1, rows2, *_ = bench_batch()
    nreads = store.n_reads
    r1 = np.asarray(r1, np.int64)
    rows2 = np.asarray(rows2, np.int64)
    r2 = rows2 % nreads            # undo the rc-row offset
    rc = rows2 // nreads
    print(f"device {torch.cuda.get_device_name(device)}; "
          f"reads={nreads} pairs={len(r1)}")

    print("original order:")
    print("  r1 tile spans (rows):", tile_stats(2 * r1))
    print("  r2 tile spans (rows):", tile_stats(2 * r2))

    t0 = time.time()
    label = bfs_order(nreads, r1, r2)
    print(f"BFS relabel: {time.time() - t0:.2f}s")

    # relabeled packed-row ids: row = 2*newlabel + rc  (fwd/rc interleaved)
    nr1 = label[r1]
    nrows2 = 2 * label[r2] + rc
    order = np.argsort(nr1, kind="stable")
    nr1s = 2 * nr1[order]
    nrows2s = nrows2[order]
    print("BFS relabeled (pairs sorted by new r1):")
    print("  r1 tile spans (rows):", tile_stats(nr1s))
    print("  r2 tile spans (rows):", tile_stats(nrows2s))

    on_card = torch.from_numpy(nrows2s).to(device)
    for wb in (256, 512, 1024):
        print(f"  b-window {wb} rows: spill "
              f"{spill_percent(on_card, wb):.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
