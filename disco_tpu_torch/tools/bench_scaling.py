"""Weak-scaling walls and the exchange-volume model of the sharded overlap
superstep (the counterpart of tools/bench_scaling.py; the distributed
buildG of dist/builder.py).

    python -m disco_tpu_torch.tools.bench_scaling [--shards 1,2,4,8]
        [--dist-mem] [--budget N] [--device cuda]

Per shard count n: a read set with a fixed window load a shard, the
chunked sharded relation run once to build the kernels and warm the card,
then once timed; one JSON line each with the supersteps, the wall a
superstep, the bytes a shard moves through the collectives a superstep,
computed from the engine's buffer shapes (`superstep_bytes`, disco_tpu's
model unchanged), and the candidate pairs a shard checks a superstep.

One-card caveat: all n shards run on the one card named by --device, one
after another between the collectives, and an exchange is a copy inside
the card's memory.  So the walls show whether the work a shard stays flat
as n grows (no serial part that grows with n); they cannot show a speed-up
from more cards, nor NVLink or NCCL times.  `nvlink_s` is a model: the
bytes a superstep over 450 GB/s, one direction of an H100's NVLink (NVIDIA's
data sheet).  Without a CUDA card the tool raises.

Reference being modelled: the RMA traffic of
src/BuildGraphMPIRMA/src/OverlapGraph.cpp:388 (per-probe MPI_Get), replaced
by bulk-synchronous all_to_all rounds."""
import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..bench_verify import cuda_device
from ..dist import builder
from ..dist.mesh import Mesh
from ..dist.overlap_shard import fetch_cap_for
from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..overlap.relation import window_codes

NVLINK_BYTES_PER_S = 450e9   # H100 NVLink, one direction


def superstep_bytes(n_dev, chunk, route_cap, hit_cap, n_reads, wp,
                    dist_mem, fetch_cap):
    """Per-shard bytes moved through collectives in one superstep, from the
    static buffer shapes in dist/overlap_shard.py (send + receive)."""
    per_dev = chunk // n_dev
    # marked all_gather: int32 mask, receive (n-1)/n of N words
    b = 4 * n_reads
    # codes route: (n, route_cap) uint64 + bool, both directions
    b += 2 * n_dev * route_cap * 9
    # hit grids back: read/orient/typ int32 + valid bool
    b += 2 * n_dev * route_cap * hit_cap * 13
    if dist_mem:
        # fetch exchange: requests int32 out, rows (wp words) back, x2 dirs
        b += 2 * n_dev * fetch_cap * (4 + 4 * wp)
    return b, per_dev


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def read_set(n_shards, windows_per_shard, read_len, min_overlap):
    """disco_tpu's weak-scaling set: reads from one random genome, about
    `windows_per_shard` windows a shard."""
    wins_per_read = read_len - (min_overlap - 1)
    n_reads = max(64, (n_shards * windows_per_shard) // wins_per_read)
    rng = np.random.default_rng(11)
    glen = max(2000, n_reads * 3)
    genome = "".join(rng.choice(list("ACGT"), glen))
    seqs = []
    for _ in range(n_reads):
        s = int(rng.integers(0, glen - read_len))
        seqs.append(genome[s:s + read_len])
    store = ReadStore.from_sequences(seqs)
    return store, FingerprintTable.build(store, min_overlap - 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", default="1,2,4,8")
    ap.add_argument("--windows-per-shard", type=int, default=120_000)
    ap.add_argument("--read-len", type=int, default=120)
    ap.add_argument("--min-overlap", type=int, default=40)
    ap.add_argument("--dist-mem", action="store_true")
    ap.add_argument("--budget", type=int, default=1 << 21,
                    help="superstep budget (words), so that a run takes "
                         "several supersteps")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card all shards run on")
    args = ap.parse_args(argv)
    device = cuda_device(args.device)
    card = card_line()

    for n in [int(x) for x in args.shards.split(",")]:
        store, table = read_set(n, args.windows_per_shard, args.read_len,
                                args.min_overlap)
        mesh = Mesh([device] * n)
        q = len(window_codes(store, table.k)[0])
        hit_cap, chunk, route_cap = builder.chunk_plan(
            table, q, n, None, args.budget)
        fetch_cap = (fetch_cap_for(chunk, n, hit_cap) if args.dist_mem
                     else 0)
        walls = []
        for _ in range(2):      # the first run builds and warms
            stats = {}
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            builder.sharded_relation(store, table, mesh, budget=args.budget,
                                     dist_mem=args.dist_mem, stats=stats)
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
        nbytes, per_dev = superstep_bytes(
            n, chunk, route_cap, hit_cap, store.n_reads,
            store.packed.shape[1], args.dist_mem, fetch_cap)
        pairs = per_dev * hit_cap
        steps = max(stats["chunks"], 1)
        print(json.dumps({
            "n_shards": n, "card": card, "windows": q, "chunk": chunk,
            "supersteps": stats["chunks"],
            "fallback_chunks": stats["fallback_chunks"],
            "route_cap": route_cap, "hit_cap": hit_cap,
            "fetch_cap": fetch_cap, "wall_first_s": walls[0],
            "wall_s": walls[1],
            "wall_per_superstep_ms": 1e3 * walls[1] / steps,
            "bytes_per_shard_per_superstep": nbytes,
            "pairs_per_shard_per_superstep": pairs,
            "comm_bytes_per_pair": nbytes / max(pairs, 1),
            "nvlink_s_per_superstep": nbytes / NVLINK_BYTES_PER_S,
        }), flush=True)


if __name__ == "__main__":
    main()
