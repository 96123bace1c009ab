"""Walls, peak device memory and superstep device time of the distributed
buildG of one checkout, on one CUDA card: two checkouts (a change and its
parent) are compared by running this once for each, in turns, each in its
own process.

    python disco_tpu_torch/tools/dist_walls.py --fasta reads.fasta
        [--root CHECKOUT] [--cfg tests/golden/thresh146/cfg.cfg]
        [--shards 4] [--supersteps 3]

`disco_tpu_torch` is imported from --root (default: the checkout that
holds this file).  With no profiler running and the peak device memory
reset before each, it runs `buildg -pe FASTA -p CFG -w 20000 -n SHARDS
-rma` and then the same without -rma, through the package's command line,
and keeps each run's wall, `clock` stages, peak device memory and the MD5
of its graph files.  Then, for each engine, it runs the first superstep of
the whole read set once and the next --supersteps under torch.profiler,
pulling each to the host as the builder does: the union of the card's
kernel intervals (kernel_s) and of its kernel and copy intervals
(busy_s) over the wall.  Prints one JSON line.  The shards share the one
card (`make_mesh`); without a card it raises."""
import argparse
import hashlib
import json
import logging
import pathlib
import subprocess
import sys
import tempfile
import time

GRAPH = ("_0_parGraph.txt", "_0_containedReads.txt", "_0_startRead.txt")


class _Stages(logging.Handler):
    """The (stage, seconds) records of utils.logging.clock."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.walls = []

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("<<<"):
            self.walls.append((record.args[0], float(record.args[1])))


def _union_s(spans):
    """Seconds covered by (start_us, end_us) intervals, overlaps once."""
    busy, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    return busy / 1e6


def _supersteps(fasta, min_ovl, n_shards, n_profiled):
    """{engine: {wall_s, kernel_s, busy_s}} of supersteps 1 .. n_profiled
    of the whole set (superstep 0 run once before, unprofiled)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from disco_tpu_torch.dist import builder
    from disco_tpu_torch.dist.mesh import gather_host, make_mesh
    from disco_tpu_torch.dist.overlap_shard import (PAD_KEY,
                                                    DistMemOverlapEngine,
                                                    ShardedOverlapEngine)
    from disco_tpu_torch.index.table import FingerprintTable
    from disco_tpu_torch.io.readstore import ReadStore
    from disco_tpu_torch.overlap.relation import window_codes

    store = ReadStore.from_files([str(fasta)], [], min_ovl)
    table = FingerprintTable.build(store, min_ovl - 1)
    qread, qj, qcode = window_codes(store, table.k)
    hit_cap, chunk, route_cap = builder.chunk_plan(
        table, len(qread), n_shards, None, 1 << 25)
    marked = np.zeros(store.n_reads + (-store.n_reads) % n_shards, np.int32)
    mesh = make_mesh(n_shards)

    def chunks(step, first, last):
        for c in range(first, last):
            sl = slice(c * chunk, (c + 1) * chunk)
            pad = chunk - len(qread[sl])
            out = step(np.pad(qread[sl], (0, pad)),
                       np.pad(qj[sl], (0, pad), constant_values=-1),
                       np.pad(qcode[sl], (0, pad), constant_values=PAD_KEY),
                       marked)
            for g in out[:6]:
                gather_host(mesh, g)

    n_chunks = -(-len(qread) // chunk)
    last = min(1 + n_profiled, n_chunks)
    res = {}
    for name, engine in (("rma", DistMemOverlapEngine),
                         ("replicated", ShardedOverlapEngine)):
        eng = engine.build(store, table, mesh, hit_cap=hit_cap,
                           route_cap=route_cap, prune_marked=True)
        step = (eng.make_step(store, q_chunk=chunk)[0]
                if engine is DistMemOverlapEngine else eng.make_step(store))
        chunks(step, 0, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunks(step, 1, last)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = [(ev.time_range.start, ev.time_range.end, ev.name)
                 for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA]
        if not spans:
            raise RuntimeError(f"{name}: the profiled supersteps ran "
                               "nothing on the card")
        kernels = [s[:2] for s in spans if not s[2].startswith("Memcpy")
                   and not s[2].startswith("Memset")]
        res[name] = {"supersteps": last - 1, "wall_s": wall,
                     "kernel_s": _union_s(kernels),
                     "busy_s": _union_s([s[:2] for s in spans])}
        del step, eng
        torch.cuda.empty_cache()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = pathlib.Path(__file__).resolve().parents[2]
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--cfg", default=str(here / "tests" / "golden" /
                                         "thresh146" / "cfg.cfg"))
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--supersteps", type=int, default=3)
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("dist_walls measures a CUDA card; none is visible")
    from disco_tpu_torch import cli

    fasta = str(pathlib.Path(args.fasta).resolve())
    stages = _Stages()
    log = logging.getLogger("disco_tpu_torch")
    log.addHandler(stages)
    log.setLevel(logging.INFO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"root": str(root), "card": card.strip(), "runs": {}}
    with tempfile.TemporaryDirectory(prefix="dist_walls_") as tmp:
        for name, extra in (("rma", ["-rma"]), ("replicated", [])):
            prefix = f"{tmp}/{name}"
            stages.walls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = cli.main(["buildg", "-pe", fasta, "-f", prefix, "-p",
                           args.cfg, "-w", "20000", "-n", str(args.shards),
                           *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"buildg -n {args.shards} {extra} exited "
                                   f"{rc}")
            out["runs"][name] = {
                "wall_s": wall, "stages": dict(stages.walls),
                "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                "md5": {s: hashlib.md5(pathlib.Path(prefix + s).read_bytes())
                        .hexdigest() for s in GRAPH}}
    out["supersteps"] = _supersteps(fasta, cli._cfg_min_overlap(args.cfg),
                                    args.shards, args.supersteps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
