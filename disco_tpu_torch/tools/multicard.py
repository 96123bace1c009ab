"""The distributed buildG on every visible CUDA card, both ways the port
runs it: one process per rank over NCCL (`python -m
disco_tpu_torch.dist.multiproc`, one card a rank) and one process holding
a shard on each card (`buildg -n N`, dist/mesh.py's round-robin), each in
both modes (`-rma`, replicated), against the native buildG's files.

    python -m disco_tpu_torch.tools.multicard --fasta reads.fasta
        [--cfg tests/golden/thresh146/cfg.cfg]

Its ranks and shards are the visible cards; `CUDA_VISIBLE_DEVICES` picks
them.

Every rank runs through `RANK_LAUNCHER`, which prints what a rank alone
can tell after `multiproc.main` returns: its launch counts (they are per
process), the bytes it receives from its peers through each collective
(the kept rows' and their counts' gathers apart) and the seconds it spends in each (the card
synchronised before and after every call, so the ranks lose the overlap
of an exchange with earlier work), its chunks, `clock` stages, wall and
peak device memory.  Prints one JSON line: the card lines of `nvidia-smi`, the
native wall, and each run's wall, stages, bytes a superstep, launches and
peak device memory a card.  Without a card it raises."""
import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
GRAPH = ("_0_parGraph.txt", "_0_containedReads.txt", "_0_startRead.txt",
         "_ReadIDMap.txt", "_CheckpointInfo.txt")
# One rank of `python -m disco_tpu_torch.dist.multiproc` (its arguments
# follow), printing one "RANK {json}" line after main returns.
RANK_LAUNCHER = """
import json, logging, sys, time
import torch
import torch.distributed as dist
from disco_tpu_torch.dist import builder, multiproc
from disco_tpu_torch.overlap import fused_kernel as fk
from disco_tpu_torch.tools import exp_k1_rows_designs as k1d

rec = {"all_to_all": 0, "all_gather": 0, "collect": 0, "all_to_all_s": 0.0,
       "all_gather_s": 0.0, "stages": []}


class Stages(logging.Handler):
    def emit(self, r):
        if isinstance(r.msg, str) and r.msg.startswith("<<<"):
            rec["stages"].append((r.args[0], float(r.args[1])))


log = logging.getLogger("disco_tpu_torch")
log.addHandler(Stages())
log.setLevel(logging.INFO)


def from_peers(nbytes):
    return nbytes * (dist.get_world_size() - 1) // dist.get_world_size()


def counted(name, key):
    real = getattr(dist, name)

    def call(out, *a, **kw):
        rec[key] += from_peers(out.numel() * out.element_size())
        # the card synchronised on both sides: the seconds in the exchange,
        # waiting for the slowest peer included
        sync = torch.cuda.synchronize if out.is_cuda else (lambda: None)
        sync()
        t = time.perf_counter()
        res = real(out, *a, **kw)
        sync()
        rec[key + "_s"] += time.perf_counter() - t
        return res
    setattr(dist, name, call)


counted("all_to_all_single", "all_to_all")
counted("all_gather_into_tensor", "all_gather")
real_gather_host, real_relation = (builder.gather_host,
                                   builder.sharded_relation_pruned)


def gather_host(mesh, xs):
    out = real_gather_host(mesh, xs)
    rec["collect"] += from_peers(out.nbytes)
    return out


def relation(*a, **kw):
    out = real_relation(*a, **kw)
    rec["stats"] = out[0].stats
    return out


builder.gather_host = gather_host
builder.sharded_relation_pruned = relation
t0 = time.perf_counter()
rc = multiproc.main(sys.argv[1:])
torch.cuda.synchronize()
rec.update(wall=time.perf_counter() - t0,
           rows=fk.fused_compare_dual_rows.launches,
           columns=fk.fused_compare_dual.launches,
           k2=fk.fused_compare_dual_fetch.launches,
           designs=k1d.design.launches,
           peak=torch.cuda.max_memory_allocated())
print("RANK " + json.dumps(rec), flush=True)
multiproc.exit_rank(rc)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(n: int, out: pathlib.Path, argv, cwd, backend=None,
                 timeout: float = 600, env=None):
    """n processes of RANK_LAUNCHER (`argv` after the rank's own flags),
    rank r writing its files under out/r<r>/ and its output to
    out/r<r>.log, on a free port of 127.0.0.1.  Returns (each rank's exit
    code and output, the ranks' prefixes).  A rank still running after
    `timeout` seconds raises TimeoutError; every rank still running is
    killed on the way out."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(ROOT) + ":" + env.get("PYTHONPATH", "")
    port = free_port()
    prefixes, procs, logs = [], [], []
    try:
        for r in range(n):
            (out / f"r{r}").mkdir(parents=True)
            prefixes.append(out / f"r{r}" / "E")
            logs.append(open(out / f"r{r}.log", "w+"))
            back = ["--dist-backend", backend] if backend else []
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_LAUNCHER, "--coordinator",
                 f"127.0.0.1:{port}", "--num-processes", str(n),
                 "--process-id", str(r), *back, "-f", str(prefixes[r]),
                 *argv], cwd=cwd, env=env, stdout=logs[r],
                stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"a rank ran past {timeout} s") from None
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
        return [(p.returncode, o) for p, o in zip(procs, outs)], prefixes
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def rank_records(results):
    """Each rank's RANK record; raises unless every rank exited 0 and
    printed one."""
    recs = []
    for r, (rc, out) in enumerate(results):
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        if rc != 0 or len(lines) != 1:
            raise RuntimeError(f"rank {r} exited {rc}:\n{out[-3000:]}")
        recs.append(json.loads(lines[0][5:]))
    return recs


def differing_files(prefix, want_prefix, suffixes=GRAPH):
    """The suffixes whose files differ between the two prefixes."""
    return [s for s in suffixes
            if pathlib.Path(f"{prefix}{s}").read_bytes()
            != pathlib.Path(f"{want_prefix}{s}").read_bytes()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--cfg", default=str(ROOT / "tests" / "golden" /
                                         "thresh146" / "cfg.cfg"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("multicard measures CUDA cards; none is visible")
    n = torch.cuda.device_count()
    from disco_tpu_torch import cli
    from disco_tpu_torch.buildg.pipeline import run_buildg

    fasta = str(pathlib.Path(args.fasta).resolve())
    min_ovl = cli._cfg_min_overlap(args.cfg)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    res = {"cards": cards, "ranks": n, "runs": {}}
    with tempfile.TemporaryDirectory(prefix="multicard_") as d:
        tmp = pathlib.Path(d)
        t0 = time.perf_counter()
        run_buildg([fasta], [], str(tmp / "native"), min_overlap=min_ovl,
                   write_par_graph_size=20000, backend="native")
        res["native_s"] = time.perf_counter() - t0
        for extra in (["-rma"], []):
            mode = "rma" if extra else "replicated"
            # one process per rank, one card each, over NCCL
            t0 = time.perf_counter()
            results, prefixes = launch_ranks(
                n, tmp / f"mp_{mode}", ["-pe", fasta, "-m-ovl",
                                        str(min_ovl), "-w", "20000", *extra],
                tmp)
            wall = time.perf_counter() - t0
            recs = rank_records(results)
            chunks = recs[0]["stats"]["chunks"]
            res["runs"][f"multiproc_{mode}"] = {
                "wall_s": wall, "files_differ": differing_files(
                    prefixes[0], tmp / "native"),
                "others_wrote": [r for r, p in enumerate(prefixes)
                                 if r and list(p.parent.iterdir())],
                "chunks": chunks, "stages": recs[0]["stages"],
                "ranks": [{k: rec[k] for k in (
                    "wall", "rows", "columns", "k2", "designs", "peak")}
                    | {f"{k}_per_superstep": rec[k] / chunks for k in (
                        "all_to_all", "all_gather", "collect")}
                    | {k: rec[k] for k in ("all_to_all_s", "all_gather_s")}
                    for rec in recs]}
            # one process, a shard on each card
            torch.cuda.synchronize()
            for c in range(n):
                torch.cuda.reset_peak_memory_stats(c)
            t0 = time.perf_counter()
            rc = cli.main(["buildg", "-pe", fasta, "-f",
                           str(tmp / f"one_{mode}"), "-p", args.cfg, "-w",
                           "20000", "-n", str(n), *extra])
            torch.cuda.synchronize()
            res["runs"][f"mesh_{mode}"] = {
                "rc": rc, "wall_s": time.perf_counter() - t0,
                "files_differ": differing_files(tmp / f"one_{mode}",
                                           tmp / "native"),
                "peak": [torch.cuda.max_memory_allocated(c)
                         for c in range(n)]}
            torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    bad = {k: v["files_differ"] for k, v in res["runs"].items()
           if v["files_differ"] or v.get("others_wrote") or v.get("rc")}
    if bad:
        raise RuntimeError(f"runs differ from the native buildG: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
