"""The distributed buildG at the size its users run, by hand: `buildg -n 4
[-rma]` and the native buildG on one read set of tools/make_testdata.py
(250 bp pairs, 500 bp insert, seed 99, MinOverlap 30), by default the JAX
package's verified set (100 Mb genome, 25x: 10,000,000 reads, 2.21e9
windows).

    python -m disco_tpu_torch.tools.dist_scale [--genome-len N]
        [--coverage C] [--runs rma,native,replicated]

Each run is `buildg` of the port's command line in a fresh process
(`bench_e2e.run_child`), in the order given: `native` (`-backend native`),
`rma` (`-n 4 -rma`), `replicated` (`-n 4`), `device` (`-backend device`).
Prints one JSON line: the card, the seconds the reads took to make, and by
run its wall and what its child reported (stages, peak RSS, launches, peak
device memory, relation stats, the distributed relation's chunk plan and
host seconds by stage), and whether every file each run wrote equals the
first run's (`same_as_first`, by suffix).  The distributed and device runs
need a CUDA card: without one the tool exits non-zero before it makes any
data."""
import argparse
import filecmp
import json
import pathlib
import subprocess
import sys
import tempfile
import time

from .bench_e2e import ROOT, run_child

RUNS = {"native": ["-backend", "native"], "rma": ["-n", "4", "-rma"],
        "replicated": ["-n", "4"], "device": ["-backend", "device"]}
SEED, MIN_OVERLAP = 99, 30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-len", type=int, default=100_000_000)
    ap.add_argument("--coverage", type=int, default=25)
    ap.add_argument("--runs", default="rma,native,replicated")
    args = ap.parse_args(argv)
    runs = args.runs.split(",")
    if any(r not in RUNS for r in runs):
        sys.exit(f"dist_scale: runs are {', '.join(RUNS)}")
    card = None
    if set(runs) != {"native"}:
        import torch
        if not torch.cuda.is_available():
            sys.exit("dist_scale: the distributed and device runs need a "
                     "CUDA card (torch.cuda.is_available() is false)")
        card = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as td:
        fasta = str(pathlib.Path(td) / "reads.fasta")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, str(ROOT / "tools" / "make_testdata.py"), fasta,
             "--genome-len", str(args.genome_len), "--coverage",
             str(args.coverage), "--read-len", "250", "--insert", "500",
             "--seed", str(SEED)], check=True, stdout=subprocess.DEVNULL)
        out = {"bench": "dist_scale", "genome_len": args.genome_len,
               "coverage": args.coverage, "card": card,
               "data_s": time.perf_counter() - t0, "runs": {}}
        first = None
        for name in runs:
            prefix = str(pathlib.Path(td) / name)
            wall, child = run_child(td, prefix, [
                "-pe", fasta, "-m-ovl", str(MIN_OVERLAP), *RUNS[name]])
            files = sorted(p.name[len(name):] for p in
                           pathlib.Path(td).glob(name + "_*"))
            same = None if first is None else {
                s: filecmp.cmp(prefix + s, first + s, shallow=False)
                for s in files}
            first = first or prefix
            out["runs"][name] = {"wall_s": wall, "files": files,
                                 "same_as_first": same, **child}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
