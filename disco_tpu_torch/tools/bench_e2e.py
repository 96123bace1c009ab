"""End-to-end buildG wall clock: the device backend against the native one
(and, with --ref, the reference's buildG -t 1) on fresh reads from
tools/make_testdata.py, by default the 4.6 Mb / 30x / 250 bp set with a
600 bp insert (the counterpart of tools/bench_e2e.py).

    python -m disco_tpu_torch.tools.bench_e2e [--genome-len N]
        [--coverage C] [--backends device,native] [--ref]

Each backend runs `python -m disco_tpu_torch buildg` in a fresh process,
timed on the host clock from start to exit.  Prints one JSON line: the
walls by backend, in seconds, and whether every run's _0_parGraph.txt is
the same.  The device backend needs a CUDA card: without one the tool
exits non-zero before it makes any data."""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
REF_BUILDG = ROOT / "refbuild" / "buildG"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=250)
    ap.add_argument("--min-overlap", type=int, default=40)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--backends", default="device,native")
    ap.add_argument("--ref", action="store_true",
                    help="also time the reference buildG -t 1 (built by "
                         "tools/build_reference.sh into refbuild/)")
    args = ap.parse_args(argv)
    backends = args.backends.split(",")
    card = None
    if "device" in backends:
        import torch
        if not torch.cuda.is_available():
            sys.exit("bench_e2e: the device backend needs a CUDA card "
                     "(torch.cuda.is_available() is false)")
        card = torch.cuda.get_device_name(0)
    if args.ref and not os.access(REF_BUILDG, os.X_OK):
        sys.exit(f"bench_e2e: --ref needs {REF_BUILDG}: build the reference "
                 "with tools/build_reference.sh")

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get("PYTHONPATH"))))}
    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "reads.fasta")
        subprocess.run(
            [sys.executable, str(ROOT / "tools" / "make_testdata.py"), fasta,
             "--genome-len", str(args.genome_len),
             "--coverage", str(args.coverage),
             "--read-len", str(args.read_len), "--insert", "600",
             "--seed", str(args.seed)],
            check=True, stdout=subprocess.DEVNULL)

        walls = {}
        outputs = {}
        for backend in backends:
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, "-m", "disco_tpu_torch", "buildg",
                 "-pe", fasta, "-f", os.path.join(td, backend),
                 "-backend", backend, "-m-ovl", str(args.min_overlap)],
                check=True, cwd=td, env=env)
            walls[backend] = time.perf_counter() - t0
            outputs[backend] = pathlib.Path(
                td, f"{backend}_0_parGraph.txt").read_bytes()

        if args.ref:
            cfg = os.path.join(td, "b.cfg")
            with open(cfg, "w") as f:
                f.write(f"MinOverlap4BuildGraph = {args.min_overlap}\n")
            t0 = time.perf_counter()
            subprocess.run(
                [str(REF_BUILDG), "-pe", fasta, "-f",
                 os.path.join(td, "REF"), "-p", cfg, "-t", "1", "-m", "4"],
                check=True, cwd=td, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            walls["reference_t1"] = time.perf_counter() - t0
            outputs["reference_t1"] = pathlib.Path(
                td, "REF_0_parGraph.txt").read_bytes()

    first = next(iter(outputs.values()))
    print(json.dumps({
        "bench": "buildg_e2e_wall_s", "genome_len": args.genome_len,
        "coverage": args.coverage,
        "outputs_identical": all(v == first for v in outputs.values()),
        "card": card, **walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
