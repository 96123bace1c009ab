"""disco-tpu-torch command line: the `buildg` subcommand (the reference's
`buildG` executable, src/BuildGraph/src/main.cpp:95-148; the counterpart
of disco_tpu/cli.py's `buildg`).

Usage:
  python -m disco_tpu_torch buildg -pe reads.fasta -f out/prefix \
      [-se single.fasta] [-p disco.cfg | -m-ovl 30] [-m 8] [-w N] \
      [-backend device|native|xla]
"""
import argparse
import sys


def _cfg_min_overlap(path: str, default: int = 30) -> int:
    try:
        with open(path) as f:
            for line in f:
                t = line.strip()
                if t.startswith("MinOverlap4BuildGraph") and "=" in t:
                    return int(t.split("=")[1].split()[0])
    except OSError:
        pass
    return default


def _par_graph_size(mem_gb: int, threads: int) -> int:
    """The reference's memory-based chunk-size rule: per-thread GB bands
    [20,inf)->80000, [10,20)->40000, [5,10)->20000, (0,5)->1000
    (reference: src/BuildGraph/src/OverlapGraph.cpp:67-81, Common.h:51-54)."""
    per_thread_mb = mem_gb * 1024 // max(threads, 1)
    if per_thread_mb >= 20 * 1024:
        return 80000
    if per_thread_mb >= 10 * 1024:
        return 40000
    if per_thread_mb >= 5 * 1024:
        return 20000
    return 1000


def cmd_buildg(args) -> int:
    """-pe/-se comma lists, -f prefix, -p cfg with MinOverlap4BuildGraph,
    -m memory budget (sets the parGraph chunk size exactly like the
    reference), -w explicit chunk override; -t enters the -m rule only."""
    if args.n and args.n > 1:
        raise NotImplementedError(
            "buildg -n (distributed build): not yet ported")
    if args.rma:
        raise NotImplementedError("buildg -rma (dist-mem build): not yet "
                                  "ported")
    from .buildg.pipeline import run_buildg

    paired = args.pe.split(",") if args.pe else []
    single = args.se.split(",") if args.se else []
    if not (paired or single):
        print("buildg: no input files (-pe/-se)", file=sys.stderr)
        return 1
    min_ovl = _cfg_min_overlap(args.p) if args.p else args.m_ovl
    wsize = args.w or (_par_graph_size(args.m, args.t or 1)
                       if args.m else 1000)
    run_buildg(paired, single, args.f, min_overlap=min_ovl,
               write_par_graph_size=wsize, max_mem_gb=args.m,
               backend=args.backend)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="disco-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("buildg", help="graph construction (buildG)")
    b.add_argument("-pe", help="paired-end file(s), comma-sep")
    b.add_argument("-se", help="single-end file(s), comma-sep")
    b.add_argument("-f", required=True, help="output file prefix")
    b.add_argument("-p", help="parameter cfg (MinOverlap4BuildGraph)")
    b.add_argument("-m-ovl", dest="m_ovl", type=int, default=30,
                   help="min overlap if no cfg")
    b.add_argument("-t", type=int, default=0,
                   help="threads (enters the -m chunk-size rule only)")
    b.add_argument("-m", type=int, default=0,
                   help="max memory GB; sets the parGraph chunk size via "
                        "the reference's per-thread bands (-m 8 -> 20000)")
    b.add_argument("-w", type=int, default=0,
                   help="explicit par-graph chunk size (writeParGraphSize); "
                        "overrides -m (default 1000 if neither given)")
    b.add_argument("-n", type=int, default=0,
                   help="devices for a distributed build (not yet ported)")
    b.add_argument("-backend", choices=["device", "native", "xla"],
                   help="overlap-phase engine: device (torch pipeline with "
                        "the CUDA kernels; default when a card is present), "
                        "native (C++/OpenMP host kernel; default otherwise), "
                        "xla (exact host expansion, checked on the device)")
    b.add_argument("-rma", action="store_true",
                   help="dist-mem build (not yet ported)")
    b.set_defaults(fn=cmd_buildg)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
