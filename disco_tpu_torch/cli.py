"""disco-tpu-torch command line: end-to-end assembly (the counterpart of
disco_tpu/cli.py).

`assemble` replaces the reference's bash layer (runDisco.sh:26-257): graph
construction (buildG) -> graph simplification (fullsimplify) -> combined
contig/scaffold FASTAs, with the same directory layout
(<out>/graph/<prefix>_*, <out>/assembly/<prefix>_*) and per-iteration
parameter files; with -ecc it first runs the BBTools preprocessing
(runAssembly.sh:195-430).  `preprocess` is runECC.sh; `buildg`,
`simplify`, `parsimplify` and `stats` are the reference's buildG,
fullsimplify and parsimplify executables and its assemblyStats.py.

Usage:
  python -m disco_tpu_torch assemble -inP reads.fasta -d out -o prefix \
      -p disco.cfg [-p2 ...] [-p3 ...] [-m 30] [-obg|-osg] [-resimp] \
      [-backend device|native|xla] [-n N] [-rma] \
      [-ecc -bbmap BBTOOLS_DIR [-ecc-t T] [-ecc-m GB]]
  python -m disco_tpu_torch preprocess -inP reads.fasta -d out \
      -bbmap BBTOOLS_DIR [-n T] [-m GB] [--keep]
  python -m disco_tpu_torch buildg -pe reads.fasta -f out/prefix \
      [-se single.fasta] [-p disco.cfg | -m-ovl 30] [-m 8] [-w N] \
      [-backend device|native|xla] [-n N] [-rma]
  python -m disco_tpu_torch simplify -fpi reads.fasta -e edges -crd crd \
      -o prefix -p disco.cfg [-p2 ...] [-p3 ...]
  python -m disco_tpu_torch parsimplify edgeFile outFile minOvl [threads]
  python -m disco_tpu_torch stats [denovo|mapped] contigs.fasta
"""
import argparse
import glob
import os
import shutil
import sys

from .utils.logging import RECORDER, job

# names a directory: every subcommand then runs under a profiler trace
TRACE_ENV = "DISCO_TPU_TORCH_TRACE"
# the track (a process id no real process or card of the trace has, and
# its name) of the program's spans
SPAN_PID, SPAN_TRACK = 1 << 30, "disco_tpu_torch spans"


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


def _mesh(n: int):
    """n shards for the distributed build (runDisco-MPI's -n, reference:
    runDisco-MPI.sh:214 `mpirun -np N`), round-robin over the visible CUDA
    cards.  Without a card this raises: there is no fallback to the CPU."""
    from .dist.mesh import make_mesh
    return make_mesh(n)


def _build_target(args):
    """(mesh, backend) of buildG: -n N (N > 1) runs the distributed build
    over a mesh of N shards (dist-mem with -rma).  -rma alone runs the
    single-device buildG, as disco_tpu does, on the card: so -n and -rma
    both raise without one, before anything is written."""
    if args.n and args.n > 1:
        return _mesh(args.n), args.backend
    if args.rma:
        from .overlap.relation import _default_device
        _default_device()
        return None, "device"
    return None, args.backend


def _hand_off() -> None:
    """Give back what buildG freed before fullsimplify starts: objects
    held in reference cycles, the free pages glibc keeps in its heap, and
    the CUDA allocator's cached blocks when the card was used
    (fullsimplify runs on the host alone).  Without it fullsimplify's
    memory stacks on top of buildG's leavings."""
    import gc
    from .utils.logging import malloc_trim
    gc.collect()
    malloc_trim()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def cmd_assemble(args) -> int:
    """reads -> graph -> contigs and scaffolds.  -backend selects buildG's
    overlap engine (default `default_backend()`: the device when a card is
    present); -n N runs buildG over a mesh of N shards, dist-mem with
    -rma (`_build_target`); -ecc assembles the BBTools-corrected reads of
    `preprocess`, written under <d>/ecc."""
    mesh, backend = _build_target(args)
    from .buildg.pipeline import run_buildg
    from .simplify.driver import run_fullsimplify

    pair_files = []
    if args.in1 and args.in2:
        pair_files = [args.in1, args.in2]
    inter_files = args.inP.split(",") if args.inP else []
    single_files = args.inS.split(",") if args.inS else []
    if not (pair_files or inter_files or single_files):
        print("No input files specified (-in1/-in2, -inP, -inS).",
              file=sys.stderr)
        return 1

    out = args.d
    if args.ecc:
        # preprocessing layer (runAssembly.sh:195-430): BBTools trim/filter/
        # error-correct, then assemble the corrected reads
        from .preprocess import run_preprocess
        if not args.bbmap:
            print("assemble -ecc: -bbmap <BBTools dir> required",
                  file=sys.stderr)
            return 1
        paired, singles = run_preprocess(
            args.bbmap, os.path.join(out, "ecc"),
            in1=[args.in1] if args.in1 else [],
            in2=[args.in2] if args.in2 else [],
            inP=inter_files, inS=single_files,
            threads=args.ecc_t or None, mem_gb=args.ecc_m or None)
        pair_files, inter_files, single_files = [], paired, singles
    os.makedirs(os.path.join(out, "graph"), exist_ok=True)
    asm_dir = os.path.join(out, "assembly")
    if os.path.isdir(asm_dir) and args.resimp:
        shutil.rmtree(asm_dir)
    os.makedirs(asm_dir, exist_ok=True)

    graph_prefix = os.path.join(out, "graph", args.o)
    asm_prefix = os.path.join(out, "assembly", args.o)
    min_ovl = _cfg_min_overlap(args.p) if args.p else args.m

    # buildG phase: interleaved + separated pairs are "paired" inputs,
    # singles are single (reference: runDisco.sh:195-257)
    if not args.osg and mesh is not None:
        # distributed graph construction over the mesh (buildG-MPI, or
        # buildG-MPIRMA with -rma)
        from .dist.builder import run_buildg_sharded
        run_buildg_sharded(inter_files + pair_files, single_files,
                           graph_prefix, mesh, min_overlap=min_ovl,
                           write_par_graph_size=args.write_par_graph_size,
                           dist_mem=args.rma)
    elif not args.osg:
        run_buildg(inter_files + pair_files, single_files, graph_prefix,
                   min_overlap=min_ovl,
                   write_par_graph_size=args.write_par_graph_size,
                   backend=backend)

    if not args.obg:
        if not args.osg:
            _hand_off()
        edge_files = sorted(glob.glob(graph_prefix + "_*_parGraph.txt"))
        crd_files = sorted(glob.glob(graph_prefix + "_*_containedReads.txt"))
        param_files = [p for p in (args.p, args.p2 or args.p,
                                   args.p3 or args.p2 or args.p) if p]
        run_fullsimplify(single_files, pair_files, inter_files, edge_files,
                         crd_files, asm_prefix,
                         param_files=param_files or None)
        for kind in ("contigs", "scaffolds"):
            parts = sorted(glob.glob(f"{asm_prefix}_{kind}Final_*.fasta"))
            combined = f"{asm_prefix}_{kind}FinalCombined.fasta"
            with open(combined, "w") as outf:
                for p in parts:
                    with open(p) as inf:
                        shutil.copyfileobj(inf, outf)
            shutil.copy(combined, out)
    return 0


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
    reference), -w explicit chunk override; -t enters the -m rule only.
    -n N runs the overlap phase over a mesh of N shards, dist-mem with
    -rma (`_build_target`)."""
    mesh, backend = _build_target(args)
    from .buildg.pipeline import run_buildg

    paired = args.pe.split(",") if args.pe else []
    single = args.se.split(",") if args.se else []
    if not (paired or single):
        print("buildg: no input files (-pe/-se)", file=sys.stderr)
        return 1
    min_ovl = _cfg_min_overlap(args.p) if args.p else args.m_ovl
    wsize = args.w or (_par_graph_size(args.m, args.t or 1)
                       if args.m else 1000)
    if mesh is not None:
        from .dist.builder import run_buildg_sharded
        run_buildg_sharded(paired, single, args.f, mesh, min_overlap=min_ovl,
                           write_par_graph_size=wsize, dist_mem=args.rma)
    else:
        run_buildg(paired, single, args.f, min_overlap=min_ovl,
                   write_par_graph_size=wsize, max_mem_gb=args.m,
                   backend=backend)
    return 0


def cmd_preprocess(args) -> int:
    """runECC.sh equivalent: BBTools trim/filter/error-correct; prints the
    corrected file lists (reference: runECC.sh:180-440)."""
    from .preprocess import run_preprocess
    paired, single = run_preprocess(
        args.bbmap, args.d,
        in1=args.in1.split(",") if args.in1 else [],
        in2=args.in2.split(",") if args.in2 else [],
        inP=args.inP.split(",") if args.inP else [],
        inS=args.inS.split(",") if args.inS else [],
        threads=args.n or None, mem_gb=args.m or None,
        keep_intermediates=args.keep)
    if paired:
        print("paired:", ",".join(paired))
    if single:
        print("single:", ",".join(single))
    return 0


def cmd_simplify(args) -> int:
    """`fullsimplify` executable equivalent (reference CLI:
    src/SimplifyGraph/src/Config.cpp:198-288)."""
    from .simplify.driver import run_fullsimplify
    from .utils.logging import set_level

    if args.log:
        set_level(args.log)
    run_fullsimplify(
        args.fs.split(",") if args.fs else [],
        args.fp.split(",") if args.fp else [],
        args.fpi.split(",") if args.fpi else [],
        args.e.split(",") if args.e else [],
        args.crd.split(",") if args.crd else [],
        args.o,
        param_files=[p for p in (args.p, args.p2, args.p3) if p] or None,
        sim_path=args.simPth)
    return 0


def cmd_parsimplify(args) -> int:
    """`parsimplify` executable equivalent (reference CLI:
    src/SimplifyGraph/src/mainParSimplify.cpp:13-17: positional
    edgeFile outFile minOvl threads)."""
    from .native import parsimplify_run
    parsimplify_run(args.edge_file, args.out_file, args.min_ovl)
    return 0


def cmd_stats(args) -> int:
    """`assemblyStats.py` equivalent.  With a mode, writes the reference's
    <base>.stat.txt (+ .filtered.fasta under cutoffs, reference:
    assemblyStats.py:27-35,202-470); without, prints a summary."""
    from .utils.stats import (assembly_stats, denovo_stat_file, format_stats,
                              mapped_stat_file)
    if args.mode == "denovo":
        path = denovo_stat_file(args.fasta, min_len=args.min_len)
        print(path)
    elif args.mode == "mapped":
        if not args.ref:
            print("stats mapped: -r reference fasta required",
                  file=sys.stderr)
            return 1
        path = mapped_stat_file(args.fasta, args.ref, min_len=args.min_len,
                                map_quality=args.q)
        print(path)
    else:
        st = assembly_stats(args.fasta, min_len=args.min_len)
        print(format_stats(st))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="disco-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("assemble", help="end-to-end assembly")
    a.add_argument("-in1", help="forward paired read file")
    a.add_argument("-in2", help="reverse paired read file")
    a.add_argument("-inP", help="interleaved paired read file(s), comma-sep")
    a.add_argument("-inS", help="single read file(s), comma-sep")
    a.add_argument("-d", required=True, help="output directory")
    a.add_argument("-o", required=True, help="output prefix")
    a.add_argument("-p", help="parameter cfg (iteration 1)")
    a.add_argument("-p2", help="parameter cfg (iteration 2)")
    a.add_argument("-p3", help="parameter cfg (iteration 3)")
    a.add_argument("-m", type=int, default=30,
                   help="min overlap for graph build (if no cfg)")
    a.add_argument("-obg", action="store_true",
                   help="only build graph, skip simplification")
    a.add_argument("-osg", action="store_true",
                   help="only simplify (graph files must exist)")
    a.add_argument("-resimp", action="store_true",
                   help="nuke previous assembly dir and re-simplify")
    a.add_argument("-n", type=int, default=0,
                   help="shards for a distributed graph build (runDisco-MPI "
                        "-n), round-robin over the CUDA cards; needs a card")
    a.add_argument("-rma", action="store_true",
                   help="dist-mem build (buildG-MPIRMA): with -n, the "
                        "packed read payload partitioned over the shards, "
                        "O(N/n) a shard (default replicates it, buildG-MPI);"
                        " alone, the single-device buildG on the card")
    a.add_argument("-ecc", action="store_true",
                   help="BBTools preprocessing before assembly "
                        "(runAssembly.sh equivalent; needs -bbmap)")
    a.add_argument("-bbmap", help="BBTools install dir (for -ecc)")
    a.add_argument("-ecc-t", dest="ecc_t", type=int, default=0,
                   help="BBTools threads for -ecc (t=N); distinct from -n, "
                        "the shard count")
    a.add_argument("-ecc-m", dest="ecc_m", type=int, default=0,
                   help="BBTools max memory GB for -ecc (-Xmx)")
    a.add_argument("--write-par-graph-size", type=int, default=1000)
    a.add_argument("-backend", choices=["device", "native", "xla"],
                   help="overlap-phase engine (see buildg -backend)")
    a.set_defaults(fn=cmd_assemble)

    pp = sub.add_parser("preprocess",
                        help="BBTools trim/filter/error-correction "
                             "(runECC.sh equivalent)")
    pp.add_argument("-in1", help="forward paired read file(s), comma-sep")
    pp.add_argument("-in2", help="reverse paired read file(s), comma-sep")
    pp.add_argument("-inP", help="interleaved paired read file(s), comma-sep")
    pp.add_argument("-inS", help="single read file(s), comma-sep")
    pp.add_argument("-d", default=".", help="output directory")
    pp.add_argument("-bbmap", required=True, help="BBTools install dir")
    pp.add_argument("-n", type=int, default=0, help="threads (t=N)")
    pp.add_argument("-m", type=int, default=0, help="max memory GB (-Xmx)")
    pp.add_argument("--keep", action="store_true",
                    help="keep intermediate trm./ftl. files")
    pp.set_defaults(fn=cmd_preprocess)

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
                   help="shards for a distributed build (buildG-MPI), "
                        "round-robin over the CUDA cards; needs a card")
    b.add_argument("-backend", choices=["device", "native", "xla"],
                   help="overlap-phase engine: device (torch pipeline with "
                        "the CUDA kernels; default when a card is present), "
                        "native (C++/OpenMP host kernel; default otherwise), "
                        "xla (exact host expansion, checked on the device)")
    b.add_argument("-rma", action="store_true",
                   help="dist-mem build (buildG-MPIRMA): the packed read "
                        "payload partitioned over the -n shards; alone, the "
                        "single-device buildG on the card")
    b.set_defaults(fn=cmd_buildg)

    fsim = sub.add_parser("simplify",
                          help="graph simplification (fullsimplify)")
    fsim.add_argument("-fs", help="single read file(s), comma-sep")
    fsim.add_argument("-fp", help="separated paired read file(s), comma-sep")
    fsim.add_argument("-fpi", help="interleaved paired file(s), comma-sep")
    fsim.add_argument("-e", help="edge file(s), comma-sep")
    fsim.add_argument("-crd", help="contained-read file(s), comma-sep")
    fsim.add_argument("-o", required=True, help="output prefix")
    fsim.add_argument("-p", help="parameter cfg (iteration 1)")
    fsim.add_argument("-p2", help="parameter cfg (iteration 2)")
    fsim.add_argument("-p3", help="parameter cfg (iteration 3)")
    fsim.add_argument("-simPth",
                      help="dir with test/<thresh>.txt post-processing "
                           "tables (parsimplify runs in-process)")
    fsim.add_argument("-t", type=int, default=0, help="accepted, unused")
    fsim.add_argument("-log", help="log level (ERROR..DEBUG4)")
    fsim.set_defaults(fn=cmd_simplify)

    ps = sub.add_parser("parsimplify",
                        help="partial-graph simplification (parsimplify)")
    ps.add_argument("edge_file")
    ps.add_argument("out_file")
    ps.add_argument("min_ovl", type=int)
    ps.add_argument("threads", type=int, nargs="?", default=1)
    ps.set_defaults(fn=cmd_parsimplify)

    s = sub.add_parser("stats", help="assembly N50/size statistics "
                                     "(assemblyStats.py equivalent)")
    s.add_argument("mode", nargs="?", choices=["denovo", "mapped"],
                   help="write <base>.stat.txt like the reference; "
                        "omit for a quick summary to stdout")
    s.add_argument("fasta")
    s.add_argument("-r", "--ref", help="reference fasta (mapped mode)")
    s.add_argument("-q", type=float, default=0.0,
                   help="min mapping rate 1-(edit/mapped) (mapped mode)")
    s.add_argument("-m", "--min-len", type=int, default=0)
    s.set_defaults(fn=cmd_stats)

    # every call is one job of the span recorder (utils/logging.py)
    with job():
        args = ap.parse_args(argv)
        trace_dir = os.environ.get(TRACE_ENV)
        if trace_dir:
            return _traced(args, trace_dir)
        return args.fn(args)


def _traced(args, trace_dir: str) -> int:
    """Run the subcommand under torch.profiler (the host's operators, and
    the card's kernels and copies when a card is present) and write a
    Chrome trace, `<cmd>.<pid>.trace.json`, into `trace_dir` (the
    reference ships runDisco-MPI-AllineaMAP.sh to run under a profiler;
    disco_tpu's counterpart is its jax.profiler trace).  The job's program
    spans join the trace as complete events on a track of their own
    (SPAN_PID), placed on the profiler's clock through the wall clock
    (`_add_spans`); this enters no range into the profiler."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    anchor = (time.time_ns(), time.perf_counter_ns())
    try:
        return args.fn(args)
    finally:
        # written also when the subcommand raises, as jax's trace is
        prof.stop()
        path = os.path.join(trace_dir,
                            f"{args.cmd}.{os.getpid()}.trace.json")
        prof.export_chrome_trace(path)
        _add_spans(path, anchor, RECORDER.spans(RECORDER.current_job()))


def _add_spans(path: str, anchor, spans) -> None:
    """Write the program's `spans` (utils/logging.py) into the Chrome trace
    at `path` as complete events of the track SPAN_PID, one thread a
    nesting depth.  `anchor` is a (wall clock, perf_counter) pair in ns,
    read together; the trace's times are the wall clock less its
    `baseTimeNanoseconds`, so the pair places every span."""
    import json
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    if not spans:
        return
    wall_ns, perf_ns = anchor
    shift = (wall_ns - perf_ns - trace["baseTimeNanoseconds"]) / 1e3
    depth = {}
    for s in sorted(spans, key=lambda s: (s["t0"], -s["t1"])):
        depth[s["id"]] = depth.get(s["parent"], -1) + 1
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_PID,
                   "tid": 0, "args": {"name": SPAN_TRACK}})
    for s in spans:
        events.append({"ph": "X", "cat": "program_span", "name": s["name"],
                       "pid": SPAN_PID, "tid": depth[s["id"]],
                       "ts": s["t0"] / 1e3 + shift,
                       "dur": (s["t1"] - s["t0"]) / 1e3,
                       "args": {"id": s["id"], "parent": s["parent"]}})
    with open(path, "w") as f:
        json.dump(trace, f)


if __name__ == "__main__":
    raise SystemExit(main())
