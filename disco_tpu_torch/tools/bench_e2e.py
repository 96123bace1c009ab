"""End-to-end buildG wall clock: the device backend against the native one
(and, with --ref, the reference's buildG -t 1) on fresh reads from
tools/make_testdata.py, by default the 4.6 Mb / 30x / 250 bp set with a
600 bp insert (the counterpart of tools/bench_e2e.py).

    python -m disco_tpu_torch.tools.bench_e2e [--genome-len N]
        [--coverage C] [--read-len L] [--insert I] [--seed S]
        [--min-overlap M] [--backends device,native] [--ref]

Each backend runs `buildg` of the port's command line in a fresh process
(`child_main`), timed on the host clock from start to exit.  Prints one
JSON line: the walls by backend, in seconds; the seconds the reads took
to make; whether every file each run wrote (`files`, by suffix) is the
same in every run; and `runs`, what each port child reported: its peak
resident set (sampled every 10 ms, `RssPeak`) and at its start, its
`clock` stages, its launches of K1, K1's rows route (`K1_rows`) and K2,
its peak device memory, and, when it made the one-pass relation or the
distributed one (`buildg -n N [-rma]`), the reads, the windows, the
relation's rows and its stats (chunks, fallback chunks; the wire row's
bytes, or the distributed relation's hit_cap), with the distributed
relation's chunk plan and host seconds by stage (`profile`).  The device
backend needs a CUDA card: without one the tool exits non-zero before it
makes any data.  `run_child` runs one such child, of `buildg` or of
`assemble`; chip_smoke.py drives its scale phases through it, and
tools/assemble_scale.py its assemble runs.  An `assemble` child also
reports buildG's wall and fullsimplify's, the resident set as buildG
returned and as fullsimplify started (`rss_handoff_bytes`), and
fullsimplify's stages by iteration."""
import argparse
import json
import logging
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
REF_BUILDG = ROOT / "refbuild" / "buildG"
CHILD = ("import sys; from disco_tpu_torch.tools.bench_e2e import "
         "child_main; sys.exit(child_main(sys.argv[1], sys.argv[2:]))")


class RssPeak:
    """While open, a thread reads this process's resident set from
    /proc/self/statm every `period` seconds and keeps the largest (the
    kernel's own peak, VmHWM, cannot be reset on every host)."""

    def __init__(self, period: float = 0.01):
        self.period = period
        self.start = self.peak = 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _sample(self) -> int:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * self._page
        self.peak = max(self.peak, rss)
        return rss

    def _run(self):
        while not self._stop.wait(self.period):
            self._sample()

    def __enter__(self):
        self.start = self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            raise RuntimeError("the RSS sampler did not stop")
        self._sample()


class StageWalls(logging.Handler):
    """Collects the (stage, seconds) records of utils.logging.clock."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.walls = []

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("<<<"):
            self.walls.append((record.args[0], float(record.args[1])))


def child_main(stats_path: str, argv) -> int:
    """`python -m disco_tpu_torch <argv>` in this process; writes what it
    measured to `stats_path` as JSON and returns the command's code."""
    import torch
    from disco_tpu_torch import cli
    from disco_tpu_torch.buildg import pipeline
    from disco_tpu_torch.dist import builder
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.utils.logging import log

    seen = {}
    real, real_dist = pipeline.compute_relation, builder.sharded_relation_pruned

    def record(store, table, rel, **more):
        seen.update(reads=store.n_reads, windows=int(store.lengths.sum())
                    - store.n_reads * table.k, rows=len(rel),
                    relation=dict(rel.stats, **more))

    def compute_relation(store, table, **kw):
        rel = real(store, table, **kw)
        record(store, table, rel)
        return rel

    def sharded_relation_pruned(store, table, mesh, **kw):
        profile = {}
        out = real_dist(store, table, mesh, profile=profile, **kw)
        record(store, table, out[0], hit_cap=profile["hit_cap"])
        seen["profile"] = profile
        return out

    pipeline.compute_relation = compute_relation
    builder.sharded_relation_pruned = sharded_relation_pruned
    stages = StageWalls()
    for h in log.handlers:        # the stages are collected, not printed
        h.setLevel(max(h.level, logging.WARNING))
    log.addHandler(stages)
    log.setLevel(min(log.level, logging.INFO))
    with RssPeak() as rss:
        if argv[0] == "assemble":
            _watch_assemble(seen, stages, rss)
        rc = cli.main(list(argv))
    out = {"rc": rc, "rss_peak_bytes": rss.peak, "rss_start_bytes": rss.start,
           "stages": stages.walls,
           "launches": {"K1": fk.fused_compare_dual.launches,
                        "K1_rows": fk.fused_compare_dual_rows.launches,
                        "K2": fk.fused_compare_dual_fetch.launches},
           "device_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if torch.cuda.is_initialized() else None),
           **seen}
    pathlib.Path(stats_path).write_text(json.dumps(out))
    return rc


def _watch_assemble(seen: dict, stages: StageWalls, rss: RssPeak):
    """Wrap the stages of `assemble` for good in this process, recording
    into `seen`: buildG's wall (either build) and the resident set as it
    returns (`rss_buildg_end_bytes`), fullsimplify's wall and the resident
    set as it starts (`rss_handoff_bytes`), and each iteration's wall and
    `clock` stages."""
    from disco_tpu_torch.buildg import pipeline
    from disco_tpu_torch.dist import builder
    from disco_tpu_torch.simplify import driver

    def timed(module, name, key, rss_key, at_start):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            if at_start:
                seen[rss_key] = rss._sample()
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                seen[key] = time.perf_counter() - t0
                if not at_start:
                    seen[rss_key] = rss._sample()
        setattr(module, name, wrapper)

    iterations = seen.setdefault("iterations", [])
    real_iteration = driver._simplify_iteration

    def simplify_iteration(dataset, params, edge_files, prefix, iteration,
                           *a, **kw):
        first, t0 = len(stages.walls), time.perf_counter()
        out = real_iteration(dataset, params, edge_files, prefix, iteration,
                             *a, **kw)
        iterations.append({"iteration": iteration,
                           "wall_s": time.perf_counter() - t0,
                           "continue": out["continue"],
                           "stages": stages.walls[first:]})
        return out

    for module, name in ((pipeline, "run_buildg"),
                         (builder, "run_buildg_sharded")):
        timed(module, name, "buildg_s", "rss_buildg_end_bytes", False)
    timed(driver, "run_fullsimplify", "fullsimplify_s", "rss_handoff_bytes",
          True)
    driver._simplify_iteration = simplify_iteration


def run_child(cwd: str, prefix: str, argv, timeout=None,
              command: str = "buildg") -> tuple:
    """`python -m disco_tpu_torch <command> <argv>` in a fresh process
    (`child_main`) run from `cwd`, timed on the host clock from start to
    exit: `buildg` writes to `-f <prefix>`, `assemble` into the directory
    `-d <prefix>` under the name `-o <its last component>`.  A child still
    running after `timeout` seconds is killed and raises.  Returns
    (seconds, what the child reported)."""
    stats = prefix + ".stats.json"
    out = {"buildg": ["-f", prefix],
           "assemble": ["-d", prefix, "-o", pathlib.Path(prefix).name]}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get("PYTHONPATH"))))}
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", CHILD, stats, command, *argv,
                    *out[command]], check=True, cwd=cwd, env=env,
                   timeout=timeout)
    return time.perf_counter() - t0, json.loads(
        pathlib.Path(stats).read_text())


def _outputs(td: str, prefix: str) -> dict:
    """The files a run wrote, by suffix."""
    return {p.name[len(prefix):]: p.read_bytes()
            for p in pathlib.Path(td).glob(prefix + "_*") if p.is_file()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=250)
    ap.add_argument("--insert", type=int, default=600)
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

    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "reads.fasta")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, str(ROOT / "tools" / "make_testdata.py"), fasta,
             "--genome-len", str(args.genome_len),
             "--coverage", str(args.coverage),
             "--read-len", str(args.read_len), "--insert", str(args.insert),
             "--seed", str(args.seed)],
            check=True, stdout=subprocess.DEVNULL)
        data_s = time.perf_counter() - t0

        walls, runs, outputs = {}, {}, {}
        for backend in backends:
            walls[backend], runs[backend] = run_child(
                td, os.path.join(td, backend),
                ["-pe", fasta, "-backend", backend, "-m-ovl",
                 str(args.min_overlap)])
            outputs[backend] = _outputs(td, backend)

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
            outputs["reference_t1"] = _outputs(td, "REF")

    first = next(iter(outputs.values()))
    print(json.dumps({
        "bench": "buildg_e2e_wall_s", "genome_len": args.genome_len,
        "coverage": args.coverage, "read_len": args.read_len,
        "insert": args.insert, "seed": args.seed,
        "min_overlap": args.min_overlap,
        "outputs_identical": all(v == first for v in outputs.values()),
        "files": sorted(first), "data_s": data_s, "card": card, **walls,
        "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
