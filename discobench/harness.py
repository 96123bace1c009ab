"""The harness of discobench: one cell, one run.

A cell of BENCHMARK.json names a configuration (its file under
discobench/configs/: the read set, the shipped cfgs) and a traffic mix
(discobench/traffic/<traffic>.json: the job's command line, where its
outputs land, the warm-up's size).  A run makes the reads from the seed,
warms up on a prefix of them, then runs whole jobs back to back in this
process, `disco_tpu_torch.cli.main`, each after a `settle`, until
`seconds` have passed since the window opened; the job running then runs
to its end and counts.  After the window it reads what the cell's metrics
need, checks the jobs' outputs against the plain reference
(lib/reference.py) and the genomes, each number with its limit (0, or the
configuration's `assembly` limits), and prints one JSON line.  A
per-layer metric is the file discobench/metrics/<name>.py, whose
`read(run)` returns a number or None."""
import hashlib
import importlib.util
import json
import logging
import pathlib
import random
import shutil
import sys
import tempfile
import time
import traceback

from discobench.lib import reference
from discobench.lib.gen import write_reads
from discobench.lib.host import RssPeak, StageWalls, settle

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "disco_tpu")
GIB = float(1 << 30)


class CellError(ValueError):
    """The cell, or a file it names, is missing or malformed."""


def load_cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell `name` of root/BENCHMARK.json with its configuration file,
    traffic file and metrics: {name, chips, config, traffic, end_to_end,
    per_layer}."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"{name}: no configuration {cell['config']!r}")
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic_file = root / "discobench" / "traffic" / f"{cell['traffic']}.json"
    if not traffic_file.exists():
        raise CellError(f"{name}: no traffic file {traffic_file}")
    traffic = json.loads(traffic_file.read_text())
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    for m in per_layer:
        if not metric_file(m["name"], root).exists():
            raise CellError(f"no reader {metric_file(m['name'], root)}")
    return {"name": name, "chips": cell["chips"], "config": config,
            "traffic": traffic, "end_to_end": bench["end_to_end"],
            "per_layer": per_layer}


def metric_file(name: str, root: pathlib.Path = ROOT) -> pathlib.Path:
    return root / "discobench" / "metrics" / f"{name}.py"


def load_reader(name: str, root: pathlib.Path = ROOT):
    """The `read` function of discobench/metrics/<name>.py."""
    path = metric_file(name, root)
    spec = importlib.util.spec_from_file_location(
        "discobench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def window(run_one, seconds: float, clock=time.perf_counter):
    """Jobs back to back: `run_one(i)` (a dict with the job's end `t1` on
    `clock`) until `seconds` have passed since the window opened; the job
    running then runs to its end and counts.  Returns (t_open, jobs)."""
    jobs = []
    t_open = clock()
    while not jobs or clock() - t_open < seconds:
        jobs.append(run_one(len(jobs)))
    return t_open, jobs


def reads_per_s(jobs, n_reads: int, t_open: float) -> float:
    """All reads of all jobs over the time from the window's opening to the
    last job's end."""
    return len(jobs) * n_reads / (jobs[-1]["t1"] - t_open)


class Run:
    """What a run hands the per-layer readers: the window's jobs (each
    with its `clock` stages as (name, seconds, end)), the traced job's
    device reading (None without --trace 1), and the reads."""

    def __init__(self, jobs, trace, reads, min_overlap, device):
        self.jobs, self.trace = jobs, trace
        self.reads, self.min_overlap, self.device = reads, min_overlap, device
        self._work = None

    def stage_mean(self, names):
        """Seconds a job spends in the `clock` stages `names`, averaged
        over the window's jobs; None when no job ran one."""
        totals = [sum(s for n, s, _ in job["stages"] if n in names)
                  for job in self.jobs]
        if not any(n in names for job in self.jobs
                   for n, _, _ in job["stages"]):
            return None
        return sum(totals) / len(totals)

    def kernel_seconds(self, fragments):
        """Device seconds of the traced job's kernels whose names hold one
        of `fragments`; None without a trace or such a kernel."""
        if self.trace is None:
            return None
        secs = [s for name, (_, s) in self.trace["ops"].items()
                if any(f in name for f in fragments)]
        return sum(secs) if secs else None

    def dual_check_work(self) -> dict:
        """lib/bounds.py's dual-check work of one job's reads."""
        if self._work is None:
            import numpy as np
            import torch
            from discobench.lib.bounds import dual_check_work
            lut = np.zeros(256, np.uint8)
            lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
            codes = torch.from_numpy(lut[np.frombuffer(
                b"".join(self.reads.fwd), np.uint8)].reshape(
                len(self.reads), self.reads.length)).to(self.device)
            self._work = dual_check_work(codes, self.min_overlap - 1)
        return self._work


def _quiet_stages():
    """The program's logger at INFO for its `clock` records, its own
    handlers kept at WARNING so that the stages are collected, not
    printed."""
    from disco_tpu_torch.utils.logging import log
    for h in log.handlers:
        h.setLevel(max(h.level, logging.WARNING))
    log.setLevel(logging.INFO)
    return log


def run_job(argv, log) -> dict:
    """One job, `cli.main(argv)`, in this process: its code, start and end
    on the host clock, the CPU seconds of all the process's threads, and
    its `clock` stages."""
    from disco_tpu_torch import cli
    walls = StageWalls()
    log.addHandler(walls)
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    try:
        rc = cli.main(list(argv))
    except Exception:
        traceback.print_exc()
        rc = None
    t1 = time.perf_counter()
    log.removeHandler(walls)
    return {"rc": rc, "t0": t0, "t1": t1,
            "cpu_s": time.process_time() - cpu0, "stages": walls.walls}


def digest(out_dir: pathlib.Path) -> dict:
    """{path relative to out_dir: SHA-256} of every file a job wrote."""
    out = {}
    for p in sorted(out_dir.rglob("*")):
        if p.is_file():
            out[str(p.relative_to(out_dir))] = hashlib.sha256(
                p.read_bytes()).hexdigest()
    return out


def refuse_jax():
    """Exit 3, naming them, when this process holds a module whose
    top-level name is JAX's or the JAX package's (whole names:
    disco_tpu_torch is not disco_tpu)."""
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"discobench: loaded {', '.join(loaded)}", file=sys.stderr)
        raise SystemExit(3)


def _min_overlap(config: dict, cfg: str) -> int:
    """MinOverlap4BuildGraph as the configuration states it, which the
    cfg the jobs read must state too."""
    want = config["MinOverlap4BuildGraph"]
    with open(cfg) as f:
        for line in f:
            t = line.strip()
            if t.startswith("MinOverlap4BuildGraph") and "=" in t:
                if int(t.split("=")[1].split()[0]) != want:
                    raise CellError(f"{cfg} states another "
                                    "MinOverlap4BuildGraph")
                return want
    raise CellError(f"{cfg} states no MinOverlap4BuildGraph")


def write_prefix(src: pathlib.Path, dst: pathlib.Path, records: int):
    """The first `records` two-line records of a FASTA."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        for _ in range(2 * records):
            line = f.readline()
            if not line:
                break
            g.write(line)


def run(name: str, seed: int, seconds: float, trace: bool,
        t_start: float, root: pathlib.Path = ROOT, device: str = "cuda",
        work_root: str = None) -> dict:
    """One run of cell `name`: the result line as a dict, its `checks`
    (each number compared, with its limit) last.  Raises SystemExit(3)
    when JAX or the JAX package was loaded."""
    import torch
    cell = load_cell(name, root)
    config, traffic = cell["config"], cell["traffic"]
    cfgs = [str(root / c) for c in config["cfgs"]]
    min_overlap = _min_overlap(config, cfgs[0])
    log = _quiet_stages()
    work = pathlib.Path(tempfile.mkdtemp(prefix="discobench-",
                                         dir=work_root))
    try:
        fasta = work / "reads.fasta"
        truth = write_reads(str(fasta), seed, **config["reads"])
        n_reads = len(truth.start)
        places = {f"cfg{i + 1}" if i else "cfg": c
                  for i, c in enumerate(cfgs)}

        def argv(reads, out):
            return [a.format(reads=reads, out=out, **places)
                    for a in traffic["argv"]]

        warm = work / "warmup.fasta"
        write_prefix(fasta, warm, min(traffic["warmup_reads"], n_reads))
        (work / "warmup").mkdir()
        w = run_job(argv(warm, work / "warmup"), log)
        if w["rc"] != 0:
            raise RuntimeError(f"the warm-up job failed (rc {w['rc']})")
        shutil.rmtree(work / "warmup")
        if device == "cuda":
            torch.cuda.synchronize()

        def one(i):
            out = work / f"job{i}"
            out.mkdir()
            settle()
            return dict(run_job(argv(fasta, out), log), out=out)

        with RssPeak() as rss:
            t_open, jobs = window(one, seconds)
        setup_s = t_open - t_start
        rate = reads_per_s(jobs, n_reads, t_open)
        for i, j in enumerate(jobs):
            stages = " ".join(f"{n} {s:.3f}" for n, s, _ in j["stages"])
            print(f"job {i}: {j['t1'] - j['t0']:.3f} s from "
                  f"{j['t0'] - t_open:.3f} s, cpu {j['cpu_s']:.3f} s; "
                  f"{stages}", file=sys.stderr)
        mem_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                    else 0)
        refuse_jax()

        reading = None
        if trace:
            from discobench.lib.trace import traced
            out = work / "traced"
            out.mkdir()
            tj, reading = traced(lambda: run_job(argv(fasta, out), log))
            jobs_checked = jobs + [dict(tj, out=out)]
        else:
            jobs_checked = jobs
        failed = sum(j["rc"] != 0 for j in jobs_checked)

        # outputs: every job's files equal the sampled job's, and the
        # sampled job's equal the reference's
        sample = random.Random(seed).randrange(len(jobs))
        want_files = digest(jobs[sample]["out"])
        differ = sum(digest(j["out"]) != want_files for j in jobs_checked)
        for j in jobs_checked:
            if j is not jobs[sample]:
                shutil.rmtree(j["out"])
        reads = reference.Reads(str(fasta))
        ids = reference.read_ids(len(reads))
        out = jobs[sample]["out"]
        checks = {"jobs_failed": failed, "files_differ": differ}
        checks.update(reference.judge_graph(
            traffic["graph"].format(out=out), reads, truth, ids,
            min_overlap))
        limits = dict.fromkeys(checks, 0)
        if "contigs" in traffic:
            import glob
            assembly = config["assembly"]
            numbers, info = reference.judge_assembly(
                sorted(glob.glob(traffic["contigs"].format(out=out))),
                sorted(glob.glob(traffic["scaffolds"].format(out=out))),
                truth.genomes, assembly["full_coverage_genomes"])
            print("assembly: " + " ".join(f"{k} {v}" for k, v in
                                          info.items()), file=sys.stderr)
            checks.update(numbers)
            limits.update(pieces_off_genome=0, **assembly["limits"])
        checks = {k: {"value": int(v), "limit": limits[k]}
                  for k, v in checks.items()}
        correct = all(c["value"] <= c["limit"] for c in checks.values())

        runrec = Run(jobs, reading, reads, min_overlap, device)
        metrics = {}
        if trace:
            for m in cell["per_layer"]:
                v = load_reader(m["name"], root)(runrec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = {"reads_per_s": rate, "peak_rss_gib": rss.peak / GIB,
                      "setup_s": setup_s}
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                        else device),
               "count": cell["chips"], "memory_peak_bytes": mem_peak}
        result = {"correct": correct, "attempted": len(jobs_checked),
                  "failed": failed, "metrics": metrics, "device": dev}
        if reading is not None:
            from discobench.lib.trace import gaps_by_stage
            dev["busy_s"] = reading["busy_s"]
            dev["window_s"] = reading["wall_s"]
            top = sorted(reading["ops"].items(), key=lambda kv: -kv[1][1])
            result["breakdown"] = {
                "device_ops": [[k[:200], s] for k, (_, s) in top[:10]],
                "idle_gaps": gaps_by_stage(reading["gaps"], tj["stages"])}
        result["checks"] = checks
        refuse_jax()
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
