"""`buildg -n N -procs` and `assemble -n N -procs` (cli.py, dist/multiproc.py
::Ranks): the distributed buildG as one process a rank, this process rank 0,
on the CPU.  `cli._ranks` is replaced so that the ranks hold one CPU shard
each over gloo (`--local-devices 1`), as the CLI tests replace `cli._mesh`.
On a seeded 2,000-read set with planted 29 bp repeats
(discobench/lib/gen.py): the files against `buildg -n N` in one process, `buildg
-backend device` and the plain reference (discobench/lib/reference.py);
two jobs in one process; a rank that raises or is killed; the ranks'
records joined into rank 0's job.  Tolerance: exact.  Every wait on a rank
has its own limit (the group's timeout, the exit's grace)."""
import ctypes
import filecmp
import os
import signal
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from conftest import GOLDEN
from disco_tpu_torch import cli
from disco_tpu_torch.dist import builder, multiproc
from disco_tpu_torch.dist.mesh import make_mesh
from disco_tpu_torch.overlap import relation
from disco_tpu_torch.utils.logging import RECORDER, Recorder
from discobench.lib import reference
from discobench.lib.gen import write_reads

torch.set_num_threads(1)

SEED = 2**31 + 24
READS = {"genome_len": 40_000, "coverage": 12.5,
         "repeats": {"families": 10, "copies": 3, "length": 29}}
MIN_OVERLAP = 30
FILES = ("_0_parGraph.txt", "_0_containedReads.txt", "_0_startRead.txt",
         "_CheckpointInfo.txt", "_ReadIDMap.txt")
SPANS = ("ranks.launch", "ranks.group", "ranks.gather", "ranks.exit")
# seconds a collective waits for a peer, and the most a failed job may take
TIMEOUT_S, FAILED_JOB_S = 60.0, 45.0
MODES = {"replicated": [], "rma": ["-rma"]}


def cpu_ranks(n):
    return multiproc.Ranks("gloo", [torch.device("cpu")] * n,
                           timeout=TIMEOUT_S)


def on_cpu(mp):
    """The CLI's ranks, mesh and device path on the CPU; the started ranks
    on one thread each."""
    mp.setattr(cli, "_ranks", cpu_ranks)
    mp.setattr(cli, "_mesh", lambda n: make_mesh(n, "cpu"))
    mp.setattr(relation, "_default_device", lambda: torch.device("cpu"))
    mp.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("procs")
    truth = write_reads(str(d / "reads.fasta"), SEED, **READS)
    return {"dir": d, "fasta": str(d / "reads.fasta"), "truth": truth,
            "jobs": {}}


def job(reads, name, argv):
    """`buildg` on the reads into its own prefix, once a name: (prefix, rc,
    the recorder's view of the job)."""
    if name not in reads["jobs"]:
        prefix = str(reads["dir"] / name)
        with pytest.MonkeyPatch.context() as mp:
            on_cpu(mp)
            rc = cli.main(["buildg", "-pe", reads["fasta"], "-f", prefix,
                           "-m-ovl", str(MIN_OVERLAP), *argv])
        reads["jobs"][name] = (prefix, rc, RECORDER.jobs()[-1])
    return reads["jobs"][name]


def same_files(a, b):
    return [s for s in FILES
            if not filecmp.cmp(a + s, b + s, shallow=False)]


def judge(reads, prefix):
    r = reference.Reads(reads["fasta"])
    return reference.judge_graph(prefix, r, reads["truth"],
                                 reference.read_ids(len(r)), MIN_OVERLAP)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [2, 4])
def test_procs_files_match_one_process_and_device(reads, n, mode):
    """`buildg -n N [-rma] -procs` writes the files of `buildg -n N [-rma]`
    in one process and of `buildg -backend device`, byte for byte; rank 0
    alone writes (the prefix holds those five files); the plain reference
    reads 0 on every number."""
    procs, rc, _ = job(reads, f"procs{n}{mode}",
                       ["-n", str(n), *MODES[mode], "-procs"])
    one, rc1, _ = job(reads, f"one{n}{mode}", ["-n", str(n), *MODES[mode]])
    device, rc2, _ = job(reads, "device", ["-backend", "device"])
    assert rc == rc1 == rc2 == 0
    assert same_files(procs, one) == [] and same_files(procs, device) == []
    written = sorted(p.name for p in reads["dir"].iterdir()
                     if p.name.startswith(f"procs{n}{mode}_"))
    assert written == sorted(f"procs{n}{mode}{s}" for s in FILES)
    numbers = judge(reads, procs)
    assert not any(numbers.values()), numbers
    assert not dist.is_initialized()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [2, 4])
def test_procs_job_joins_its_ranks(reads, n, mode):
    """The job holds each ranks.* span once, `ranks` one entry a rank in
    rank order, counters that are the sum of its ranks'; its exchanges'
    bytes (dist.route_bytes + dist.fetch_bytes) are the one-process mesh's
    at the same shard count; every rank counted the same chunks; a
    one-process job has no `ranks`."""
    _, _, view = job(reads, f"procs{n}{mode}",
                     ["-n", str(n), *MODES[mode], "-procs"])
    _, _, one = job(reads, f"one{n}{mode}", ["-n", str(n), *MODES[mode]])
    for name in SPANS:
        assert view["totals"][name][0] == 1, name
    assert [r["rank"] for r in view["ranks"]] == list(range(n))
    total = {}
    for r in view["ranks"]:
        for k, v in r["counters"].items():
            total[k] = total.get(k, 0) + v
    assert view["counters"] == total
    assert view["ranks"][0]["totals"] == view["totals"]

    def sent(c):
        return c.get("dist.route_bytes", 0) + c.get("dist.fetch_bytes", 0)
    assert sent(view["counters"]) == sent(one["counters"]) > 0
    assert (view["counters"]["dist.gather_bytes"]
            == one["counters"]["dist.gather_bytes"] > 0)
    assert len({r["counters"]["dist.chunks"] for r in view["ranks"]}) == 1
    assert "ranks" not in one and not any(n in one["totals"] for n in SPANS)
    assert all("overlapRelation" in r["totals"] for r in view["ranks"])
    assert not any("buildOverlapGraphFromHashTable" in r["totals"]
                   for r in view["ranks"][1:])


def test_two_jobs_in_one_process(reads):
    """The group is formed and torn down for every job: a second job in the
    same process, on a fresh prefix (the flag spelled --procs), writes the
    same files."""
    first, _, _ = job(reads, "procs2rma", ["-n", "2", "-rma", "-procs"])
    second, rc, view = job(reads, "again2rma", ["-n", "2", "-rma", "--procs"])
    assert rc == 0 and same_files(first, second) == []
    assert view["totals"]["ranks.group"][0] == 1


def test_assemble_procs_matches_device(tmp_path, monkeypatch):
    """`assemble -n 2 -rma -procs` on mini under the thresh146 cfgs: every
    file under graph/ and assembly/ equals `assemble -backend device`'s."""
    on_cpu(monkeypatch)
    mini, cfg = GOLDEN / "mini", GOLDEN / "thresh146"
    monkeypatch.chdir(mini)
    outs = {}
    for name, argv in (("procs", ["-n", "2", "-rma", "-procs"]),
                       ("device", ["-backend", "device"])):
        outs[name] = tmp_path / name
        assert cli.main(["assemble", "-inP", "reads.fasta", "-d",
                         str(outs[name]), "-o", "mini", "-p",
                         str(cfg / "cfg.cfg"), "-p2", str(cfg / "cfg_2.cfg"),
                         "-p3", str(cfg / "cfg_3.cfg"), *argv]) == 0
    files = sorted(p.relative_to(outs["device"])
                   for p in outs["device"].rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(outs["procs"])
                           for p in outs["procs"].rglob("*") if p.is_file())
    assert len(files) > 5
    for f in files:
        assert filecmp.cmp(outs["procs"] / f, outs["device"] / f,
                           shallow=False), f


class FaultyRanks(multiproc.Ranks):
    """Rank 1 reads a file that is not there: it raises mid-build, once the
    group has formed and taken rank 0's checkpoint state."""

    def argv(self, rank, coordinator, job_argv):
        argv = super().argv(rank, coordinator, job_argv)
        if rank == 1:
            argv[argv.index("-pe") + 1] += ".missing"
        return argv


@pytest.mark.parametrize("fault", ["rank1_raises", "rank1_killed",
                                   "rank0_raises"])
def test_failed_rank_fails_the_job(reads, tmp_path, monkeypatch, fault):
    """A started rank that raises, or is killed mid-build (at rank 0's first
    pull), fails the job with return 1 (RankFailed, the rank's output's
    tail on stderr); rank 0 raising raises out of the CLI.  Each within
    FAILED_JOB_S, no rank left running, the group gone, and a job after it
    works."""
    on_cpu(monkeypatch)
    made = []

    def ranks(n):
        kind = FaultyRanks if fault == "rank1_raises" else multiproc.Ranks
        made.append(kind("gloo", [torch.device("cpu")] * n,
                         timeout=TIMEOUT_S))
        return made[-1]
    monkeypatch.setattr(cli, "_ranks", ranks)
    real_pull = builder._pull

    def pull(*a):
        if fault == "rank0_raises":
            raise RuntimeError("planted on rank 0")
        os.kill(made[-1].procs[0].pid, signal.SIGKILL)
        return real_pull(*a)
    if fault != "rank1_raises":
        monkeypatch.setattr(builder, "_pull", pull)
    argv = ["buildg", "-pe", reads["fasta"], "-f", str(tmp_path / "x"),
            "-m-ovl", str(MIN_OVERLAP), "-n", "3", "-rma", "-procs"]
    t0 = time.monotonic()
    if fault == "rank0_raises":
        with pytest.raises(RuntimeError, match="planted on rank 0"):
            cli.main(argv)
    else:
        assert cli.main(argv) == 1
    assert time.monotonic() - t0 < FAILED_JOB_S
    monkeypatch.undo()
    on_cpu(monkeypatch)
    (r,) = made
    assert len(r.procs) == 2 and all(p.exitcode is not None
                                     for p in r.procs)
    if fault == "rank1_killed":
        assert r.procs[0].exitcode == -signal.SIGKILL
    for p in r.procs:
        with pytest.raises(ProcessLookupError):
            os.kill(p.pid, 0)
    assert not dist.is_initialized()
    assert not (tmp_path / "x_0_parGraph.txt").exists()
    prefix, rc, _ = job(reads, "procs2rma", ["-n", "2", "-rma", "-procs"])
    again = str(tmp_path / "y")
    assert cli.main(["buildg", "-pe", reads["fasta"], "-f", again, "-m-ovl",
                     str(MIN_OVERLAP), "-n", "2", "-rma", "-procs"]) == 0
    assert same_files(prefix, again) == []


def test_procs_needs_a_card_a_rank(tmp_path, monkeypatch):
    """-procs raises before anything is written: without a card, with fewer
    cards than ranks, and without -n N (N > 1)."""
    argv = ["buildg", "-pe", str(GOLDEN / "mini" / "reads.fasta"), "-f",
            str(tmp_path / "x")]
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError, match="CUDA card"):
            cli.main([*argv, "-n", "8", "-procs"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 ranks need 4 CUDA cards"):
        cli.main([*argv, "-n", "4", "-rma", "-procs"])
    with pytest.raises(ValueError, match="give -n N"):
        cli.main([*argv, "-procs"])
    assert list(tmp_path.iterdir()) == []


def _native_threads():
    return ctypes.CDLL("libgomp.so.1").omp_get_max_threads()


@pytest.mark.parametrize("k", [None, 1, 3])
def test_host_threads_set_and_restored(k):
    """Inside `host_threads(k)` torch's and the native libraries' OpenMP
    runtimes start regions on k threads; after it, on as many as before;
    None changes neither."""
    before = torch.get_num_threads(), _native_threads()
    with multiproc.host_threads(k):
        inside = torch.get_num_threads(), _native_threads()
    assert inside == (before if k is None else (k, k))
    assert (torch.get_num_threads(), _native_threads()) == before


def test_ranks_run_on_their_host_share(reads, tmp_path, monkeypatch):
    """Ranks on cards take an n-th of the host's cores each; a job with
    `threads` runs rank 0's build on that many threads, starts the ranks
    with --threads, writes the same files, and leaves this process's
    thread counts as they were."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = multiproc.Ranks.on_cards(4)
    assert cards.threads == multiproc.host_share(4) == max(
        1, len(os.sched_getaffinity(0)) // 4)
    assert cards.argv(1, "h:1", [])[-2:] == ["--threads", str(cards.threads)]
    monkeypatch.undo()
    on_cpu(monkeypatch)
    made, seen = [], []
    monkeypatch.setattr(cli, "_ranks", lambda n: made.append(
        multiproc.Ranks("gloo", [torch.device("cpu")] * n,
                        timeout=TIMEOUT_S, threads=2)) or made[-1])
    real = multiproc.run_buildg_sharded

    def build(*a, **kw):
        seen.append((torch.get_num_threads(), _native_threads()))
        return real(*a, **kw)
    monkeypatch.setattr(multiproc, "run_buildg_sharded", build)
    before = torch.get_num_threads(), _native_threads()
    prefix = str(tmp_path / "x")
    assert cli.main(["buildg", "-pe", reads["fasta"], "-f", prefix, "-m-ovl",
                     str(MIN_OVERLAP), "-n", "2", "-rma", "-procs"]) == 0
    assert seen == [(2, 2)]
    assert (torch.get_num_threads(), _native_threads()) == before
    (r,) = made
    assert "--threads" in r.argv(1, "h:1", [])
    one, _, _ = job(reads, "one2rma", ["-n", "2", "-rma"])
    assert same_files(prefix, one) == []


def test_rank_launcher_leaves_with_its_caller():
    """A process that started the rank launcher (dist/launch.py) closes it
    at its exit and waits for it: once the process has exited, so has the
    launcher, even one still importing torch."""
    code = ("from disco_tpu_torch.dist import launch, multiproc; "
            "print(launch.launcher(multiproc._rank_env()).proc.pid)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=GOLDEN.parents[1])
    assert out.returncode == 0, out.stderr
    with pytest.raises(ProcessLookupError):
        os.kill(int(out.stdout), 0)


@pytest.mark.parametrize("rank", [0, 2])
def test_join_ranks_sums_counters(rank):
    """A job that joins its ranks' records: `ranks` in rank order, this
    process's entry its live record, counters the ranks' sum, totals this
    process's; a counter added after the join counts."""
    rec = Recorder()
    with rec.job():
        with rec.span("a"):
            rec.count("c", 2)
        peers = [{"totals": {"b": (1, 0.5, 0.5)}, "counters": {"c": 5,
                                                                 "d": 1},
                  "device_peak_bytes": 7} for _ in range(3)]
        peers[rank] = rec.snapshot()
        rec.join_ranks(peers, rank)
        rec.count("c", 1)
    (view,) = rec.jobs()
    assert [r["rank"] for r in view["ranks"]] == [0, 1, 2]
    assert view["ranks"][rank]["counters"] == {"c": 3}
    assert view["counters"] == {"c": 13, "d": 2}
    assert set(view["totals"]) == {"job", "a"}
    assert view["ranks"][rank]["totals"] == view["totals"]
    assert [r.get("device_peak_bytes") for r in view["ranks"]].count(7) == 2
