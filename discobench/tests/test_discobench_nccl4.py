"""The multi-process cell, ecoli_k12.buildg-nccl4 (`buildg -n 4 -rma
--procs`): a tiny copy on the CPU, its four ranks processes over gloo
(`cli._ranks` replaced, one CPU shard a rank), is correct; its three new
readers read numbers, dist.link_share within (0, 100]; the dist.* readers
agree with what rank 0's loop took; a fault planted in rank 0's loop makes
the run not correct.  On four cards, at the cell's own size, the cell is
correct (skips with fewer, decided inside the test):

    python -m pytest --noconftest -p no:cacheprovider -s discobench/tests \
        -m cuda -k nccl4
"""
import json
import subprocess
import sys

import pytest

from _tiny import ROOT, SEED, on_cpu, run_tiny, tiny_root
from discobench import harness
from discobench.lib import spans

NCCL4 = "ecoli_k12.buildg-nccl4"
NEW = ("ranks.overhead_s", "dist.collective_s", "dist.link_share")
DIST = ("dist.host_s", "dist.pull_s", "dist.exchange_gib",
        "dist.fallback_share")


def ranks_on_cpu(monkeypatch):
    """The device path, the CLI's mesh and its ranks on the CPU: each rank
    a process of one CPU shard over gloo, on one thread."""
    import torch
    from disco_tpu_torch import cli
    from disco_tpu_torch.dist.mesh import make_mesh
    from disco_tpu_torch.dist.multiproc import Ranks
    on_cpu(monkeypatch)
    monkeypatch.setattr(cli, "_mesh", lambda n: make_mesh(n, "cpu"))
    monkeypatch.setattr(cli, "_ranks", lambda n: Ranks(
        "gloo", [torch.device("cpu")] * n, timeout=120))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def rank0_rows_dropped(monkeypatch):
    """Rank 0's `builder._pull` reports its shard's count of kept rows as
    0: every rank leaves rank 0's rows out of every chunk."""
    from disco_tpu_torch.dist import builder
    real = builder._pull

    def dropped(mesh, rows, metas):
        last = metas[-1].clone()
        last[0] = 0
        return real(mesh, rows, metas[:-1] + [last])
    monkeypatch.setattr(builder, "_pull", dropped)


def neighbour_block_rows(monkeypatch):
    """Rank 0's `_fetch_rows` asks for read r + 1's row where read r's was
    wanted: its rows come from the neighbouring rank's block."""
    import torch
    from disco_tpu_torch.dist.overlap_shard import DistMemOverlapEngine
    real = DistMemOverlapEngine._fetch_rows

    def shifted(self, row_ids, payload, n_reads, *a):
        moved = [torch.where(i >= 0, (i % n_reads + 1) % n_reads
                             + (i >= n_reads).to(i.dtype) * n_reads, i)
                 for i in row_ids]
        return real(self, moved, payload, n_reads, *a)
    monkeypatch.setattr(DistMemOverlapEngine, "_fetch_rows", shifted)


FAULTS = (rank0_rows_dropped, neighbour_block_rows)


def numbers(result):
    return {k: c["value"] for k, c in result["checks"].items()}


@pytest.fixture
def root(tmp_path, monkeypatch):
    ranks_on_cpu(monkeypatch)
    return tiny_root(tmp_path, genome_len=20_000, families=(5, 1))


def test_sound_cell_reads_its_metrics(root, tmp_path, monkeypatch):
    """A traced run (a stand-in trace: the CPU has no card, so rank 0's
    collectives are given one second) reads 0 on every check; each new
    reader and each dist.* reader reads a number; dist.collective_s is the
    trace's NCCL kernel seconds (not the profiler's nccl:* ranges),
    dist.link_share lies in (0, 100];
    dist.fallback_share is rank 0's stats ratio, the job's dist.rows four
    times the rows rank 0 pulled, dist.exchange_gib its ranks' bytes."""
    from disco_tpu_torch.dist import builder
    from discobench.lib import trace
    calls, runs = [], []
    real_pruned, real_pull, make_run = (builder.sharded_relation_pruned,
                                        builder._pull, harness.Run)

    def pruned(*a, **kw):
        calls.append({"rows": 0})
        out = real_pruned(*a, **kw)
        calls[-1]["stats"] = dict(out[0].stats)
        return out

    def pull(*a):
        got = real_pull(*a)
        calls[-1]["rows"] += 0 if got is None else len(got)
        return got

    def keep_run(*a):
        runs.append(make_run(*a))
        return runs[-1]

    def stand_in(fn):
        out = fn()
        return out, {"wall_s": out["t1"] - out["t0"], "busy_s": 1.0,
                     "ops": {"ncclDevKernel_SendRecv": (3, 1.0),
                             "nccl:all_to_all": (3, 1.5)},
                     "gaps": []}

    monkeypatch.setattr(builder, "sharded_relation_pruned", pruned)
    monkeypatch.setattr(builder, "_pull", pull)
    monkeypatch.setattr(harness, "Run", keep_run)
    monkeypatch.setattr(trace, "traced", stand_in)
    r = harness.run(NCCL4, SEED, 0.0, True, 0.0, root, device="cpu",
                    work_root=str(tmp_path))
    assert r["correct"] and not any(numbers(r).values()), numbers(r)
    assert r["attempted"] == 2 and len(calls) == 3  # warm-up, window, traced
    got = {k: m["value"] for k, m in r["metrics"].items()}
    assert set(NEW + DIST) <= set(got), got
    assert all(isinstance(got[k], float) and got[k] >= 0
               for k in NEW + DIST), got
    assert got["dist.collective_s"] == 1.0
    assert 0 < got["dist.link_share"] <= 100
    assert got["ranks.overhead_s"] > 0
    assert "kernel.dual_check_roofline" not in got
    run = runs[-1]
    (job,) = spans.window_jobs(run)
    stats = calls[1]["stats"]
    assert got["dist.fallback_share"] == pytest.approx(
        100.0 * stats["fallback_chunks"] / stats["chunks"])
    assert len(job["ranks"]) == 4
    assert job["counters"]["dist.rows"] == 4 * calls[1]["rows"]
    assert job["counters"]["dist.chunks"] == 4 * stats["chunks"]
    assert got["dist.exchange_gib"] * (1 << 30) == pytest.approx(sum(
        rk["counters"][c] for rk in job["ranks"]
        for c in ("dist.route_bytes", "dist.fetch_bytes")))
    relation_s = harness.load_reader("overlap.relation_s", root)(run)
    parts = got["dist.host_s"] + got["dist.pull_s"]
    assert abs(parts - relation_s) <= 0.1 * relation_s


@pytest.mark.parametrize("key", ["reads", "MinOverlap4BuildGraph", "cfgs",
                                 "ranks"])
def test_deployment_is_the_isolate_on_four_processes(key):
    """The cell's configuration is ecoli_k12's read set, cfgs and
    MinOverlap under four ranks, the `-n` of its traffic, launched as
    processes (`--procs`, which a program without the flag refuses) on
    four chips."""
    cell = harness.load_cell(NCCL4, ROOT)
    conf = cell["config"]
    if key == "ranks":
        argv = cell["traffic"]["argv"]
        assert conf["ranks"] == int(argv[argv.index("-n") + 1]) == 4
        assert cell["chips"] == 4 and "--procs" in argv
        assert "-rma" in argv and conf["mode"] == "rma"
        return
    isolate = harness.load_cell("ecoli_k12.buildg", ROOT)["config"]
    assert conf[key] == isolate[key]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    r = run_tiny(root, NCCL4, tmp=str(tmp_path))
    assert not r["correct"], numbers(r)


@pytest.mark.cuda
def test_nccl4_cell_is_correct_on_four_cards():
    import torch
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")
    p = subprocess.run([sys.executable, str(ROOT / "discobench" / "run.py"),
                        "--workload", NCCL4, "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().split("\n")[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["count"] == 4
