"""The distributed-memory cell, ecoli_k12.buildg-rma4 (`buildg -n 4 -rma`):
a tiny copy on the CPU, its four shards on the CPU too, is correct, and its
four dist.* readers read numbers that agree with what the sharded loop
itself took; a fault planted in that loop makes the run not correct.  On
the card, at the cell's own size, the sound cell is correct and each fault
is not correct on three seeds (skips without a card, decided inside the
test):

    python -m pytest --noconftest -p no:cacheprovider -s discobench/tests \
        -m cuda -k rma4
"""
import json
import subprocess
import sys
import time

import pytest

from _tiny import ROOT, on_cpu, run_tiny, tiny_root
from discobench import harness
from discobench.lib import spans

RMA4 = "ecoli_k12.buildg-rma4"
NEW = ("dist.host_s", "dist.pull_s", "dist.exchange_gib",
       "dist.fallback_share")
SEEDS = (2200000301, 2200000302, 2200000303)


def shards_on_cpu(monkeypatch):
    """The device path and the CLI's mesh (`-n`) on the CPU."""
    from disco_tpu_torch import cli
    from disco_tpu_torch.dist.mesh import make_mesh
    on_cpu(monkeypatch)
    monkeypatch.setattr(cli, "_mesh", lambda n: make_mesh(n, "cpu"))


def last_shard_dropped(monkeypatch):
    """`builder._pull` leaves out the last shard's kept rows of every
    chunk: its count read as 0."""
    from disco_tpu_torch.dist import builder
    real = builder._pull

    def dropped(mesh, rows, metas):
        last = metas[-1].clone()
        last[0] = 0
        return real(mesh, rows, metas[:-1] + [last])
    monkeypatch.setattr(builder, "_pull", dropped)


def neighbour_rows(monkeypatch):
    """`_fetch_rows` serves every request from the neighbouring shard's
    payload block: the row of read r + 1 where read r's was asked for."""
    from disco_tpu_torch.dist.overlap_shard import DistMemOverlapEngine
    real = DistMemOverlapEngine._fetch_rows

    def shifted(self, row_ids, payload, *a):
        return real(self, row_ids, payload[1:] + payload[:1], *a)
    monkeypatch.setattr(DistMemOverlapEngine, "_fetch_rows", shifted)


FAULTS = (last_shard_dropped, neighbour_rows)


def numbers(result):
    return {k: c["value"] for k, c in result["checks"].items()}


@pytest.fixture
def root(tmp_path, monkeypatch):
    shards_on_cpu(monkeypatch)
    return tiny_root(tmp_path)


@pytest.mark.parametrize("caps", ["as_built", "route_cap_8"])
def test_sound_cell_reads_its_metrics(root, tmp_path, monkeypatch, caps):
    """Every check reads 0; each dist.* reader reads a number;
    dist.fallback_share is the builder's stats ratio and the counter
    dist.rows the rows `_pull` brought to the host, in the window's job;
    dist.host_s and dist.pull_s add up to overlap.relation_s within 10%;
    with a route cap of 8 every chunk overflows into the exact re-run, and
    the run stays correct."""
    from disco_tpu_torch.dist import builder
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

    monkeypatch.setattr(builder, "sharded_relation_pruned", pruned)
    monkeypatch.setattr(builder, "_pull", pull)
    monkeypatch.setattr(harness, "Run", keep_run)
    if caps == "route_cap_8":
        monkeypatch.setattr(builder, "_default_route_cap", lambda c, n: 8)
    r = run_tiny(root, RMA4, tmp=str(tmp_path))
    assert r["correct"] and not any(numbers(r).values()), numbers(r)
    assert r["attempted"] == 1 and len(calls) == 2   # warm-up, window job
    run = runs[-1]
    got = {name: harness.load_reader(name, root)(run) for name in NEW}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    stats = calls[-1]["stats"]
    assert got["dist.fallback_share"] == pytest.approx(
        100.0 * stats["fallback_chunks"] / stats["chunks"])
    assert (stats["fallback_chunks"] == stats["chunks"]) == (
        caps == "route_cap_8")
    (job,) = spans.window_jobs(run)
    assert job["counters"].get("dist.rows", 0) == calls[-1]["rows"]
    assert job["counters"]["dist.chunks"] == stats["chunks"]
    assert got["dist.exchange_gib"] > 0
    relation_s = harness.load_reader("overlap.relation_s", root)(run)
    parts = got["dist.host_s"] + got["dist.pull_s"]
    assert abs(parts - relation_s) <= 0.1 * relation_s


@pytest.mark.parametrize("key", ["reads", "MinOverlap4BuildGraph", "cfgs",
                                 "ranks"])
def test_deployment_is_the_isolate_on_four_ranks(key):
    """The cell's configuration is ecoli_k12's read set, cfgs and
    MinOverlap under four ranks, the `-n` of the cell's traffic."""
    cell = harness.load_cell(RMA4, ROOT)
    conf = cell["config"]
    if key == "ranks":
        argv = cell["traffic"]["argv"]
        assert conf["ranks"] == int(argv[argv.index("-n") + 1]) == 4
        assert "-rma" in argv and conf["mode"] == "rma"
        return
    isolate = harness.load_cell("ecoli_k12.buildg", ROOT)["config"]
    assert conf[key] == isolate[key]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    r = run_tiny(root, RMA4, tmp=str(tmp_path))
    assert not r["correct"], numbers(r)


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_rma4_cell_is_correct_on_the_card():
    _card()
    p = subprocess.run([sys.executable, str(ROOT / "discobench" / "run.py"),
                        "--workload", RMA4, "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().split("\n")[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_rma4_fault_at_the_cells_size(tmp_path, monkeypatch, fault):
    """Prints one JSON line a seed: the numbers compared, and their
    limits."""
    _card()
    fault(monkeypatch)
    for seed in SEEDS:
        r = harness.run(RMA4, seed, 1.0, False, time.perf_counter(), ROOT,
                        work_root=str(tmp_path))
        print(json.dumps({"cell": RMA4, "fault": fault.__name__,
                          "seed": seed, "checks": r["checks"]}), flush=True)
        assert not r["correct"]
