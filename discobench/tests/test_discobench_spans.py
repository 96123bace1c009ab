"""The readers of the program's spans and counters (lib/spans.py and the
metrics that use it): each reads a number after a tiny traced run on the
CPU, the busy share reads None without a trace, the arithmetic of idle
gaps against a span, and on the card, at the cells' size, every new
metric reads and the busy share over the whole job agrees with
device.idle_share.

    python -m pytest --noconftest -p no:cacheprovider -s discobench/tests \
        -m cuda -k spans
"""
import json
import time

import pytest

from _tiny import ISOLATE, MOCK, ROOT, SEED, on_cpu, tiny_root
from discobench import harness
from discobench.lib import spans as lib

NEW = {"overlap.host_s", "overlap.wait_s", "kernel.dual_check_slot_use",
       "device.relation_busy_share", "simplify.driver_self_s",
       "kernels.load_s"}


def _listed(cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}


def _traced_run(monkeypatch, root, cell, seconds, device, tmp):
    """harness.run with --trace 1: (its result, its Run, the trace's
    reading)."""
    from discobench.lib import trace
    runs, readings = [], []
    make_run, traced = harness.Run, trace.traced

    def keep_run(*a):
        runs.append(make_run(*a))
        return runs[-1]

    def keep_reading(fn):
        out, reading = traced(fn)
        readings.append(reading)
        return out, reading

    monkeypatch.setattr(harness, "Run", keep_run)
    monkeypatch.setattr(trace, "traced", keep_reading)
    r = harness.run(cell, SEED if device == "cpu" else 2200000411, seconds,
                    True, time.perf_counter(), root, device=device,
                    work_root=tmp)
    return r, runs[-1], readings[-1]


@pytest.mark.parametrize("cell", [ISOLATE, MOCK])
def test_new_readers_read_after_a_tiny_run(tmp_path, monkeypatch, cell):
    import torch
    root = tiny_root(tmp_path, genome_len=12_000, mock_len=10_000,
                     mock_reads=6_000, warmup=300, families=(3, 1))
    on_cpu(monkeypatch)
    # the trace's synchronisations have no card to wait for here
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    r, run, _ = _traced_run(monkeypatch, root, cell, 0.0, "cpu",
                            str(tmp_path))
    assert r["correct"]
    got = {k: m["value"] for k, m in r["metrics"].items() if k in NEW}
    assert set(got) == _listed(cell)
    assert all(isinstance(v, float) and v >= 0 for v in got.values())
    # the CPU's trace holds no device work: the relation is all idle
    assert got["device.relation_busy_share"] == 0.0
    assert 0 < got["kernel.dual_check_slot_use"] < 100
    run.trace = None
    read = harness.load_reader("device.relation_busy_share", root)
    assert read(run) is None


def test_readers_read_none_without_the_recorder(monkeypatch):
    """Against a program older than the recorder, every new reader returns
    None and none raises."""
    monkeypatch.setattr(lib, "recorder", lambda: None)
    run = harness.Run([{"t0": 1.0, "t1": 2.0, "stages": []}],
                      {"gaps": [], "wall_s": 1.0, "busy_s": 0.0, "ops": {}},
                      None, 30, "cpu")
    for name in NEW:
        assert harness.load_reader(name, ROOT)(run) is None, name


def test_gap_arithmetic_against_a_span(monkeypatch):
    """A span of perf 51-53 s in a job anchored at (wall 1000 s, perf 50 s)
    lies at wall 1001-1003 s; gaps cover 0.5 + 0.5 + 0.1 s of it, so the
    card is busy 45% of it."""
    job = {"id": 7, "anchor": (1000 * 10**9, 50 * 10**9)}
    rows = [{"name": "overlapRelation", "t0": 51 * 10**9, "t1": 53 * 10**9},
            {"name": "other", "t0": 50 * 10**9, "t1": 54 * 10**9}]

    class Stub:
        def spans(self, job_id):
            return rows if job_id == 7 else None

    monkeypatch.setattr(lib, "recorder", Stub)
    monkeypatch.setattr(lib, "traced_job", lambda run: job)
    gaps = [(1000.5, 1001.5), (1002.0, 1002.5), (1002.9, 1010.0)]
    run = harness.Run([], {"gaps": gaps}, None, 30, "cpu")
    assert lib.wall(job, 51 * 10**9) == 1001.0
    assert lib.covered(1001.0, 1003.0, gaps) == pytest.approx(1.1)
    assert lib.span_busy_share(run, "overlapRelation") == pytest.approx(45.0)
    assert lib.busy_share([(1001.0, 1002.0), (1002.0, 1003.0)],
                          gaps) == pytest.approx(45.0)
    assert lib.span_busy_share(run, "absent") is None
    run.trace = None
    assert lib.span_busy_share(run, "overlapRelation") is None


def test_window_jobs_match_by_interval(monkeypatch):
    """A window job holds exactly one recorder job; the traced job is the
    first after the window; a window job holding none reads None."""
    rec_jobs = [{"id": i, "t0": t0, "t1": t1, "totals": {"x": (1, s, s / 2)},
                 "counters": {"n": i, "d": 10}}
                for i, (t0, t1, s) in enumerate(
                    [(1.1e9, 1.9e9, 0.5), (2.1e9, 2.9e9, 0.7),
                     (3.1e9, 3.9e9, 9.0)], 1)]

    class Stub:
        def jobs(self):
            return rec_jobs

    monkeypatch.setattr(lib, "recorder", Stub)
    run = harness.Run([{"t0": 1.0, "t1": 2.0}, {"t0": 2.0, "t1": 3.0}],
                      None, None, 30, "cpu")
    assert [j["id"] for j in lib.window_jobs(run)] == [1, 2]
    assert lib.traced_job(run)["id"] == 3
    assert lib.mean_seconds(run, ("x",)) == pytest.approx(0.6)
    assert lib.mean_seconds(run, ("x",), self_time=True) == pytest.approx(
        0.3)
    assert lib.mean_seconds(run, ("y",)) is None
    assert lib.counter_ratio(run, "n", "d") == pytest.approx(15.0)
    run.jobs.append({"t0": 4.0, "t1": 5.0})
    assert lib.window_jobs(run) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [ISOLATE, MOCK])
def test_new_metrics_on_the_card(tmp_path, monkeypatch, cell):
    """At the cell's size, traced: every new metric of the cell reads; the
    relation's host and wait seconds add up to overlap.relation_s within
    5%; the busy share over the traced job's whole span agrees with
    100 - device.idle_share within 1 point."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r, run, reading = _traced_run(monkeypatch, ROOT, cell, 1.0, "cuda",
                                  str(tmp_path))
    m = {k: v["value"] for k, v in r["metrics"].items()}
    job = lib.traced_job(run)
    spans = lib.recorder().spans(job["id"])
    (root,) = [s for s in spans if s["name"] == "job"]
    whole = lib.busy_share([(lib.wall(job, root["t0"]),
                             lib.wall(job, root["t1"]))], reading["gaps"])
    print(json.dumps({"cell": cell, "metrics": m, "spans": len(spans),
                      "counters": job["counters"], "totals": job["totals"],
                      "job_busy_share": whole}), flush=True)
    assert r["correct"] and set(m) >= _listed(cell)
    parts = m["overlap.host_s"] + m["overlap.wait_s"]
    assert abs(parts - m["overlap.relation_s"]) <= 0.05 * m[
        "overlap.relation_s"]
    assert abs(whole - (100.0 - m["device.idle_share"])) <= 1.0
