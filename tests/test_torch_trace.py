"""The span recorder of disco_tpu_torch/utils/logging.py: spans nest under
their parents and their job, `clock` keeps its log records, memory stays
bounded, the device relation records its chunk spans and counters (mini on
the CPU, the kernels' plain versions), no span enters a profiler, and the
CLI's trace wrap carries the spans on the profiler's clock."""
import json
import logging
import tracemalloc

import numpy as np
import pytest
import torch

from conftest import GOLDEN

from disco_tpu_torch import cli
from disco_tpu_torch.index.table import FingerprintTable
from disco_tpu_torch.io.readstore import ReadStore
from disco_tpu_torch.overlap import relation
from disco_tpu_torch.utils import logging as tlog
from disco_tpu_torch.utils.logging import RECORDER, Recorder

MINI, MICRO = GOLDEN / "mini", GOLDEN / "micro"
# the relation's spans: every chunk's, then once a relation; fallback only
# on a chunk over its caps
CHUNK_SPANS = ("relation.windows", "relation.step", "relation.wait",
               "relation.pull", "relation.decode", "relation.order")
ONCE_SPANS = ("relation.upload", "relation.join")


def _on_cpu(mp):
    mp.setattr(relation, "_default_device", lambda: torch.device("cpu"))


def _buildg(out, reads=MINI, backend="device"):
    return cli.main(["buildg", "-pe", str(reads / "reads.fasta"), "-f",
                     str(out / "g"), "-p", str(reads / "buildg.cfg"),
                     "-backend", backend])


def _last_job():
    job = RECORDER.jobs()[-1]
    return job, RECORDER.spans(job["id"])


@pytest.fixture(scope="module")
def mini_device(tmp_path_factory):
    """buildg -backend device on mini, on the CPU, as one job: (its job,
    its spans, the output directory)."""
    out = tmp_path_factory.mktemp("mini_device")
    with pytest.MonkeyPatch.context() as mp:
        _on_cpu(mp)
        assert _buildg(out) == 0
    return (*_last_job(), out)


@pytest.fixture(scope="module")
def mini_traced(tmp_path_factory):
    """The same under DISCO_TPU_TORCH_TRACE: (the trace's events, the
    job's spans, the output directory)."""
    out = tmp_path_factory.mktemp("mini_traced")
    with pytest.MonkeyPatch.context() as mp:
        _on_cpu(mp)
        mp.setenv(cli.TRACE_ENV, str(out / "trace"))
        assert _buildg(out) == 0
    (path,) = (out / "trace").iterdir()
    return json.loads(path.read_text())["traceEvents"], _last_job()[1], out


def test_spans_nest_under_parents_and_jobs():
    rec = Recorder()
    with rec.span("outside"):
        rec.count("loose", 2)
    with rec.job() as root:
        with rec.span("stage") as stage:
            with rec.span("step") as step:
                rec.count("c", 3)
            with rec.span("step"):
                rec.count("c", 4)
        with rec.job("nested") as nested:
            pass
    with rec.job() as second:
        with rec.span("stage"):
            pass
    first, last = rec.jobs()
    assert (first["id"], last["id"]) == (root.id, second.id)
    spans = {s["id"]: s for s in rec.spans(root.id)}
    assert spans[step.id]["parent"] == stage.id
    assert spans[stage.id]["parent"] == root.id
    assert spans[nested.id]["parent"] == root.id
    assert spans[root.id]["parent"] is None
    assert [s["name"] for s in spans.values()].count("step") == 2
    assert all(s["t0"] <= s["t1"] for s in spans.values())
    assert first["counters"] == {"c": 7}
    assert first["totals"]["step"][0] == 2
    # self time: the span less its children
    c, secs, self_s = first["totals"]["stage"]
    assert self_s == pytest.approx(secs - first["totals"]["step"][1])
    assert first["t0"] <= spans[stage.id]["t0"]
    assert first["t1"] == spans[root.id]["t1"]
    wall_ns, perf_ns = first["anchor"]
    assert perf_ns == first["t0"] and wall_ns > 0
    # outside any job: the process's job
    assert [s["name"] for s in rec.spans(0)] == ["outside"]
    assert rec.spans(0)[0]["parent"] is None
    assert [s["name"] for s in rec.spans(second.id)] == ["stage", "job"]


def test_clock_keeps_its_records():
    """`clock`'s INFO record keeps (name, seconds, rss before, rss after),
    in that order, and the DEBUG `>>>` record; the rss pair is the resident
    set at the stage's ends, not the process's high-water mark."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    keep, level = Keep(logging.DEBUG), tlog.log.level
    tlog.log.setLevel(logging.DEBUG)
    tlog.log.addHandler(keep)
    try:
        with RECORDER.job():
            with tlog.clock("big"):
                block = np.ones(1 << 23)          # 64 MB, touched
            del block                             # and given back
            with tlog.clock("small"):
                pass
    finally:
        tlog.log.removeHandler(keep)
        tlog.log.setLevel(level)
    (dbig, big, dsmall, small) = records
    assert (dbig.levelno, dbig.msg, dbig.args) == (logging.DEBUG,
                                                   ">>> %s()", ("big",))
    assert big.msg == "<<< %s(): %.3fs, rss %.0f -> %.0f MB"
    assert big.args[0] == "big" and small.args[0] == "small"
    assert all(isinstance(a, float) for a in big.args[1:])
    # "big" ends 64 MB up; "small" starts after they went back
    assert big.args[3] - big.args[2] > 48
    assert small.args[2] < big.args[3] - 48
    spans = {s["name"]: s for s in RECORDER.spans(RECORDER.jobs()[-1]["id"])}
    assert spans["small"]["rss"] == small.args[2:]
    assert big.args[1] == pytest.approx(
        (spans["big"]["t1"] - spans["big"]["t0"]) / 1e9)
    import resource
    high = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    assert small.args[2] < high


def test_recorder_memory_is_bounded():
    """5,000 jobs of 50 spans and 3 counters each: the last 1,024 keep
    their totals and counters, the last 2 their spans, and the recorder
    holds under 10 MB."""
    rec = Recorder()
    tracemalloc.start()
    try:
        for _ in range(5000):
            with rec.job():
                for i in range(50):
                    with rec.span(f"s{i % 10}"):
                        pass
                for c in ("a", "b", "c"):
                    rec.count(c, 1)
        held, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    jobs = rec.jobs()
    assert len(jobs) == 1024
    assert all(j["counters"] == {"a": 1, "b": 1, "c": 1} for j in jobs)
    assert all(j["totals"]["s3"][0] == 5 for j in jobs)
    kept = [rec.spans(j["id"]) for j in jobs]
    assert all(k is None for k in kept[:-2])
    assert [len(k) for k in kept[-2:]] == [51, 51]
    assert held < 10 << 20, held


def test_device_relation_records_its_chunk_spans(mini_device):
    """Every relation span under overlapRelation, in the job; their seconds
    within 10% of overlapRelation's; the outputs unchanged."""
    job, spans, out = mini_device
    by_id = {s["id"]: s for s in spans}
    (rel,) = [s for s in spans if s["name"] == "overlapRelation"]
    names = [s["name"] for s in spans]
    chunks = names.count("relation.step")
    assert chunks >= 3
    for name in CHUNK_SPANS[1:]:
        assert names.count(name) == chunks, name
    for name in ONCE_SPANS:
        assert names.count(name) == 1, name
    for s in spans:
        if s["name"].startswith("relation."):
            assert rel["t0"] <= s["t0"] <= s["t1"] <= rel["t1"]
            up = s
            while up["parent"] in by_id and up["name"] != "overlapRelation":
                up = by_id[up["parent"]]
            assert up is rel, s
    parts = sum(v[1] for n, v in job["totals"].items()
                if n.startswith("relation."))
    whole = job["totals"]["overlapRelation"][1]
    assert abs(parts - whole) <= 0.1 * whole
    for suffix in ("_0_parGraph.txt", "_0_containedReads.txt"):
        assert ((out / f"g{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix
    assert job["counters"]["relation.candidates"] > 0


def test_slots_count_every_chunk_and_fallback_is_a_span(tmp_path):
    """relation.slots = stats["chunks"] x cand_cap, relation.candidates the
    chunks' candidates; a chunk over its caps is a relation.fallback span,
    its rows ordered after it."""
    store = ReadStore.from_files([str(MINI / "reads.fasta")], [], 30,
                                 id_map_path=str(tmp_path / "ids.txt"))
    table = FingerprintTable.build(store, 29)
    for factor, over in ((4, False), (0.05, True)):
        with RECORDER.job():
            rel = relation._device_relation(store, table, chunk=1 << 13,
                                            cand_factor=factor,
                                            device="cpu")
        job, spans = _last_job()
        names = [s["name"] for s in spans]
        cand_cap = int(factor * (1 << 13))
        assert (job["counters"]["relation.slots"]
                == rel.stats["chunks"] * cand_cap)
        assert names.count("relation.wait") == rel.stats["chunks"]
        assert names.count("relation.fallback") == rel.stats[
            "fallback_chunks"]
        assert (rel.stats["fallback_chunks"] > 0) == over
    native = relation.compute_relation(store, table, backend="native")
    assert np.array_equal(rel.r2, native.r2)


def test_no_span_enters_the_profiler(tmp_path, monkeypatch):
    """Under torch.profiler a job records its spans but adds no profiler
    event named after one."""
    from torch.profiler import ProfilerActivity, profile
    _on_cpu(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _buildg(tmp_path, MICRO) == 0
    names = {s["name"] for s in _last_job()[1]}
    assert {"job", "overlapRelation", "relation.step"} <= names
    assert not names & {e.name for e in prof.events()}


def test_trace_wrap_places_spans_on_the_profilers_clock(mini_traced,
                                                        mini_device):
    """The exported trace holds the job's spans on a track of their own,
    and each relation.step span holds the aten::searchsorted operators its
    step enqueued (the lookup and the candidates' windows), every one of
    them inside a step; no profiler event carries a span's name; the
    outputs equal those of the run without the wrap."""
    events, spans, out = mini_traced
    mine = [e for e in events if e.get("pid") == cli.SPAN_PID
            and e.get("ph") == "X"]
    # the job's own span closes after the export
    assert sorted(e["name"] for e in mine) == sorted(
        s["name"] for s in spans if s["name"] != "job")
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in mine
             if e["name"] == "relation.step"]
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("name") == "aten::searchsorted" and e.get("ph") == "X"]
    assert len(steps) >= 3 and ops
    for a, b in steps:
        assert sum(a <= lo and hi <= b for lo, hi in ops) >= 3
    for lo, hi in ops:
        assert any(a <= lo and hi <= b for a, b in steps), (lo, hi)
    others = {e.get("name") for e in events if e.get("pid") != cli.SPAN_PID}
    assert not others & {s["name"] for s in spans}
    for suffix in ("_0_parGraph.txt", "_0_containedReads.txt"):
        assert ((out / f"g{suffix}").read_bytes()
                == (mini_device[2] / f"g{suffix}").read_bytes())
