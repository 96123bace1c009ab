"""The sharded relation's spans and counters in the span recorder
(disco_tpu_torch/utils/logging.py): dist/builder.py::_relation opens a
span "dist.<stage>" for each of its HOST_STAGES and none of the
single-device loop's "relation.*" names, and the single-device loop opens
no "dist.*" span; `profile["host_s"]` is the dist.* spans' seconds; the
counters dist.chunks, dist.fallback_chunks and dist.rows are what the loop
took, and dist.route_bytes and dist.fetch_bytes the bytes of the tensors
that the exchanges of dist/overlap_shard.py hand to `all_to_all`, counted
here by wrapping it, and equal to the closed form of the padded buffers.
Golden mini on CPU shards (the kernels' plain versions).  On a card the
counting adds no synchronisation: a dist-mem superstep and its compaction
raise nothing under `torch.cuda.set_sync_debug_mode("error")`.

This file imports neither jax nor disco_tpu, so its card test runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_dist_trace.py -m cuda
"""
import pathlib

import numpy as np
import pytest
import torch

from disco_tpu_torch.buildg import pipeline
from disco_tpu_torch.dist import builder, overlap_shard
from disco_tpu_torch.dist.mesh import make_mesh
from disco_tpu_torch.dist.overlap_shard import (DistMemOverlapEngine,
                                                ShardedOverlapEngine)
from disco_tpu_torch.index.table import FingerprintTable
from disco_tpu_torch.io.readstore import ReadStore
from disco_tpu_torch.overlap import relation
from disco_tpu_torch.overlap.device import window_offsets
from disco_tpu_torch.utils.logging import RECORDER

MINI = pathlib.Path(__file__).resolve().parent / "golden" / "mini"
BUDGET = 1 << 16          # at least 3 chunks on mini
MODES = {"replicated": False, "dist_mem": True}
# a route cap of 8 slots a peer overflows every chunk into the exact re-run
CAPS = {"as_built": None, "route_cap_8": 8}


def _last_job():
    job = RECORDER.jobs()[-1]
    return job, RECORDER.spans(job["id"])


def _mini_state(tmp_path):
    store = ReadStore.from_files([str(MINI / "reads.fasta")], [], 30,
                                 id_map_path=str(tmp_path / "ids.txt"))
    return store, FingerprintTable.build(store, 29)


def _sharded_build(tmp_path, mode, route_cap, monkeypatch, n=4):
    """run_buildg_sharded on mini over n CPU shards, as one recorder job:
    (its job, its spans, the stats, the rows each `_pull` returned)."""
    pulled, real = [], builder._pull

    def pull(*a):
        got = real(*a)
        pulled.append(None if got is None else len(got))
        return got

    monkeypatch.setattr(builder, "_pull", pull)
    stats = {}
    with RECORDER.job():
        builder.run_buildg_sharded(
            [str(MINI / "reads.fasta")], [], str(tmp_path / "g"),
            make_mesh(n, "cpu"), dist_mem=MODES[mode], budget=BUDGET,
            route_cap=route_cap, stats=stats)
    for suffix in ("_0_parGraph.txt", "_0_containedReads.txt"):
        assert ((tmp_path / f"g{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix
    return (*_last_job(), stats, pulled)


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_loop_opens_dist_spans(tmp_path, monkeypatch, mode, caps):
    """Every chunk a dist.marked, .windows, .step, .pull, .order and
    .replay span, a dist.fallback span a re-run chunk, one dist.build and
    one dist.join, each inside overlapRelation, together within 10% of it;
    no relation.* span; the counters dist.chunks, dist.fallback_chunks and
    dist.rows equal the loop's stats and the rows `_pull` brought to the
    host."""
    job, spans, stats, pulled = _sharded_build(tmp_path, mode, CAPS[caps],
                                               monkeypatch)
    names = [s["name"] for s in spans]
    chunks, fallback = stats["chunks"], stats["fallback_chunks"]
    assert chunks >= 3 and len(pulled) == chunks
    assert fallback == (0 if caps == "as_built" else chunks)
    for stage in builder.HOST_STAGES:
        want = fallback if stage == "fallback" else chunks
        assert names.count("dist." + stage) == want, stage
    assert names.count("dist.build") == names.count("dist.join") == 1
    assert not [n for n in names if n.startswith("relation.")]
    # the table is built on the mesh's device: its spans once each, in
    # insertDataset
    (insert,) = [s for s in spans if s["name"] == "insertDataset"]
    for name in ("index.keys", "index.order", "index.pull"):
        (sp,) = [s for s in spans if s["name"] == name]
        assert sp["parent"] == insert["id"], name
    (rel,) = [s for s in spans if s["name"] == "overlapRelation"]
    for s in spans:
        if s["name"].startswith("dist."):
            assert rel["t0"] <= s["t0"] <= s["t1"] <= rel["t1"]
    parts = sum(v[1] for n, v in job["totals"].items()
                if n.startswith("dist."))
    whole = job["totals"]["overlapRelation"][1]
    assert abs(parts - whole) <= 0.1 * whole
    c = job["counters"]
    assert c["dist.chunks"] == chunks
    assert c.get("dist.fallback_chunks", 0) == fallback
    assert c.get("dist.rows", 0) == sum(p or 0 for p in pulled)
    assert (c.get("dist.rows", 0) > 0) == (caps == "as_built")


def test_single_device_loop_opens_no_dist_span(tmp_path, monkeypatch):
    """buildG -backend device on mini (the device loop on the CPU): its
    relation.* spans, and no dist.* span or counter."""
    monkeypatch.setattr(relation, "_default_device",
                        lambda: torch.device("cpu"))
    with RECORDER.job():
        pipeline.run_buildg([str(MINI / "reads.fasta")], [],
                            str(tmp_path / "g"), backend="device")
    job, spans = _last_job()
    names = {s["name"] for s in spans}
    assert {"relation.step", "relation.pull"} <= names
    assert not [n for n in names if n.startswith("dist.")]
    assert not [n for n in job["counters"] if n.startswith("dist.")]


@pytest.mark.parametrize("prune", [False, True], ids=["plain", "pruned"])
@pytest.mark.parametrize("mode", list(MODES))
def test_host_s_is_the_dist_spans(tmp_path, mode, prune):
    """profile["host_s"] keeps its keys, HOST_STAGES, and each is the
    seconds of the job's dist.<stage> spans."""
    store, table = _mini_state(tmp_path)
    run = (builder.sharded_relation_pruned if prune
           else builder.sharded_relation)
    profile = {}
    with RECORDER.job():
        run(store, table, make_mesh(4, "cpu"), budget=BUDGET,
            dist_mem=MODES[mode], profile=profile)
    job, _ = _last_job()
    assert set(profile["host_s"]) == set(builder.HOST_STAGES)
    for stage, secs in profile["host_s"].items():
        total = job["totals"].get("dist." + stage, (0, 0.0, 0.0))[1]
        assert secs == pytest.approx(total, abs=1e-9), stage
    assert (profile["host_s"]["replay"] > 0) == prune


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_exchange_bytes_are_the_tensors_sent(tmp_path, monkeypatch, mode, n):
    """dist.route_bytes is the bytes of every tensor the key-owner lookup
    (`_candidates`) hands to all_to_all, dist.fetch_bytes those of the
    payload fetch (`_fetch_rows`; none without -rma), each counted here by
    a wrapper of all_to_all, and each the closed form of the padded
    buffers: a shard sends n * route_cap codes (8 B) and valid flags (1 B)
    and gets back n * route_cap * hit_cap of r2, orient, typ (4 B each)
    and valid (1 B) a chunk; it sends n * fetch_cap requests (4 B) and
    returns as many rows of Wp words."""
    sent, where = {"route": 0, "fetch": 0}, []
    real = overlap_shard.all_to_all

    def labelled(fn, label):
        def inner(*a, **kw):
            where.append(label)
            try:
                return fn(*a, **kw)
            finally:
                where.pop()
        return inner

    def all_to_all(mesh, xs):
        sent[where[-1]] += sum(x.nbytes for x in xs)
        return real(mesh, xs)

    monkeypatch.setattr(ShardedOverlapEngine, "_candidates", labelled(
        ShardedOverlapEngine._candidates, "route"))
    monkeypatch.setattr(DistMemOverlapEngine, "_fetch_rows", labelled(
        DistMemOverlapEngine._fetch_rows, "fetch"))
    monkeypatch.setattr(overlap_shard, "all_to_all", all_to_all)
    store, table = _mini_state(tmp_path)
    profile, stats = {}, {}
    with RECORDER.job():
        builder.sharded_relation(store, table, make_mesh(n, "cpu"),
                                 budget=BUDGET, dist_mem=MODES[mode],
                                 profile=profile, stats=stats)
    c = _last_job()[0]["counters"]
    assert c["dist.route_bytes"] == sent["route"] > 0
    assert c.get("dist.fetch_bytes", 0) == sent["fetch"]
    chunks, rc, h = stats["chunks"], profile["route_cap"], profile["hit_cap"]
    assert sent["route"] == chunks * n * n * rc * (9 + 13 * h)
    if MODES[mode]:
        fc = overlap_shard.fetch_cap_for(profile["chunk"], n, h)
        wp = store.packed.shape[1]
        assert sent["fetch"] == chunks * n * n * fc * 4 * (1 + wp)
    else:
        assert sent["fetch"] == 0


@pytest.mark.cuda
def test_counters_add_no_sync_on_the_card():
    """A dist-mem superstep of four shards on the card (2,500 reads of 250
    bp from a 50 kb genome) and its compaction, inputs staged beforehand,
    wait for nothing: no synchronisation under
    torch.cuda.set_sync_debug_mode("error"), and the job's exchange
    counters moved by the closed form of test_exchange_bytes_are_the_
    tensors_sent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), 50_000))
    store = ReadStore.from_sequences(
        [genome[s:s + 250] for s in rng.integers(0, 50_000 - 250, 2_500)])
    table = FingerprintTable.build(store, 29)
    n = 4
    mesh = make_mesh(n, "cuda")
    q = int(window_offsets(store.lengths, table.k)[-1])
    hit_cap, chunk, rc = builder.chunk_plan(table, q, n, None, 1 << 20)
    eng = DistMemOverlapEngine.build(store, table, mesh, hit_cap=hit_cap,
                                     route_cap=rc, prune_marked=True)
    windows, _ = eng.make_chunk_step(store, chunk)
    run = eng._runner(store, chunk)
    inputs = windows(0, min(chunk, q))
    marked = mesh.split(np.zeros(store.n_reads + (-store.n_reads) % n,
                                 np.int32))
    torch.cuda.synchronize()
    with RECORDER.job():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run(*inputs, marked)
            rows, metas = overlap_shard.compact(inputs[0], inputs[1], out)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    c = _last_job()[0]["counters"]
    fc = overlap_shard.fetch_cap_for(chunk, n, hit_cap)
    assert c["dist.route_bytes"] == n * n * rc * (9 + 13 * hit_cap)
    assert c["dist.fetch_bytes"] == (n * n * fc * 4
                                     * (1 + store.packed.shape[1]))
    got = builder._pull(mesh, rows, metas)
    assert got is not None and len(got) > 0
