"""disco_tpu_torch.tools.bench_e2e, the end-to-end buildG wall clock, as
its users run it: `python -m disco_tpu_torch.tools.bench_e2e` on a small
fresh set.  The native backend prints its one JSON line with
outputs_identical; the device backend needs a CUDA card and, without
one, exits non-zero before it times anything."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from disco_tpu_torch.tools import bench_e2e

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = ("_0_containedReads.txt", "_0_parGraph.txt", "_0_startRead.txt",
         "_CheckpointInfo.txt", "_ReadIDMap.txt")


def _bench(*args):
    return subprocess.run(
        [sys.executable, "-m", "disco_tpu_torch.tools.bench_e2e",
         "--genome-len", "20000", "--coverage", "10", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_native_prints_one_json_line():
    res = _bench("--backends", "native")
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["bench"] == "buildg_e2e_wall_s"
    assert line["genome_len"] == 20000 and line["coverage"] == 10
    assert line["outputs_identical"] is True
    assert line["native"] > 0 and line["card"] is None
    # every file buildg writes is compared, and the child's numbers carried
    assert line["files"] == sorted(FILES) and line["data_s"] > 0
    run = line["runs"]["native"]
    assert run["rc"] == 0 and run["rss_peak_bytes"] >= run["rss_start_bytes"]
    assert run["rss_start_bytes"] > 0 and run["device_peak_bytes"] is None
    assert run["launches"] == {"K1": 0, "K1_rows": 0, "K2": 0}
    assert [s for s, _ in run["stages"]][:2] == ["readDataset",
                                                 "insertDataset"]


def test_device_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the device backend runs")
    res = _bench("--backends", "device,native")
    assert res.returncode != 0
    assert "CUDA card" in res.stderr and not res.stdout.strip()


def test_child_reports_the_relation(tmp_path):
    """A child that makes the one-pass relation (here native, `-m 100`; `-w 1000` keeps the
    golden's parGraph chunks)
    reports the reads, the windows and the relation's stats beside its
    stages, peak RSS and launch counts."""
    stats = tmp_path / "stats.json"
    fasta = ROOT / "tests" / "golden" / "mini" / "reads.fasta"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run(
        [sys.executable, "-c", bench_e2e.CHILD, str(stats), "buildg", "-pe",
         str(fasta), "-f", str(tmp_path / "m"), "-backend", "native", "-m",
         "100", "-w", "1000"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    run = json.loads(stats.read_text())
    assert run["rc"] == 0 and run["reads"] == 1600
    assert run["windows"] == 1600 * (250 - 29) and run["relation"] == {}
    assert run["rows"] == 57_894         # mini's relation
    assert "overlapRelation" in dict(run["stages"])
    assert run["rss_peak_bytes"] > 0 and run["launches"]["K2"] == 0
    assert sorted(p.name[1:] for p in tmp_path.glob("m_*")) == sorted(FILES)
    for suffix in FILES:
        want = ROOT / "tests" / "golden" / "mini" / f"mini{suffix}"
        if suffix not in ("_ReadIDMap.txt", "_0_startRead.txt"):
            assert (tmp_path / f"m{suffix}").read_bytes() == \
                want.read_bytes(), suffix


def test_child_reports_the_dist_relation(tmp_path, monkeypatch):
    """A child of `buildg -n 4 -rma` (here in this process, its four shards
    on the CPU) reports the distributed relation: the reads, windows, kept
    rows, its stats with hit_cap, its chunk plan and the host's seconds by
    stage, and its launch counts, the rows route's among them (0 here: the
    CPU shards run the plain versions); its files equal the golden's."""
    from disco_tpu_torch import cli
    from disco_tpu_torch.buildg import pipeline
    from disco_tpu_torch.dist import builder
    from disco_tpu_torch.dist.mesh import make_mesh

    # child_main wraps these two for good: put them back after the test
    for mod, name in ((pipeline, "compute_relation"),
                      (builder, "sharded_relation_pruned")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(cli, "_mesh", lambda n: make_mesh(n, "cpu"))
    mini = ROOT / "tests" / "golden" / "mini"
    monkeypatch.chdir(mini)     # _ReadIDMap.txt records the path as given
    stats = tmp_path / "stats.json"
    assert bench_e2e.child_main(str(stats), [
        "buildg", "-pe", "reads.fasta", "-f", str(tmp_path / "mini"),
        "-n", "4", "-rma", "-m-ovl", "30", "-w", "1000"]) == 0
    run = json.loads(stats.read_text())
    rel, prof = run["relation"], run["profile"]
    assert run["reads"] == 1600 and run["windows"] == 1600 * (250 - 29)
    assert set(rel) == {"chunks", "fallback_chunks", "hit_cap"}
    assert rel["fallback_chunks"] == 0 and rel["hit_cap"] == prof["hit_cap"]
    assert rel["chunks"] == -(-run["windows"] // prof["chunk"])
    assert 0 < run["rows"] <= 57_894          # pruned: at most mini's
    assert set(prof["host_s"]) == set(builder.HOST_STAGES)
    assert run["launches"] == {"K1": 0, "K1_rows": 0, "K2": 0}
    for suffix in FILES:
        if suffix != "_0_startRead.txt":
            assert (tmp_path / f"mini{suffix}").read_bytes() == \
                (mini / f"mini{suffix}").read_bytes(), suffix


def test_dist_scale_native_runs_print_one_json_line():
    """tools/dist_scale.py with the native run alone on a small set: one
    JSON line with the run's files, stages and launches, and no first run
    to compare its files with."""
    res = subprocess.run(
        [sys.executable, "-m", "disco_tpu_torch.tools.dist_scale",
         "--genome-len", "20000", "--coverage", "10", "--runs", "native"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["bench"] == "dist_scale" and line["card"] is None
    run = line["runs"]["native"]
    assert run["files"] == sorted(FILES) and run["wall_s"] > 0
    assert run["same_as_first"] is None and run["stages"]
    assert run["launches"] == {"K1": 0, "K1_rows": 0, "K2": 0}


def test_dist_scale_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the distributed runs run")
    res = subprocess.run(
        [sys.executable, "-m", "disco_tpu_torch.tools.dist_scale",
         "--genome-len", "20000", "--runs", "rma,native"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA card" in res.stderr and not res.stdout.strip()
