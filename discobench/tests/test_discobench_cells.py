"""Cells, configurations and metrics found by name, and a new cell that
needs only new files."""
import hashlib
import json
import math

import pytest

from _tiny import ROOT, on_cpu, run_tiny, tiny_root
from discobench import harness


def test_every_cell_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        assert cell["config"]["name"] == w["config"]
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(harness.load_reader(m["name"], ROOT))


def test_unknown_cell_is_refused():
    with pytest.raises(harness.CellError):
        harness.load_cell("no_such.cell", ROOT)


def _files(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in (root / "discobench").rglob("*")
            if p.is_file()}


def test_new_cell_config_and_metric_as_new_files(tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    before = _files(root)
    d = root / "discobench"
    conf = json.loads((d / "configs" / "ecoli_k12.json").read_text())
    conf.update(name="tiny_isolate", reduced=["genome_len"])
    conf["reads"].update(genome_len=30000, coverage=12.0)
    (d / "configs" / "tiny_isolate.json").write_text(json.dumps(conf))
    traffic = json.loads((d / "traffic" / "buildg.json").read_text())
    traffic["argv"] = traffic["argv"][:-1] + ["native"]
    (d / "traffic" / "buildg_native.json").write_text(json.dumps(traffic))
    (d / "metrics" / "jobs.count.py").write_text(
        '"""Jobs in the window."""\n\n\ndef read(run):\n'
        '    return float(len(run.jobs))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_isolate", "source": "x",
                             "file": "discobench/configs/tiny_isolate.json",
                             "reduced": ["genome_len"], "why": "x"})
    bench["workloads"].append({"name": "tiny_isolate.buildg_native",
                               "config": "tiny_isolate",
                               "traffic": "buildg_native", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "jobs.count", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "reads_per_s",
                               "workloads": ["tiny_isolate.buildg_native"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _files(root)
    assert {k: after[k] for k in before} == before

    cell = harness.load_cell("tiny_isolate.buildg_native", root)
    assert [m["name"] for m in cell["per_layer"]] == ["jobs.count"]
    on_cpu(monkeypatch)
    r = run_tiny(root, "tiny_isolate.buildg_native", tmp=str(tmp_path))
    assert r["correct"] and r["attempted"] == 1
    assert set(r["metrics"]) == {"reads_per_s", "peak_rss_gib", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    run = harness.Run([{"stages": []}] * 3, None, None, 30, "cpu")
    assert harness.load_reader("jobs.count", root)(run) == 3.0
