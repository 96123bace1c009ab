"""On the card: each cell of BENCHMARK.json runs through run.py, short,
and is correct; each fault of `_faults.py` that a cell's limits were set
against, planted at the cell's own size, is not correct on three seeds.
Skips without a card (decided inside the test).

    python -m pytest --noconftest -p no:cacheprovider -s discobench/tests \
        -m cuda
"""
import json
import subprocess
import sys
import time

import pytest

import _faults
from _tiny import ISOLATE, MOCK, ROOT

SEEDS = (2200000301, 2200000302, 2200000303)


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [ISOLATE, MOCK])
def test_cell_is_correct_on_the_card(tmp_path, cell):
    _card()
    p = subprocess.run([sys.executable, str(ROOT / "discobench" / "run.py"),
                        "--workload", cell, "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().split("\n")[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell, fault", [
    (ISOLATE, _faults.k2_accepts_all), (ISOLATE, _faults.k2_half_words),
    (MOCK, _faults.k2_accepts_all), (MOCK, _faults.half_the_contigs),
    (MOCK, _faults.scaffolds_cut)], ids=lambda x: getattr(x, "__name__", x))
def test_fault_at_the_cells_size(tmp_path, monkeypatch, cell, fault):
    """Prints one JSON line a seed: the numbers compared, and their
    limits."""
    _card()
    from discobench import harness
    fault(monkeypatch)
    for seed in SEEDS:
        r = harness.run(cell, seed, 1.0, False, time.perf_counter(), ROOT,
                        work_root=str(tmp_path))
        print(json.dumps({"cell": cell, "fault": fault.__name__,
                          "seed": seed, "checks": r["checks"]}), flush=True)
        assert not r["correct"]
