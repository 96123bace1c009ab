"""disco_tpu_torch.tools.bench_e2e, the end-to-end buildG wall clock, as
its users run it: `python -m disco_tpu_torch.tools.bench_e2e` on a small
fresh set.  The native backend prints its one JSON line with
outputs_identical; the device backend needs a CUDA card and, without
one, exits non-zero before it times anything."""
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def test_device_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the device backend runs")
    res = _bench("--backends", "device,native")
    assert res.returncode != 0
    assert "CUDA card" in res.stderr and not res.stdout.strip()
