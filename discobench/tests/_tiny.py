"""Tiny copies of the benchmark's cells for the CPU tests: the checkout's
discobench/ and BENCHMARK.json copied into a temporary root, with the read
sets and warm-ups cut so that a run takes seconds on the CPU, and the
program's device path put on the CPU (the kernels' plain versions)."""
import json
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

ISOLATE, MOCK = "ecoli_k12.buildg", "atcc_msa1003.assemble"
SEED = 2**31 + 77          # larger than 32 signed bits hold


def tiny_root(tmp, genome_len=40_000, mock_len=20_000, mock_reads=8_000,
              warmup=1_000, families=(10, 3)) -> pathlib.Path:
    """`families`: the repeat families of the isolate's and of each mock
    strain's genome (none when None)."""
    root = pathlib.Path(tmp) / "root"
    shutil.copytree(ROOT / "discobench", root / "discobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = root / c["file"]
        conf = json.loads(path.read_text())
        mock = bool(conf["reads"].get("levels"))
        if mock:
            conf["reads"].update(genome_len=mock_len, reads=mock_reads)
        else:
            conf["reads"].update(genome_len=genome_len)
        if families is None:
            conf["reads"].pop("repeats", None)
        else:
            conf["reads"]["repeats"]["families"] = families[mock]
        path.write_text(json.dumps(conf))
    for path in (root / "discobench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["warmup_reads"] = warmup
        path.write_text(json.dumps(t))
    return root


def on_cpu(monkeypatch):
    """The device path on the CPU: its entry takes the CPU for the card."""
    import torch
    from disco_tpu_torch.overlap import relation
    monkeypatch.setattr(relation, "_default_device",
                        lambda: torch.device("cpu"))


def run_tiny(root, cell, seed=SEED, seconds=0.0, tmp=None):
    from discobench import harness
    return harness.run(cell, seed, seconds, False, time.perf_counter(),
                       root, device="cpu", work_root=tmp)
