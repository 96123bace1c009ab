"""Nothing a run loads is JAX or the JAX package, by whole top-level name
(the program's package, disco_tpu_torch, begins with disco_tpu)."""
import json
import subprocess
import sys

from _tiny import ROOT

PROBE = """
import json, sys, time
sys.path.insert(0, {tests!r})
import _tiny
import pytest
mp = pytest.MonkeyPatch()
root = _tiny.tiny_root({tmp!r})
_tiny.on_cpu(mp)
r = _tiny.run_tiny(root, _tiny.ISOLATE, tmp={tmp!r})
print(json.dumps({{"correct": r["correct"],
                  "top": sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""


def test_no_jax_loaded(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(tests=str(ROOT / "discobench" /
                                                       "tests"),
                                            tmp=str(tmp_path))],
        check=True, capture_output=True, text=True, env={
            "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
            "TMPDIR": str(tmp_path)})
    got = json.loads(out.stdout.strip().split("\n")[-1])
    assert got["correct"]
    assert "disco_tpu_torch" in got["top"]
    for name in ("jax", "jaxlib", "flax", "disco_tpu"):
        assert name not in got["top"]


def test_run_exits_without_a_card(tmp_path):
    """run.py exits non-0 and prints no result where torch sees no card."""
    p = subprocess.run([sys.executable, str(ROOT / "discobench" / "run.py"),
                        "--workload", "ecoli_k12.buildg", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "TMPDIR": str(tmp_path),
                            "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuse_jax_compares_whole_names(monkeypatch, capsys):
    import types

    import pytest

    from discobench.harness import refuse_jax
    monkeypatch.setitem(sys.modules, "disco_tpu_torch_x",
                        types.ModuleType("disco_tpu_torch_x"))
    refuse_jax()
    monkeypatch.setitem(sys.modules, "disco_tpu.cli",
                        types.ModuleType("disco_tpu.cli"))
    with pytest.raises(SystemExit) as e:
        refuse_jax()
    assert e.value.code == 3 and "disco_tpu" in capsys.readouterr().err
