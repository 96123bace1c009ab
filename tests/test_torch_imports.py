"""disco_tpu_torch never imports jax: every module of the package, and the
command line's subcommands, run in a fresh interpreter without pulling it
in (nor anything of disco_tpu)."""
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "disco_tpu_torch"


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        if parts[-1] == "__main__":
            continue
        mods.append(".".join(parts))
    return mods


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("overlap.fused_kernel", "overlap.pallas_kernel",
              "overlap.locality", "bench_verify", "tools.exp_fetch_variants",
              "tools.exp_mxu_fetch", "tools.exp_locality", "simplify",
              "simplify.params", "simplify.core", "simplify.dataset",
              "simplify.pargraph", "simplify.engine", "simplify.flow",
              "simplify.scaffold", "simplify.contigs", "simplify.gfa",
              "simplify.cytoscape", "simplify.driver", "utils.stats",
              "dist", "dist.mesh", "dist.overlap_shard", "dist.builder",
              "dist.multiproc", "preprocess", "tools.bench_scaling",
              "tools.bench_e2e", "tools.assemble_scale", "buildg.replay",
              "overlap.device", "cli"):
        assert "disco_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'disco_tpu.'))\n"
            "             or m == 'disco_tpu')\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_cli_help_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['disco_tpu_torch', 'buildg', '--help']\n"
            "try:\n"
            "    runpy.run_module('disco_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "-backend" in res.stdout and "-pe" in res.stdout


@pytest.mark.parametrize("cmd,opts", [
    ("assemble", ("-inP", "-backend", "-p3", "--write-par-graph-size",
                  "-rma", "buildG-MPIRMA")),
    ("buildg", ("-pe", "-rma", "buildG-MPI", "-n")),
    ("preprocess", ("-in1", "-inP", "-bbmap", "--keep")),
    ("simplify", ("-fpi", "-crd", "-simPth")),
    ("parsimplify", ("edge_file", "min_ovl")),
    ("stats", ("denovo", "--min-len"))])
def test_subcommand_help_without_jax(cmd, opts):
    code = ("import runpy, sys\n"
            f"sys.argv = ['disco_tpu_torch', '{cmd}', '--help']\n"
            "try:\n"
            "    runpy.run_module('disco_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'disco_tpu')\n"
            "             or m.startswith(('jax.', 'disco_tpu.')))\n"
            "assert not bad, bad\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    for opt in opts:
        assert opt in res.stdout


def test_cli_buildg_runs(tmp_path):
    """python -m disco_tpu_torch buildg on golden micro, native backend
    (the device backend is covered by test_torch_buildg.py)."""
    micro = ROOT / "tests" / "golden" / "micro"
    res = subprocess.run(
        [sys.executable, "-m", "disco_tpu_torch", "buildg", "-se",
         str(micro / "reads.fasta"), "-f", str(tmp_path / "micro"), "-p",
         str(micro / "buildg.cfg"), "-m", "4", "-backend", "native"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    for suffix in ("_0_parGraph.txt", "_0_containedReads.txt"):
        assert ((tmp_path / ("micro" + suffix)).read_bytes()
                == (micro / ("micro" + suffix)).read_bytes())


def test_cli_unported_options_raise():
    """buildg -n and -rma (the distributed build) take the CUDA cards:
    without one they raise, in a process without jax; assemble -ecc
    without -bbmap returns 1, as disco_tpu's does."""
    code = ("import torch\n"
            "from disco_tpu_torch.cli import main\n"
            "assert main(['assemble', '-inP', 'x.fasta', '-d', 'd', '-o',\n"
            "             'p', '-ecc']) == 1\n"
            "cases = []\n"
            "if not torch.cuda.is_available():\n"
            "    cases += [(['buildg', '-se', 'x.fasta', '-f', 'p'] + extra,\n"
            "               RuntimeError, 'no CUDA card')\n"
            "              for extra in (['-n', '2'], ['-rma'])]\n"
            "for argv, exc, msg in cases:\n"
            "    try:\n"
            "        main(argv)\n"
            "    except exc as e:\n"
            "        assert msg in str(e), e\n"
            "    else:\n"
            "        raise AssertionError(argv)\n"
            "import sys\n"
            "assert 'jax' not in sys.modules\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_dist_modules_use_no_jax_and_no_torch_distributed():
    """torch.distributed stays behind two modules: the mesh's collectives
    (dist/mesh.py) and the launcher (dist/multiproc.py).  The engines, the
    chunk loop and the scaling tool see only the mesh's list collectives:
    they import or call no torch.distributed.  No module of
    disco_tpu_torch/dist/ imports jax or disco_tpu."""
    users = {"mesh.py", "multiproc.py"}
    for p in [*sorted((PKG / "dist").glob("*.py")),
              PKG / "tools" / "bench_scaling.py"]:
        text = p.read_text()
        words = ["import jax", "from jax", "import disco_tpu\n",
                 "from disco_tpu.", "import disco_tpu."]
        if p.name in users and p.parent.name == "dist":
            assert "import torch.distributed as dist" in text, p.name
        else:
            words += ["import torch.distributed", "from torch.distributed",
                      "from torch import distributed", "torch.distributed.",
                      "dist.all_", "dist.init"]
        for word in words:
            assert word not in text, (p.name, word)


def _help(module):
    code = ("import runpy, sys\n"
            f"sys.argv = ['{module}', '--help']\n"
            "try:\n"
            f"    runpy.run_module('{module}', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_multiproc_help_without_jax():
    out = _help("disco_tpu_torch.dist.multiproc")
    for opt in ("--coordinator", "--num-processes", "--process-id",
                "--local-devices", "--dist-backend", "-m-ovl", "-rma"):
        assert opt in out


def test_bench_scaling_help_without_jax():
    out = _help("disco_tpu_torch.tools.bench_scaling")
    for opt in ("--shards", "--dist-mem", "--budget", "--device"):
        assert opt in out


def test_bench_verify_help_without_jax():
    out = _help("disco_tpu_torch.bench_verify")
    for opt in ("--path", "--genome-len", "--device", "fused_mxu3"):
        assert opt in out


@pytest.mark.parametrize("tool", ["exp_fetch_variants", "exp_mxu_fetch",
                                  "exp_locality"])
def test_tool_help_without_jax(tool):
    assert "--device" in _help(f"disco_tpu_torch.tools.{tool}")
