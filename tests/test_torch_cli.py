"""disco_tpu_torch's command line (`assemble`, `simplify`, `parsimplify`,
`stats`) against disco_tpu's and the reference's goldens, byte for byte.

`assemble` runs from the golden's directory because _ReadIDMap.txt records
the reads' path as given.  Without a card the device backend is reached
only through `run_buildg(..., device="cpu")` (test_torch_buildg.py);
`assemble -backend device`, and -n and -rma, must raise there, not fall
back; the tests run -n on CPU shards by naming the CPU (`cpu_shards`)."""
import pathlib
import shutil

import pytest
import torch

from conftest import GOLDEN
from test_torch_native import private_native  # noqa: F401
from test_torch_simplify import OUTPUTS, assert_same_tree

from disco_tpu.cli import main as jmain
from disco_tpu_torch.cli import main as tmain

MINI = GOLDEN / "mini"
THRESH = GOLDEN / "thresh146"
CFG_ARGS = ["-p", str(THRESH / "cfg.cfg"), "-p2", str(THRESH / "cfg_2.cfg"),
            "-p3", str(THRESH / "cfg_3.cfg")]
GRAPH = ("_0_parGraph.txt", "_0_containedReads.txt", "_ReadIDMap.txt",
         "_CheckpointInfo.txt", "_0_startRead.txt")


def _assemble(main, out: pathlib.Path, *extra):
    return main(["assemble", "-inP", "reads.fasta", "-d", str(out),
                 "-o", "mini", *CFG_ARGS, *extra])


def test_assemble_native_mini(tmp_path, monkeypatch):
    """Reads to scaffolds on mini with the native buildG: the port's tree
    equals disco_tpu's file for file, its graph equals the reference's
    buildG output and its assembly the reference's fullsimplify output."""
    monkeypatch.chdir(MINI)
    # disco_tpu's assemble exports -backend through the environment
    monkeypatch.setenv("DISCO_TPU_BACKEND", "native")
    assert _assemble(tmain, tmp_path / "port", "-backend", "native") == 0
    assert _assemble(jmain, tmp_path / "jax", "-backend", "native") == 0
    assert assert_same_tree(tmp_path / "port", tmp_path / "jax") > 20
    port = tmp_path / "port"
    for suffix in GRAPH:
        assert ((port / "graph" / f"mini{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix
    for name in OUTPUTS:
        assert ((port / "assembly" / f"mini_{name}").read_bytes()
                == (MINI / "simplify" / f"mini_{name}").read_bytes()), name
    for kind in ("contigs", "scaffolds"):
        combined = (port / f"mini_{kind}FinalCombined.fasta").read_bytes()
        assert combined == (port / "assembly" /
                            f"mini_{kind}Final_1.fasta").read_bytes()
        assert combined.startswith(b">")


def test_assemble_graph_then_simplify(tmp_path, monkeypatch):
    """-obg (graph only) and then -osg (simplify only) write the tree of
    one whole run."""
    monkeypatch.chdir(MINI)
    assert _assemble(tmain, tmp_path / "whole", "-backend", "native") == 0
    assert _assemble(tmain, tmp_path / "split", "-backend", "native",
                     "-obg") == 0
    assert not (tmp_path / "split" / "assembly" / "mini_UsedReads_1.txt"
                ).exists()
    assert _assemble(tmain, tmp_path / "split", "-osg") == 0
    assert_same_tree(tmp_path / "whole", tmp_path / "split")


def test_assemble_hands_off_between_the_stages(tmp_path, monkeypatch):
    """assemble gives back buildG's leavings (`_hand_off`) once, after
    buildG and before fullsimplify; -obg and -osg, which run one stage
    each, do not; the tree is the same as one whole run's."""
    from disco_tpu_torch import cli
    from disco_tpu_torch.buildg import pipeline
    from disco_tpu_torch.simplify import driver

    calls = []

    def logged(mod, name):
        real = getattr(mod, name)

        def wrapper(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for mod, name in ((pipeline, "run_buildg"),
                      (driver, "run_fullsimplify"), (cli, "_hand_off")):
        logged(mod, name)
    monkeypatch.chdir(MINI)
    assert _assemble(tmain, tmp_path / "whole", "-backend", "native") == 0
    assert calls == ["run_buildg", "_hand_off", "run_fullsimplify"]
    for flag, stage in (("-obg", "run_buildg"), ("-osg", "run_fullsimplify")):
        calls.clear()
        assert _assemble(tmain, tmp_path / "split", "-backend", "native",
                         flag) == 0
        assert calls == [stage]
    assert_same_tree(tmp_path / "whole", tmp_path / "split")


def test_assemble_device_without_card_raises(tmp_path, monkeypatch):
    """-backend device takes the card; without one it raises before any
    graph is written, and nothing falls back to the native backend."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the device backend runs")
    monkeypatch.chdir(MINI)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _assemble(tmain, tmp_path / "out", "-backend", "device")
    assert not list((tmp_path / "out").rglob("*_parGraph.txt"))
    assert not list((tmp_path / "out").rglob("*.fasta"))


@pytest.mark.parametrize("extra", [["-n", "2"], ["-rma"], ["-ecc"]],
                         ids=["n", "rma", "ecc"])
def test_assemble_unported_options_raise(extra, tmp_path, capsys):
    """-ecc without -bbmap returns 1, as disco_tpu's assemble does.  -n and
    -rma (the distributed build) take the CUDA cards: without one they
    raise.  Either way nothing is written, and nothing falls back to the
    CPU."""
    argv = ["assemble", "-inP", "x.fasta", "-d", str(tmp_path), "-o", "p",
            *extra]
    if extra == ["-ecc"]:
        assert tmain(argv) == 1
        assert "-bbmap" in capsys.readouterr().err
    elif torch.cuda.is_available():
        pytest.skip("a CUDA card is present: -n and -rma run on it")
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmain(argv)
    assert not list(tmp_path.iterdir())


@pytest.fixture
def cpu_shards(monkeypatch):
    """The CLI's mesh on CPU shards: `-n N` lays out N shards over the
    CUDA cards, so without a card the tests name the CPU, as
    run_buildg_sharded(..., device="cpu") does."""
    from disco_tpu_torch import cli
    from disco_tpu_torch.dist.mesh import make_mesh
    monkeypatch.setattr(cli, "_mesh", lambda n: make_mesh(max(n, 1), "cpu"))


@pytest.mark.parametrize("extra", [[], ["-rma"]], ids=["n4", "n4_rma"])
def test_buildg_sharded_mini(extra, cpu_shards, tmp_path, monkeypatch):
    """buildg -n 4 [-rma] on mini: every file equals the reference's golden
    and disco_tpu's `buildg -n 4 [-rma]` (on its virtual CPU mesh)."""
    monkeypatch.chdir(MINI)
    for name, main in (("port", tmain), ("jax", jmain)):
        (tmp_path / name).mkdir()
        assert main(["buildg", "-pe", "reads.fasta", "-f",
                     str(tmp_path / name / "mini"), "-p", "buildg.cfg",
                     "-n", "4", *extra]) == 0
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    for suffix in GRAPH:
        assert ((tmp_path / "port" / f"mini{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix


def test_assemble_sharded_mini(cpu_shards, tmp_path, monkeypatch):
    """assemble -n 4 -rma: reads to scaffolds with the dist-mem buildG; the
    tree equals disco_tpu's assemble -n 4 -rma, and the graph the
    reference's goldens."""
    monkeypatch.chdir(MINI)
    for name, main in (("port", tmain), ("jax", jmain)):
        assert _assemble(main, tmp_path / name, "-n", "4", "-rma") == 0
    assert assert_same_tree(tmp_path / "port", tmp_path / "jax") > 20
    for suffix in GRAPH:
        assert ((tmp_path / "port" / "graph" / f"mini{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix


def test_cli_parsimplify_mini(tmp_path):
    out = tmp_path / "pse.txt"
    assert tmain(["parsimplify", str(MINI / "mini_0_parGraph.txt"), str(out),
                  "30", "1"]) == 0
    assert out.read_bytes() == (
        MINI / "simplify" / "mini_parsimple.txt").read_bytes()


def test_cli_simplify_mini(tmp_path):
    """`simplify` (fullsimplify's command line) on mini's graph, against
    disco_tpu's `simplify` and the golden outputs."""
    for name, main in (("port", tmain), ("jax", jmain)):
        w = tmp_path / name
        w.mkdir()
        for f in ("mini_0_parGraph.txt", "mini_0_containedReads.txt",
                  "reads.fasta"):
            shutil.copy(MINI / f, w / f)
        assert main(["simplify", "-fpi", str(w / "reads.fasta"),
                     "-e", str(w / "mini_0_parGraph.txt"),
                     "-crd", str(w / "mini_0_containedReads.txt"),
                     "-o", str(w / "mini"), *CFG_ARGS, "-log", "WARNING"]) == 0
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    for name in OUTPUTS:
        assert ((tmp_path / "port" / f"mini_{name}").read_bytes()
                == (MINI / "simplify" / f"mini_{name}").read_bytes()), name


def test_cli_stats(tmp_path, monkeypatch, capsys):
    """`stats` with no mode prints the summary; `stats denovo` writes
    <base>.stat.txt beside the input and prints its path."""
    scaffolds = MINI / "simplify" / "mini_scaffoldsFinal_1.fasta"
    printed = {}
    for name, main in (("port", tmain), ("jax", jmain)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(scaffolds, d / "scf.fasta")
        monkeypatch.chdir(d)
        assert main(["stats", "scf.fasta"]) == 0
        assert main(["stats", "denovo", "scf.fasta", "-m", "500"]) == 0
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert printed["port"].endswith("scf.stat.txt\n")
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_trace_wrap_keeps_the_outputs(tmp_path, monkeypatch):
    """buildg -backend native on mini with DISCO_TPU_TORCH_TRACE naming a
    directory: the files equal those of the run without it (and the
    reference's), and the directory holds one Chrome trace, JSON with
    `traceEvents`."""
    import json
    from disco_tpu_torch.cli import TRACE_ENV
    monkeypatch.chdir(MINI)
    trace = tmp_path / "trace"
    for name in ("plain", "traced"):
        if name == "traced":
            monkeypatch.setenv(TRACE_ENV, str(trace))
        (tmp_path / name).mkdir()
        assert tmain(["buildg", "-pe", "reads.fasta", "-f",
                      str(tmp_path / name / "mini"), "-p", "buildg.cfg",
                      "-backend", "native"]) == 0
    assert_same_tree(tmp_path / "plain", tmp_path / "traced")
    for suffix in GRAPH:
        assert ((tmp_path / "traced" / f"mini{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix
    files = list(trace.iterdir())
    assert len(files) == 1 and files[0].name.startswith("buildg.")
    assert isinstance(json.loads(files[0].read_text())["traceEvents"], list)
