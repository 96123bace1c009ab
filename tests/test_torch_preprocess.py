"""The port's BBTools preprocessing (disco_tpu_torch/preprocess.py, the CLI's
`preprocess` and `assemble -ecc`) against disco_tpu's, under the stand-in
tools of tests/test_preprocess.py (copy in= to out=, record argv): the same
commands, in the same order, and the same files.  Tolerance: exact."""
import os
import pathlib
import shutil

import pytest

from conftest import GOLDEN
from test_preprocess import bbmap  # noqa: F401
from test_torch_native import private_native  # noqa: F401
from test_torch_simplify import assert_same_tree

from disco_tpu import preprocess as jpre
from disco_tpu.cli import main as jmain
from disco_tpu_torch import preprocess as tpre
from disco_tpu_torch.cli import main as tmain

MINI = GOLDEN / "mini"
THRESH = GOLDEN / "thresh146"
CFG_ARGS = ["-p", str(THRESH / "cfg.cfg"), "-p2", str(THRESH / "cfg_2.cfg"),
            "-p3", str(THRESH / "cfg_3.cfg")]

# the five branches of Preprocessor.run (runECC.sh:178-440): each input's
# files, by the keyword run_preprocess takes
BRANCHES = {
    "interleaved": {"inP": ["lib1.fasta", "lib2.fa"]},
    "single": {"inS": ["se.fasta"]},
    "pairs": {"in1": ["a_r1.fq", "b_r1.fastq"],
              "in2": ["a_r2.fq", "b_r2.fastq"]},
    "interleaved_single": {"inP": ["pe.fasta"], "inS": ["se1.fa", "se2.fa"]},
    "pairs_single": {"in1": ["a_r1.fq"], "in2": ["a_r2.fq"],
                     "inS": ["se.fasta"]},
}


def _inputs(tmp_path, branch):
    """The branch's input files in tmp_path/in, each its own records."""
    d = tmp_path / "in"
    d.mkdir(exist_ok=True)
    out = {}
    for key, names in BRANCHES[branch].items():
        out[key] = []
        for i, name in enumerate(names):
            p = d / name
            p.write_text("".join(f">{name}{r}\n{'ACGT' * (3 + i + r)}\n"
                                 for r in range(4)))
            out[key].append(str(p))
    return out


def _files(d: pathlib.Path):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _run(run_preprocess, bb, wd, inputs, keep):
    """One package's run: (returned lists, command log, the stand-in tools'
    argv log, the work directory's files); the work directory and the
    tools' log are left empty for the next run."""
    log = []
    lists = run_preprocess(str(bb), str(wd), threads=4, mem_gb=2,
                           keep_intermediates=keep, command_log=log,
                           **inputs)
    tools_log = bb / "cmds.log"
    res = (lists, log, tools_log.read_text(), _files(wd))
    tools_log.unlink()
    shutil.rmtree(wd)
    return res


@pytest.mark.parametrize("keep", [False, True], ids=["rm", "keep"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branches_match_jax(tmp_path, bbmap, branch, keep):  # noqa: F811
    """Each branch of the ladder, with and without --keep: the port runs
    disco_tpu's command lines in its order (t=4 -Xmx2g), returns the same
    corrected lists and leaves the same files, intermediates kept or
    removed."""
    inputs = _inputs(tmp_path, branch)
    wd = tmp_path / "wd"
    want = _run(jpre.run_preprocess, bbmap, wd, inputs, keep)
    got = _run(tpre.run_preprocess, bbmap, wd, inputs, keep)
    assert got == want
    lists, log, _, files = got
    assert log and all("t=4" in c and "-Xmx2g" in c for c in log)
    assert all(os.path.basename(p) in files for p in lists[0] + lists[1])
    assert any(n.startswith("trm.") for n in files) == keep


def test_missing_tools_raise_as_jax(tmp_path):
    """Without the tools both raise BBToolsNotFound with one message, before
    any command runs."""
    fa = tmp_path / "x.fasta"
    fa.write_text(">x\nACGT\n")
    msgs = []
    for mod in (jpre, tpre):
        log = []
        with pytest.raises(mod.BBToolsNotFound) as e:
            mod.run_preprocess(str(tmp_path / "none"), str(tmp_path / "wd"),
                               inP=[str(fa)], command_log=log)
        msgs.append(str(e.value))
        assert log == []
    assert msgs[0] == msgs[1] and "bbduk.sh" in msgs[0]


def test_preprocess_subcommand_matches_jax(tmp_path, bbmap, capsys,  # noqa: F811
                                           monkeypatch):
    """`preprocess -in1 -in2 -inS -n -m --keep` prints disco_tpu's lists and
    writes its files, from the same relative paths."""
    inputs = _inputs(tmp_path, "pairs_single")
    trees = {}
    for name, main in (("jax", jmain), ("port", tmain)):
        monkeypatch.chdir(tmp_path)
        argv = ["preprocess", "-in1", ",".join(inputs["in1"]), "-in2",
                ",".join(inputs["in2"]), "-inS", ",".join(inputs["inS"]),
                "-d", f"pp_{name}", "-bbmap", str(bbmap), "-n", "2", "-m",
                "1", "--keep"]
        assert main(argv) == 0
        trees[name] = capsys.readouterr().out.replace(f"pp_{name}", "pp")
    assert trees["port"] == trees["jax"]
    assert trees["port"].startswith("paired: pp/tecc.int.ftl.trm.a_r1.fq")
    assert assert_same_tree(tmp_path / "pp_port", tmp_path / "pp_jax") > 6


def test_assemble_ecc_native_matches_jax(tmp_path, bbmap,  # noqa: F811
                                         monkeypatch):
    """`assemble -ecc -backend native` on mini with the thresh146 cfgs:
    every file under the port's -d (ecc/, graph/, assembly/ and the
    combined FASTAs) equals disco_tpu's `assemble -ecc`.  The tools copy
    through, so the graph is the golden's."""
    # disco_tpu's assemble exports -backend through the environment
    monkeypatch.setenv("DISCO_TPU_BACKEND", "native")
    for name, main in (("jax", jmain), ("port", tmain)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(["assemble", "-inP", str(MINI / "reads.fasta"), "-d",
                     "out", "-o", "mini", *CFG_ARGS, "-ecc", "-bbmap",
                     str(bbmap), "-ecc-t", "3", "-ecc-m", "1", "-backend",
                     "native"]) == 0
    port = tmp_path / "port" / "out"
    assert assert_same_tree(port, tmp_path / "jax" / "out") > 20
    assert [p.name for p in (port / "ecc").iterdir()] == [
        "tecc.ftl.trm.reads.fasta"]
    for suffix in ("_0_parGraph.txt", "_0_containedReads.txt"):
        assert ((port / "graph" / f"mini{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix
    assert "t=3" in (bbmap / "cmds.log").read_text()
