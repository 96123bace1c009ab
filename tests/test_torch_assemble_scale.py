"""disco_tpu_torch.tools.assemble_scale, time to contigs by hand, at small
sizes on the CPU: the genome it draws against tools/make_testdata.py's
reads, its genome check on the scaffolds of `assemble -backend native`
(and on a copy with one base changed), its JSON line, `--keep` and
`--against`, its refusal without a card; an `assemble` child of
bench_e2e.run_child; the port's `assemble -backend native` against
disco_tpu's on a set that runs all three iterations; and the device
relation's `assemble` against native's over reads with errors."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_native import private_native  # noqa: F401
from test_torch_simplify import assert_same_tree

from disco_tpu_torch.tools import assemble_scale as asc
from disco_tpu_torch.tools.bench_e2e import run_child

ROOT = pathlib.Path(__file__).resolve().parent.parent
MINI = ROOT / "tests" / "golden" / "mini"
STAGES = ["parSimplifyAndLoad", "graphPathFindInitial", "simplifyGraph",
          "calculateFlowStream", "postFlowSimplify", "streamContigs",
          "scaffold", "streamScaffolds"]


def _make(path: pathlib.Path, *args):
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_testdata.py"),
                    str(path), *map(str, args)], check=True,
                   stdout=subprocess.DEVNULL)


def _reads(path: pathlib.Path):
    return [line.strip() for line in path.read_text().splitlines()
            if not line.startswith(">")]


def _tool(*args, cwd=ROOT, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "disco_tpu_torch.tools.assemble_scale",
         *args], cwd=cwd, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT)})


def test_genome_draw_matches_make_testdata(tmp_path):
    """Every read of a 20 kb set made by tools/make_testdata.py lies in the
    genome the port draws from the same seed, or in its reverse
    complement; and in no genome of another seed."""
    fasta = tmp_path / "r.fasta"
    _make(fasta, "--genome-len", 20000, "--coverage", 10, "--seed", 7)
    reads = _reads(fasta)
    assert len(reads) == 800
    genome = asc.BASES[asc.draw_genome(20000, 7)].tobytes().decode()
    rc = asc.revcomp(genome)
    assert all(r in genome or r in rc for r in reads)
    other = asc.BASES[asc.draw_genome(20000, 8)].tobytes().decode()
    assert not any(r in other or r in asc.revcomp(other) for r in reads)


def test_locate_gives_the_forward_strands_place():
    """locate finds a piece as itself or as its reverse complement and
    gives its place on the forward strand; a piece with a base changed,
    or with another letter, is in neither."""
    rng = np.random.default_rng(3)
    genome = asc.BASES[asc.draw_genome(5000, 11)].tobytes().decode()
    rc_genome = asc.revcomp(genome)
    for _ in range(300):
        s, n = int(rng.integers(0, 4900)), int(rng.integers(40, 100))
        piece = genome[s:s + n]
        if rng.random() < 0.5:
            piece = asc.revcomp(piece)
        assert asc.locate(genome, rc_genome, piece) == (s, n)
        i = int(rng.integers(0, n))
        for b in "ACGTN".replace(piece[i], ""):
            assert asc.locate(genome, rc_genome,
                              piece[:i] + b + piece[i + 1:]) is None


def test_scaffold_pieces_split_at_runs_of_n(tmp_path):
    """A scaffold is checked piece by piece between its runs of N; the
    longest scaffold's pieces cover the union of their places."""
    codes = asc.draw_genome(3000, 5)
    g = asc.BASES[codes].tobytes().decode()
    ctg = tmp_path / "c.fasta"
    ctg.write_text(f">c1\n{g[100:900]}\n>c2\n{asc.revcomp(g[1000:1500])}\n")
    scf = tmp_path / "s.fasta"
    scf.write_text(f">s1\n{g[0:1000]}NNNNN{asc.revcomp(g[1200:2000])}"
                   f"NN{g[1900:2500]}\n>s2\n{g[2600:2700]}\n")
    out = asc.genome_check(codes, [ctg], [scf])
    assert out["ok"] and out["genome_len"] == 3000
    assert out["contigs"] == {"files": 1, "sequences": 2, "n50": 800,
                              "longest": 800, "total": 1300, "pieces": 2,
                              "failed": 0, "first_failed": []}
    s = out["scaffolds"]
    assert (s["sequences"], s["pieces"], s["failed"]) == (2, 4, 0)
    assert s["longest"] == 1000 + 5 + 800 + 2 + 600
    assert s["longest_covers"] == (1000 + 1300) / 3000
    # no pieces at all is no pass
    assert not asc.genome_check(codes, [], [scf])["ok"]


@pytest.fixture(scope="module")
def native_assembly(tmp_path_factory):
    """`assemble -backend native` over a small error-free set (40 kb, 25x,
    seed 99), run from the reads' directory: (genome codes, directory)."""
    d = tmp_path_factory.mktemp("asm")
    _make(d / "reads.fasta", "--genome-len", 40000, "--coverage", 25,
          "--seed", 99)
    subprocess.run(
        [sys.executable, "-m", "disco_tpu_torch", "assemble", "-inP",
         "reads.fasta", "-d", "out", "-o", "a", *asc.CFGS, "-backend",
         "native"], check=True, cwd=d, capture_output=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=300)
    return asc.draw_genome(40000, 99), d / "out"


@pytest.mark.parametrize("kind", ["contigs", "scaffolds"])
def test_genome_check_holds_and_catches_one_base(kind, native_assembly,
                                                 tmp_path):
    """The genome check passes on the native assembly's contigs and
    scaffolds, and fails on a copy of one of them with one base changed."""
    codes, out = native_assembly
    asm = out / "assembly"
    files = {k: sorted(asm.glob(f"a_{k}Final_*.fasta"))
             for k in ("contigs", "scaffolds")}
    check = asc.genome_check(codes, files["contigs"], files["scaffolds"])
    assert check["ok"], check
    assert check[kind]["sequences"] >= 1 and check[kind]["pieces"] >= 1
    assert check["scaffolds"]["longest_covers"] > 0.99
    bad = tmp_path / files[kind][0].name
    lines = files[kind][0].read_text().splitlines(keepends=True)
    seq = lines[1]
    i = len(seq) // 2
    lines[1] = seq[:i] + "ACGT"[("ACGT".find(seq[i]) + 1) % 4] + seq[i + 1:]
    bad.write_text("".join(lines))
    files[kind] = [bad, *files[kind][1:]]
    check = asc.genome_check(codes, files["contigs"], files["scaffolds"])
    assert not check["ok"]
    assert check[kind]["failed"] == 1
    assert check[kind]["first_failed"] == [f"{bad.name}:0"]


def test_native_run_prints_one_json_line(tmp_path):
    """--runs native on a 20 kb genome: one JSON line with the run's wall,
    files and child report (buildG's and fullsimplify's walls, the
    iterations' stages, the RSS at the hand-off), no first run to compare
    with, and the genome check; --keep keeps the tree and its digests,
    and a second call --against it finds every file equal, by bytes and,
    with the kept tree gone, by the digests."""
    keep = tmp_path / "keep"       # named relative to the tool's directory
    res = _tool("--genome-len", "20000", "--runs", "native", "--keep",
                "keep", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["bench"] == "assemble_scale" and line["ok"] is True
    assert (line["genome_len"], line["coverage"], line["seed"]) == (
        20000, 25.0, 99)
    assert line["card"] is None and line["data_s"] > 0
    run = line["runs"]["native"]
    assert run["rc"] == 0 and run["same_as_first"] is None
    assert run["against"] is None and run["files"] > 20
    assert 0 < run["buildg_s"] < run["wall_s"]
    assert 0 < run["fullsimplify_s"] < run["wall_s"]
    assert run["rss_start_bytes"] <= run["rss_handoff_bytes"] \
        <= run["rss_peak_bytes"]
    assert run["launches"] == {"K1": 0, "K1_rows": 0, "K2": 0}
    assert [it["iteration"] for it in run["iterations"]] == [1]
    assert [s for s, _ in run["iterations"][0]["stages"]] == STAGES
    check = line["genome_check"]
    assert check["ok"] and check["scaffolds"]["sequences"] >= 1
    digests = json.loads((keep / "native.sha256.json").read_text())
    assert len(digests) == run["files"]
    assert "asm_scaffoldsFinalCombined.fasta" in digests
    assert "graph/asm_0_parGraph.txt" in digests

    for gone in (False, True):
        if gone:
            shutil.rmtree(keep / "native")
        res = _tool("--genome-len", "20000", "--runs", "native", "--reads",
                    "keep/reads.fasta", "--against", "keep", cwd=tmp_path)
        assert res.returncode == 0, res.stderr
        line = json.loads(res.stdout.strip().splitlines()[-1])
        assert line["data_s"] is None
        same = line["runs"]["native"]["against"]["native"]
        assert sorted(same) == sorted(digests) and all(same.values())


def test_device_without_a_card_exits_before_any_data(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the device run runs")
    for runs in ("device", "native,rma"):
        res = _tool("--genome-len", "20000", "--runs", runs, "--reads",
                    str(tmp_path / "r.fasta"))
        assert res.returncode != 0
        assert "CUDA card" in res.stderr and not res.stdout.strip()
        assert not list(tmp_path.iterdir())


def test_assemble_child_reports_fullsimplify(tmp_path):
    """An `assemble` child of run_child on mini: its graph equals the
    reference's golden, and it reports buildG's and fullsimplify's walls,
    the RSS at the hand-off and each iteration's stages."""
    wall, run = run_child(str(MINI), str(tmp_path / "mini"),
                          ["-inP", "reads.fasta", *asc.CFGS, "-backend",
                           "native"], timeout=300, command="assemble")
    assert run["rc"] == 0 and wall > run["buildg_s"] + run["fullsimplify_s"]
    for key in ("rss_buildg_end_bytes", "rss_handoff_bytes"):
        assert run["rss_start_bytes"] <= run[key] <= run["rss_peak_bytes"]
    its = run["iterations"]
    assert [it["iteration"] for it in its] == [1] and not its[0]["continue"]
    assert [s for s, _ in its[0]["stages"]] == STAGES
    assert sum(t for _, t in its[0]["stages"]) <= its[0]["wall_s"] \
        <= run["fullsimplify_s"]
    assert [s for s, _ in run["stages"]][-len(STAGES):] == STAGES
    for suffix in ("_0_parGraph.txt", "_0_containedReads.txt"):
        assert (tmp_path / "mini" / "graph" / f"mini{suffix}").read_bytes() \
            == (MINI / f"mini{suffix}").read_bytes(), suffix
    assert (tmp_path / "mini" / "mini_scaffoldsFinalCombined.fasta").read_bytes(
        ) == (MINI / "simplify" / "mini_scaffoldsFinal_1.fasta").read_bytes()


def test_assemble_three_iterations_matches_disco_tpu(tmp_path, monkeypatch):
    """`assemble -backend native` of both packages on a set whose noise
    pairs and islets keep iterations 2 and 3 running (40 kb, 15x, 120 bp,
    noise 0.30, 8 islets, seed 888): every file the same."""
    from disco_tpu.cli import main as jmain
    from disco_tpu_torch.cli import main as tmain

    _make(tmp_path / "reads.fasta", "--genome-len", 40000, "--coverage", 15,
          "--read-len", 120, "--insert", 360, "--seed", 888, "--noise-frac",
          0.30, "--islets", 8)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DISCO_TPU_BACKEND", "native")
    for name, main in (("port", tmain), ("jax", jmain)):
        assert main(["assemble", "-inP", "reads.fasta", "-d", name, "-o",
                     "it", *asc.CFGS, "-backend", "native"]) == 0
    assert assert_same_tree(tmp_path / "port", tmp_path / "jax") > 50
    for it in (1, 2, 3):
        for kind in ("contigs", "scaffolds"):
            assert (tmp_path / "port" / "assembly" /
                    f"it_{kind}Final_{it}.fasta").exists()


def test_device_relation_with_read_errors_assembles_as_native(tmp_path,
                                                             monkeypatch):
    """`assemble -backend device` (its relation on the CPU: the plain
    versions of the kernels) and `-backend native` over reads with a
    substitution in 1 of 200 bases (40 kb, 25x, seed 99, as the 4.6 Mb
    cell with errors): the operators and the flow have work, all three
    iterations run, and every file is the same."""
    import functools

    from disco_tpu_torch.buildg import pipeline
    from disco_tpu_torch.cli import main as tmain

    _make(tmp_path / "reads.fasta", "--genome-len", 40000, "--coverage", 25,
          "--seed", 99, "--error-rate", 0.005)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pipeline, "run_buildg", functools.partial(
        pipeline.run_buildg, device="cpu"))
    for name in ("device", "native"):
        assert tmain(["assemble", "-inP", "reads.fasta", "-d", name, "-o",
                      "e", *asc.CFGS, "-backend", name]) == 0
    assert assert_same_tree(tmp_path / "device", tmp_path / "native") > 50
    flow = (tmp_path / "device" / "assembly" / "e_dimacs_dump.txt")
    assert flow.stat().st_size > 0
    for it in (1, 2, 3):
        assert (tmp_path / "device" / "assembly" /
                f"e_scaffoldsFinal_{it}.fasta").exists()
