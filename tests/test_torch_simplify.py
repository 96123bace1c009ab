"""disco_tpu_torch.simplify (fullsimplify, parsimplify) against
disco_tpu.simplify and the reference's goldens, byte for byte.

Each test runs both packages on the same inputs in directories of their
own, requires every file either writes to be byte-identical to the other's,
and holds the port's outputs to the goldens of the reference assembler
(tests/golden).  The parameter files are the in-repo
tests/golden/thresh146/cfg{,_2,_3}.cfg, which reproduce the committed
fullsimplify goldens."""
import io
import pathlib
import shutil
import tempfile

import pytest

from conftest import GOLDEN
from test_torch_native import private_native  # noqa: F401

import disco_tpu.simplify.driver as jdriver
import disco_tpu_torch.simplify.driver as tdriver
from disco_tpu.simplify.cytoscape import write_cytoscape as j_cytoscape
from disco_tpu.simplify.dataset import SimplifyDataset as JDataset
from disco_tpu.simplify.engine import FullGraph as JGraph
from disco_tpu.simplify.params import Params as JParams
from disco_tpu.simplify.pargraph import parsimplify as j_parsimplify
from disco_tpu.native import parsimplify_run as j_parsimplify_run
from disco_tpu_torch.native import parsimplify_run as t_parsimplify_run
from disco_tpu_torch.simplify.cytoscape import write_cytoscape as t_cytoscape
from disco_tpu_torch.simplify.dataset import SimplifyDataset as TDataset
from disco_tpu_torch.simplify.engine import FullGraph as TGraph
from disco_tpu_torch.simplify.params import Params as TParams
from disco_tpu_torch.simplify.pargraph import parsimplify as t_parsimplify

THRESH = GOLDEN / "thresh146"
CFGS = [str(THRESH / f) for f in ("cfg.cfg", "cfg_2.cfg", "cfg_3.cfg")]

# the reference's fullsimplify outputs held by the goldens
OUTPUTS = [
    "phase_parsimplify_1.txt", "phase_initial_1.txt",
    "phase_aggressive_1.txt", "phase_flow_1.txt", "phase_postflow_1.txt",
    "phase_scaffold_1.txt", "dimacs_dump.txt", "scaffoldsFinal_1.fasta",
    "UsedReads_1.txt", "scaffoldEdgesFinal_1.txt",
    "scaffoldEdgeCoverageFinal_1.txt",
]

PACKAGES = {"jax": jdriver, "port": tdriver}


def _stage(w: pathlib.Path, files) -> None:
    w.mkdir(parents=True)
    for src in files:
        shutil.copy(src, w / pathlib.Path(src).name)


def assert_same_tree(a: pathlib.Path, b: pathlib.Path) -> int:
    """Every file under `a` equals the file of the same name under `b`, and
    neither has a file the other lacks.  Returns the number compared."""
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), f"{n} differs"
    return len(names)


def _run_both(tmp_path, files, run):
    """Stage `files` into tmp_path/{jax,port}, call run(driver, dir) with
    each package's driver module, and require byte-identical trees.
    Returns the port's directory."""
    for name, driver in PACKAGES.items():
        _stage(tmp_path / name, files)
        run(driver, tmp_path / name)
    assert assert_same_tree(tmp_path / "jax", tmp_path / "port") > len(files)
    return tmp_path / "port"


def _fixture_inputs(fix):
    d = GOLDEN / fix
    graph = [d / f"{fix}_0_parGraph.txt", d / f"{fix}_0_containedReads.txt"]
    if fix == "mixed":
        return graph + [d / "se.fasta", d / "p1.fasta", d / "p2.fasta"]
    return graph + [d / "reads.fasta"]


def _simplify(driver, w, fix, **kw):
    """fullsimplify of the staged fixture `fix` in `w` (mixed: -fs se.fasta
    -fpi p1,p2, the multi-dataset mate arithmetic; else -fpi reads)."""
    if fix == "mixed":
        single, inter = [str(w / "se.fasta")], [str(w / "p1.fasta"),
                                                str(w / "p2.fasta")]
    else:
        single, inter = [], [str(w / "reads.fasta")]
    kw.setdefault("param_files", CFGS)
    return driver.run_fullsimplify(
        single, [], inter, [str(w / f"{fix}_0_parGraph.txt")],
        [str(w / f"{fix}_0_containedReads.txt")], str(w / fix), **kw)


@pytest.mark.parametrize("fix", ["mini", "ecoli", "mixed"])
def test_fullsimplify_parity(fix, tmp_path):
    w = _run_both(tmp_path, _fixture_inputs(fix),
                  lambda driver, w: _simplify(driver, w, fix))
    gold = GOLDEN / fix / "simplify"
    for name in OUTPUTS:
        assert ((w / f"{fix}_{name}").read_bytes()
                == (gold / f"{fix}_{name}").read_bytes()), name


@pytest.mark.parametrize("variant", ["tab", "notab"])
def test_stream_contigs_thresh_parity(variant, tmp_path):
    """-simPth: the contig post-processing for a read count of the
    reference's threshold table (146 reads), with and without the split and
    join tables."""
    sim = tmp_path / "simdir"
    (sim / "test").mkdir(parents=True)
    if variant == "tab":
        for f in ("2800.txt", "2800_join.txt"):
            shutil.copy(THRESH / "simdir" / "test" / f, sim / "test" / f)

    def run(driver, w):
        driver.run_fullsimplify(
            [], [], [str(w / "reads146.fasta")],
            [str(w / "T_0_parGraph.txt")], [str(w / "T_0_containedReads.txt")],
            str(w / "R"), param_files=CFGS, sim_path=str(sim))

    w = _run_both(tmp_path, [THRESH / f for f in (
        "reads146.fasta", "T_0_parGraph.txt", "T_0_containedReads.txt")], run)
    for name in ("R_contigsFinal_1.fasta", "R_contigEdgesFinal_1.txt",
                 "R_contigEdgeCoverageFinal_1.txt", "R_scaffoldsFinal_1.fasta",
                 "R_UsedReads_1.txt"):
        assert ((w / name).read_bytes()
                == (THRESH / f"ref_{variant}" / name).read_bytes()), name


def test_gfa_and_unused_parity(tmp_path):
    """PrintGFA, PrintGFA2 and PrintUnused (tests/golden/mini/simplify_gfa)."""
    gold = GOLDEN / "mini" / "simplify_gfa"
    params = [str(gold / "p1gfa.cfg"), CFGS[1], CFGS[2]]
    w = _run_both(tmp_path, _fixture_inputs("mini"),
                  lambda driver, w: _simplify(driver, w, "mini",
                                              param_files=params))
    for name in ("mini_Graph_1.gfa", "mini_Graph_1.gfa2",
                 "mini_0_UnusedPairedReads.fasta"):
        assert (w / name).read_bytes() == (gold / name).read_bytes(), name


def test_resume_after_flow(tmp_path):
    """A run interrupted after FlowAnalysis resumes from the checkpoint file
    and the _CurrGraph_ snapshot (tests/golden/mini/resume)."""
    d = GOLDEN / "mini"
    resume = tmp_path / "resume"
    resume.mkdir()
    (resume / "mini_SimplificationCheckpointInfo.txt").write_text(
        "Iteration=1\nParSimplify=1\nInitialSimplify=1\n"
        "AggressiveSimplify=1\nFlowAnalysis=1\n")
    shutil.copy(d / "simplify" / "mini_phase_flow_1.txt",
                resume / "mini_CurrGraph_.txt")
    w = _run_both(tmp_path, _fixture_inputs("mini") + [
        resume / "mini_SimplificationCheckpointInfo.txt",
        resume / "mini_CurrGraph_.txt",
        d / "simplify" / "mini_0_ParSimpleEdges.txt"],
        lambda driver, w: _simplify(driver, w, "mini"))
    for name in ("mini_scaffoldsFinal_1.fasta", "mini_phase_postflow_1.txt",
                 "mini_phase_scaffold_1.txt", "mini_UsedReads_1.txt"):
        assert ((w / name).read_bytes()
                == (d / "resume" / name).read_bytes()), name


class _Killed(RuntimeError):
    pass


def _cadence_cfgs(w, cadence):
    cfg = w / "disco1.cfg"
    cfg.write_text(pathlib.Path(CFGS[0]).read_text()
                   + f"\nDiskGraphUpdate={cadence}\n")
    return [str(cfg), CFGS[1], CFGS[2]]


MIDLOOP_COMPARE = [
    "mini_phase_initial_1.txt", "mini_phase_aggressive_1.txt",
    "mini_phase_flow_1.txt", "mini_phase_postflow_1.txt",
    "mini_phase_scaffold_1.txt", "mini_UsedReads_1.txt",
    "mini_scaffoldsFinal_1.fasta"]


def test_midloop_kill_resume_byte_identical(tmp_path):
    """The periodic in-loop graph snapshot (DiskGraphUpdate, cadence 0:
    every loop pass): a port run killed right after the first snapshot
    resumes from it and ends byte-identical to an uninterrupted run, which
    is byte-identical to disco_tpu's."""
    base = _run_both(
        tmp_path / "base", _fixture_inputs("mini"),
        lambda driver, w: _simplify(driver, w, "mini",
                                    param_files=_cadence_cfgs(w, 0)))
    cut = tmp_path / "cut"
    _stage(cut, _fixture_inputs("mini"))
    params = _cadence_cfgs(cut, 0)
    hits = []

    def bomb():
        hits.append(1)
        raise _Killed()

    with pytest.raises(_Killed):
        _simplify(tdriver, cut, "mini", param_files=params,
                  on_disk_snapshot=bomb)
    assert hits, "periodic snapshot never fired"
    assert (cut / "mini_CurrGraph_.txt").exists()
    ckpt = (cut / "mini_SimplificationCheckpointInfo.txt").read_text()
    assert "ParSimplify=1" in ckpt and "InitialSimplify=1" not in ckpt
    _simplify(tdriver, cut, "mini", param_files=params)
    for name in MIDLOOP_COMPARE:
        assert (cut / name).read_bytes() == (base / name).read_bytes(), name


def test_cadence_never_fires_at_default(tmp_path):
    """At the reference's 18000 s cadence no snapshot fires on a short run
    (_CurrGraph_ changes only at phase boundaries)."""
    hits = []
    w = tmp_path / "w"
    _stage(w, _fixture_inputs("mini"))
    _simplify(tdriver, w, "mini", param_files=_cadence_cfgs(w, 18000),
              on_disk_snapshot=lambda: hits.append(1))
    assert not hits
    assert ((w / "mini_scaffoldsFinal_1.fasta").read_bytes()
            == (GOLDEN / "mini" / "simplify" / "mini_scaffoldsFinal_1.fasta"
                ).read_bytes())


# parsimplify on each fixture: the native code (the production path) and the
# Python oracle, each against its disco_tpu twin and the reference's output
# (refbuild/parsimplify <parGraph> <out> 30 1)
PARSIMPLIFY = {
    "native": (lambda src, out: t_parsimplify_run(src, out, 30),
               lambda src, out: j_parsimplify_run(src, out, 30)),
    "oracle": (lambda src, out: t_parsimplify(src, out, 30, 1),
               lambda src, out: j_parsimplify(src, out, 30, 1)),
}


@pytest.mark.parametrize("impl", sorted(PARSIMPLIFY))
@pytest.mark.parametrize("fix", ["micro", "microC", "mini", "ecoli"])
def test_parsimplify_parity(fix, impl, tmp_path):
    d = GOLDEN / fix
    golden = d / "simplify" / f"{fix}_parsimple.txt"
    port, jax = PARSIMPLIFY[impl]
    src = str(d / f"{fix}_0_parGraph.txt")
    port(src, str(tmp_path / "port.txt"))
    jax(src, str(tmp_path / "jax.txt"))
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    assert got == golden.read_bytes()


def _graph_from_lines(pkg, lines):
    Dataset, Graph, Params = pkg
    params = Params()
    params.set_parameters(CFGS[0])
    graph = Graph(Dataset([], [], [str(GOLDEN / "mini" / "reads.fasta")]),
                  params)
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "edges.txt"
        path.write_text("\n".join(lines) + "\n")
        graph.read_par_edges(str(path))
    graph.sort_edges_by_dest()
    return graph


def _dump(graph, tmp_path, name):
    path = tmp_path / name
    graph.print_all_edges(str(path))
    return path.read_bytes()


T_PKG = (TDataset, TGraph, TParams)
J_PKG = (JDataset, JGraph, JParams)


def test_remove_parallel_edges(tmp_path):
    """removeParallelEdges (reference: OverlapGraph.cpp:1611-1648): three
    parallel 1->2 edges and an unrelated 3->4 edge; the longest 1->2 edge
    (offset 150) survives, as in disco_tpu."""
    lines = ["1\t2\t0,100,0,0,0,0", "1\t2\t1,150,0,0,0,0",
             "1\t2\t2,120,0,0,0,0", "3\t4\t0,80,0,0,0,0"]
    graph = _graph_from_lines(T_PKG, lines)
    twin = _graph_from_lines(J_PKG, lines)
    assert graph.n_edges == 8  # 4 forward + 4 twins
    assert graph.remove_parallel_edges() == twin.remove_parallel_edges() == 2
    assert graph.n_edges == twin.n_edges == 4
    kept = [e for e in graph.g.at(1) if e.dst == 2]
    assert len(kept) == 1 and kept[0].offset == 150
    assert len(graph.g.at(3)) == 1
    assert len([e for e in graph.g.at(2) if e.dst == 1]) == 1
    assert graph.remove_parallel_edges() == 0
    assert _dump(graph, tmp_path, "t.txt") == _dump(twin, tmp_path, "j.txt")


def _mini_graph(pkg, edges: pathlib.Path):
    Dataset, Graph, Params = pkg
    d = GOLDEN / "mini"
    params = Params()
    params.set_parameters(CFGS[0])
    ds = Dataset([], [], [str(d / "reads.fasta")])
    ds.store_contained_read_info([str(d / "mini_0_containedReads.txt")])
    graph = Graph(ds, params)
    graph.read_par_edges(str(edges))
    graph.sort_edges_by_dest()
    return graph


def test_remove_parallel_edges_real_graph(tmp_path):
    """On mini's parsimplified graph no node keeps two edges to one
    destination after one pass, and the graph equals disco_tpu's."""
    out = tmp_path / "pse.txt"
    t_parsimplify(str(GOLDEN / "mini" / "mini_0_parGraph.txt"), str(out), 30,
                  1)
    graph = _mini_graph(T_PKG, out)
    twin = _mini_graph(J_PKG, out)
    before = graph.n_edges
    removed = graph.remove_parallel_edges()
    assert removed == twin.remove_parallel_edges()
    assert graph.n_edges == before - 2 * removed
    for k in graph.g:
        dsts = [e.dst for e in graph.g.at(k)]
        assert len(dsts) == len(set(dsts)), f"node {k} kept parallel edges"
    assert _dump(graph, tmp_path, "t.txt") == _dump(twin, tmp_path, "j.txt")


def test_cytoscape_dump():
    """The Cytoscape TSV (reference: OverlapGraph.cpp:1969-1986) of mini's
    parsimplified graph equals disco_tpu's."""
    edges = GOLDEN / "mini" / "simplify" / "mini_0_ParSimpleEdges.txt"
    dumps = []
    for pkg, write in ((T_PKG, t_cytoscape), (J_PKG, j_cytoscape)):
        buf = io.StringIO()
        write(_mini_graph(pkg, edges), buf)
        dumps.append(buf.getvalue())
    assert dumps[0] == dumps[1]
    lines = dumps[0].splitlines()
    assert lines[0].startswith("source\ttarget\t")
    n_smaller = sum(1 for e in _mini_graph(T_PKG, edges).get_edges()
                    if e.is_smaller())
    assert len(lines) - 1 == n_smaller > 0
    assert all(len(row.split("\t")) == 8 for row in lines[1:])


def test_mate_array_matches_mate_pair():
    """The vectorized mate array equals mate_pair for every read across
    interleaved, separated and single datasets, and disco_tpu's array."""
    files = ([str(GOLDEN / "mixed" / "se.fasta")],
             [str(GOLDEN / "mixed" / "p1.fasta"),
              str(GOLDEN / "mixed" / "p2.fasta")],
             [str(GOLDEN / "mini" / "reads.fasta")])
    d, twin = TDataset(*files), JDataset(*files)
    for rid in range(1, d.size() + 1, 7):  # the contained-read branches
        d.contained_flag[rid] = True
        twin.contained_flag[rid] = True
    ma = d.mate_array()
    assert ma.tolist() == twin.mate_array().tolist()
    for rid in range(1, d.size() + 1):
        assert int(ma[rid]) == d.mate_pair(rid), rid
