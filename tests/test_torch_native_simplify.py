"""The port's bindings of simplify's C++ host code (native/__init__.py:
stdsort_permutation, seq_scan_lengths, iter_record_windows, mcmf_solve,
NativeBackIndex) against disco_tpu.native's, and a check that a
fullsimplify run takes the native paths.

simplify's dataset and contig streamer fall back to Python readers when a
native scan returns None or raises, and its flow solver to the Python
solver when the library cannot be built: a misbound symbol would give the
same bytes by another path.  test_native_paths_taken makes each fallback
fail, so only the native paths can give the goldens."""
import numpy as np
import pytest

from conftest import GOLDEN
from test_torch_native import private_native  # noqa: F401

import disco_tpu.native as jnative
from disco_tpu_torch import native
from disco_tpu_torch.io import fasta as iofasta
from disco_tpu_torch.simplify import driver, flow
from disco_tpu_torch.simplify.dataset import iter_fasta_seqs

READS = [GOLDEN / "mini" / "reads.fasta", GOLDEN / "mixed" / "p1.fasta",
         GOLDEN / "ecoli" / "reads.fasta"]
CFGS = [str(GOLDEN / "thresh146" / f)
        for f in ("cfg.cfg", "cfg_2.cfg", "cfg_3.cfg")]


@pytest.mark.parametrize("path", READS, ids=lambda p: p.parent.name)
def test_seq_scan_lengths(path):
    offs = native.seq_scan_lengths(str(path))
    assert isinstance(offs, np.ndarray) and offs.dtype == np.int64
    assert offs.tolist() == jnative.seq_scan_lengths(str(path)).tolist()
    assert np.diff(offs).tolist() == [len(s) for s in iter_fasta_seqs(
        str(path))]


@pytest.mark.parametrize("window_bytes", [64 << 20, 10_000, 1])
def test_iter_record_windows(window_bytes):
    """Windows of the default size (one for mini), of some 40 records and
    of one record each: the same windows as disco_tpu's, covering the
    whole-file scan in order."""
    path = str(READS[0])
    got = native.iter_record_windows(path, window_bytes)
    assert got is not None
    got = [(b.tobytes(), o.tolist(), lo) for b, o, lo in got]
    want = [(b.tobytes(), o.tolist(), lo)
            for b, o, lo in jnative.iter_record_windows(path, window_bytes)]
    assert got == want
    blob, offs = native.seq_scan_path(path)
    assert b"".join(b for b, _, _ in got) == blob.tobytes()
    assert [lo for _, _, lo in got][0] == 0
    assert sum(len(o) - 1 for _, o, _ in got) == len(offs) - 1
    if window_bytes == 1:
        assert len(got) == len(offs) - 1


def test_native_paths_taken(tmp_path, monkeypatch):
    """fullsimplify on mini with the fallbacks made to fail or watched: the
    read lengths come from seq_scan_lengths (an array for every file: the
    reader after it runs only when it raises or returns None), the contig
    and scaffold reads from iter_record_windows, the flow from mcmf_solve,
    and the outputs are the goldens."""
    seen = {"lengths": [], "windows": [], "mcmf": 0}

    def lengths(path, _real=native.seq_scan_lengths):
        out = _real(path)
        seen["lengths"].append(out)
        return out

    def windows(path, *a, _real=native.iter_record_windows):
        out = _real(path, *a)
        seen["windows"].append(out)
        return out

    def mcmf(*a, _real=native.mcmf_solve):
        seen["mcmf"] += 1
        return _real(*a)

    def fallback(*a, **kw):
        raise AssertionError("a Python fallback was taken")

    monkeypatch.setattr(native, "seq_scan_lengths", lengths)
    monkeypatch.setattr(native, "seq_scan", fallback)
    monkeypatch.setattr(native, "iter_record_windows", windows)
    monkeypatch.setattr(iofasta, "scan_records", fallback)
    monkeypatch.setattr(native, "mcmf_solve", mcmf)
    monkeypatch.setattr(flow, "_solve_flow_py", fallback)
    d = GOLDEN / "mini"
    driver.run_fullsimplify(
        [], [], [str(d / "reads.fasta")], [str(d / "mini_0_parGraph.txt")],
        [str(d / "mini_0_containedReads.txt")], str(tmp_path / "mini"),
        param_files=CFGS)
    assert seen["lengths"] and all(
        isinstance(o, np.ndarray) for o in seen["lengths"])
    assert len(seen["windows"]) >= 2 and all(
        w is not None for w in seen["windows"])
    assert seen["mcmf"] >= 1
    for name in ("scaffoldsFinal_1.fasta", "UsedReads_1.txt",
                 "scaffoldEdgesFinal_1.txt", "phase_flow_1.txt"):
        assert ((tmp_path / f"mini_{name}").read_bytes()
                == (d / "simplify" / f"mini_{name}").read_bytes()), name


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("n", [0, 5, 16, 17, 1000])
def test_stdsort_permutation(n, descending, dtype):
    """libstdc++ std::sort's permutation, ties included: n <= 16 takes the
    stable-argsort shortcut, larger n the native sort."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(n // 4, 1) + 1, n).astype(dtype)
    got = native.stdsort_permutation(keys, descending=descending)
    want = jnative.stdsort_permutation(keys, descending=descending)
    assert got.tolist() == want.tolist()
    assert sorted(got.tolist()) == list(range(n))
    s = keys.astype(np.int64)[got]
    assert np.all(np.diff(s) <= 0 if descending else np.diff(s) >= 0)


def _parse_dimacs(path) -> flow.FlowProblem:
    fp = flow.FlowProblem()
    with open(path) as f:
        for line in f:
            tok = line.split()
            if tok and tok[0] == "p":
                fp.v = int(tok[2])
            elif tok and tok[0] == "a":
                fp.arcs.append(tuple(int(x) for x in tok[1:6]))
    return fp


DUMPS = sorted(GOLDEN.glob("*/simplify/*dimacs*"))


@pytest.mark.parametrize("dump", DUMPS, ids=lambda p: p.parent.parent.name)
def test_mcmf_solve(dump):
    """The per-arc flows of the golden DIMACS dumps equal disco_tpu's native
    solver's and the Python solver's (min-cost optima are degenerate, so
    the arc choices must agree, not only the cost)."""
    fp = _parse_dimacs(dump)
    assert fp.arcs
    cols = [np.array(c, np.int64) for c in zip(*fp.arcs)]
    got = native.mcmf_solve(fp.v, *cols).tolist()
    assert got == jnative.mcmf_solve(fp.v, *cols).tolist()
    assert got == flow._solve_flow_py(fp)


def test_native_back_index():
    """Bulk registrations and removals, then every read's entries in both
    orientations (more than the 64 its query buffers start with), against
    disco_tpu's back index."""
    rng = np.random.default_rng(3)
    n = 20
    ours, twin = native.NativeBackIndex(n), jnative.NativeBackIndex(n)
    for addr in range(1, 40):
        rids = rng.integers(1, n + 1, int(rng.integers(1, 200)))
        bits = rng.integers(0, 2, len(rids))
        for idx in (ours, twin):
            idx.add_bulk(rids, bits, addr, idx0=addr % 3)
        if addr % 5 == 0:
            for idx in (ours, twin):
                idx.remove_bulk(rids[::2], bits[::2], addr, idx0=addr % 3)
    for rid in range(n + 1):
        assert ours.has(rid) == twin.has(rid)
        for bit in (0, 1):
            assert ours.query(rid, bit) == twin.query(rid, bit)
    assert ours.head.tolist() == twin.head.tolist()
    assert max(len(ours.query(r, b)[0] or ()) for r in range(n + 1)
               for b in (0, 1)) > 64
