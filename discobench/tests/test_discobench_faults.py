"""A run's `correct` with the timed path broken underneath: the harness
without its look for a card, the program's device path on the CPU (the
kernels' plain versions), each fault the cells can have (`_faults.py`)
planted in the program.  A sound run of the same cells is correct.  (The
cells run on one card, so no exchange between cards can be left out.)"""
import pytest

import _faults
from _tiny import ISOLATE, MOCK, on_cpu, run_tiny, tiny_root

CELLS = (ISOLATE, MOCK)


@pytest.fixture
def root(tmp_path, monkeypatch):
    on_cpu(monkeypatch)
    return tiny_root(tmp_path)


def numbers(result):
    return {k: c["value"] for k, c in result["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, tmp_path, cell):
    r = run_tiny(root, cell, tmp=str(tmp_path))
    assert r["correct"], numbers(r)
    assert not any(numbers(r).values()) or cell == MOCK
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", _faults.GRAPH, ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run_tiny(root, cell, tmp=str(tmp_path))
    assert not r["correct"], numbers(r)


@pytest.mark.parametrize("fault, number", [
    (_faults.altered_contig, "pieces_off_genome"),
    (_faults.half_the_contigs, "contig_gap_bp"),
    (_faults.scaffolds_cut, "scaffold_gap_bp")], ids=lambda x: getattr(
        x, "__name__", x))
def test_assembly_fault_is_not_correct(root, tmp_path, monkeypatch, fault,
                                       number):
    fault(monkeypatch)
    r = run_tiny(root, MOCK, tmp=str(tmp_path))
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]


def test_k2_rejections_need_the_repeats(tmp_path, monkeypatch):
    """Without the planted repeats every candidate is a true overlap, so a
    K2 that accepts every candidate reads correct: the repeats are what
    lets `correct` see the dual check's rejections."""
    on_cpu(monkeypatch)
    root = tiny_root(tmp_path, families=None)
    _faults.k2_accepts_all(monkeypatch)
    r = run_tiny(root, ISOLATE, tmp=str(tmp_path))
    assert r["correct"], numbers(r)
