"""The port's buildG front end (disco_tpu_torch.buildg.pipeline.run_buildg)
against the committed reference outputs: byte-identical
_0_parGraph.txt, _0_containedReads.txt, _ReadIDMap.txt and
_CheckpointInfo.txt, with the device backend pinned (and the native one).
Also: the port's ReadStore / FingerprintTable arrays equal disco_tpu's."""
import numpy as np
import pytest
import torch

from conftest import GOLDEN
from disco_tpu.index.table import FingerprintTable as RefTable
from disco_tpu.io.readstore import ReadStore as RefStore
from disco_tpu_torch.buildg.pipeline import run_buildg
from disco_tpu_torch.index.table import FingerprintTable
from disco_tpu_torch.io.readstore import ReadStore
from test_torch_native import private_native  # noqa: F401

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)

SUFFIXES = ("_0_parGraph.txt", "_0_containedReads.txt", "_ReadIDMap.txt",
            "_CheckpointInfo.txt")

# goldens were made by the reference `buildG -t 1 -m 4` (writeParGraphSize
# 1000), ecoli with -m 8 (20000); see tests/test_buildg_parity.py
CASES = [
    ("micro", [], ["reads.fasta"], 1000),
    ("microC", [], ["reads.fasta"], 1000),
    ("mini", ["reads.fasta"], [], 1000),
    ("mixed", ["p1.fasta", "p2.fasta"], ["se.fasta"], 1000),
]


def _run(case, pe, se, wsize, backend, tmp_path, monkeypatch):
    # _ReadIDMap.txt records the input paths as given: run from the golden
    # directory with the names the reference was given
    monkeypatch.chdir(GOLDEN / case)
    out = str(tmp_path / case)
    store, rel, _ = run_buildg(pe, se, out, min_overlap=30,
                               write_par_graph_size=wsize, backend=backend,
                               device="cpu")
    for suffix in SUFFIXES:
        got = (tmp_path / (case + suffix)).read_bytes()
        want = (GOLDEN / case / (case + suffix)).read_bytes()
        assert got == want, f"{case}{suffix} differs"
    return store, rel


@pytest.mark.parametrize("backend", ["device", "native"])
@pytest.mark.parametrize("case,pe,se,wsize", CASES)
def test_buildg_matches_golden(case, pe, se, wsize, backend, tmp_path,
                               monkeypatch):
    _, rel = _run(case, pe, se, wsize, backend, tmp_path, monkeypatch)
    # the device backend builds the one-pass relation; native runs two-pass
    assert (rel is not None) == (backend == "device")


@pytest.mark.slow
def test_buildg_ecoli_device(tmp_path, monkeypatch):
    """40,000 records: the libgomp LIFO block permutation of read IDs."""
    _run("ecoli", ["reads.fasta"], [], 20000, "device", tmp_path,
         monkeypatch)


def test_store_and_table_match_reference():
    d = GOLDEN / "mixed"
    pe = [str(d / "p1.fasta"), str(d / "p2.fasta")]
    se = [str(d / "se.fasta")]
    want = RefStore.from_files(pe, se, 30)
    got = ReadStore.from_files(pe, se, 30)
    for f in ("n_reads", "max_len", "n_words", "min_overlap",
              "dataset_ranges"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("lengths", "file_index", "packed", "packed_rc"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    t_want = RefTable.build(want, 29)
    t_got = FingerprintTable.build(got, 29)
    assert t_got.k == t_want.k
    for f in ("keys", "read", "orient", "typ"):
        a, b = getattr(t_got, f), getattr(t_want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # lookups: every table key, keys between and beyond them, 0 and 2^64-1
    rng = np.random.default_rng(0)
    q = np.concatenate([t_want.keys, t_want.keys + np.uint64(1),
                        rng.integers(0, 2**64, 1000, dtype=np.uint64),
                        np.array([0, 2**64 - 1], np.uint64)])
    for a, b in zip(t_got.lookup_ranges(q), t_want.lookup_ranges(q)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checkpoint_skips_finished_build(tmp_path, monkeypatch):
    """GC=Complete in _CheckpointInfo.txt makes run_buildg a no-op, as in
    the reference (main.cpp:45-52)."""
    _run("micro", [], ["reads.fasta"], 1000, "device", tmp_path, monkeypatch)
    before = (tmp_path / "micro_0_parGraph.txt").read_bytes()
    assert run_buildg([], ["reads.fasta"], str(tmp_path / "micro"),
                      backend="device", device="cpu") == (None, None, None)
    assert (tmp_path / "micro_0_parGraph.txt").read_bytes() == before
