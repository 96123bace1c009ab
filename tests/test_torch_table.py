"""The fingerprint table's two routes (disco_tpu_torch/index/table.py): the
torch route on CPU tensors gives the numpy route's arrays, dtypes and order,
ties included, and both give disco_tpu's; run_buildg's device backend takes
the torch route inside insertDataset, the native backend the numpy one."""
import numpy as np
import pytest
import torch

from conftest import GOLDEN
from disco_tpu_torch.buildg.pipeline import run_buildg
from disco_tpu_torch.index.table import FingerprintTable
from disco_tpu_torch.io.readstore import ReadStore
from disco_tpu_torch.utils.logging import RECORDER

try:
    from disco_tpu.index.table import FingerprintTable as RefTable
except ImportError:          # the reference package is not installed
    RefTable = None

torch.set_num_threads(1)

COLUMNS = ("keys", "read", "orient", "typ")
MIXED, MINI = GOLDEN / "mixed", GOLDEN / "mini"
_COMP = str.maketrans("ACGT", "TGCA")


def _rc(s: str) -> str:
    return s.translate(_COMP)[::-1]


def _random_store(k: int, seed: int, n: int = 3000) -> ReadStore:
    """n reads of lengths in [k, 250] under a permuted file index, with
    planted ends: k-mers shared across reads, forward and rc (ties that only
    the file index and the type break); at k > 32 k-mers that share their
    first 32 bases only (ties of the truncated key); at even k palindromes
    (their rc entries dropped); past 64 bases, ends whose key equals their
    rc's key while the k-mer is no palindrome (a read's two entries of one
    type tie, and only the sort's stability orders them)."""
    rng = np.random.default_rng(seed)

    def draw(m):
        return "".join(rng.choice(list("ACGT"), m))

    # "T" * k: at k >= 32 its key is the largest, the one a dropped
    # palindrome entry takes inside the torch route
    shared = [draw(k) for _ in range(40)] + ["T" * k]
    if k > 32:
        shared += [shared[i][:32] + draw(k - 32) for i in range(20)]
    ends = shared + [_rc(s) for s in shared]
    if k % 2 == 0:
        ends += [h + _rc(h) for h in (draw(k // 2) for _ in range(10))]
    if k > 64:
        ends += [h + draw(k - 64) + _rc(h) for h in (draw(32)
                                                      for _ in range(10))]
    seqs = []
    for _ in range(n):
        s = draw(int(rng.integers(k, 251)))
        if rng.random() < 0.3:
            s = ends[rng.integers(len(ends))] + s[k:]
        if rng.random() < 0.3:
            s = s[:len(s) - k] + ends[rng.integers(len(ends))]
        seqs.append(s)
    return ReadStore.from_sequences(
        seqs, file_index=rng.permutation(n).astype(np.int64) + 1)


def _mixed_store() -> ReadStore:
    return ReadStore.from_files(
        [str(MIXED / "p1.fasta"), str(MIXED / "p2.fasta")],
        [str(MIXED / "se.fasta")], 30)


CASES = [("mixed", 29)] + [("random", k) for k in (15, 16, 29, 32, 33, 40,
                                                    72)]


@pytest.mark.parametrize("store_name,k", CASES)
def test_device_route_matches_numpy(store_name, k):
    store = _mixed_store() if store_name == "mixed" else _random_store(k, k)
    want = FingerprintTable.build(store, k)
    got = FingerprintTable.build(store, k, device="cpu")
    assert got.k == want.k == k
    for f in COLUMNS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if store_name == "random":
        # the planted ends: shared keys, dropped palindromes at even k, and
        # past 64 bases ties within one read and type
        assert len(np.unique(want.keys)) < len(want.keys)
        assert (len(want.keys) < 4 * store.n_reads) == (k % 2 == 0)
        same = ((want.keys[1:] == want.keys[:-1])
                & (want.read[1:] == want.read[:-1])
                & (want.typ[1:] == want.typ[:-1]))
        assert same.any() == (k > 64)
    if RefTable is not None:
        ref = RefTable.build(store, k)
        for f in COLUMNS:
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("backend", ["device", "native"])
def test_run_buildg_takes_the_route_of_its_backend(backend, tmp_path):
    """buildg -backend device on mini (on the CPU): index.keys, .order and
    .pull once each, children of insertDataset, and index.entries the
    table's size; no card build on the CPU.  The native backend builds by
    the numpy route: no index.* span or counter."""
    with RECORDER.job():
        store, _, _ = run_buildg([str(MINI / "reads.fasta")], [],
                                 str(tmp_path / "g"), backend=backend,
                                 device="cpu")
    job = RECORDER.jobs()[-1]
    spans = RECORDER.spans(job["id"])
    (insert,) = [s for s in spans if s["name"] == "insertDataset"]
    index = [s for s in spans if s["name"].startswith("index.")]
    counters = {n: v for n, v in job["counters"].items()
                if n.startswith("index.")}
    if backend == "native":
        assert index == [] and counters == {}
        return
    assert [s["name"] for s in index] == ["index.keys", "index.order",
                                          "index.pull"]
    assert all(s["parent"] == insert["id"] for s in index)
    table = FingerprintTable.build(store, 29)
    assert counters == {"index.entries": len(table.keys)}
