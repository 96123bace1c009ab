"""The port's overlap relation (disco_tpu_torch.overlap.relation) against
disco_tpu's native relation on golden `mini`: the device backend in the
cases of tests/test_device_backend.py, the K1 route, the exact expansion
backend, and the native backend.  Tolerance: exact — every column equal.

`mini` never exceeds the device caps (at most 16 candidates in any 32
windows), so the cap-overflow cases run on a synthetic high-coverage set
(300 reads of 100 bp from a 600 bp genome) where most chunks overflow, and
the sparse cases on a set of 300 reads of 100 bp from a 200 kb genome,
where hits lie up to some 1,500 windows apart and most chunks keep no row."""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import GOLDEN
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.relation import compute_relation as ref_relation
from disco_tpu_torch.convert import state_from_reference
from disco_tpu_torch.overlap import relation as port
from disco_tpu_torch.utils.logging import RECORDER
from test_torch_native import private_native  # noqa: F401

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)

FIELDS = ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok")


@pytest.fixture(scope="module")
def mini():
    store = ReadStore.from_files([str(GOLDEN / "mini" / "reads.fasta")], [],
                                 30, reference_task_order=False)
    table = FingerprintTable.build(store, 29)
    want = ref_relation(store, table, backend="native")
    return state_from_reference(store, table), want


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 600))
    store = ReadStore.from_sequences(
        [genome[s:s + 100] for s in rng.integers(0, 500, 300)])
    table = FingerprintTable.build(store, 29)
    want = ref_relation(store, table, backend="native")
    return state_from_reference(store, table), want


@pytest.fixture(scope="module")
def sparse():
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), 200_000))
    store = ReadStore.from_sequences(
        [genome[s:s + 100] for s in rng.integers(0, 199_900, 300)])
    table = FingerprintTable.build(store, 29)
    want = ref_relation(store, table, backend="native")
    return state_from_reference(store, table), want


def _assert_equal(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# the cases of tests/test_device_backend.py (its cap-overflow case split
# into candidate and hit overflow), plus the K1 route
DEVICE_CASES = {
    "default": dict(chunk=1 << 14),
    "cand_cap_overflow": dict(chunk=64, cand_factor=1),
    "hit_cap_overflow": dict(chunk=64, cand_factor=4),
    "small_chunks": dict(chunk=256),
    # hits up to 1,474 windows apart: chunks with no row between chunks
    # with rows, in one segment and over many
    "sparse_hits": dict(chunk=1 << 14),
    "sparse_small_chunks": dict(chunk=100),
    "k1_route": dict(chunk=1 << 14, fetch=False),
    # the relation streamed by chunk: chunks that do not divide the window
    # count, a short last chunk padded on the device, and re-runs spread
    # over several chunks of odd sizes, between chunks kept on the device
    "odd_chunks": dict(chunk=1000),
    "odd_chunks_prime": dict(chunk=997),
    "odd_chunks_cand_overflow": dict(chunk=97, cand_factor=1),
    "odd_chunks_hit_overflow": dict(chunk=100, cand_factor=4),
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_device_relation_matches_native(mini, dense, sparse, case):
    overflow = case.endswith("_overflow")
    (store, table), want = (dense if overflow else
                            sparse if case.startswith("sparse") else mini)
    got = port._device_relation(store, table, device="cpu",
                                **DEVICE_CASES[case])
    _assert_equal(got, want)
    fallback = got.stats["fallback_chunks"]
    if overflow:
        # some chunks were re-run exactly, not all
        assert 0 < fallback < got.stats["chunks"]
    else:
        assert fallback == 0
    assert got.stats["reordered_chunks"] == 0


def test_fractional_cand_factor_forces_reruns_on_mini(mini):
    """`mini` never fills cand_cap = chunk (under one candidate a window):
    a cand_factor below 1 forces exact re-runs of some chunks, as
    chip_smoke.py's forced overflow does on the goldens."""
    (store, table), want = mini
    got = port._device_relation(store, table, device="cpu", chunk=1 << 12,
                                cand_factor=1 / 6)
    _assert_equal(got, want)
    assert 0 < got.stats["fallback_chunks"] < got.stats["chunks"]


@pytest.mark.parametrize("backend", ["native", "xla"])
def test_compute_relation_backends(mini, backend):
    (store, table), want = mini
    _assert_equal(port.compute_relation(store, table, backend=backend,
                                        device="cpu"), want)


def test_default_backend_env(monkeypatch):
    monkeypatch.setenv(port.BACKEND_ENV, "xla")
    assert port.default_backend() == "xla"
    monkeypatch.delenv(port.BACKEND_ENV)
    want = "device" if torch.cuda.is_available() else "native"
    assert port.default_backend() == want


def test_device_backends_need_a_card(mini, monkeypatch):
    """With no device named, the device and xla backends take the CUDA
    card; without one they raise instead of running the plain versions on
    the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (store, table), _ = mini
    for backend in ("device", "xla"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            port.compute_relation(store, table, backend=backend)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port._device_relation(store, table)


def _counters(fn):
    """fn() run as one job of the recorder: (its result, its counters)."""
    with RECORDER.job():
        got = fn()
    return got, RECORDER.jobs()[-1]["counters"]


def test_rows_counter_is_the_relation_when_nothing_reruns(mini):
    """relation.rows counts the rows kept on the device: all of the
    relation when no chunk is re-run, fewer when some are;
    relation.reordered reads 0 on a table as built."""
    (store, table), want = mini
    for kw, rerun in ((dict(chunk=1000), False),
                      (dict(chunk=1 << 12, cand_factor=1 / 6), True)):
        got, c = _counters(lambda: port._device_relation(
            store, table, device="cpu", **kw))
        _assert_equal(got, want)
        assert (got.stats["fallback_chunks"] > 0) == rerun
        assert c["relation.reordered"] == 0
        if rerun:
            assert 0 < c["relation.rows"] < len(got)
        else:
            assert c["relation.rows"] == len(got)


def test_bucket_out_of_order_is_sorted_on_the_host():
    """A table with two neighbours of one bucket swapped, so that the
    bucket is no longer in (file index, type) order, makes the one chunk
    whose windows keep both keep rows out of the relation's order: the
    device flags that chunk (relation.reordered 1), the host sorts it, and
    the relation still equals native's on the table as built.  The reads
    (400 of 100 bp, 2x over 20 kb) lie in the genome's order, so that the
    windows that keep two given entries lie near each other."""
    rng = np.random.default_rng(6)
    genome = "".join(rng.choice(list("ACGT"), 20_000))
    ref_store = ReadStore.from_sequences(
        [genome[s:s + 100] for s in np.sort(rng.integers(0, 19_900, 400))])
    ref_table = FingerprintTable.build(ref_store, 29)
    want = ref_relation(ref_store, ref_table, backend="native")
    store, table = state_from_reference(ref_store, ref_table)
    chunk = 1 << 12
    woff = np.concatenate([[0], np.cumsum(store.lengths.astype(np.int64)
                                          - table.k)])
    w = woff[want.r1] + want.j
    code = port.window_codes_at(store, want.r1.astype(np.int64),
                                want.j.astype(np.int64), table.k)
    # each row's table entry: its bucket's first entry plus its rank there
    lo, hi = table.lookup_ranges(code)
    pos = np.full(len(w), -1)
    for i in range(len(w)):
        b = np.flatnonzero((table.read[lo[i]:hi[i]] == want.r2[i])
                           & (table.orient[lo[i]:hi[i]] == want.orient[i])
                           & (table.typ[lo[i]:hi[i]] == want.typ[i]))
        pos[i] = lo[i] + b[0]
    # neighbouring entries kept together, by the chunks of their windows
    both = np.flatnonzero((w[1:] == w[:-1]) & (pos[1:] == pos[:-1] + 1))
    chunks = {}
    for i in both:
        chunks.setdefault(pos[i], set()).add(w[i] // chunk)
    p = min(q for q, c in chunks.items() if len(c) == 1)
    flip = np.arange(len(table.keys))
    flip[[p, p + 1]] = p + 1, p
    permuted = dataclasses.replace(table, read=table.read[flip],
                                   orient=table.orient[flip],
                                   typ=table.typ[flip])
    got, c = _counters(lambda: port._device_relation(
        store, permuted, device="cpu", chunk=chunk))
    assert c["relation.reordered"] == 1
    assert got.stats["reordered_chunks"] == 1
    assert got.stats["fallback_chunks"] == 0
    assert c["relation.rows"] == len(got)
    _assert_equal(got, want)
