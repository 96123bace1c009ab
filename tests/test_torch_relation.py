"""The port's overlap relation (disco_tpu_torch.overlap.relation) against
disco_tpu's native relation on golden `mini`: the device backend in the
cases of tests/test_device_backend.py, the K1 route, the exact expansion
backend, and the native backend.  Tolerance: exact — every column equal.

`mini` never exceeds the device caps (at most 16 candidates in any 32
windows), so the cap-overflow cases run on a synthetic high-coverage set
(300 reads of 100 bp from a 600 bp genome) where most chunks overflow."""
import numpy as np
import pytest
import torch

from conftest import GOLDEN
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.relation import compute_relation as ref_relation
from disco_tpu_torch.convert import state_from_reference
from disco_tpu_torch.overlap import relation as port
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
    "wire32_escapes": dict(chunk=1 << 14, rbits=24),
    "wire64": dict(chunk=1 << 14, wire64=True),
    "k1_route": dict(chunk=1 << 14, fetch=False),
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_device_relation_matches_native(mini, dense, case):
    overflow = case.endswith("_overflow")
    (store, table), want = dense if overflow else mini
    got = port._device_relation(store, table, device="cpu",
                                **DEVICE_CASES[case])
    _assert_equal(got, want)
    fallback = got.stats["fallback_chunks"]
    if overflow:
        # some chunks were re-run exactly, not all
        assert 0 < fallback < got.stats["chunks"]
    else:
        assert fallback == 0


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
