"""The port's dense device steps (disco_tpu_torch.overlap.device) against
disco_tpu's on golden `mini`: the same store and table (handed over by
state_from_reference), the same window chunks, identical wire arrays.
Tolerance: exact — every output is an integer array."""
import numpy as np
import pytest
import torch

from conftest import GOLDEN
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap import device as ref
from disco_tpu.overlap.relation import window_codes
from disco_tpu_torch.convert import state_from_reference
from disco_tpu_torch.overlap import device as port
from test_torch_native import private_native  # noqa: F401

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mini():
    store = ReadStore.from_files([str(GOLDEN / "mini" / "reads.fasta")], [],
                                 30, reference_task_order=False)
    table = FingerprintTable.build(store, 29)
    qread, qj, _ = window_codes(store, table.k)
    starts = qread.astype(np.int64) * store.max_len + qj
    return store, table, starts


def _engines(store, table):
    return (ref.DeviceOverlapEngine(store, table),
            port.DeviceOverlapEngine(*state_from_reference(store, table),
                                     device="cpu"))


def _u(x):
    return np.asarray(x).astype(np.int64)


def _windows(starts, chunk):
    """All of mini's windows at chunk 2^14; at chunk 256 the first 40,000
    (157 chunks, the last one padded) keep the run short."""
    return starts if chunk >= 1 << 14 else starts[:40_000]


@pytest.mark.parametrize("chunk,rbits", [(1 << 14, None), (256, None),
                                         (1 << 14, 24)])
def test_dense32_matches_reference(mini, chunk, rbits):
    store, table, starts = mini
    starts = _windows(starts, chunk)
    ref_eng, port_eng = _engines(store, table)
    want_rbits = rbits or max(int(store.n_reads).bit_length() + 1, 8)
    n_chunks = 0
    escapes = 0
    for want, got in zip(
            ref_eng.run_dense32_chunked(starts, chunk=chunk,
                                        rbits=want_rbits),
            port_eng.run_dense32_chunked(starts, chunk=chunk, rbits=rbits),
            strict=True):
        assert want[0] == got[0]
        for name, w, g in zip(("word", "esc", "meta"), want[1:], got[1:]):
            np.testing.assert_array_equal(_u(g), _u(w), err_msg=name)
        escapes += int(_u(got[3])[2])
        n_chunks += 1
    assert n_chunks == -(-len(starts) // chunk)
    assert port_eng.stats["chunks"] == n_chunks
    if rbits == 24:
        assert escapes > 0   # the 4-bit delta field forces escapes


@pytest.mark.parametrize("chunk", [1 << 14, 256])
def test_dense_matches_reference(mini, chunk):
    store, table, starts = mini
    starts = _windows(starts, chunk)
    ref_eng, port_eng = _engines(store, table)
    for want, got in zip(ref_eng.run_dense_chunked(starts, chunk=chunk),
                         port_eng.run_dense_chunked(starts, chunk=chunk),
                         strict=True):
        assert want[0] == got[0]
        for name, w, g in zip(("data", "meta"), want[1:], got[1:]):
            np.testing.assert_array_equal(_u(g), _u(w), err_msg=name)


def test_k1_route_and_window_starts(mini):
    """The K1 route (engine without the fetch table) gives the same wire
    rows as the K2 route; window_starts matches the reference."""
    store, table, starts = mini
    ref_eng, port_eng = _engines(store, table)
    np.testing.assert_array_equal(port_eng.window_starts(),
                                  ref_eng.window_starts())
    k1_eng = port.DeviceOverlapEngine(*state_from_reference(store, table),
                                      device="cpu", fetch=False)
    assert k1_eng.packed_table is None and port_eng.packed_table is not None
    part = starts[: 1 << 13]
    for w, g in zip(port_eng.run_dense32(part, 1 << 15, 1 << 13, 12),
                    k1_eng.run_dense32(part, 1 << 15, 1 << 13, 12)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_flipped_keys_keep_unsigned_order():
    keys = np.array([0, 1, 2**62, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)
    flipped = port.flip_keys(keys)
    assert (np.diff(flipped) > 0).all()


def test_engine_needs_a_card_unless_told_cpu(mini, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store, table, _ = mini
    state = state_from_reference(store, table)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port.DeviceOverlapEngine(*state)
    assert port.DeviceOverlapEngine(*state, device="cpu").device.type == "cpu"
