"""The device relation at the size its users run (disco_tpu_torch.overlap):
the engine's chunk windows at global window offsets past 2^31, the
relation order against np.lexsort, the relation's r2 column past 2^23
reads, the host's work (codes, windows and sorts for re-run chunks only)
and the streamed relation's host memory, against disco_tpu and closed
formulas.
Tolerance: exact — every output is an integer or boolean array."""
import tracemalloc

import numpy as np
import pytest
import torch

from conftest import GOLDEN
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.relation import compute_relation as ref_relation
from disco_tpu.overlap.relation import window_codes as ref_window_codes
from disco_tpu_torch.convert import state_from_reference
from disco_tpu_torch.overlap import device as port_device
from disco_tpu_torch.overlap import relation as port
from test_torch_native import private_native  # noqa: F401

torch.set_num_threads(1)

FIELDS = ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok")
N_BIG, LEN_BIG, K = 10_000_000, 250, 29   # the 100 Mb / 25x / 250 bp set


@pytest.fixture(scope="module")
def mini():
    store = ReadStore.from_files([str(GOLDEN / "mini" / "reads.fasta")], [],
                                 30, reference_task_order=False)
    table = FingerprintTable.build(store, K)
    return store, table


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 600))
    store = ReadStore.from_sequences(
        [genome[s:s + 100] for s in rng.integers(0, 500, 300)])
    return store, FingerprintTable.build(store, K)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---- the engine's chunk windows ------------------------------------------
@pytest.mark.parametrize("where", ["below", "above", "across", "last"])
def test_chunk_windows_past_2_31(where):
    """(read, j) of a chunk of 2^20 windows of 10M reads of 250 bp (2.21e9
    windows), one chunk either side of 2^31, one across it and the last,
    equal the closed formula read = g // 221, j = g % 221, in int64."""
    woff = port_device.window_offsets(np.full(N_BIG, LEN_BIG, np.int32), K)
    n_win = LEN_BIG - K
    assert woff[-1] == N_BIG * n_win > 1 << 31
    chunk = 1 << 20
    s = {"below": (1 << 31) - chunk, "above": 1 << 31,
         "across": (1 << 31) - 777, "last": int(woff[-1]) - 1000}[where]
    e = min(s + chunk, int(woff[-1]))
    read, j = port_device.chunk_windows(woff, s, e)
    g = np.arange(s, e, dtype=np.int64)
    assert read.dtype == j.dtype == np.int64
    np.testing.assert_array_equal(read, g // n_win)
    np.testing.assert_array_equal(j, g % n_win)
    starts = read * LEN_BIG + j
    assert (np.diff(starts) > 0).all()


@pytest.mark.parametrize("where", ["below", "across", "last"])
def test_window_starts_at_past_2_31(where):
    """The window ids the rows step makes on the device
    (`window_starts_at`), over the same 10M reads, equal read * 250 + j of
    `chunk_windows`, and past the last window repeat it."""
    woff = port_device.window_offsets(np.full(N_BIG, LEN_BIG, np.int32), K)
    q, chunk = int(woff[-1]), 1 << 20
    s = {"below": (1 << 31) - chunk, "across": (1 << 31) - 777,
         "last": q - 1000}[where]
    e = min(s + chunk, q)
    got = port_device.window_starts_at(torch.from_numpy(woff), s, q, chunk,
                                       LEN_BIG).numpy()
    read, j = port_device.chunk_windows(woff, s, e)
    assert got.dtype == np.int64 and len(got) == chunk
    np.testing.assert_array_equal(got[:e - s], read * LEN_BIG + j)
    assert (got[e - s:] == got[e - s - 1]).all()


@pytest.mark.parametrize("chunk", [1, 97, 4096])
def test_chunk_windows_cover_every_window_in_order(chunk):
    """Over reads of mixed lengths, the chunks of any size, joined, are
    every (read, j) of disco_tpu's window_codes, in its order."""
    rng = np.random.default_rng(chunk)
    lens = rng.integers(K + 1, 300, 500).astype(np.int32)
    woff = port_device.window_offsets(lens, K)
    got = [port_device.chunk_windows(woff, s, min(s + chunk, int(woff[-1])))
           for s in range(0, int(woff[-1]), chunk)]
    want_read = np.repeat(np.arange(len(lens)), lens - K)
    want_j = np.concatenate([np.arange(n) for n in lens - K])
    np.testing.assert_array_equal(np.concatenate([r for r, _ in got]),
                                  want_read)
    np.testing.assert_array_equal(np.concatenate([j for _, j in got]), want_j)
    with pytest.raises(ValueError, match="shorter than min overlap"):
        port_device.window_offsets(np.array([K + 5, K], np.int32), K)


# ---- the relation order ---------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relation_order_is_lexsort(seed):
    """relation_order's permutation is np.lexsort((typ, fidx2, j, r1))'s,
    ties included: rows drawn from few reads, windows and candidates (many
    equal keys), device rows in window order and re-run rows appended out
    of order, at global window indices past 2^31."""
    rng = np.random.default_rng(seed)
    n_reads = N_BIG
    woff = port_device.window_offsets(np.full(n_reads, LEN_BIG, np.int32), K)
    fidx = rng.permutation(n_reads)
    reads = np.concatenate([rng.integers(0, 50, 10),
                            rng.integers(n_reads - 50, n_reads, 10)])
    n = 20_000
    r1 = np.sort(rng.choice(reads, n))
    j = rng.integers(0, 6, n)
    r2 = rng.choice(rng.integers(0, n_reads, 40), n)
    typ = rng.integers(0, 2, n)
    dev = np.lexsort((typ, fidx[r2], j, r1))      # window order, then slot
    tail = rng.permutation(n // 4)                 # re-run rows, scrambled
    rows = [np.concatenate([x[dev], x[tail]]) for x in (r1, j, r2, typ)]
    r1, j, r2, typ = rows
    assert woff[r1].max() > 1 << 31
    got = port.relation_order(woff[r1] + j, fidx[r2], typ)
    np.testing.assert_array_equal(got,
                                  np.lexsort((typ, fidx[r2], j, r1)))
    # rows already in order keep their order
    in_order = got[:n // 2]
    np.testing.assert_array_equal(
        port.relation_order(woff[r1[in_order]] + j[in_order],
                            fidx[r2[in_order]], typ[in_order]),
        np.arange(len(in_order)))


# ---- the r2 column past 2^23 reads -----------------------------------------
@pytest.mark.parametrize("top", [(1 << 23) - 1, 1 << 23, N_BIG,
                                 (1 << 28) - 1])
def test_read_ids_past_2_23_reach_the_r2_column_exact(mini, monkeypatch,
                                                      top):
    """Read ids at 2^23 - 1, 2^23 and beyond (the 10M-read set, and the
    engine's limit of 2^28 reads) reach the relation's r2 column exact: the
    rows step's r2 column on mini, shifted so that its largest id is `top`,
    comes back unchanged through the segments kept on the device and the
    pull, in chunks of 1000 windows (many segments)."""
    store, table = mini
    want = ref_relation(store, table, backend="native")
    st, tb = state_from_reference(store, table)
    shift = top - int(want.r2.max())
    real = port_device.DeviceOverlapEngine.dense_row_chunks

    def shifted(self, woff, chunk, cand_cap, keep):
        def keep_shifted(rows, meta):
            return keep((*rows[:2], rows[2] + shift, *rows[3:]), meta)
        return real(self, woff, chunk, cand_cap, keep_shifted)

    monkeypatch.setattr(port_device.DeviceOverlapEngine, "dense_row_chunks",
                        shifted)
    got = port._device_relation(st, tb, device="cpu", chunk=1000)
    assert got.r2.dtype == np.int32 and int(got.r2.max()) == top
    np.testing.assert_array_equal(got.r2.astype(np.int64) - shift, want.r2)
    for f in FIELDS:
        if f != "r2":
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# ---- the host's work: codes for re-run windows only, no per-window array --
def test_window_codes_at_equals_window_codes(mini):
    store, table = mini
    qread, qj, qcode = ref_window_codes(store, table.k)
    pick = np.random.default_rng(4).choice(len(qread), 5000, replace=False)
    st, _ = state_from_reference(store, table)
    got = port.window_codes_at(st, qread[pick].astype(np.int64),
                               qj[pick].astype(np.int64), table.k)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, qcode[pick])


def test_codes_only_for_rerun_chunks(mini, dense, monkeypatch):
    """With re-runs forced over several chunks, the host makes window codes
    and the windows' (read, j) for those chunks' windows alone, a chunk at
    a time, and never for the whole set; with none re-run, on mini, it
    makes neither; the relations equal disco_tpu's."""
    sizes, windows = [], []
    real, real_windows = port.window_codes_at, port_device.chunk_windows

    def codes_at(store, qread, qj, k):
        sizes.append(len(qread))
        return real(store, qread, qj, k)

    def chunk_windows(woff, s, e):
        windows.append(e - s)
        return real_windows(woff, s, e)

    def whole_set(*a, **kw):
        raise AssertionError("window_codes over the whole set")

    monkeypatch.setattr(port, "window_codes", whole_set)
    monkeypatch.setattr(port, "window_codes_at", codes_at)
    monkeypatch.setattr(port_device, "chunk_windows", chunk_windows)
    store, table = mini
    got = port._device_relation(*state_from_reference(store, table),
                                device="cpu", chunk=1000)
    _assert_equal(got, ref_relation(store, table, backend="native"))
    assert got.stats["fallback_chunks"] == 0 and sizes == windows == []

    store, table = dense
    want = ref_relation(store, table, backend="native")
    st, tb = state_from_reference(store, table)
    chunk = 100
    got = port._device_relation(st, tb, device="cpu", chunk=chunk,
                                cand_factor=1)
    _assert_equal(got, want)
    fb = got.stats["fallback_chunks"]
    n_win = int(store.lengths.sum()) - store.n_reads * table.k
    assert 1 < fb < got.stats["chunks"] and len(sizes) == fb
    assert windows == sizes
    assert all(0 < s <= chunk for s in sizes) and sum(sizes) < n_win


def test_relation_order_only_for_rerun_or_flagged_chunks(mini, dense,
                                                         monkeypatch):
    """The host sorts rows (`relation_order`) only of a chunk it re-ran or
    that the device found out of order: never on mini, where none is
    either, and once a re-run chunk on the dense set with re-runs forced."""
    calls = []
    real = port.relation_order

    def relation_order(w, fidx2, typ):
        calls.append(len(w))
        return real(w, fidx2, typ)

    monkeypatch.setattr(port, "relation_order", relation_order)
    for (store, table), kw in ((mini, dict(chunk=1000)),
                               (dense, dict(chunk=100, cand_factor=1))):
        calls.clear()
        got = port._device_relation(*state_from_reference(store, table),
                                    device="cpu", **kw)
        _assert_equal(got, ref_relation(store, table, backend="native"))
        assert got.stats["reordered_chunks"] == 0
        assert len(calls) == got.stats["fallback_chunks"]
    assert calls


def test_no_host_array_a_window():
    """Over 4000 reads of 250 bp (884,000 windows) in chunks of 4096, the
    relation's numpy allocations peak below 2 B a window: no host array of
    one int16 or wider entry a window of the whole set exists at any time
    (the whole-set window codes alone take some 85 B a window at their
    peak)."""
    rng = np.random.default_rng(7)
    store = ReadStore.from_sequences(
        ["".join(rng.choice(list("ACGT"), LEN_BIG)) for _ in range(4000)])
    table = FingerprintTable.build(store, K)
    want = ref_relation(store, table, backend="native")
    st, tb = state_from_reference(store, table)
    n_win = int(store.lengths.sum()) - store.n_reads * table.k
    tracemalloc.start()
    try:
        got = port._device_relation(st, tb, device="cpu", chunk=1 << 12)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    _assert_equal(got, want)
    assert got.stats["chunks"] == -(-n_win // (1 << 12))
    assert peak < 2 * n_win, (peak, n_win)
