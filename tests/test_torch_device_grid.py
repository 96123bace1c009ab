"""The port's hit-cap grid engine (disco_tpu_torch.overlap.device:
device_overlap, device_overlap_compact, device_overlap_packed and the
engine's run, run_compact, run_packed, run_chunked, run_packed_chunked)
against disco_tpu's on the CPU: golden `mini` and a seeded dense read set
(300 reads of 100 bp from a 600 bp genome, buckets of up to 8 entries), the
same state on both sides (state_from_reference).  disco_tpu's functions run
as its own tests run them on the CPU (the XLA check); the port's take
device="cpu", where K1's rows route runs as its plain version.
Tolerance: exact — every output is an integer or boolean array."""
import numpy as np
import pytest
import torch

from conftest import GOLDEN
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap import device as ref
from disco_tpu.overlap.relation import compute_relation as ref_relation
from disco_tpu.overlap.relation import window_codes
from disco_tpu_torch.convert import state_from_reference
from disco_tpu_torch.overlap import device as port
from disco_tpu_torch.overlap.relation import compute_relation
from test_torch_native import private_native  # noqa: F401

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)


def _state(store):
    """(store, table, window starts, bucket size a window, the windows with
    a containment hit)."""
    table = FingerprintTable.build(store, 29)
    qread, qj, qcode = window_codes(store, table.k)
    lo, hi = table.lookup_ranges(qcode)
    starts = qread.astype(np.int64) * store.max_len + qj
    rel = ref_relation(store, table, backend="native")
    cont = rel.r1[rel.cont_ok].astype(np.int64) * store.max_len \
        + rel.j[rel.cont_ok]
    return (store, table, starts, (hi - lo).astype(np.int64),
            np.searchsorted(starts, cont))


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 600))
    dense = ReadStore.from_sequences(
        [genome[s:s + 100] for s in rng.integers(0, 500, 300)])
    return {"mini": _state(ReadStore.from_files(
                [str(GOLDEN / "mini" / "reads.fasta")], [], 30,
                reference_task_order=False)),
            "dense": _state(dense)}


def _engines(store, table, hit_cap):
    return (ref.DeviceOverlapEngine(store, table, hit_cap=hit_cap),
            port.DeviceOverlapEngine(*state_from_reference(store, table),
                                     hit_cap=hit_cap, device="cpu"))


def _pick(starts, buckets, cont, hit_cap, n=3000, seed=1):
    """n windows drawn in order, with up to 64 windows whose bucket
    overflows hit_cap and 64 with a containment hit among them."""
    rng = np.random.default_rng(seed)
    idx = np.union1d(rng.choice(len(starts), n, replace=False),
                     np.flatnonzero(buckets > hit_cap)[:64])
    return starts[np.union1d(idx, cont[:64])]


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _assert_fields(got, want):
    assert got._fields == want._fields
    for f, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.bool_): torch.bool,
                           np.dtype(np.int32): torch.int32,
                           np.dtype(np.int64): torch.int64}[w.dtype], f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


@pytest.mark.parametrize("case", ["mini", "dense"])
@pytest.mark.parametrize("hit_cap", [32, 2])
def test_device_overlap_matches_reference(sets, case, hit_cap):
    store, table, starts, buckets, cont = sets[case]
    part = _pick(starts, buckets, cont, hit_cap)
    ref_eng, port_eng = _engines(store, table, hit_cap)
    got, want = port_eng.run(part), ref_eng.run(part)
    _assert_fields(got, want)
    assert int(got.overflow) == int((buckets[np.searchsorted(
        starts, part)] > hit_cap).sum())
    if hit_cap == 2:
        # overflowing windows keep their first hit_cap slots valid
        assert int(got.overflow) > 0
    assert got.edge_ok.any() and got.cont_ok.any()


@pytest.mark.parametrize("case", ["mini", "dense"])
@pytest.mark.parametrize("room", ["above", "below"])
def test_compact_matches_reference(sets, case, room):
    store, table, starts, buckets, cont = sets[case]
    part = _pick(starts, buckets, cont, 2)
    ref_eng, port_eng = _engines(store, table, 2)
    count = int(port_eng.run_compact(part, len(part)).count)
    out_cap = count + 100 if room == "above" else count // 2
    got = port_eng.run_compact(part, out_cap)
    _assert_fields(got, ref_eng.run_compact(part, out_cap))
    assert int(got.count) == count and got.over.any()
    if room == "below":
        assert count > out_cap      # the rows past out_cap were dropped
    else:
        assert not got.r2[count:].any()


def test_packed_matches_reference_with_bit_31(sets):
    """Q not a multiple of 32, overflowing windows in lane 31 of the first
    two words: data and meta equal as uint32, bit 31 set."""
    store, table, starts, buckets, _ = sets["mini"]
    ref_eng, port_eng = _engines(store, table, 2)
    over = starts[buckets > 2]
    part = starts[:101].copy()
    part[31], part[63] = over[0], over[1]
    got, want = port_eng.run_packed(part, 512), ref_eng.run_packed(part, 512)
    assert got[0].dtype == got[1].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u32(g), _u32(w))
    meta = _u32(got[1])
    assert len(meta) == 1 + 4
    assert meta[1] >> 31 == 1 and meta[2] >> 31 == 1
    assert meta[1] & 0x7FFFFFFF == 0 and meta[2] & 0x7FFFFFFF == 0


def test_packed_refuses_more_than_2_21_windows(sets):
    store, table, starts, *_ = sets["mini"]
    eng = port.DeviceOverlapEngine(*state_from_reference(store, table),
                                   device="cpu")
    with pytest.raises(ValueError, match="2\\^21"):
        eng.run_packed(np.resize(starts, (1 << 21) + 1), 16)


@pytest.mark.parametrize("case", ["mini", "dense"])
def test_chunked_runs_match_reference(sets, case):
    """run_chunked and run_packed_chunked at a chunk that does not divide
    the window count: the same n_real and arrays, chunk by chunk."""
    store, table, starts, *_ = sets[case]
    part = starts[:5000]
    chunk = 1536
    ref_eng, port_eng = _engines(store, table, 4)
    n = 0
    for (n1, w), (n2, g) in zip(ref_eng.run_chunked(part, chunk=chunk),
                                port_eng.run_chunked(part, chunk=chunk),
                                strict=True):
        assert n1 == n2
        _assert_fields(g, w)
        n += 1
    assert n == 4 and port_eng.stats["chunks"] == 4
    for want, got in zip(
            ref_eng.run_packed_chunked(part, chunk=chunk, out_cap=1024),
            port_eng.run_packed_chunked(part, chunk=chunk, out_cap=1024),
            strict=True):
        assert want[0] == got[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_u32(g), _u32(w))


def _decode(chunks):
    """The packed rows of every chunk as relation rows of the windows that
    did not overflow, plus the overflowing windows' global indices."""
    rows, over = [], []
    s = 0
    for n_real, data, meta in chunks:
        meta = _u32(meta)
        count = int(meta[0])
        assert count <= data.shape[1]
        bits = np.unpackbits(meta[1:].astype("<u4").view(np.uint8),
                             bitorder="little")[:n_real]
        over.append(s + np.flatnonzero(bits))
        w0, r2 = (x.numpy()[:count] for x in data)
        wi = w0 & 0x1FFFFF
        sel = wi < n_real
        rows.append(np.stack([s + wi, r2, (w0 >> 21) & 3, (w0 >> 23) & 1,
                              (w0 >> 24) & 3])[:, sel])
        s += n_real
    return np.concatenate(rows, 1), np.concatenate(over)


@pytest.mark.parametrize("case", ["mini", "dense"])
def test_packed_rows_equal_the_dense_relation(sets, case):
    """The packed rows, decoded, of the windows that do not overflow
    (hit_cap 2) equal the port's dense-path relation on those windows."""
    store, table, starts, buckets, _ = sets[case]
    pstore, ptable = state_from_reference(store, table)
    eng = port.DeviceOverlapEngine(pstore, ptable, hit_cap=2, device="cpu")
    rows, over = _decode(eng.run_packed_chunked(starts, chunk=1 << 14))
    np.testing.assert_array_equal(over, np.flatnonzero(buckets > 2))
    rel = compute_relation(pstore, ptable, backend="device", device="cpu")
    n_win = pstore.lengths.astype(np.int64) - ptable.k
    gw = (np.concatenate([[0], np.cumsum(n_win)])[rel.r1] + rel.j)
    keep = ~np.isin(gw, over)
    flags = rel.edge_ok.astype(np.int64) | (rel.cont_ok.astype(np.int64) << 1)
    want = np.stack([gw, rel.r2, rel.orient, rel.typ, flags])[:, keep]
    fidx = pstore.file_index
    order = lambda r: np.lexsort((r[3], fidx[r[1]], r[0]))   # noqa: E731
    np.testing.assert_array_equal(rows[:, order(rows)], want[:, order(want)])
    assert len(over) > 0 and keep.sum() < len(keep)
