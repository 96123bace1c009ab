"""The port's rows step (disco_tpu_torch.overlap.device:
device_overlap_rows, run over the store by DeviceOverlapEngine's
dense_row_chunks on the windows of window_starts_at) against disco_tpu's
dense step on the CPU: golden `mini` and a seeded dense read set (300 reads
of 100 bp from a 600 bp genome, buckets of up to 8 entries), the same store
and table on both sides (state_from_reference).  disco_tpu's
DeviceOverlapEngine.run_dense_chunked is the reference: its 8-byte wire
rows, decoded, over the same windows.  The port's checks run on the CPU as
their plain versions.
Tolerance: exact — every output is an integer or boolean array."""
import dataclasses
import weakref

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
from test_torch_native import private_native  # noqa: F401

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)

CASES = ("mini", "dense")
CHUNKS = (1 << 14, 1000, 256)
FIRST = 40_000    # the windows run below chunk 2^14


@dataclasses.dataclass
class _Set:
    store: object       # disco_tpu's ReadStore
    table: object       # disco_tpu's FingerprintTable
    starts: np.ndarray  # disco_tpu's window ids, read * max_len + j
    pstore: object      # the port's copies (state_from_reference)
    ptable: object
    hit: np.ndarray     # the windows with a hit, by global index
    wire: dict = dataclasses.field(default_factory=dict)   # reference runs


def _set(store):
    table = FingerprintTable.build(store, 29)
    qread, qj, _ = window_codes(store, table.k)
    starts = qread.astype(np.int64) * store.max_len + qj
    rel = ref_relation(store, table, backend="native")
    hit = np.searchsorted(starts, rel.r1.astype(np.int64) * store.max_len
                          + rel.j)
    return _Set(store, table, starts, *state_from_reference(store, table),
                np.unique(hit))


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 600))
    dense = ReadStore.from_sequences(
        [genome[s:s + 100] for s in rng.integers(0, 500, 300)])
    return {"mini": _set(ReadStore.from_files(
                [str(GOLDEN / "mini" / "reads.fasta")], [], 30,
                reference_task_order=False)),
            "dense": _set(dense)}


def _woff(st, n=None):
    """The port's window offsets of the set, cut to its first n windows
    (the offsets of the reads they touch, then n)."""
    woff = port.window_offsets(st.pstore.lengths, st.ptable.k)
    if n is None or n >= woff[-1]:
        return woff
    return np.append(woff[woff < n], n)


def _engine(st, fetch=True):
    return port.DeviceOverlapEngine(st.pstore, st.ptable, device="cpu",
                                    fetch=fetch)


def _reference(st, n, chunk, cand_cap, out_cap):
    """disco_tpu's dense step over the set's first n windows: per chunk
    (n_real, its wire rows of the chunk's real windows decoded to (r1, j,
    r2, orient, typ, cont_ok, edge_ok), meta [n_hits, n_cand] as int64),
    kept on the set for the cases that share them."""
    key = (n, chunk, cand_cap, out_cap)
    if key not in st.wire:
        starts = st.starts[:n]
        eng = ref.DeviceOverlapEngine(st.store, st.table)
        out = []
        for i, (n_real, data, meta) in enumerate(eng.run_dense_chunked(
                starts, chunk=chunk, cand_cap=cand_cap, out_cap=out_cap)):
            meta = np.asarray(meta).astype(np.int64)
            w0, r2 = np.asarray(data).astype(np.int64)[:, :min(
                int(meta[0]), out_cap)]
            sel = (w0 & 0x1FFFFF) < n_real
            w0, r2 = w0[sel], r2[sel]
            w = starts[i * chunk + (w0 & 0x1FFFFF)]
            out.append((n_real, (
                w // st.store.max_len, w % st.store.max_len, r2,
                (w0 >> 21) & 3, (w0 >> 23) & 1, (w0 >> 25) & 1 == 1,
                (w0 >> 24) & 1 == 1), meta))
        st.wire[key] = out
    return st.wire[key]


def _rows_steps(eng, woff, chunk, cand_cap, out_cap):
    """device_overlap_rows a chunk over the windows of `woff`, called
    directly (any out_cap): per chunk (n_real, rows, meta)."""
    q = int(woff[-1])
    dwoff = torch.from_numpy(woff)
    fidx = torch.from_numpy(eng.store.file_index)
    for s in range(0, q, chunk):
        starts = port.window_starts_at(dwoff, s, q, chunk, eng.store.max_len)
        rows, meta = port.device_overlap_rows(
            eng.packed, eng.packed_all, eng.lengths, starts, eng.tmeta,
            eng.keys, fidx, k=eng.k, max_len=eng.store.max_len,
            cand_cap=cand_cap, out_cap=out_cap, n_real=min(chunk, q - s),
            packed_table=eng.packed_table)
        yield min(chunk, q - s), rows, meta.numpy()


def _assert_rows(got, n, want, msg):
    """The port's first n rows equal the decoded reference rows."""
    assert n == len(want[0]), msg
    for name, g, w in zip(("r1", "j", "r2", "orient", "typ", "cont_ok",
                           "edge_ok"), got, want, strict=True):
        np.testing.assert_array_equal(g[:n].numpy().astype(w.dtype), w,
                                      err_msg=f"{msg}: {name}")


@pytest.mark.parametrize("route", ["k2", "k1_rows"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", CASES)
def test_rows_step_matches_reference(sets, monkeypatch, case, chunk, route):
    """Every chunk of the engine's rows step (dense_row_chunks, cand_cap 4
    windows a window, out_cap a chunk) holds the reference's rows of the
    chunk's real windows, in the same order, with the same candidate
    count; in order (n_disorder 0) on a table as built.  The run ends at
    the last window with a hit (of all, or of the first 40,000 below chunk
    2^14), so that the last chunk's pad windows, which repeat it, have
    hits the step must leave out.  Where the reference dropped no row, the
    hit counts equal; in a chunk of no pad windows, always (dense
    overflows out_cap in most chunks: then both hold the first out_cap
    rows).  The engine copies the host's offsets and file indices to the
    device in the call, and none while its chunks are asked for; it holds
    no chunk's rows once `keep` has taken them."""
    st = sets[case]
    n = FIRST if chunk < 1 << 14 else len(st.starts)
    woff = _woff(st, int(st.hit[st.hit < n][-1]) + 1)
    q = int(woff[-1])
    cand_cap = 4 * chunk
    want = _reference(st, q, chunk, cand_cap, chunk)
    eng = _engine(st, fetch=route == "k2")
    copies, from_numpy = [], torch.from_numpy
    monkeypatch.setattr(port.torch, "from_numpy",
                        lambda a: copies.append(len(a)) or from_numpy(a))
    kept, handed = [], []

    def keep(rows, meta):
        kept.append([r.clone() for r in rows])
        handed.append(weakref.ref(rows[0]))

    got = eng.dense_row_chunks(woff, chunk, cand_cap, keep)
    assert copies == [len(woff), st.pstore.n_reads]
    for i, (((s, e), _, meta), (n_real, rows, jmeta)) in enumerate(
            zip(got, want, strict=True)):
        assert all(h() is None for h in handed), i
        assert (s, e) == (i * chunk, i * chunk + n_real)
        meta = meta.numpy()
        assert meta[1] == jmeta[1] and meta[2] == 0, i
        if jmeta[0] <= chunk:
            assert meta[0] == len(rows[0]), i
        if n_real == chunk:
            assert meta[0] == jmeta[0], i
        _assert_rows(kept[i], min(int(meta[0]), chunk), rows, f"chunk {i}")
    assert len(copies) == 2
    assert eng.stats["chunks"] == len(want) == -(-q // chunk)
    assert sum(len(r[0]) for _, r, _ in want) > 0


@pytest.mark.parametrize("cap", ["cand_cap", "out_cap"])
@pytest.mark.parametrize("case", CASES)
def test_rows_step_flags_overflow(sets, case, cap):
    """With cand_cap or out_cap set to the median chunk's candidates or
    hits, the rows step's meta asks for a re-run (meta[1] > cand_cap or
    meta[0] > out_cap) in exactly the chunks where the reference's meta
    does, some chunks and not all, over whole chunks of 1000 windows."""
    st = sets[case]
    chunk = 1000
    woff = _woff(st, min(FIRST, int(_woff(st)[-1]) // chunk * chunk))
    q = int(woff[-1])
    full = _reference(st, q, chunk, 4 * chunk, 4 * chunk)
    if cap == "cand_cap":
        cand_cap = int(np.median([m[1] for *_, m in full]))
        out_cap = cand_cap          # at most cand_cap hits: never over
    else:
        cand_cap = 4 * chunk
        out_cap = int(np.median([m[0] for *_, m in full]))
    want = [(m[1] > cand_cap) | (m[0] > out_cap) for *_, m in _reference(
        st, q, chunk, cand_cap, out_cap)]
    got = [(m[1] > cand_cap) | (m[0] > out_cap) for _, _, m in _rows_steps(
        _engine(st), woff, chunk, cand_cap, out_cap)]
    assert got == want
    assert any(got) and not all(got)


@pytest.mark.parametrize("case", CASES)
def test_rows_step_counts_disorder(sets, case):
    """On a table whose buckets are shuffled out of (file index, type)
    order, n_disorder is above 0 in exactly the chunks whose rows
    np.lexsort((typ, fidx2, j, r1)) would reorder, and 0 elsewhere."""
    st = sets[case]
    t = st.ptable
    rng = np.random.default_rng(5)
    order = np.lexsort((rng.random(len(t.keys)), t.keys))
    shuffled = dataclasses.replace(t, keys=t.keys[order], read=t.read[order],
                                   orient=t.orient[order], typ=t.typ[order])
    eng = port.DeviceOverlapEngine(st.pstore, shuffled, device="cpu")
    chunk = 256
    fidx = st.pstore.file_index
    flagged, reorders = [], []
    for _, rows, meta in _rows_steps(eng, _woff(st, 16_384), chunk,
                                     4 * chunk, 4 * chunk):
        n = int(meta[0])
        assert n <= 4 * chunk and meta[1] <= 4 * chunk
        r1, j, r2, _, typ = (x[:n].numpy().astype(np.int64)
                             for x in rows[:5])
        perm = np.lexsort((typ, fidx[r2], j, r1))
        flagged.append(bool(meta[2] > 0))
        reorders.append(not (perm == np.arange(n)).all())
    assert flagged == reorders
    assert any(flagged)
    if case == "mini":
        assert not all(flagged)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", CASES)
def test_window_starts_at_equals_reference(sets, case, chunk):
    """The chunks of window_starts_at over every window of the set, joined,
    are disco_tpu's DeviceOverlapEngine.window_starts(); a short last
    chunk's tail repeats the last window."""
    st = sets[case]
    want = ref.DeviceOverlapEngine(st.store, st.table).window_starts()
    woff = _woff(st)
    q = int(woff[-1])
    assert q == len(want)
    dwoff = torch.from_numpy(woff)
    got = [port.window_starts_at(dwoff, s, q, chunk,
                                 st.pstore.max_len).numpy()
           for s in range(0, q, chunk)]
    assert all(g.dtype == np.int64 and len(g) == chunk for g in got)
    np.testing.assert_array_equal(np.concatenate(got)[:q], want)
    tail = got[-1][q - (len(got) - 1) * chunk:]
    assert (tail == want[-1]).all()
    assert len(tail) == (-q) % chunk


def test_flipped_keys_keep_unsigned_order():
    keys = np.array([0, 1, 2**62, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)
    flipped = port.flip_keys(keys)
    assert (np.diff(flipped) > 0).all()


def test_engine_needs_a_card_unless_told_cpu(sets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = sets["mini"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port.DeviceOverlapEngine(st.pstore, st.ptable)
    assert port.DeviceOverlapEngine(st.pstore, st.ptable,
                                    device="cpu").device.type == "cpu"
