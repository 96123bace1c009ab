"""The port's packed-word verification twins (disco_tpu_torch.overlap.verify)
against disco_tpu.overlap.verify, on the same random packed reads.
Tolerance: exact — the outputs are uint32 words and booleans."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap import verify as ref
from disco_tpu_torch.overlap import verify as port
from test_torch_native import private_native  # noqa: F401

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)

READ_LEN = 96          # a multiple of 16: windows can end on a row's last word


def _reads(seed, n_reads=120):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 1500))
    starts = rng.integers(0, len(genome) - READ_LEN, n_reads)
    lens = rng.integers(60, READ_LEN + 1, n_reads)
    lens[:8] = READ_LEN
    seqs = [genome[s:s + n] for s, n in zip(starts, lens)]
    store = ReadStore.from_sequences(seqs)
    packed_all = np.concatenate([store.packed, store.packed_rc])
    return rng, store, packed_all


def _pairs(rng, store, p, kind):
    n = store.n_reads
    rows1 = rng.integers(0, n, p)
    rows2 = rng.integers(0, 2 * n, p)
    lens1 = store.lengths[rows1]
    lens2 = store.lengths[rows2 % n]
    if kind == "random":
        o1 = rng.integers(0, 60, p)
        o2 = rng.integers(0, 60, p)
        nl = rng.integers(0, 40, p)
    elif kind == "phases":
        # every bit phase on both sides, windows inside both rows
        o1 = np.arange(p) % 16 + 16 * rng.integers(0, 2, p)
        o2 = (np.arange(p) // 16) % 16 + 16 * rng.integers(0, 2, p)
        room = np.minimum(lens1 - o1, lens2 - o2)
        nl = rng.integers(0, room + 1)
    elif kind == "row_end":
        # windows ending at the last base of each row (and of the last word)
        nl = rng.integers(1, 50, p)
        o1 = lens1 - nl
        o2 = lens2 - nl
        rows1[: p // 4] = 0          # full-length reads
        o1[: p // 4] = READ_LEN - nl[: p // 4]
    elif kind == "zero_n":
        o1 = rng.integers(-40, 200, p)
        o2 = rng.integers(-40, 200, p)
        nl = np.zeros(p, np.int64)
    else:
        raise ValueError(kind)
    if kind == "phases" or kind == "row_end":
        # make a third of the pairs true matches: same row, same window
        m = np.arange(p) % 3 == 0
        rows2[m] = rows1[m]
        o2[m] = o1[m]
    return tuple(x.astype(np.int32) for x in (rows1, rows2, o1, o2, nl))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _words(x: np.ndarray) -> torch.Tensor:
    return port.as_words(x)


@pytest.mark.parametrize("kind", ["random", "phases", "row_end", "zero_n"])
def test_verify_windows_twin(kind):
    rng, store, packed_all = _reads(seed=len(kind))
    rows1, rows2, o1, o2, nl = _pairs(rng, store, 1500, kind)
    want = np.asarray(ref.verify_windows(packed_all, rows1, rows2, o1, o2,
                                         nl, n_words=store.n_words))
    got = port.verify_windows(_words(packed_all), _t(rows1), _t(rows2),
                              _t(o1), _t(o2), _t(nl),
                              n_words=store.n_words).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "zero_n":
        assert got.all()
    if kind != "zero_n":
        # the per-element gather formulation is an independent oracle for
        # windows inside their rows
        gat = np.asarray(ref.verify_windows_gather(
            packed_all, rows1, rows2, o1, o2, nl, n_words=store.n_words))
        np.testing.assert_array_equal(got, gat)
    if kind in ("phases", "row_end"):
        assert got[::3].all()


@pytest.mark.parametrize("kind", ["random", "phases", "zero_n"])
def test_align_window_twin(kind):
    rng, store, packed_all = _reads(seed=10 + len(kind))
    rows1, _, o1, _, _ = _pairs(rng, store, 800, kind)
    blk = packed_all[rows1]
    want = np.asarray(ref.align_window(jnp.asarray(blk), jnp.asarray(o1)))
    got = port.align_window(_words(blk), _t(o1)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_masked_equal_twin():
    rng, store, packed_all = _reads(seed=3)
    p = 2000
    a = packed_all[rng.integers(0, len(packed_all), p)]
    b = a.copy()
    flip = rng.integers(0, 2, a.shape).astype(bool) & (
        rng.random(a.shape) < 0.05)
    b[flip] ^= np.uint32(1) << rng.integers(0, 32, flip.sum()).astype(
        np.uint32)
    nl = rng.integers(-5, 16 * store.n_words + 10, p).astype(np.int32)
    want = np.asarray(ref._masked_equal(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(nl), store.n_words))
    got = port._masked_equal(_words(a), _words(b), _t(nl),
                             store.n_words).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.all() and got.any()


def test_make_packed_all_bits():
    _, store, packed_all = _reads(seed=4)
    got = port.make_packed_all(store.packed, store.packed_rc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), packed_all)
    np.testing.assert_array_equal(
        np.asarray(ref.make_packed_all(store.packed, store.packed_rc)),
        packed_all)


@pytest.mark.parametrize("kind", ["random", "phases", "row_end", "zero_n"])
def test_verify_windows_gather_twin(kind):
    """The per-element-gather oracle, word indices past the row included
    (they follow JAX's clamped gather)."""
    rng, store, packed_all = _reads(seed=20 + len(kind))
    rows1, rows2, o1, o2, nl = _pairs(rng, store, 1500, kind)
    want = np.asarray(ref.verify_windows_gather(
        packed_all, rows1, rows2, o1, o2, nl, n_words=store.n_words))
    got = port.verify_windows_gather(_words(packed_all), _t(rows1),
                                     _t(rows2), _t(o1), _t(o2), _t(nl),
                                     n_words=store.n_words)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "zero_n":
        assert want.any() and not want.all()


@pytest.mark.parametrize("kind,p", [("random", 4096), ("phases", 1500),
                                    ("row_end", 1500), ("zero_n", 1500)])
def test_verify_windows_pallas_twin(kind, p):
    """K7 behind its align preamble: the port's plain compare on the CPU
    against disco_tpu's Pallas kernel in interpret mode."""
    from disco_tpu_torch.overlap import pallas_kernel

    rng, store, packed_all = _reads(seed=30 + len(kind))
    rows1, rows2, o1, o2, nl = _pairs(rng, store, p, kind)
    want = np.asarray(ref.verify_windows_pallas(
        packed_all, rows1, rows2, o1, o2, nl, n_words=store.n_words,
        interpret=True))
    got = port.verify_windows_pallas(_words(packed_all), _t(rows1),
                                     _t(rows2), _t(o1), _t(o2), _t(nl),
                                     n_words=store.n_words)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pallas_kernel.compare_windows.launches == 0
    if kind in ("phases", "row_end"):
        assert got[::3].all() and not got.all()
