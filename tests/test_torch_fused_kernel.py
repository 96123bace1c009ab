"""The dual-check wrappers of disco_tpu_torch.overlap.fused_kernel against
disco_tpu's Pallas kernels (interpret mode on the CPU).  The CUDA kernels
are held against these plain versions in tests/test_torch_cuda.py.
Tolerance: exact — the outputs are booleans."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap import fused_kernel as ref
from disco_tpu_torch.overlap import fused_kernel as port
from disco_tpu_torch.overlap.verify import as_words

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)

TILE = ref.TILE


def _fixture(seed, p, n_reads=200):
    """Random reads of 100 bp from a 2 kb genome, random window geometry
    inside the rows (as tests/test_fused_kernel.py), with a third of the
    edge windows made true matches."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 2000))
    seqs = [genome[s:s + 100] for s in rng.integers(0, 1900, n_reads)]
    store = ReadStore.from_sequences(seqs)
    packed_all = np.concatenate([store.packed, store.packed_rc])
    rows2 = rng.integers(0, 2 * n_reads, p).astype(np.int32)
    e_o1 = rng.integers(0, 60, p).astype(np.int32)
    e_o2 = rng.integers(0, 60, p).astype(np.int32)
    e_n = rng.integers(0, 40, p).astype(np.int32)
    c_o1 = rng.integers(0, 60, p).astype(np.int32)
    c_n = rng.integers(0, 40, p).astype(np.int32)
    e_n[::7] = 0
    c_n[::5] = 0
    return rng, store, packed_all, rows2, (e_o1, e_o2, e_n, c_o1, c_n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _pad(x, p_pad, fill=None):
    """Pad a (P,) vector to p_pad with `fill` (default its last value)."""
    extra = p_pad - len(x)
    fill = x[-1] if fill is None else fill
    return np.concatenate([x, np.full(extra, fill, x.dtype)])


@pytest.mark.parametrize("p", [2 * TILE, 1500])
def test_dual_twin_matches_pallas(p):
    """K1: fused_compare_dual's plain version (CPU) against the Pallas
    kernel in interpret mode.  The Pallas kernel needs P % 1024 == 0, so
    its inputs are padded (zero geometry) and cut back."""
    rng, _, packed_all, rows2, geo = _fixture(seed=5, p=p)
    rows1 = rng.integers(0, len(packed_all), p)
    a = packed_all[rows1].T
    b = packed_all[rows2].T
    pp = -(-p // TILE) * TILE
    a_pad = np.zeros((a.shape[0], pp), np.uint32)
    b_pad = np.zeros_like(a_pad)
    a_pad[:, :p], b_pad[:, :p] = a, b
    want = ref.fused_compare_dual(
        jnp.asarray(a_pad), jnp.asarray(b_pad),
        *(jnp.asarray(_pad(g, pp, 0)) for g in geo), interpret=True)
    got = port.fused_compare_dual(as_words(a), as_words(b),
                                  *(_t(g) for g in geo))
    for w, g in zip(want, got):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:p])
    assert port.fused_compare_dual.launches == 0   # no kernel on the CPU


@pytest.mark.parametrize("p,order", [(2 * TILE, "sorted"),
                                     (2 * TILE, "random"),
                                     (1500, "sorted")])
def test_dual_fetch_twin_matches_pallas(p, order):
    """K2: fused_compare_dual_fetch's plain version (CPU, table =
    packed_all) against fused_compare_dual_mxu in interpret mode (table =
    pack_lines(packed_all)), with b as the reference passes it: (32, P)
    columns, zero padded.  Random rows1 take the Pallas kernel's in-graph
    fallback; the booleans must be the same."""
    rng, _, packed_all, rows2, geo = _fixture(seed=21, p=p)
    if order == "sorted":
        rows1 = np.sort(rng.integers(0, 55, p))
    else:
        rows1 = rng.integers(0, len(packed_all), p)
    rows1 = rows1.astype(np.int32)
    wp = packed_all.shape[1]
    b = np.zeros((ref.W32, p), np.uint32)
    b[:wp] = packed_all[rows2].T
    pp = -(-p // TILE) * TILE
    b_pad = np.zeros((ref.W32, pp), np.uint32)
    b_pad[:, :p] = b
    b_pad[:wp, p:] = packed_all[rows2[-1]][:, None]
    lines, _ = ref.pack_lines(packed_all)
    want = ref.fused_compare_dual_mxu(
        jnp.asarray(lines), jnp.asarray(b_pad), jnp.asarray(_pad(rows1, pp)),
        *(jnp.asarray(_pad(g, pp, 0)) for g in geo), interpret=True)
    got = port.fused_compare_dual_fetch(as_words(packed_all), as_words(b),
                                        _t(rows1), *(_t(g) for g in geo))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:p])
    assert got[0].any() or got[1].any()
    assert port.fused_compare_dual_fetch.launches == 0


def test_wrappers_reject_bad_inputs():
    _, _, packed_all, rows2, geo = _fixture(seed=1, p=64)
    cols = as_words(packed_all[rows2].T)
    g = [_t(x) for x in geo]
    with pytest.raises(TypeError):
        port.fused_compare_dual(cols, cols, g[0].long(), *g[1:])
    with pytest.raises(ValueError):
        port.fused_compare_dual(cols, cols[:, :32], *g)
    with pytest.raises(ValueError):
        port.fused_compare_dual(cols, cols.T.contiguous().T, *g)
    with pytest.raises(ValueError):
        port.fused_compare_dual_fetch(as_words(packed_all), cols[:3],
                                      _t(rows2), *g)
    with pytest.raises(ValueError):
        port.fused_compare_dual_fetch(as_words(packed_all), cols,
                                      _t(rows2[:10]), *g)
