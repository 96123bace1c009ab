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
from test_torch_native import private_native  # noqa: F401

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


# ---------------------------------------------------------------------------
# the single window check: K3, K4, K6
# ---------------------------------------------------------------------------
def _single(seed, p, n_reads=200):
    """rows1 read ids, rows2 stacked-table rows and one window each, inside
    the 100 bp rows (offsets < 60, lengths < 40), n = 0 on a tenth of the
    pairs and a third of the pairs true matches."""
    rng, store, packed_all, rows2, (o1, o2, n, _, _) = _fixture(seed, p,
                                                                n_reads)
    rows1 = rng.integers(0, store.n_reads, p).astype(np.int32)
    m = np.arange(p) % 3 == 0
    rows2[m], o2[m] = rows1[m], o1[m]
    n[::10] = 0
    return rng, store, packed_all, rows1, rows2, o1, o2, n


def _ints(*xs):
    return [_t(x) for x in xs]


@pytest.mark.parametrize("p", [2 * TILE, 1500])
def test_fused_paths_match_pallas(p):
    """K3 through verify_windows_fused and verify_windows_fused_t (plain on
    the CPU) against the Pallas kernel in interpret mode."""
    _, store, packed_all, rows1, rows2, o1, o2, n = _single(seed=41, p=p)
    args = (rows1, rows2, o1, o2, n)
    want = np.asarray(ref.verify_windows_fused(
        packed_all, *args, n_words=store.n_words, interpret=True))
    got = port.verify_windows_fused(as_words(packed_all), *_ints(*args),
                                    n_words=store.n_words)
    got_t = port.verify_windows_fused_t(
        as_words(np.ascontiguousarray(packed_all.T)), *_ints(*args),
        n_words=store.n_words)
    for g in (got, got_t):
        assert g.dtype == torch.bool and g.shape == (p,)
        np.testing.assert_array_equal(g.numpy(), want)
    assert want[::10].all() and want[::3].all() and not want.all()
    assert port.fused_compare.launches == 0


@pytest.mark.parametrize("order", ["sorted", "random"])
def test_mxu_fetch_matches_pallas(order):
    """K4 in both table forms against verify_windows_fused_mxu in interpret
    mode; random rows1 take the Pallas version's in-graph fallback to K3,
    and the booleans must be the same."""
    rng, store, packed_all, rows1, rows2, o1, o2, n = _single(
        seed=43, p=2 * TILE + 300)
    if order == "sorted":
        rows1 = np.sort(rng.integers(0, 55, len(rows1))).astype(np.int32)
    else:
        rows1 = rng.integers(0, len(packed_all), len(rows1)).astype(np.int32)
    args = (rows1, rows2, o1, o2, n)
    lines, nr = ref.pack_lines(packed_all)
    for table in (lines, (lines, packed_all)):
        want = np.asarray(ref.verify_windows_fused_mxu(
            table, *args, n_words=store.n_words, interpret=True))
        ptable = (tuple(as_words(t) for t in table)
                  if isinstance(table, tuple) else as_words(table))
        got = port.verify_windows_fused_mxu(ptable, *_ints(*args),
                                            n_words=store.n_words)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any() and not want.all()
    assert port.fused_compare_fetch.launches == 0


def test_mxu_fetch_empty_input():
    _, store, packed_all, *_ = _single(seed=13, p=64)
    lines = as_words(port.pack_lines(packed_all)[0])
    z = torch.zeros(0, dtype=torch.int32)
    for table in (lines, (lines, as_words(packed_all))):
        got = port.verify_windows_fused_mxu(table, z, z, z, z, z,
                                            n_words=store.n_words)
        assert got.shape == (0,) and got.dtype == torch.bool
    got = port.verify_windows_fused_mxu_both16(
        as_words(port.pack_lines16(packed_all)[0]), z, z, z, z, z,
        n_words=store.n_words)
    assert got.shape == (0,) and got.dtype == torch.bool


@pytest.mark.parametrize("layout", ["relabeled", "wide_span"])
def test_both16_matches_pallas(layout):
    """K6 against verify_windows_fused_mxu_both16 in interpret mode, over a
    relabeled workload of 200 reads (the Pallas kernel proper) and over an
    unrelabeled one of 2000 reads, whose tile spans are too wide for it (its
    in-graph gather fallback)."""
    from disco_tpu.overlap.locality import relabel_workload

    _, store, packed_all, rows1, rows2, o1, o2, n = _single(
        seed=47, p=4096, n_reads=200 if layout == "relabeled" else 2000)
    rows1 = np.sort(rows1)
    args = (rows1, rows2, o1, o2, n)
    want = np.asarray(ref.verify_windows_fused_mxu_both16(
        ref.pack_lines16(packed_all)[0], *args, n_words=store.n_words,
        interpret=True))
    table = packed_all
    if layout == "relabeled":
        table, *args, perm, _, o1p, o2p, n_p = relabel_workload(
            store.n_reads, packed_all, rows1, rows2, o1, o2, n)
        args = [args[0], args[1], o1p, o2p, n_p]
        want_p = np.asarray(ref.verify_windows_fused_mxu_both16(
            ref.pack_lines16(table)[0], *args, n_words=store.n_words,
            interpret=True))
        np.testing.assert_array_equal(want_p, want[perm])
        want = want_p
    lines16 = port.pack_lines16(table)[0]
    got = port.verify_windows_fused_mxu_both16(
        as_words(lines16), *_ints(*args), n_words=store.n_words)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    assert port.verify_windows_fused_mxu_both16.launches == 0


def _both_misses(rows1, rows2, n_rows):
    """K5's row reads outside its windows: each tile of TILE pairs stages
    192 rows from its least read1 row and 384 from its least read2 row."""
    total = 0
    for rows, cap in ((rows1, 192), (rows2, 384)):
        first = np.minimum.reduceat(rows, np.arange(0, len(rows), TILE))
        first = first[np.arange(len(rows)) // TILE]
        total += int(((rows < first) | (rows >= np.minimum(first + cap,
                                                           n_rows))).sum())
    return total


@pytest.mark.parametrize("layout", ["relabeled", "wide_span"])
def test_both_matches_pallas(layout):
    """K5 against verify_windows_fused_mxu_both in interpret mode, over a
    relabeled workload of 200 reads (the Pallas kernel proper) and over an
    unrelabeled one of 2000 reads, whose tile spans are too wide for it
    (its in-graph fallback to K4), as tests/test_fused_kernel.py:209 does;
    with the row reads the port's kernel would make outside its windows."""
    from disco_tpu.overlap.locality import relabel_workload

    _, store, packed_all, rows1, rows2, o1, o2, n = _single(
        seed=53, p=4096, n_reads=200 if layout == "relabeled" else 2000)
    rows1 = np.sort(rows1)
    args = (rows1, rows2, o1, o2, n)
    want = np.asarray(ref.verify_windows_fused_mxu_both(
        ref.pack_lines(packed_all)[0], *args, n_words=store.n_words,
        interpret=True))
    table = packed_all
    if layout == "relabeled":
        table, *args, perm, _, o1p, o2p, n_p = relabel_workload(
            store.n_reads, packed_all, rows1, rows2, o1, o2, n)
        args = [args[0], args[1], o1p, o2p, n_p]
        want_p = np.asarray(ref.verify_windows_fused_mxu_both(
            ref.pack_lines(table)[0], *args, n_words=store.n_words,
            interpret=True))
        np.testing.assert_array_equal(want_p, want[perm])
        want = want_p
    lines = port.pack_lines(table)[0]
    got = port.verify_windows_fused_mxu_both(
        as_words(lines), *_ints(*args), n_words=store.n_words)
    assert got.dtype == torch.bool and got.shape == (4096,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    assert port.verify_windows_fused_mxu_both.launches == 0
    misses = _both_misses(np.asarray(args[0], np.int64),
                          np.asarray(args[1], np.int64), len(lines) * 4)
    assert int(port.verify_windows_fused_mxu_both.out_of_window) == misses
    assert misses > 0 or layout == "relabeled"


def test_both_takes_reads_of_at_most_256_bp():
    """K5 fails where the reference asserts: n_words > W_CMP - 8 = 16."""
    _, store, packed_all, *_ = _single(seed=7, p=64)
    lines = port.pack_lines(packed_all)[0]
    one = np.zeros(1, np.int32)
    with pytest.raises(AssertionError):
        ref.verify_windows_fused_mxu_both(lines, *[one] * 5, n_words=17,
                                          interpret=True)
    with pytest.raises(ValueError, match="n_words <= 16"):
        port.verify_windows_fused_mxu_both(as_words(lines), *_ints(*[one] * 5),
                                           n_words=17)
    got = port.verify_windows_fused_mxu_both(as_words(lines),
                                             *_ints(*[one] * 5), n_words=16)
    assert got.tolist() == [True]
    # an empty batch returns before the check, as the reference does, and
    # leaves no count of an earlier call behind
    far = np.array([0, len(lines) * 4 - 1], np.int32)
    port.verify_windows_fused_mxu_both(as_words(lines), *_ints(far, far),
                                       *_ints(*[far * 0] * 3), n_words=16)
    assert int(port.verify_windows_fused_mxu_both.out_of_window) > 0
    none = np.zeros(0, np.int32)
    assert np.asarray(ref.verify_windows_fused_mxu_both(
        lines, *[none] * 5, n_words=17, interpret=True)).shape == (0,)
    got = port.verify_windows_fused_mxu_both(as_words(lines),
                                             *_ints(*[none] * 5), n_words=17)
    assert got.shape == (0,)
    assert int(port.verify_windows_fused_mxu_both.out_of_window) == 0


def test_pack_lines_equal():
    _, store, packed_all, *_ = _fixture(seed=51, p=8)
    for fn in ("pack_lines", "pack_lines16"):
        want, want_n = getattr(ref, fn)(packed_all)
        got, got_n = getattr(port, fn)(packed_all)
        assert got.dtype == want.dtype == np.uint32 and got_n == want_n
        np.testing.assert_array_equal(got, want)
    wide = np.zeros((4, 18), np.uint32)
    with pytest.raises(ValueError, match="256 bp"):
        port.pack_lines16(wide)
    with pytest.raises(ValueError, match="256 bp"):
        port.verify_windows_fused_mxu_both16(
            as_words(port.pack_lines16(packed_all)[0]),
            *[torch.zeros(1, dtype=torch.int32)] * 5, n_words=17)


def test_single_wrappers_reject_bad_inputs():
    from disco_tpu_torch.overlap.pallas_kernel import compare_windows

    _, store, packed_all, rows1, rows2, o1, o2, n = _single(seed=1, p=64)
    cols = as_words(packed_all[rows2].T)
    g = _ints(o1, o2, n)
    lines = as_words(port.pack_lines(packed_all)[0])
    r1, r2 = _ints(rows1, rows2)
    with pytest.raises(TypeError):
        port.fused_compare(cols, cols, g[0].long(), *g[1:])
    with pytest.raises(ValueError):
        port.fused_compare(cols, cols[:, :32], *g)
    with pytest.raises(ValueError):
        port.fused_compare(cols, cols, *g[:2], g[2][:10])
    with pytest.raises(ValueError):
        port.verify_windows_fused_mxu(lines.view(-1, 32), r1, r2, *g,
                                      n_words=store.n_words)
    with pytest.raises(ValueError):
        port.verify_windows_fused_mxu((lines, as_words(np.zeros((4, 33),
                                                                np.uint32))),
                                      r1, r2, *g, n_words=store.n_words)
    with pytest.raises(ValueError):
        port.fused_compare_fetch(lines.view(-1, 32), cols, r1[:10], *g)
    with pytest.raises(ValueError):
        port.verify_windows_fused_mxu_both16(lines, r1[:10], r2, *g,
                                             n_words=store.n_words)
    with pytest.raises(ValueError):
        compare_windows(cols, cols.T.contiguous().T, *g)
