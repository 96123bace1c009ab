"""The CUDA kernels of disco_tpu_torch (overlap/fused_kernel.py: K1, its
rows route and that route's designs, K2, K3,
K4, K5, K6, the one-thread-a-pair controls of K3, K4 and K6 and the
unpipelined control of K5; overlap/pallas_kernel.py: K7;
index/table.py: the table's torch route;
tools/exp_fetch_variants.py: T1 and its unpipelined control, T2;
tools/exp_mxu_fetch.py: T3 and its unpipelined control) against their plain
versions, on a CUDA card; the main path's relation on the card against
the CPU (and the relation against native's); and the distributed buildG (dist/) with its
shards on the card, against CPU shards and the goldens.
Tolerance: exact — the outputs are booleans and integers.

This file imports neither jax nor disco_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card every test skips."""
import pathlib

import numpy as np
import pytest
import torch

from disco_tpu_torch.io.readstore import ReadStore
from disco_tpu_torch.overlap import fused_kernel as port
from disco_tpu_torch.overlap import pallas_kernel
from disco_tpu_torch.overlap.verify import align_window, as_words
from disco_tpu_torch.tools import exp_fetch_variants as fv
from disco_tpu_torch.tools import exp_k1_rows_designs as k1d
from disco_tpu_torch.tools import exp_mxu_fetch as mf

READ_LEN = 250


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _batch(seed, p, n_reads=300):
    """Reads of 250 bp (Wp = 17) from a 4 kb genome, and window geometry
    that covers every bit phase of both offsets, windows ending at the
    read's last base, n = 0, and pairs compared with themselves (true
    matches).  Every window lies inside its row, as on the main path: past
    the row the kernels read zeros and the plain versions' word roll wraps
    (`test_kernels_read_zeros_past_row_end` covers that).
    Returns (packed_all, rows1, rows2, geo), int numpy arrays."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 4000))
    seqs = [genome[s:s + READ_LEN]
            for s in rng.integers(0, 4000 - READ_LEN, n_reads)]
    store = ReadStore.from_sequences(seqs)
    packed_all = np.concatenate([store.packed, store.packed_rc])
    rows1 = rng.integers(0, len(packed_all), p)
    rows2 = rng.integers(0, len(packed_all), p)
    e_o1 = rng.integers(0, READ_LEN, p)
    e_o2 = rng.integers(0, READ_LEN, p)
    c_o1 = rng.integers(0, READ_LEN, p)
    i = np.arange(p)
    e_o1 = (e_o1 & ~15) | (i & 15)                  # every phase ...
    e_o2 = (e_o2 & ~15) | ((i >> 4) & 15)           # ... against every phase
    e_n = READ_LEN - np.maximum(e_o1, e_o2)         # ends at the row end
    e_n = np.where(i % 3 == 0, np.minimum(rng.integers(0, 40, p), e_n), e_n)
    c_n = READ_LEN - c_o1
    c_n[::5] = 0
    e_n[::7] = 0
    same = i % 4 == 0                               # true matches
    rows2 = np.where(same, rows1, rows2)
    e_o2 = np.where(same, e_o1, e_o2)
    e_n = np.where(same, READ_LEN - e_o1, e_n)
    geo = tuple(np.clip(g, 0, None).astype(np.int32)
                for g in (e_o1, e_o2, e_n, c_o1, c_n))
    return packed_all, rows1, rows2, geo


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _assert_same(want, got):
    for w, g in zip(want, got):
        assert g.is_cuda and g.dtype == torch.bool
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2 * 1024, 100_003])
def test_dual_kernel_matches_plain(cuda_device, p):
    packed_all, rows1, rows2, geo = _batch(seed=7, p=p)
    args = (as_words(packed_all[rows1].T), as_words(packed_all[rows2].T),
            *(_t(g) for g in geo))
    want = port.fused_compare_dual_plain(*args)
    before = port.fused_compare_dual.launches
    got = port.fused_compare_dual(*(x.to(cuda_device) for x in args))
    torch.cuda.synchronize()
    assert port.fused_compare_dual.launches == before + 1
    _assert_same(want, got)
    if p > 1:
        assert want[0].any() and not want[0].all()


@pytest.mark.cuda
@pytest.mark.parametrize("p,wb,order", [(2 * 1024, 17, "sorted"),
                                        (100_003, 32, "sorted"),
                                        (3001, 17, "random")])
def test_dual_fetch_kernel_matches_plain(cuda_device, p, wb, order):
    packed_all, rows1, rows2, geo = _batch(seed=9, p=p)
    if order == "sorted":
        perm = np.argsort(rows1, kind="stable")
        rows1, rows2 = rows1[perm], rows2[perm]
        geo = tuple(g[perm] for g in geo)
    wp = packed_all.shape[1]
    b = np.zeros((wb, p), np.uint32)
    b[:wp] = packed_all[rows2].T
    args = (as_words(packed_all), as_words(b), _t(rows1),
            *(_t(g) for g in geo))
    want = port.fused_compare_dual_fetch_plain(*args)
    before = port.fused_compare_dual_fetch.launches
    got = port.fused_compare_dual_fetch(*(x.to(cuda_device) for x in args))
    torch.cuda.synchronize()
    assert port.fused_compare_dual_fetch.launches == before + 1
    _assert_same(want, got)
    assert want[0].any() and want[1].any()


def _past_row_geometry(seed, p, wp):
    """Windows that run into a row's last word and up to one word past it;
    a quarter of the lanes compare a row with itself (true matches)."""
    rng = np.random.default_rng(seed)
    end = 16 * (wp + 1)
    i = np.arange(p)
    same = i % 4 == 0
    e_o1 = rng.integers(16 * (wp - 3), end, p)
    e_o2 = np.where(same, e_o1, rng.integers(16 * (wp - 3), end, p))
    e_n = end - np.maximum(e_o1, e_o2)
    c_o1 = np.where(same, 0, rng.integers(0, end, p))
    c_n = end - c_o1
    e_n[::7] = 0
    c_n[::5] = 0
    return same, tuple(g.astype(np.int32) for g in (e_o1, e_o2, e_n, c_o1,
                                                    c_n))


@pytest.mark.cuda
def test_kernels_read_zeros_past_row_end(cuda_device):
    """A word past the row reads as 0 in both kernels, as in the TPU
    kernels' zero-filled word roll (disco_tpu fused_kernel._roll_up); K2
    never reads the next row of its table.  The reference is the plain
    version on rows padded with two zero words, over which its roll never
    wraps; on the unpadded rows it wraps, and the batch shows that."""
    packed_all, rows1, rows2, _ = _batch(seed=11, p=3001)
    rows1 = np.sort(rows1)
    rows1[-8:] = len(packed_all) - 1             # the table's last row
    wp = packed_all.shape[1]
    same, geo = _past_row_geometry(seed=11, p=len(rows1), wp=wp)
    rows2 = np.where(same, rows1, rows2)
    padded = np.zeros((len(packed_all), wp + 2), np.uint32)
    padded[:, :wp] = packed_all
    geo = tuple(_t(g) for g in geo)
    cols = lambda x, r: as_words(x[r].T)                      # noqa: E731
    want1 = port.fused_compare_dual_plain(cols(padded, rows1),
                                          cols(padded, rows2), *geo)
    want2 = port.fused_compare_dual_fetch_plain(
        as_words(padded), cols(padded, rows2), _t(rows1), *geo)
    wrapped = port.fused_compare_dual_plain(cols(packed_all, rows1),
                                            cols(packed_all, rows2), *geo)
    assert want1[0].any() and want1[1].any()
    assert any((w != v).any() for w, v in zip(want1, wrapped))

    def dev(x):
        return x.to(cuda_device)

    got1 = port.fused_compare_dual(dev(cols(packed_all, rows1)),
                                   dev(cols(packed_all, rows2)),
                                   *map(dev, geo))
    got2 = port.fused_compare_dual_fetch(
        dev(as_words(packed_all)), dev(cols(packed_all, rows2)),
        dev(_t(rows1)), *map(dev, geo))
    torch.cuda.synchronize()
    _assert_same(want1, got1)
    _assert_same(want2, got2)


@pytest.mark.cuda
def test_kernels_on_empty_batch(cuda_device):
    packed_all, _, _, _ = _batch(seed=1, p=1)
    z = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    cols = torch.zeros((packed_all.shape[1], 0), dtype=torch.int32,
                       device=cuda_device)
    for out in (port.fused_compare_dual(cols, cols, z, z, z, z, z),
                port.fused_compare_dual_fetch(
                    as_words(packed_all, cuda_device), cols, z, z, z, z, z,
                    z)):
        assert all(o.shape == (0,) and o.is_cuda for o in out)


# ---------------------------------------------------------------------------
# the single window check: K3, K4 (both table forms), K6, K7
# ---------------------------------------------------------------------------
def _single_cases(packed_all, rows1, rows2, o1, o2, n):
    """(name, wrapper, kernel args, plain version, plain args) of every
    single-check kernel over one batch, all on the CPU; read1's rows
    sorted."""
    rows1 = np.sort(rows1)
    r1, r2, g = _t(rows1), _t(rows2), [_t(x) for x in (o1, o2, n)]
    cols = lambda r: as_words(packed_all[r].T)               # noqa: E731
    lines = as_words(port.pack_lines(packed_all)[0])
    lines16 = as_words(port.pack_lines16(packed_all)[0])
    nw = packed_all.shape[1] - 1
    # K7 takes word-aligned columns and the bit phases
    word = lambda o: _t(o & ~15)                             # noqa: E731
    aligned = lambda r, o: align_window(                     # noqa: E731
        as_words(packed_all[r]), word(o)).T.contiguous()
    bits = [_t((o & 15) << 1) for o in (o1, o2)]
    k7 = (aligned(rows1, o1), aligned(rows2, o2), *bits, g[2])
    return [
        ("K3", port.fused_compare, (cols(rows1), cols(rows2), *g),
         port.fused_compare_plain),
        ("K4", lambda *a: port.verify_windows_fused_mxu(*a, n_words=nw),
         (lines, r1, r2, *g),
         lambda *a: port.verify_windows_fused_mxu_plain(*a, n_words=nw)),
        ("K4 (lines, packed_all)",
         lambda *a: port.verify_windows_fused_mxu(*a, n_words=nw),
         ((lines, as_words(packed_all)), r1, r2, *g),
         lambda *a: port.verify_windows_fused_mxu_plain(*a, n_words=nw)),
        ("K6", lambda *a: port.verify_windows_fused_mxu_both16(*a,
                                                               n_words=nw),
         (lines16, r1, r2, *g),
         lambda *a: port.verify_windows_fused_mxu_both16_plain(*a,
                                                               n_words=nw)),
        ("K6 direct",
         lambda *a: port.verify_windows_fused_mxu_both16_direct(*a,
                                                                n_words=nw),
         (lines16, r1, r2, *g),
         lambda *a: port.verify_windows_fused_mxu_both16_plain(*a,
                                                               n_words=nw)),
        ("K7", pallas_kernel.compare_windows, k7,
         pallas_kernel.compare_windows_plain),
    ]


def _counter(name):
    if name == "K6 direct":
        return port.verify_windows_fused_mxu_both16_direct
    return {"K3": port.fused_compare, "K4": port.fused_compare_fetch,
            "K6": port.verify_windows_fused_mxu_both16,
            "K7": pallas_kernel.compare_windows}[name.split()[0]]


def _to(x, device):
    return (tuple(_to(t, device) for t in x) if isinstance(x, tuple)
            else x.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2 * 1024, 100_003])
def test_single_kernels_match_plain(cuda_device, p):
    """Every bit phase of both offsets, windows ending at the read's last
    base, n = 0, true matches; P = 1 and P not a multiple of 1024."""
    packed_all, rows1, rows2, geo = _batch(seed=13, p=p)
    for name, kern, args, plain in _single_cases(packed_all, rows1, rows2,
                                                 *geo[:3]):
        want = plain(*args)
        counter = _counter(name)
        before = counter.launches
        got = kern(*(_to(a, cuda_device) for a in args))
        torch.cuda.synchronize()
        assert counter.launches == before + 1, name
        _assert_same([want], [got])
        if p > 1:
            assert want.any() and not want.all(), name


@pytest.mark.cuda
def test_single_kernels_read_zeros_past_row_end(cuda_device):
    """K3, K4 and K6 read a word past the row as 0, like the TPU kernels'
    zero-filled roll; the reference is the plain check over rows padded
    with two zero words.  K7 compares words wi < W only: a window longer
    than 16 W bases is compared over W words, as its plain version does."""
    packed_all, rows1, rows2, _ = _batch(seed=17, p=3001)
    rows1 = np.sort(rows1)
    rows1[-8:] = len(packed_all) - 1
    cases = {"K3": packed_all,
             "K4": port.pack_lines(packed_all)[0].reshape(-1, 32),
             "K6": port.pack_lines16(packed_all)[0].reshape(-1, 16)}
    for name, table in cases.items():
        wp = table.shape[1]
        same, (o1, o2, n, _, _) = _past_row_geometry(seed=17, p=len(rows1),
                                                     wp=wp)
        r1 = rows1 if name == "K3" else np.minimum(rows1, len(table) - 1)
        r2 = np.where(same, r1, rows2)
        padded = np.zeros((len(table), wp + 2), np.uint32)
        padded[:, :wp] = table
        g = [_t(x) for x in (o1, o2, n)]
        want = port.window_check_plain(as_words(padded[r1]),
                                       as_words(padded[r2]), *g)
        wrapped = port.window_check_plain(as_words(table[r1]),
                                          as_words(table[r2]), *g)
        assert want.any() and (want != wrapped).any(), name
        dev = [x.to(cuda_device) for x in (_t(r1), _t(r2), *g)]
        if name == "K3":
            got = port.fused_compare(
                as_words(table[r1].T, cuda_device),
                as_words(table[r2].T, cuda_device), *dev[2:])
        elif name == "K4":
            lines = as_words(table.reshape(-1, 128), cuda_device)
            got = port.verify_windows_fused_mxu(lines, *dev, n_words=16)
        else:
            lines = as_words(table.reshape(-1, 128), cuda_device)
            got = port.verify_windows_fused_mxu_both16(lines, *dev,
                                                       n_words=16)
            control = port.verify_windows_fused_mxu_both16_direct(
                lines, *dev, n_words=16)
            torch.cuda.synchronize()
            _assert_same([want], [control])
        torch.cuda.synchronize()
        _assert_same([want], [got])
        if name in ("K3", "K4"):             # the direct control
            if name == "K3":
                got = port.fused_compare_direct(
                    as_words(table[r1].T, cuda_device),
                    as_words(table[r2].T, cuda_device), *dev[2:])
            else:
                got = port.fused_compare_fetch_direct(
                    as_words(table, cuda_device),
                    as_words(table[r2].T, cuda_device), *dev[:1], *dev[2:])
            torch.cuda.synchronize()
            _assert_same([want], [got])
    # K7: lengths up to 16 (W + 2) bases over (W + 1)-word columns
    w1 = packed_all.shape[1]
    rng = np.random.default_rng(17)
    a = packed_all[rows1].T
    b = np.where(rng.random(a.shape) < 0.02, a ^ np.uint32(1), a)
    b[-1] ^= np.uint32(0xFFFFFFFF)           # the funnel word differs
    bits = [_t(2 * rng.integers(0, 16, len(rows1))) for _ in range(2)]
    bits[1] = bits[0]
    n = _t(rng.integers(0, 16 * (w1 + 2), len(rows1)))
    args = (as_words(a), as_words(b), *bits, n)
    want = pallas_kernel.compare_windows_plain(*args)
    got = pallas_kernel.compare_windows(*(x.to(cuda_device) for x in args))
    torch.cuda.synchronize()
    _assert_same([want], [got])
    assert want.any() and not want.all()


def _k6_long_windows(seed, n_rows=600, p=3001):
    """A 16-word table and windows of 257 to 300 bases (more than the 16
    compared words K6's fast path holds) at every bit phase, rows outside
    the table at both ends, n = 0 on every seventh pair, and true matches
    on every fourth; with the plain check over rows padded with zeros (the
    kernels read zeros past the row).  Returns (lines16, rows1, rows2, o1,
    o2, n, want), CPU tensors."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2 ** 32, (n_rows, 16), dtype=np.uint64).astype(
        np.uint32)
    i = np.arange(p)
    rows1 = np.sort(rng.integers(-3, n_rows + 3, p))
    same = i % 4 == 0
    rows2 = np.where(same, rows1, rng.integers(-3, n_rows + 3, p))
    o1 = rng.integers(0, 256, p) & ~15 | (i & 15)
    o2 = np.where(same, o1, rng.integers(0, 256, p) & ~15 | (i >> 4) & 15)
    n = rng.integers(257, 301, p)
    n[::7] = 0
    padded = np.zeros((n_rows + 6, 40), np.uint32)
    padded[3:-3, :16] = table
    g = [_t(x) for x in (o1, o2, n)]
    want = port.window_check_plain(as_words(padded[rows1 + 3]),
                                   as_words(padded[rows2 + 3]), *g)
    return (as_words(table.reshape(-1, 128)), _t(rows1), _t(rows2), *g,
            want)


@pytest.mark.cuda
def test_k6_windows_over_256_bases_and_a_misaligned_table(cuda_device):
    """K6 and its control on windows of more than 16 compared words (the
    checked readers) against the plain check over zero-padded rows; K6 on
    a table that is not 16-B aligned (its direct kernel, counted as K6's
    launch)."""
    *args, want = _k6_long_windows(seed=41)
    assert want.any() and not want.all()
    dev = [x.to(cuda_device) for x in args]
    for fn in (port.verify_windows_fused_mxu_both16,
               port.verify_windows_fused_mxu_both16_direct):
        got = fn(*dev, n_words=16)
        torch.cuda.synchronize()
        _assert_same([want], [got])
    lines = dev[0]
    flat = torch.zeros(lines.numel() + 4, dtype=torch.int32,
                       device=cuda_device)
    shifted = flat[1:1 + lines.numel()].view(lines.shape)
    shifted.copy_(lines)
    assert shifted.data_ptr() % 16
    counts = (port.verify_windows_fused_mxu_both16.launches,
              port.verify_windows_fused_mxu_both16_direct.launches)
    got = port.verify_windows_fused_mxu_both16(shifted, *dev[1:], n_words=16)
    torch.cuda.synchronize()
    _assert_same([want], [got])
    assert (port.verify_windows_fused_mxu_both16.launches,
            port.verify_windows_fused_mxu_both16_direct.launches) == (
                counts[0] + 1, counts[1])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 3001, 100_003])
def test_k6_designs_match_plain(cuda_device, p):
    """Every design of tools/exp_k6_designs.py on the batch of
    test_single_kernels_match_plain (every bit phase, n = 0, true matches,
    P not a multiple of 4 or of a block) and on windows of 257 to 300 bases
    with rows outside the table."""
    from disco_tpu_torch.tools import exp_k6_designs as kd
    packed_all, rows1, rows2, geo = _batch(seed=43, p=p)
    lines16 = as_words(port.pack_lines16(packed_all)[0])
    g = [_t(x) for x in (np.sort(rows1), rows2, *geo[:3])]
    want = port.verify_windows_fused_mxu_both16_plain(lines16, *g,
                                                      n_words=16)
    *long_args, long_want = _k6_long_windows(seed=p)
    for args, w in (((lines16, *g), want), (long_args, long_want)):
        dev = [x.to(cuda_device) for x in args]
        for name in kd.DESIGNS:
            got = kd.design(name, *dev, n_words=16)
            torch.cuda.synchronize()
            _assert_same([w], [got])
        if p > 1:
            assert w.any() and not w.all()


@pytest.mark.cuda
def test_single_kernels_on_empty_batch(cuda_device):
    packed_all, _, _, _ = _batch(seed=1, p=1)
    z = np.zeros(0, np.int64)
    for name, kern, args, _ in _single_cases(packed_all, z, z, z, z, z):
        out = kern(*(_to(a, cuda_device) for a in args))
        assert out.shape == (0,) and out.is_cuda, name


# ---------------------------------------------------------------------------
# the staged-window kernels: K5, T1, T3, and T2 (K4's kernel, own count)
# ---------------------------------------------------------------------------
def _staged_cases(packed_all, rows1, rows2, o1, o2, n):
    """(name, wrapper, args) of K5, T1, T2 and T3 (both salts) over one
    batch, all on the CPU."""
    r1, r2, g = _t(rows1), _t(rows2), [_t(x) for x in (o1, o2, n)]
    lines = as_words(port.pack_lines(packed_all)[0])
    table = as_words(packed_all)
    nw = packed_all.shape[1] - 1
    bases = _t(rows1[::1024])
    return [
        ("K5", lambda *a: port.verify_windows_fused_mxu_both(*a, n_words=nw),
         (lines, r1, r2, *g)),
        ("K5 unpipelined",
         lambda *a: port.verify_windows_fused_mxu_both_unpipelined(
             *a, n_words=nw), (lines, r1, r2, *g)),
        ("T1", fv.verify_sync, (lines, table, r1, r2, *g)),
        ("T1 unpipelined", fv.verify_sync_unpipelined,
         (lines, table, r1, r2, *g)),
        ("T2", fv.verify_pipe_nc, (lines, table, r1, r2, *g)),
        ("T3", lambda *a: mf.fetch_checksum(*a, 0), (table, r1, bases)),
        ("T3 salt 1", lambda *a: mf.fetch_checksum(*a, 1),
         (table, r1, bases)),
        ("T3 unpipelined", lambda *a: mf.fetch_checksum_unpipelined(*a, 0),
         (table, r1, bases)),
        ("T3 unpipelined salt 1",
         lambda *a: mf.fetch_checksum_unpipelined(*a, 1), (table, r1, bases)),
    ]


def _staged(name):
    return {"K5": port.verify_windows_fused_mxu_both,
            "K5 unpipelined": port.verify_windows_fused_mxu_both_unpipelined,
            "T1": fv.verify_sync,
            "T1 unpipelined": fv.verify_sync_unpipelined,
            "T2": fv.verify_pipe_nc,
            "T3": mf.fetch_checksum,
            "T3 unpipelined": mf.fetch_checksum_unpipelined}[
                name.replace(" salt 1", "")]


def _past_the_rings():
    """A P past the rings of T1, K5 and T3: more tiles than blocks x
    stages."""
    stages, blocks = mf.checksum_shape(17, 1 << 40)
    return max([tile * blocks * stages + 5 for tile, blocks, stages in (
        port.staged_shape("T1", 17, 17, 1 << 40),
        port.staged_shape("K5", 0, 17, 1 << 40))] +
        [port.TILE * blocks * stages + 5])


@pytest.mark.cuda
@pytest.mark.parametrize("p,order", [(1, "sorted"), (255, "sorted"),
                                     (1023, "sorted"), (1025, "sorted"),
                                     (2 * 1024, "sorted"),
                                     (100_003, "sorted"), ("ring", "sorted"),
                                     (1025, "random"), (3001, "random"),
                                     ("ring", "random")])
def test_staged_kernels_match_plain(cuda_device, p, order):
    """Every bit phase, n = 0, true matches, any P (past the rings of T1's
    and K5's kernels too); sorted rows1, or random rows1 whose tiles miss
    their windows.  The kernels' out-of-window counts, their controls'
    included, equal the counts of their windows' rule (sync_misses,
    _both_misses), which the CPU call gives."""
    if p == "ring":
        p = _past_the_rings()
    packed_all, rows1, rows2, geo = _batch(seed=19, p=p)
    if order == "sorted":
        perm = np.argsort(rows1, kind="stable")
        rows1, rows2 = rows1[perm], rows2[perm]
        geo = tuple(g[perm] for g in geo)
    for name, kern, args in _staged_cases(packed_all, rows1, rows2,
                                          *geo[:3]):
        counter = _staged(name)
        want = kern(*args)
        want_missed = getattr(counter, "out_of_window", None)
        before = counter.launches
        got = kern(*(_to(a, cuda_device) for a in args))
        torch.cuda.synchronize()
        assert counter.launches == before + 1, name
        assert got.is_cuda and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        if want_missed is not None:
            missed = int(counter.out_of_window)
            assert missed == int(want_missed), name
            if order == "random":
                assert missed > 0, name
        if p > 1 and want.dtype == torch.bool:
            assert want.any() and not want.all(), name


@pytest.mark.cuda
def test_staged_kernels_read_zeros_past_row_end(cuda_device):
    """K5 compares the first 24 words of each 32-word row and T1/T2 the 32
    words of theirs; a word past them reads as 0.  Rows of random words, so
    that the words past the staged ones (ws = Wp) come from device memory;
    the reference is the plain check over rows padded with two zero
    words."""
    rng = np.random.default_rng(23)
    lines = rng.integers(0, 2 ** 32, (4 * 512 // 4, 128),
                         dtype=np.uint64).astype(np.uint32)
    table32 = lines.reshape(-1, 32)
    p = 3001
    rows1 = np.sort(rng.integers(0, len(table32), p))
    rows1[-8:] = len(table32) - 1
    rows2 = rng.integers(0, len(table32), p)
    for name, w in (("K5", 24), ("K5 unpipelined", 24), ("T1", 32),
                    ("T1 unpipelined", 32), ("T2", 32)):
        same, (o1, o2, n, _, _) = _past_row_geometry(seed=23, p=p, wp=w)
        r2 = np.where(same, rows1, rows2)
        padded = np.zeros((len(table32), w + 2), np.uint32)
        padded[:, :w] = table32[:, :w]
        g = [_t(x) for x in (o1, o2, n)]
        want = port.window_check_plain(as_words(padded[rows1]),
                                       as_words(padded[r2]), *g)
        assert want.any() and not want.all(), name
        dev = [x.to(cuda_device) for x in (_t(rows1), _t(r2), *g)]
        lines_d = as_words(lines, cuda_device)
        fn = _staged(name)
        if name.startswith("K5"):
            got = fn(lines_d, *dev, n_words=16)
        else:
            got = fn(lines_d, as_words(table32, cuda_device), *dev)
        torch.cuda.synchronize()
        _assert_same([want], [got])


@pytest.mark.cuda
@pytest.mark.parametrize("wt", [16, 17, 400, 700])
def test_checksum_wide_rows_and_rows_past_the_table(cuda_device, wt):
    """T3 and its control over rows of 16 and 17 words (staged row by row,
    and as one span), of 400 (three stages of 51,344 B: above the default
    48 KB of shared memory) and of 700 words, too wide for the ring's
    stages, which the copy-then-sum kernel takes under T3's count; rows
    past both ends of the table, more tiles than blocks x stages, both
    salts; the out-of-window counts equal checksum_misses."""
    rng = np.random.default_rng(29)
    table = rng.integers(0, 2 ** 32, (300, wt), dtype=np.uint64).astype(
        np.uint32)
    stages, blocks = mf.checksum_shape(wt, 1 << 40)
    assert (stages == 0) == (wt == 700)
    for p in (2 * 1024 + 5, port.TILE * blocks * stages + 5):
        rows = np.sort(rng.integers(-40, 340, p))
        bases = rows[::1024]
        args = (as_words(table), _t(rows), _t(bases))
        for salt in (0, 1):
            want = mf.fetch_checksum(*args, salt)
            rule = int(mf.fetch_checksum.out_of_window)
            assert rule > 0
            for fn in (mf.fetch_checksum, mf.fetch_checksum_unpipelined):
                before = fn.launches
                got = fn(*(a.to(cuda_device) for a in args), salt)
                torch.cuda.synchronize()
                assert fn.launches == before + 1
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.numpy())
                assert int(fn.out_of_window) == rule
            assert (want == 0).any() and (want > 0).any()


@pytest.mark.cuda
def test_public_wrappers_leave_the_controls_at_zero(cuda_device):
    """K6's and T3's public wrappers launch their redesigned kernels (T3's
    sums equal the tool's numpy checksum); the controls (`_direct`,
    `_unpipelined`) count only their own calls."""
    packed_all, rows1, rows2, geo = _batch(seed=31, p=5000)
    rows1 = np.sort(rows1)
    lines16 = as_words(port.pack_lines16(packed_all)[0], cuda_device)
    g = [_t(x).to(cuda_device) for x in (rows1, rows2, *geo[:3])]
    table = as_words(packed_all, cuda_device)
    bases = g[0][::1024].contiguous()
    controls = (port.verify_windows_fused_mxu_both16_direct,
                mf.fetch_checksum_unpipelined)
    before = [c.launches for c in controls]
    k6, t3 = (port.verify_windows_fused_mxu_both16.launches,
              mf.fetch_checksum.launches)
    port.verify_windows_fused_mxu_both16(lines16, *g, n_words=16)
    sums = mf.fetch_checksum(table, g[0], bases, 0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(sums.cpu().numpy(),
                                  mf.checksum_numpy(packed_all, rows1))
    assert [c.launches for c in controls] == before
    assert (port.verify_windows_fused_mxu_both16.launches,
            mf.fetch_checksum.launches) == (k6 + 1, t3 + 1)


@pytest.mark.cuda
def test_staged_kernels_on_empty_batch(cuda_device):
    packed_all, _, _, _ = _batch(seed=1, p=1)
    z = np.zeros(0, np.int64)
    for name, kern, args in _staged_cases(packed_all, z, z, z, z, z):
        out = kern(*(_to(a, cuda_device) for a in args))
        assert out.shape == (0,) and out.is_cuda, name


@pytest.mark.cuda
def test_k5_ring_takes_at_most_17_staged_words(cuda_device):
    """K5's ring compares a staged window of at most 16 words (reads of at
    most 256 bp, all it takes), so its launch shape refuses wider rows."""
    assert port.staged_shape("K5", 0, 17, 1025)[0] == 1024
    with pytest.raises(RuntimeError, match="window_staged_shape"):
        port.staged_shape("K5", 0, 18, 1025)


# ---------------------------------------------------------------------------
# K3's and K4's tiled kernels and their one-thread-a-pair controls
# ---------------------------------------------------------------------------
def _sizes(w, table_words):
    """P of one pair, of partial and whole tiles, not a multiple of 4
    (misaligned column rows), and past the ring: more tiles than blocks x
    stages, so that every block's stages wrap."""
    tile, blocks, stages = port.tiled_shape(w, table_words, 1 << 40)
    return [1, 31, 255, 256, 257, 3001, (1 << 16) + 5,
            blocks * stages * tile + 5]


def _column_batch(seed, p, w, n_rows=4096, order="sorted"):
    """Rows of w random words; rows1 sorted (or not); windows at every bit
    phase of both offsets ending inside the row (before word w - 1), n = 0
    on every seventh pair and on the whole second tile of 256, true matches
    on every fourth pair.  Returns (table, rows1, rows2, o1, o2, n)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2 ** 32, (n_rows, w), dtype=np.uint64).astype(
        np.uint32)
    i = np.arange(p)
    rows1 = rng.integers(0, n_rows, p)
    if order == "sorted":
        rows1 = np.sort(rows1)
    same = i % 4 == 0
    rows2 = np.where(same, rows1, rng.integers(0, n_rows, p))
    end = 16 * (w - 1)
    o1 = rng.integers(0, end, p) & ~15 | (i & 15)
    o2 = np.where(same, o1, rng.integers(0, end, p) & ~15 | (i >> 4) & 15)
    n = np.minimum(end - np.maximum(o1, o2), rng.integers(0, 16 * w, p))
    n[::7] = 0
    n[256:512] = 0
    return table, rows1, rows2, o1, o2, n


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 17, 32, 256])
def test_tiled_k3_and_control_match_plain(cuda_device, w):
    for p in _sizes(w, 0):
        table, rows1, rows2, o1, o2, n = _column_batch(w + p, p, w)
        args = (as_words(table[rows1].T), as_words(table[rows2].T),
                *(_t(x) for x in (o1, o2, n)))
        want = port.fused_compare_plain(*args)
        for fn in (port.fused_compare, port.fused_compare_direct):
            before = fn.launches
            got = fn(*(x.to(cuda_device) for x in args))
            torch.cuda.synchronize()
            assert fn.launches == before + 1, (fn.__name__, p)
            _assert_same([want], [got])
        if p > 1000:
            assert want.any() and not want.all()


@pytest.mark.cuda
@pytest.mark.parametrize("wb", [17, 32, 256])
@pytest.mark.parametrize("order", ["sorted", "random"])
def test_tiled_k4_and_control_match_plain(cuda_device, wb, order):
    """read1's rows fetched from a (R, 32) table, read2's (Wb, P) columns
    staged; T2's launch (compare_fetch) is the same kernel."""
    for p in _sizes(wb, 32):
        table, rows1, rows2, o1, o2, n = _column_batch(wb + p, p, max(wb, 32),
                                                       order=order)
        o1, o2 = o1 % (16 * (wb - 1)), o2 % (16 * (wb - 1))
        n = np.minimum(n, 16 * (wb - 1) - np.maximum(o1, o2))
        args = (as_words(table[:, :32]), as_words(table[rows2, :wb].T),
                _t(rows1), *(_t(x) for x in (o1, o2, n)))
        want = port.fused_compare_fetch_plain(*args)
        dev = [x.to(cuda_device) for x in args]
        for fn in (port.fused_compare_fetch, port.fused_compare_fetch_direct):
            before = fn.launches
            got = fn(*dev)
            torch.cuda.synchronize()
            assert fn.launches == before + 1, (fn.__name__, p)
            _assert_same([want], [got])
        got, launched = port.compare_fetch(*dev)
        torch.cuda.synchronize()
        assert launched
        _assert_same([want], [got])
        if p > 1000:
            assert want.any() and not want.all()


@pytest.mark.cuda
def test_tiled_kernels_past_the_row_and_before_it(cuda_device):
    """Windows running up to one word past rows of 2, 17 and 32 words, and
    windows starting before the row (negative offsets): a word outside the
    row reads as 0 in the tiled kernels and their controls alike.  The
    reference is the plain check over rows with two zero words on both
    sides, the offsets moved by those two words."""
    rng = np.random.default_rng(31)
    for w in (2, 17, 32):
        p = 3001
        table = rng.integers(0, 2 ** 32, (512, w), dtype=np.uint64).astype(
            np.uint32)
        i = np.arange(p)
        same = i % 4 == 0
        rows1 = np.sort(rng.integers(0, 512, p))
        rows2 = np.where(same, rows1, rng.integers(0, 512, p))
        o1 = rng.integers(-32, 16 * (w + 1), p)
        o2 = np.where(same, o1, rng.integers(-32, 16 * (w + 1), p))
        n = np.maximum(16 * (w + 1) - np.maximum(o1, o2), 0)
        n[::7] = 0
        padded = np.zeros((512, w + 4), np.uint32)
        padded[:, 2:w + 2] = table
        g = [_t(x) for x in (o1 + 32, o2 + 32, n)]
        want = port.window_check_plain(as_words(padded[rows1]),
                                       as_words(padded[rows2]), *g)
        assert want.any() and not want.all()
        dev = [_t(x).to(cuda_device) for x in (rows1, o1, o2, n)]
        a = as_words(table[rows1].T, cuda_device)
        b = as_words(table[rows2].T, cuda_device)
        t = as_words(table, cuda_device)
        for got in (port.fused_compare(a, b, *dev[1:]),
                    port.fused_compare_direct(a, b, *dev[1:]),
                    port.fused_compare_fetch(t, b, *dev),
                    port.fused_compare_fetch_direct(t, b, *dev)):
            torch.cuda.synchronize()
            _assert_same([want], [got])


# ---------------------------------------------------------------------------
# columns wider than the tiled kernels take (over 256 words)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("w", [257, 300])
def test_wide_columns_launch_the_direct_kernel(cuda_device, w):
    """K3 and K4 with column inputs wider than their tiled kernels take:
    the one-thread-a-pair kernel, counted under the public wrapper's
    `launches` (and not the control's), equal to the plain version."""
    p = 3001
    table, rows1, rows2, o1, o2, n = _column_batch(w + p, p, w)
    cols = [as_words(table[r].T) for r in (rows1, rows2)]
    g = [_t(x) for x in (o1, o2, n)]
    cases = (
        (port.fused_compare, port.fused_compare_direct,
         (cols[0], cols[1], *g), port.fused_compare_plain),
        (port.fused_compare_fetch, port.fused_compare_fetch_direct,
         (as_words(table), cols[1], _t(rows1), *g),
         port.fused_compare_fetch_plain))
    for fn, control, args, plain in cases:
        want = plain(*args)
        assert want.any() and not want.all()
        with pytest.raises(ValueError, match="at most 256"):
            port.tiled_shape(w, 32 if fn is port.fused_compare_fetch else 0,
                             p)
        before, before_control = fn.launches, control.launches
        got = fn(*(x.to(cuda_device) for x in args))
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert control.launches == before_control
        _assert_same([want], [got])


# ---------------------------------------------------------------------------
# K1's rows route (fused_compare_dual_rows): rows read by index
# ---------------------------------------------------------------------------
def _rows_inputs(seed, p, wp, live="random", tables="two"):
    """Random row-major tables of `wp` words (every word nonzero-ish, so a
    read past a row would see the next row's first word) and window
    geometry reaching up to the row's last word (the one-past word then
    lies past the row: the kernel reads 0 there).  Each table carries 3
    rows fewer than the indices address, so some indices fall outside it;
    a quarter of the pairs compare a row with itself.  `live`: "random"
    (a third of the windows n = 0), "dead", "all" or "single".  Returns
    numpy (table1, rows1, table2, rows2, geo)."""
    rng = np.random.default_rng(seed)
    n1, n2 = 64, 96
    table1 = rng.integers(-2**31, 2**31, (n1, wp)).astype(np.int32)
    table2 = (table1 if tables == "one" else
              rng.integers(-2**31, 2**31, (n2, wp)).astype(np.int32))
    rows1 = np.sort(rng.integers(-1, len(table1) + 3, p))   # runs, repeats
    rows2 = rng.integers(-1, len(table2) + 3, p)
    bases = 16 * wp
    e_o1, e_o2, c_o1 = (rng.integers(0, bases, p) for _ in range(3))
    e_n = rng.integers(1, bases + 1, p) % (bases - np.maximum(e_o1, e_o2) + 1)
    c_n = rng.integers(1, bases + 1, p) % (bases - c_o1 + 1)
    same = (np.arange(p) % 4 == 0) & (tables == "one")
    rows2 = np.where(same, rows1, rows2)
    e_o2 = np.where(same, e_o1, e_o2)
    if live == "random":
        e_n[rng.random(p) < 1 / 3] = 0
        c_n[rng.random(p) < 1 / 3] = 0
    elif live == "dead":
        e_n[:] = 0
        c_n[:] = 0
    elif live == "all":
        e_n = np.maximum(e_n, 1)
        e_o1 = np.minimum(e_o1, bases - e_n)
        e_o2 = np.minimum(e_o2, bases - e_n)
    elif live == "single":
        keep = rng.integers(0, p)
        e_n[np.arange(p) != keep] = 0
        c_n[:] = 0
    geo = tuple(np.asarray(g, np.int32) for g in (e_o1, e_o2, e_n, c_o1,
                                                   c_n))
    return table1, rows1, table2, rows2, geo


def _rows_plain(table1, rows1, table2, rows2, geo):
    """The plain version (run on the card, brought back) over the rows
    padded with two zero words, which is what the kernel reads past a
    row."""
    def dev(x):
        return _t(x).cuda()

    def pad(t):
        return dev(np.pad(t, ((0, 0), (0, 2))))
    want = port.fused_compare_dual_rows_plain(
        pad(table1), dev(rows1), pad(table2), dev(rows2),
        *(dev(g) for g in geo))
    return tuple(w.cpu() for w in want)


def _rows_on_card(fn, table1, rows1, table2, rows2, geo):
    dev = [_t(x).cuda() for x in (table1, rows1, table2, rows2, *geo)]
    return fn(*dev)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 255, 3001, (1 << 20) + 3])
@pytest.mark.parametrize("wp", [1, 2, 17, 32, 257])
def test_rows_kernel_matches_plain(cuda_device, wp, p):
    """The rows route against its plain version at every width and size,
    two tables of different lengths and one table passed twice, indices
    repeated and outside the tables, windows up to the row's last word:
    exact, one launch counted, and no host synchronisation."""
    for tables in ("two", "one"):
        inputs = _rows_inputs(wp * 7 + p, p, wp, tables=tables)
        want = _rows_plain(*inputs)
        dev = [_t(x).cuda() for x in (inputs[0], inputs[1], inputs[2],
                                      inputs[3], *inputs[4])]
        torch.cuda.synchronize()
        before = port.fused_compare_dual_rows.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = port.fused_compare_dual_rows(*dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert port.fused_compare_dual_rows.launches == before + 1
        _assert_same(want, got)
        if p > 255:
            assert want[0].any() and not want[0].all()


@pytest.mark.cuda
@pytest.mark.parametrize("live", ["dead", "all", "single"])
def test_rows_kernel_on_dead_live_and_single_grids(cuda_device, live):
    """All lanes dead (every flag True), all live, and one live lane of
    3001, against the plain version, with the kept design and the others
    (tools/exp_k1_rows_designs.py)."""
    inputs = _rows_inputs(11, 3001, 17, live=live, tables="one")
    want = _rows_plain(*inputs)
    if live == "dead":
        assert want[0].all() and want[1].all()
    _assert_same(want, _rows_on_card(port.fused_compare_dual_rows, *inputs))
    for name in k1d.DESIGNS:
        _assert_same(want, _rows_on_card(
            lambda *a: k1d.design(name, "route", *a), *inputs))


@pytest.mark.cuda
@pytest.mark.parametrize("wp", [17, 32])
def test_rows_designs_and_stages_match_plain(cuda_device, wp):
    """Every design of the rows route, and the compaction then the check
    launched apart, equal the plain version on tables viewed at a one-word
    offset (rows not 16-B aligned); the designs count under their own
    wrapper, not the path's."""
    table1, rows1, table2, rows2, geo = _rows_inputs(5, 100_003, wp)
    want = _rows_plain(table1, rows1, table2, rows2, geo)

    def offset(t):
        buf = torch.zeros(t.size + 1, dtype=torch.int32, device=cuda_device)
        buf[1:] = _t(t).reshape(-1).cuda()
        return buf[1:].view(t.shape)
    args = (offset(table1), _t(rows1).cuda(), offset(table2),
            _t(rows2).cuda(), *(_t(g).cuda() for g in geo))
    path = port.fused_compare_dual_rows.launches
    for name in k1d.DESIGNS:
        _assert_same(want, k1d.design(name, "route", *args))
    p = len(rows1)
    out = (torch.empty(p, dtype=torch.bool, device=cuda_device),
           torch.empty(p, dtype=torch.bool, device=cuda_device))
    scratch = (torch.empty(p, dtype=torch.int32, device=cuda_device),
               torch.empty(1, dtype=torch.int32, device=cuda_device))
    live = (_t(geo[2]) > 0) | (_t(geo[4]) > 0)
    for name in k1d.LISTED:
        for o in out:
            o.zero_()
        k1d.design("scalar", "compact", *args, out=out, scratch=scratch)
        torch.cuda.synchronize()
        assert int(scratch[1]) == int(live.sum())
        ids = torch.sort(scratch[0][:int(scratch[1])].cpu()).values
        assert torch.equal(ids, torch.nonzero(live).squeeze(1).int())
        k1d.design(name, "check", *args, out=out, scratch=scratch)
        _assert_same(want, out)
    _assert_same(want, port.fused_compare_dual_rows(*args))
    assert port.fused_compare_dual_rows.launches == path + 1


@pytest.mark.cuda
def test_rows_kernel_on_empty_grid(cuda_device):
    inputs = _rows_inputs(3, 0, 17)
    before = port.fused_compare_dual_rows.launches
    got = _rows_on_card(port.fused_compare_dual_rows, *inputs)
    assert [g.shape for g in got] == [(0,), (0,)]
    assert port.fused_compare_dual_rows.launches == before


# ---------------------------------------------------------------------------
# the distributed buildG (dist/): four shards on the card
# ---------------------------------------------------------------------------
MINI = pathlib.Path(__file__).resolve().parent / "golden" / "mini"


def _mini_state():
    from disco_tpu_torch.index.table import FingerprintTable
    store = ReadStore.from_files([str(MINI / "reads.fasta")], [], 30,
                                 reference_task_order=False)
    return store, FingerprintTable.build(store, 29)


@pytest.mark.cuda
@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
def test_dist_engines_on_the_card_match_cpu_shards(cuda_device, dist_mem):
    """One superstep of both engines at n = 4, the shards on the card (K1's
    rows route) against the same engine on four CPU shards (its plain
    version), on two chunks of mini with a tenth of the reads marked: every
    grid, the overflows and the unions equal; the rows route launched once
    a shard, the column kernel never."""
    from disco_tpu_torch.dist import overlap_shard as shard
    from disco_tpu_torch.dist.mesh import make_mesh
    from disco_tpu_torch.overlap.relation import window_codes

    store, table = _mini_state()
    chunk = 4 * 2048
    kw = dict(hit_cap=4, route_cap=1024, prune_marked=True)
    engine = shard.DistMemOverlapEngine if dist_mem else \
        shard.ShardedOverlapEngine
    steps = []
    meshes = (make_mesh(4), make_mesh(4, "cpu"))
    for mesh in meshes:
        assert mesh.devices[0].type == ("cuda" if not steps else "cpu")
        eng = engine.build(store, table, mesh, **kw)
        steps.append(eng.make_step(store, q_chunk=chunk)[0] if dist_mem
                     else eng.make_step(store))
    qread, qj, qcode = window_codes(store, table.k)
    rng = np.random.default_rng(0)
    for s in (0, len(qread) // 2):
        marked = (rng.random(store.n_reads) < 0.1).astype(np.int32)
        args = (qread[s:s + chunk], qj[s:s + chunk], qcode[s:s + chunk],
                marked)
        before = port.fused_compare_dual_rows.launches
        columns = port.fused_compare_dual.launches
        got = shard.gather(meshes[0], steps[0](*args))
        torch.cuda.synchronize()
        assert port.fused_compare_dual_rows.launches == before + 4
        assert port.fused_compare_dual.launches == columns
        want = shard.gather(meshes[1], steps[1](*args))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[3].any() and got[5].sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
def test_dist_buildg_forced_overflow_on_the_card(cuda_device, dist_mem,
                                                 tmp_path, monkeypatch):
    """buildg -n 4 [-rma] on mini with route_cap 8: every chunk overflows
    and is re-run exactly (K1 on the card), counted in fallback_chunks, and
    the files equal the reference's goldens; K1 launched, K2 not."""
    from disco_tpu_torch.dist.builder import run_buildg_sharded

    monkeypatch.chdir(MINI)        # _ReadIDMap.txt records the path as given
    k1, k2 = port.fused_compare_dual.launches, \
        port.fused_compare_dual_fetch.launches
    stats = {}
    run_buildg_sharded(["reads.fasta"], [], str(tmp_path / "mini"), 4,
                       min_overlap=30, write_par_graph_size=1000,
                       budget=1 << 15, route_cap=8, dist_mem=dist_mem,
                       stats=stats)
    torch.cuda.synchronize()
    assert stats["fallback_chunks"] >= 1 and stats["chunks"] >= 2, stats
    assert port.fused_compare_dual.launches > k1
    assert port.fused_compare_dual_fetch.launches == k2
    for suffix in ("_0_parGraph.txt", "_0_containedReads.txt",
                   "_0_startRead.txt", "_ReadIDMap.txt"):
        assert ((tmp_path / f"mini{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix


@pytest.mark.cuda
@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
def test_streamed_relation_on_the_card_matches_cpu(cuda_device, dist_mem,
                                                   monkeypatch):
    """The streamed sharded relation on mini, four shards on the card,
    unpruned and pruned, equals the same relation on four CPU shards (the
    plain versions), row for row, with the same stats; the rows route
    launched once a shard a chunk and the column kernel never; each chunk's
    compaction ran with host synchronisation made an error, and the host
    read the shards' counts once a chunk (then their rows)."""
    from disco_tpu_torch.dist import builder
    from disco_tpu_torch.dist.mesh import make_mesh

    store, table = _mini_state()
    real_compact, real_gather = builder.compact, builder.gather_host
    reads = []

    def compact(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_compact(*a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def gather_host(mesh, xs):
        reads.append(len(xs[0]) if xs[0].dim() == 1 else "rows")
        return real_gather(mesh, xs)

    monkeypatch.setattr(builder, "compact", compact)
    monkeypatch.setattr(builder, "gather_host", gather_host)
    kw = dict(budget=1 << 16, dist_mem=dist_mem)
    for relation in (builder.sharded_relation,
                     builder.sharded_relation_pruned):
        rows, columns = (port.fused_compare_dual_rows.launches,
                         port.fused_compare_dual.launches)
        stats, want_stats = {}, {}
        reads.clear()
        got = relation(store, table, make_mesh(4), stats=stats, **kw)
        torch.cuda.synchronize()
        assert port.fused_compare_dual_rows.launches == \
            rows + 4 * stats["chunks"]
        assert port.fused_compare_dual.launches == columns
        assert reads == [2, "rows"] * stats["chunks"]
        want = relation(store, table, make_mesh(4, "cpu"), stats=want_stats,
                        **kw)
        if isinstance(got, tuple):
            for a, b in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            got, want = got[0], want[0]
        assert stats == want_stats and stats["chunks"] > 3
        assert len(got) == len(want) > 0
        for f in ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# ---------------------------------------------------------------------------
# the main path's relation (overlap/relation.py::_device_relation) on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("cand_factor", [4, 1 / 64], ids=["kept", "rerun"])
def test_device_relation_on_the_card(cuda_device, cand_factor):
    """The relation of 2,500 reads of 250 bp from a 50 kb genome (552,500
    windows, one chunk of 2^20) on the card equals the plain versions' run
    on the CPU and native's; with cand_factor 1/64 the chunk is re-run on
    the host (K1's column kernel).  The rows step, the window ops and the
    rows' copy to their segment never wait for the host; the card raises
    nothing."""
    from disco_tpu_torch.index.table import FingerprintTable
    from disco_tpu_torch.overlap import device as dv
    from disco_tpu_torch.overlap import relation as rel

    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), 50_000))
    store = ReadStore.from_sequences(
        [genome[s:s + READ_LEN]
         for s in rng.integers(0, 50_000 - READ_LEN, 2_500)])
    table = FingerprintTable.build(store, 29)
    got = rel._device_relation(store, table, chunk=1 << 20,
                               cand_factor=cand_factor, device=cuda_device)
    torch.cuda.synchronize()
    assert got.stats["chunks"] == 1
    assert got.stats["fallback_chunks"] == (cand_factor < 1)
    assert got.stats["reordered_chunks"] == 0
    for want in (rel._device_relation(store, table, device="cpu"),
                 rel.compute_relation(store, table, backend="native")):
        assert len(got) == len(want) > 0
        for f in ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)

    eng = dv.DeviceOverlapEngine(store, table, device=cuda_device)
    woff = dv.window_offsets(store.lengths, table.k)
    chunk = 1 << 20
    segs = rel._RowSegments(16 * chunk, chunk, 4 * chunk, cuda_device)
    chunks = eng.dense_row_chunks(woff, chunk, 4 * chunk, segs.put)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (_, seg, meta), = chunks
    finally:
        torch.cuda.set_sync_debug_mode("default")
    meta = meta.cpu().numpy()
    torch.cuda.synchronize()
    assert meta[0] == len(got) and meta[2] == 0 and seg == 0


@pytest.mark.cuda
@pytest.mark.parametrize("store_name", ["mixed", "random_200k"])
def test_table_on_the_card_equals_numpy_route(cuda_device, store_name):
    """The fingerprint table built on the card (index/table.py's torch
    route) equals the numpy route's, array for array and dtype for dtype:
    on the golden mixed set, and on 200,000 reads of 250 bp from a 2 Mb
    genome under a permuted file index (shared end k-mers abound at 30x);
    the job counts one card build and the table's entries."""
    from disco_tpu_torch.index.table import FingerprintTable
    from disco_tpu_torch.utils.logging import RECORDER

    if store_name == "mixed":
        d = MINI.parent / "mixed"
        store = ReadStore.from_files(
            [str(d / "p1.fasta"), str(d / "p2.fasta")],
            [str(d / "se.fasta")], 30)
    else:
        rng = np.random.default_rng(23)
        genome = "".join(rng.choice(list("ACGT"), 2_000_000))
        n = 200_000
        store = ReadStore.from_sequences(
            [genome[s:s + READ_LEN]
             for s in rng.integers(0, 2_000_000 - READ_LEN, n)],
            file_index=rng.permutation(n).astype(np.int64) + 1)
    want = FingerprintTable.build(store, 29)
    with RECORDER.job():
        got = FingerprintTable.build(store, 29, device=cuda_device)
    counters = RECORDER.jobs()[-1]["counters"]
    assert counters == {"index.card_builds": 1,
                        "index.entries": len(want.keys)}
    for f in ("keys", "read", "orient", "typ"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# one process per rank (dist/multiproc.py): two ranks on the one card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("rma", [False, True], ids=["replicated", "rma"])
def test_two_ranks_on_the_card_over_gloo(cuda_device, rma, tmp_path):
    """`python -m disco_tpu_torch.dist.multiproc --dist-backend gloo` in two
    processes, one shard each on the card, on mini (through
    tools/multicard.py's launcher, each rank's output to a file): rank 0's
    files equal the reference's goldens, rank 1 writes nothing, and each
    rank's supersteps launched K1's rows route (the column kernel and K2
    never)."""
    from disco_tpu_torch.tools.multicard import launch_ranks, rank_records

    results, prefixes = launch_ranks(
        2, tmp_path, ["-pe", "reads.fasta", *(["-rma"] if rma else [])],
        MINI, backend="gloo", timeout=300)
    for rec in rank_records(results):
        assert rec["rows"] > 0, rec
        assert (rec["columns"], rec["k2"]) == (0, 0), rec
    for suffix in ("_0_parGraph.txt", "_0_containedReads.txt",
                   "_0_startRead.txt", "_CheckpointInfo.txt",
                   "_ReadIDMap.txt"):
        assert (pathlib.Path(f"{prefixes[0]}{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix
    assert not list(prefixes[1].parent.iterdir())
