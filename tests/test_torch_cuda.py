"""The CUDA kernels of disco_tpu_torch (overlap/fused_kernel.py: K1, K2, K3,
K4, K5, K6; overlap/pallas_kernel.py: K7; tools/exp_fetch_variants.py: T1,
T2; tools/exp_mxu_fetch.py: T3) against their plain versions, on a CUDA
card.  Tolerance: exact — the outputs are booleans and integers.

This file imports neither jax nor disco_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card every test skips."""
import numpy as np
import pytest
import torch

from disco_tpu_torch.io.readstore import ReadStore
from disco_tpu_torch.overlap import fused_kernel as port
from disco_tpu_torch.overlap import pallas_kernel
from disco_tpu_torch.overlap.verify import align_window, as_words
from disco_tpu_torch.tools import exp_fetch_variants as fv
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
        ("K7", pallas_kernel.compare_windows, k7,
         pallas_kernel.compare_windows_plain),
    ]


def _counter(name):
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
        ("T1", fv.verify_sync, (lines, table, r1, r2, *g)),
        ("T2", fv.verify_pipe_nc, (lines, table, r1, r2, *g)),
        ("T3", lambda *a: mf.fetch_checksum(*a, 0), (table, r1, bases)),
        ("T3 salt 1", lambda *a: mf.fetch_checksum(*a, 1),
         (table, r1, bases)),
    ]


def _staged(name):
    return {"K5": port.verify_windows_fused_mxu_both, "T1": fv.verify_sync,
            "T2": fv.verify_pipe_nc, "T3": mf.fetch_checksum}[name.split()[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("p,order", [(1, "sorted"), (2 * 1024, "sorted"),
                                     (100_003, "sorted"),
                                     (3001, "random")])
def test_staged_kernels_match_plain(cuda_device, p, order):
    """Every bit phase, n = 0, true matches, any P; sorted rows1, or random
    rows1 whose tiles miss their windows.  The kernels' out-of-window counts
    equal the counts of their windows' rule (window_misses), which the CPU
    call gives."""
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
    for name, w in (("K5", 24), ("T1", 32), ("T2", 32)):
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
        if name == "K5":
            got = port.verify_windows_fused_mxu_both(lines_d, *dev,
                                                     n_words=16)
        else:
            fn = fv.verify_sync if name == "T1" else fv.verify_pipe_nc
            got = fn(lines_d, as_words(table32, cuda_device), *dev)
        torch.cuda.synchronize()
        _assert_same([want], [got])


@pytest.mark.cuda
def test_checksum_wide_rows_and_rows_past_the_table(cuda_device):
    """T3 over 400-word rows (51,328 B of staged rows: above the default
    48 KB of shared memory) and rows past both ends of the table."""
    rng = np.random.default_rng(29)
    table = rng.integers(0, 2 ** 32, (300, 400), dtype=np.uint64).astype(
        np.uint32)
    rows = np.sort(rng.integers(-2, 302, 2 * 1024 + 5))
    bases = rows[::1024]
    for salt in (0, 1):
        args = (as_words(table), _t(rows), _t(bases))
        want = mf.fetch_checksum(*args, salt)
        got = mf.fetch_checksum(*(a.to(cuda_device) for a in args), salt)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        assert (want == 0).any() and (want > 0).any()


@pytest.mark.cuda
def test_staged_kernels_on_empty_batch(cuda_device):
    packed_all, _, _, _ = _batch(seed=1, p=1)
    z = np.zeros(0, np.int64)
    for name, kern, args in _staged_cases(packed_all, z, z, z, z, z):
        out = kern(*(_to(a, cuda_device) for a in args))
        assert out.shape == (0,) and out.is_cuda, name
