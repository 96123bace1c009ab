"""The compare of word-aligned windows as a CUDA kernel for the H100, with
its plain PyTorch version (the counterpart of
disco_tpu/overlap/pallas_kernel.py).

`compare_windows` (K7, TPU kernel `_compare_kernel`) takes (W+1, P) word
columns whose windows already start at word 0, a bit phase per pair, and
the window lengths:

    ok[p] = AND over wi < W of ((funnel(a, wi, bit1) ^ funnel(b, wi, bit2))
                                & mask(wi)) == 0

where funnel(x, wi, s) is the top 32 bits of (x[wi] : x[wi+1]) << s.  Only
words wi < W are compared, so a window longer than 16 W bases is compared
over W words.  `verify_windows_pallas` (overlap/verify.py) calls it after
the row gathers and `align_window`, with zero phases.  The kernel is
`window_compare_aligned` in csrc/window_compare.cu; the TPU version needs
P to be a multiple of 1024, this one takes any P."""
import torch

from .fused_kernel import _check, _raise_on, _stream, load_window
from .verify import _funnel, _masked_equal


def compare_windows_plain(a, b, bit1, bit2, n):
    """Plain version of `compare_windows`."""
    w = a.shape[0] - 1
    at, bt = a.T, b.T
    x = _funnel(at[:, :w], at[:, 1:], bit1[:, None])
    y = _funnel(bt[:, :w], bt[:, 1:], bit2[:, None])
    return _masked_equal(x, y, n, w)


def compare_windows(a, b, bit1, bit2, n):
    """a, b: (W+1, P) int32 word columns; bit1/bit2: (P,) int32 bit phases
    (even, 0..30); n: (P,) int32 window lengths (0 => True).  Returns (P,)
    bool."""
    if a.dim() != 2 or a.shape[0] < 1 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "be equal (W+1, P) column blocks")
    w1, p = a.shape
    geo = (bit1, bit2, n)
    dev = _check((a, b), geo, p)
    if dev.type == "cpu":
        return compare_windows_plain(a, b, *geo)
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    if p == 0:
        return ok
    with torch.cuda.device(dev):
        err = load_window().disco_window_compare_aligned(
            a.data_ptr(), b.data_ptr(), w1, p, *(g.data_ptr() for g in geo),
            ok.data_ptr(), _stream(dev))
    _raise_on(err, "window_compare_aligned")
    compare_windows.launches += 1
    return ok


compare_windows.launches = 0
