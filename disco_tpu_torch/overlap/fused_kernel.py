"""The dual window check (edge + containment) as CUDA kernels for the H100,
with their plain PyTorch versions.

Counterparts of disco_tpu/overlap/fused_kernel.py:

- `fused_compare_dual` (K1, TPU kernel `_dual_kernel`): both rows arrive as
  pre-gathered (Wp, P) int32 columns.
- `fused_compare_dual_fetch` (K2, TPU kernel `_mxu2_dual_kernel` behind
  `fused_compare_dual_mxu`): read1's rows are fetched inside the kernel
  from the row-major (2N, Wp) packed table; read2's rows arrive as (Wb, P)
  columns with Wb >= Wp.  The TPU's 128-lane line packing and one-hot MXU
  row expansion are TPU layout; a Hopper thread loads its row directly, so
  there is no span precondition and no fallback.

Both return (edge_ok, cont_ok) bool (P,):
edge_ok = a@e_o1 == b@e_o2 over e_n bases, cont_ok = a@c_o1 == b@0 over c_n
bases, a length of 0 giving True.  The kernels are in csrc/dual_compare.cu.

Each wrapper checks its tensors and dispatches on where they lie: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or an
error).  `launches` on each wrapper counts kernel launches."""
import ctypes

import torch

from .. import kernels
from .verify import _masked_equal, align_window

_LIB = None


def load():
    """Build (nvcc, sm_90a) and load the kernels; returns the library."""
    global _LIB
    if _LIB is None:
        lib = kernels.load_cuda("dual_compare")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.disco_dual_compare.argtypes = [vp, vp, i32, i64] + [vp] * 8
        lib.disco_dual_compare.restype = ctypes.c_int
        lib.disco_dual_compare_fetch.argtypes = (
            [vp, i64, i32, vp, i32, vp, i64] + [vp] * 8)
        lib.disco_dual_compare_fetch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def dual_check_plain(blk1, blk2, e_o1, e_o2, e_n, c_o1, c_n):
    """Edge + containment window compares over gathered (P, Wp) row blocks
    with the roll-align twins of overlap/verify.py (disco_tpu's
    `device._dual_check`, non-fused branch)."""
    n_words = blk1.shape[1] - 1

    def check(o1, o2, nl):
        return _masked_equal(align_window(blk1, o1), align_window(blk2, o2),
                             nl, n_words)

    return (check(e_o1, e_o2, e_n),
            check(c_o1, torch.zeros_like(c_o1), c_n))


def fused_compare_dual_plain(a, b, e_o1, e_o2, e_n, c_o1, c_n):
    """Plain version of `fused_compare_dual` over (Wp, P) columns."""
    return dual_check_plain(a.T, b.T, e_o1, e_o2, e_n, c_o1, c_n)


def fused_compare_dual_fetch_plain(table, b, rows1, e_o1, e_o2, e_n, c_o1,
                                   c_n):
    """Plain version of `fused_compare_dual_fetch`: gathers read1's rows
    from the (R, Wp) table; b's rows past Wp are the caller's zero pad."""
    wp = table.shape[1]
    return dual_check_plain(table[rows1.long()], b[:wp].T, e_o1, e_o2, e_n,
                            c_o1, c_n)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check(tensors, geometry, p):
    dev = tensors[0].device
    for t in (*tensors, *geometry):
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    for g in geometry:
        if g.shape != (p,):
            raise ValueError(f"geometry of shape {tuple(g.shape)}, not ({p},)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no dual-check kernel for device {dev}")
    return dev


def _outputs(p, dev):
    return (torch.empty(p, dtype=torch.bool, device=dev),
            torch.empty(p, dtype=torch.bool, device=dev))


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def fused_compare_dual(a, b, e_o1, e_o2, e_n, c_o1, c_n):
    """a, b: (Wp, P) int32 row columns; e_*/c_*: (P,) int32 window
    geometry (lengths 0 => True).  Returns (edge_ok, cont_ok) bool (P,)."""
    if a.dim() != 2 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "be equal (Wp, P) column blocks")
    wp, p = a.shape
    geo = (e_o1, e_o2, e_n, c_o1, c_n)
    dev = _check((a, b), geo, p)
    if dev.type == "cpu":
        return fused_compare_dual_plain(a, b, *geo)
    edge_ok, cont_ok = _outputs(p, dev)
    if p == 0:
        return edge_ok, cont_ok
    with torch.cuda.device(dev):
        err = load().disco_dual_compare(
            a.data_ptr(), b.data_ptr(), wp, p,
            *(g.data_ptr() for g in geo), edge_ok.data_ptr(),
            cont_ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "dual_compare")
    fused_compare_dual.launches += 1
    return edge_ok, cont_ok


fused_compare_dual.launches = 0


def fused_compare_dual_fetch(table, b, rows1, e_o1, e_o2, e_n, c_o1, c_n):
    """table: (R, Wp) int32 packed rows (packed_all); b: (Wb, P) int32
    columns of read2's rows, Wb >= Wp; rows1: (P,) int32 rows of read1 in
    `table`, best sorted; e_*/c_*: (P,) int32 window geometry.
    Returns (edge_ok, cont_ok) bool (P,)."""
    if table.dim() != 2 or b.dim() != 2 or b.shape[0] < table.shape[1]:
        raise ValueError(f"table {tuple(table.shape)} and b "
                         f"{tuple(b.shape)}: need (R, Wp) and (Wb>=Wp, P)")
    n_rows, wp = table.shape
    wb, p = b.shape
    geo = (e_o1, e_o2, e_n, c_o1, c_n)
    dev = _check((table, b, rows1), geo, p)
    if rows1.shape != (p,):
        raise ValueError(f"rows1 of shape {tuple(rows1.shape)}, not ({p},)")
    if dev.type == "cpu":
        return fused_compare_dual_fetch_plain(table, b, rows1, *geo)
    edge_ok, cont_ok = _outputs(p, dev)
    if p == 0:
        return edge_ok, cont_ok
    with torch.cuda.device(dev):
        err = load().disco_dual_compare_fetch(
            table.data_ptr(), n_rows, wp, b.data_ptr(), wb, rows1.data_ptr(),
            p, *(g.data_ptr() for g in geo), edge_ok.data_ptr(),
            cont_ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "dual_compare_fetch")
    fused_compare_dual_fetch.launches += 1
    return edge_ok, cont_ok


fused_compare_dual_fetch.launches = 0
