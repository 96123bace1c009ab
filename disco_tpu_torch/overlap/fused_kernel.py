"""The window-check kernels of disco_tpu/overlap/fused_kernel.py as CUDA
kernels for the H100, with their plain PyTorch versions.

The dual check (edge + containment), in csrc/dual_compare.cu:

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
bases, a length of 0 giving True.

The single check ok = a@o1 == b@o2 over n bases, in csrc/window_compare.cu:

- `fused_compare` (K3, TPU kernel `_fused_kernel`): pre-gathered (Wp, P)
  columns; behind `verify_windows_fused` and `verify_windows_fused_t`.
- `fused_compare_fetch` (K4, TPU kernel `_mxu2_kernel` behind
  `verify_windows_fused_mxu`): read1's row fetched inside the kernel from
  the `pack_lines` table viewed as 32-word rows; read2's rows arrive as
  (Wb, P) columns, which `verify_windows_fused_mxu` gathers from that
  table, or from the 17-word packed table when the lines come as
  (lines, packed_all).
- `verify_windows_fused_mxu_both16` (K6, TPU kernel `_mxu3_16_kernel`): both
  rows fetched inside the kernel from the `pack_lines16` table viewed as
  16-word rows (reads of at most 256 bp).
The TPU versions need P to be a multiple of TILE, check a span guard and
fall back through lax.cond; these take any P and have no guard, because a
thread loads its own rows.  They return the same booleans.

And in csrc/window_staged.cu, whose kernels read their rows from a window
of rows staged in shared memory for each tile of TILE pairs:

- `verify_windows_fused_mxu_both` (K5, TPU kernel `_mxu3_kernel`): both
  rows from the `pack_lines` table (relabeled rows), compared over its
  first W_CMP = 24 words; reads of at most 256 bp (n_words <= 16).  Each
  tile stages 192 rows from its least read1 row and 384 from its least
  read2 row (the TPU's window budgets).
`load_staged` also serves the fetch-experiment kernels of
disco_tpu_torch/tools (T1, T3).  A row outside its tile's window is read
from device memory, so the result is exact for every input; the wrapper's
`out_of_window` holds the count of such row reads of its last call (a
tensor on the call's device; on the CPU, the count the kernel would give,
from `window_misses`).

Each wrapper checks its tensors and dispatches on where they lie: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or an
error).  `launches` on each wrapper counts kernel launches."""
import ctypes

import numpy as np
import torch

from .. import kernels
from .verify import _masked_equal, align_window

TILE = 1024       # pairs per grid step of the TPU kernels (tile spans)
W32 = 32          # words per row of the pack_lines table
NB_B = 6          # pack_lines headroom: 64-row blocks of the widest window
W16 = 16          # words per row of the pack_lines16 table
NB16_B = 7        # pack_lines16 headroom, in 64-row blocks
W_CMP = 24        # words K5 compares of each 32-word row
BOTH_ROWS = (192, 384)   # K5's staged rows per tile: read1, read2

_LIB = None
_WINDOW_LIB = None
_STAGED_LIB = None


def load():
    """Build (nvcc, sm_90a) and load the dual-check kernels; returns the
    library."""
    global _LIB
    if _LIB is None:
        lib = kernels.load_cuda("dual_compare", deps=["window.cuh"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.disco_dual_compare.argtypes = [vp, vp, i32, i64] + [vp] * 8
        lib.disco_dual_compare.restype = ctypes.c_int
        lib.disco_dual_compare_fetch.argtypes = (
            [vp, i64, i32, vp, i32, vp, i64] + [vp] * 8)
        lib.disco_dual_compare_fetch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def load_window():
    """Build (nvcc, sm_90a) and load the single-check kernels (K3, K4, K6,
    K7); returns the library."""
    global _WINDOW_LIB
    if _WINDOW_LIB is None:
        lib = kernels.load_cuda("window_compare", deps=["window.cuh"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.disco_window_compare.argtypes = [vp, vp, i32, i64] + [vp] * 5
        lib.disco_window_compare_fetch.argtypes = (
            [vp, i64, i32, vp, i32, vp, i64] + [vp] * 5)
        lib.disco_window_compare_fetch_both.argtypes = (
            [vp, i64, i32, vp, vp, i64] + [vp] * 5)
        lib.disco_window_compare_aligned.argtypes = (
            [vp, vp, i32, i64] + [vp] * 5)
        for fn in (lib.disco_window_compare, lib.disco_window_compare_fetch,
                   lib.disco_window_compare_fetch_both,
                   lib.disco_window_compare_aligned):
            fn.restype = ctypes.c_int
        _WINDOW_LIB = lib
    return _WINDOW_LIB


def load_staged():
    """Build (nvcc, sm_90a) and load the staged-window kernels (K5, T1,
    T3); returns the library."""
    global _STAGED_LIB
    if _STAGED_LIB is None:
        lib = kernels.load_cuda("window_staged", deps=["window.cuh"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.disco_window_compare_staged_both.argtypes = (
            [vp, i64, i32, i32, i32, vp, vp, i64] + [vp] * 6)
        lib.disco_window_compare_staged.argtypes = (
            [vp, i64, i32, i32, vp, i32, vp, i64] + [vp] * 6)
        lib.disco_row_checksum_staged.argtypes = [vp, i64, i32, vp, i64, vp,
                                                  i32, vp, vp, vp]
        for fn in (lib.disco_window_compare_staged_both,
                   lib.disco_window_compare_staged,
                   lib.disco_row_checksum_staged):
            fn.restype = ctypes.c_int
        _STAGED_LIB = lib
    return _STAGED_LIB


# ---------------------------------------------------------------------------
# host-side table layouts (numpy, the same arrays as disco_tpu's)
# ---------------------------------------------------------------------------
def pack_lines(packed_all):
    """Rows padded to 32 words, the row count padded to a multiple of 64
    plus 64 * NB_B rows of headroom, as 128-word lines of 4 rows.  Returns
    (lines (L, 128) uint32, n_rows)."""
    pa = np.asarray(packed_all)
    nr, wp = pa.shape
    nrp = nr + (-nr) % 64 + 64 * max(NB_B, 2)
    out = np.zeros((nrp, W32), np.uint32)
    out[:nr, :wp] = pa
    return np.ascontiguousarray(out.reshape(-1, 128)), nr


def pack_lines16(packed_all):
    """Rows cut or padded to 16 words (exact for reads of at most 256 bp:
    word 16 of packed_all is then the zero funnel pad), 8 rows per 128-word
    line.  Raises for rows of more than 17 words.  Returns (lines (L, 128)
    uint32, n_rows)."""
    pa = np.asarray(packed_all)
    nr, wp = pa.shape
    if wp > W16 + 1:
        raise ValueError(f"pack_lines16 takes rows of at most {W16 + 1} "
                         f"words (reads <= 256 bp), not {wp}")
    nrp = nr + (-nr) % 64 + 64 * NB16_B
    out = np.zeros((nrp, W16), np.uint32)
    out[:nr, :min(wp, W16)] = pa[:, :W16]
    return np.ascontiguousarray(out.reshape(-1, 128)), nr


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
        raise ValueError(f"no window-check kernel for device {dev}")
    return dev


def _outputs(p, dev):
    return (torch.empty(p, dtype=torch.bool, device=dev),
            torch.empty(p, dtype=torch.bool, device=dev))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


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
            cont_ok.data_ptr(), _stream(dev))
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
            cont_ok.data_ptr(), _stream(dev))
    _raise_on(err, "dual_compare_fetch")
    fused_compare_dual_fetch.launches += 1
    return edge_ok, cont_ok


fused_compare_dual_fetch.launches = 0


# ---------------------------------------------------------------------------
# the single window check: plain versions
# ---------------------------------------------------------------------------
def _widen(blk, w):
    """(P, W) rows padded with zero words to (P, w), w >= W."""
    if blk.shape[1] >= w:
        return blk
    pad = torch.zeros((blk.shape[0], w - blk.shape[1]), dtype=blk.dtype,
                      device=blk.device)
    return torch.cat([blk, pad], dim=1)


def window_check_plain(blk1, blk2, o1, o2, n):
    """blk1@o1 == blk2@o2 over n bases, for (P, W) row blocks of any widths,
    compared over all the words of the wider one (the narrower one reads
    zeros past its row), with the roll-align twins of overlap/verify.py."""
    w = max(blk1.shape[1], blk2.shape[1])
    return _masked_equal(align_window(_widen(blk1, w), o1),
                         align_window(_widen(blk2, w), o2), n, w)


def fused_compare_plain(a, b, o1, o2, n):
    """Plain version of `fused_compare` over (Wp, P) columns."""
    return window_check_plain(a.T, b.T, o1, o2, n)


def _mxu_tables(packed_lines, rows2):
    """K4's row-major 32-word table and read2's (Wb, P) columns: gathered
    from that table, or from the packed table when the lines come as
    (lines, packed_all)."""
    if isinstance(packed_lines, (tuple, list)):
        lines, packed_orig = packed_lines
        b = packed_orig[rows2.long()].T.contiguous()
    else:
        lines = packed_lines
        b = lines.view(-1, W32)[rows2.long()].T.contiguous()
    return lines.view(-1, W32), b


def fused_compare_fetch_plain(table, b, rows1, o1, o2, n):
    """Plain version of `fused_compare_fetch`: gathers read1's rows from
    the (R, Wt) table; b's rows past Wb read as zeros."""
    return window_check_plain(table[rows1.long()], b.T, o1, o2, n)


def verify_windows_fused_mxu_plain(packed_lines, rows1, rows2, o1, o2, n, *,
                                   n_words):
    """Plain version of `verify_windows_fused_mxu`."""
    return fused_compare_fetch_plain(*_mxu_tables(packed_lines, rows2),
                                     rows1, o1, o2, n)


def verify_windows_fused_mxu_both16_plain(packed_lines16, rows1, rows2, o1,
                                          o2, n, *, n_words):
    """Plain version of `verify_windows_fused_mxu_both16`."""
    table = packed_lines16.view(-1, W16)
    return window_check_plain(table[rows1.long()], table[rows2.long()], o1,
                              o2, n)


# ---------------------------------------------------------------------------
# the single window check: wrappers
# ---------------------------------------------------------------------------
def fused_compare(a, b, o1, o2, n):
    """a, b: (Wp, P) int32 row columns (pair p's packed row in column p);
    o1/o2: (P,) int32 base offsets of the windows; n: (P,) int32 window
    lengths (0 => True).  Returns (P,) bool."""
    if a.dim() != 2 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "be equal (Wp, P) column blocks")
    wp, p = a.shape
    geo = (o1, o2, n)
    dev = _check((a, b), geo, p)
    if dev.type == "cpu":
        return fused_compare_plain(a, b, *geo)
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    if p == 0:
        return ok
    with torch.cuda.device(dev):
        err = load_window().disco_window_compare(
            a.data_ptr(), b.data_ptr(), wp, p, *(g.data_ptr() for g in geo),
            ok.data_ptr(), _stream(dev))
    _raise_on(err, "window_compare")
    fused_compare.launches += 1
    return ok


fused_compare.launches = 0


def verify_windows_fused(packed_all, rows1, rows2, o1, o2, n, *, n_words):
    """verify_windows as two whole-row gathers into (Wp, P) columns and the
    fused compare (K3).  packed_all: (2N, W+1) int32; rows1/rows2/o1/o2/n:
    (P,) int32.  Returns (P,) bool."""
    a = packed_all[rows1.long()].T.contiguous()
    b = packed_all[rows2.long()].T.contiguous()
    return fused_compare(a, b, o1, o2, n)


def verify_windows_fused_t(packed_all_t, rows1, rows2, o1, o2, n, *,
                           n_words):
    """verify_windows_fused fed by the transposed table packed_all_t
    (W+1, 2N): the row fetch is a column gather that gives (Wp, P)
    directly."""
    a = packed_all_t.index_select(1, rows1.long())
    b = packed_all_t.index_select(1, rows2.long())
    return fused_compare(a, b, o1, o2, n)


def _check_lines(lines):
    if lines.dim() != 2 or lines.shape[1] != 128:
        raise ValueError(f"lines of shape {tuple(lines.shape)}, not (L, 128)")


def fused_compare_fetch(table, b, rows1, o1, o2, n):
    """table: (R, Wt) int32 row-major packed rows; b: (Wb, P) int32 columns
    of read2's rows; rows1: (P,) int32 rows of read1 in `table`, best
    sorted (a row outside the table reads as zeros); o1/o2/n: (P,) int32
    window geometry.  Returns (P,) bool."""
    ok, launched = compare_fetch(table, b, rows1, o1, o2, n)
    fused_compare_fetch.launches += launched
    return ok


fused_compare_fetch.launches = 0


def compare_fetch(table, b, rows1, o1, o2, n):
    """`fused_compare_fetch` without its count, for the wrappers that run
    the same kernel under their own (tools.exp_fetch_variants.verify_pipe_nc).
    Returns (ok, whether the kernel was launched)."""
    if table.dim() != 2 or b.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} and b "
                         f"{tuple(b.shape)}: need (R, Wt) and (Wb, P)")
    n_rows, wt = table.shape
    wb, p = b.shape
    geo = (o1, o2, n)
    dev = _check((table, b, rows1), geo, p)
    if rows1.shape != (p,):
        raise ValueError(f"rows1 of shape {tuple(rows1.shape)}, not ({p},)")
    if dev.type == "cpu":
        return fused_compare_fetch_plain(table, b, rows1, *geo), False
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    if p == 0:
        return ok, False
    with torch.cuda.device(dev):
        err = load_window().disco_window_compare_fetch(
            table.data_ptr(), n_rows, wt, b.data_ptr(), wb, rows1.data_ptr(),
            p, *(g.data_ptr() for g in geo), ok.data_ptr(), _stream(dev))
    _raise_on(err, "window_compare_fetch")
    return ok, True


def verify_windows_fused_mxu(packed_lines, rows1, rows2, o1, o2, n, *,
                             n_words):
    """verify_windows over the `pack_lines` table: packed_lines is the
    (L, 128) int32 lines, or (lines, packed_all) with packed_all (2N, Wp)
    int32, Wp <= 32, from which read2's rows are gathered.  read1's rows
    (best sorted) are fetched inside the kernel (K4, `fused_compare_fetch`).
    rows1/rows2/o1/o2/n: (P,) int32.  Returns (P,) bool; empty input gives
    an empty mask."""
    if isinstance(packed_lines, (tuple, list)):
        lines, packed_orig = packed_lines
        if packed_orig.dim() != 2 or packed_orig.shape[1] > W32:
            raise ValueError(f"packed table of shape "
                             f"{tuple(packed_orig.shape)}, not (2N, <= 32)")
        tables = (lines, packed_orig)
    else:
        lines = packed_lines
        tables = (lines,)
    _check_lines(lines)
    p = rows1.numel()
    dev = _check(tables, (rows1, rows2, o1, o2, n), p)
    if p == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    return fused_compare_fetch(*_mxu_tables(packed_lines, rows2), rows1, o1,
                               o2, n)


def verify_windows_fused_mxu_both16(packed_lines16, rows1, rows2, o1, o2, n,
                                    *, n_words):
    """verify_windows with both rows fetched inside the kernel from the
    `pack_lines16` table: packed_lines16 (L, 128) int32; rows1/rows2 (P,)
    int32 rows of that table (after `relabel_workload`, both sides lie in
    narrow bands of rows); o1/o2/n (P,) int32.  Reads of at most 256 bp:
    raises for n_words > 16.  Returns (P,) bool."""
    if n_words > W16:
        raise ValueError(f"n_words = {n_words}: the 16-word table holds "
                         "reads of at most 256 bp")
    _check_lines(packed_lines16)
    p = rows1.numel()
    dev = _check((packed_lines16,), (rows1, rows2, o1, o2, n), p)
    if p == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return verify_windows_fused_mxu_both16_plain(
            packed_lines16, rows1, rows2, o1, o2, n, n_words=n_words)
    table = packed_lines16.view(-1, W16)
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = load_window().disco_window_compare_fetch_both(
            table.data_ptr(), table.shape[0], W16, rows1.data_ptr(),
            rows2.data_ptr(), p, o1.data_ptr(), o2.data_ptr(), n.data_ptr(),
            ok.data_ptr(), _stream(dev))
    _raise_on(err, "window_compare_fetch_both")
    verify_windows_fused_mxu_both16.launches += 1
    return ok


verify_windows_fused_mxu_both16.launches = 0


# ---------------------------------------------------------------------------
# staged row windows (csrc/window_staged.cu): K5 here, T1 and T3 in tools/
# ---------------------------------------------------------------------------
def tile_min_max(rows):
    """Per-tile (TILE pairs, the last one partial) least and greatest row of
    (P,) int64 `rows`: two (ceil(P / TILE),) int64 tensors."""
    t = torch.arange(rows.numel(), device=rows.device) // TILE
    nt = -(-rows.numel() // TILE)
    lo = torch.full((nt,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                    device=rows.device).scatter_reduce(0, t, rows, "amin")
    hi = torch.full((nt,), -1, dtype=torch.int64,
                    device=rows.device).scatter_reduce(0, t, rows, "amax")
    return lo, hi


def window_misses(rows, first, last, cap, n_rows):
    """The row reads a staged kernel makes outside its windows (window.cuh:
    row_window): tile t of TILE pairs stages rows [max(first[t], 0),
    min(first[t] + cap, last[t] + 1, n_rows)), and each of its rows outside
    that range is read from device memory.  rows: (P,) int64; first/last:
    (ceil(P / TILE),) int64.  Returns a 0-dim int64 tensor."""
    t = torch.arange(rows.numel(), device=rows.device) // TILE
    lo = first.clamp(min=0)
    hi = torch.minimum(first + cap, last + 1).clamp(max=n_rows)
    return ((rows < lo[t]) | (rows >= hi[t])).sum()


def _both_misses(n_rows, rows1, rows2):
    total = 0
    for rows, cap in zip((rows1.long(), rows2.long()), BOTH_ROWS):
        total = total + window_misses(rows, *tile_min_max(rows), cap, n_rows)
    return total


def verify_windows_fused_mxu_both_plain(packed_lines, rows1, rows2, o1, o2,
                                        n, *, n_words):
    """Plain version of `verify_windows_fused_mxu_both`: both rows gathered
    from the 32-word table and cut to its first W_CMP words."""
    table = packed_lines.view(-1, W32)[:, :W_CMP]
    return window_check_plain(table[rows1.long()], table[rows2.long()], o1,
                              o2, n)


def verify_windows_fused_mxu_both(packed_lines, rows1, rows2, o1, o2, n, *,
                                  n_words):
    """verify_windows with both rows fetched inside the kernel from the
    `pack_lines` table: packed_lines (L, 128) int32, viewed as 32-word rows
    of which the first W_CMP = 24 are compared; rows1/rows2 (P,) int32 rows
    of that table (after `relabel_workload`, a tile's rows lie in narrow
    bands); o1/o2/n (P,) int32.  Like the reference it takes reads of at
    most 256 bp only (n_words <= W_CMP - 8 = 16) and raises otherwise.
    Returns (P,) bool; `out_of_window` then holds the row reads outside the
    staged windows."""
    _check_lines(packed_lines)
    p = rows1.numel()
    dev = _check((packed_lines,), (rows1, rows2, o1, o2, n), p)
    fn = verify_windows_fused_mxu_both
    if p == 0:
        fn.out_of_window = torch.zeros((), dtype=torch.int64, device=dev)
        return torch.zeros(0, dtype=torch.bool, device=dev)
    if n_words > W_CMP - 8:
        raise ValueError(f"n_words = {n_words}: K5 compares {W_CMP} words "
                         f"and needs n_words <= {W_CMP - 8} (reads of at "
                         "most 256 bp), as disco_tpu asserts")
    table = packed_lines.view(-1, W32)
    if dev.type == "cpu":
        fn.out_of_window = _both_misses(table.shape[0], rows1, rows2)
        return verify_windows_fused_mxu_both_plain(
            packed_lines, rows1, rows2, o1, o2, n, n_words=n_words)
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    ws = max(1, min(W_CMP, n_words + 1))     # the words a window can reach
    with torch.cuda.device(dev):
        err = load_staged().disco_window_compare_staged_both(
            table.data_ptr(), table.shape[0], W32, W_CMP, ws,
            rows1.data_ptr(), rows2.data_ptr(), p, o1.data_ptr(),
            o2.data_ptr(), n.data_ptr(), ok.data_ptr(), misses.data_ptr(),
            _stream(dev))
    _raise_on(err, "window_compare_staged_both")
    fn.launches += 1
    fn.out_of_window = misses[0]
    return ok


verify_windows_fused_mxu_both.launches = 0
verify_windows_fused_mxu_both.out_of_window = None
