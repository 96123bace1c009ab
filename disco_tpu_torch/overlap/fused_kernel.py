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
- `fused_compare_dual_rows` (K1's rows route, for the distributed build's
  sparse (Q, H) grid): both rows read by index from row-major (R, Wp)
  tables, on the live lanes only: one launch in which each block lists
  its tile's lanes with a window to compare in shared memory and checks
  them, so no count reaches the host.  The designs timed against it are
  `tools/exp_k1_rows_designs.py`'s (csrc/k1_rows_designs.cu), on no path.

All three return (edge_ok, cont_ok) bool (P,):
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
  16-word rows (reads of at most 256 bp), as the 16-B chunks that hold
  each window's words (`row_words`), four pairs a thread.
  `verify_windows_fused_mxu_both16_direct` launches its kernel of before,
  one thread a pair loading each word: a timing control, on no path.
The TPU versions need P to be a multiple of TILE, check a span guard and
fall back through lax.cond; these take any P and have no guard, because a
thread loads its own rows.  They return the same booleans.
K3's and K4's kernels stage each tile's rows in shared memory (`tile_rows`
states which column rows) and take column inputs of at most
MAX_COLUMN_WORDS words (`tiled_shape` raises above); `fused_compare` and
`fused_compare_fetch` send wider columns to the one-thread-a-pair kernels,
which take any width, and count that launch as their own.
`fused_compare_direct` and `fused_compare_fetch_direct` launch those
one-thread-a-pair kernels at every width: timing controls, on no path.

And in csrc/window_staged.cu, whose kernels read their rows from a window
of rows staged in shared memory for each tile of TILE pairs:

- `verify_windows_fused_mxu_both` (K5, TPU kernel `_mxu3_kernel`): both
  rows from the `pack_lines` table (relabeled rows), compared over its
  first W_CMP = 24 words; reads of at most 256 bp (n_words <= 16).  Each
  tile stages 192 rows from its least read1 row and 384 from its least
  read2 row (the TPU's window budgets; `both_windows` states which rows),
  while the tile before it is compared.
  `verify_windows_fused_mxu_both_unpipelined` launches its kernel of
  before, which copied, waited and synced before every compare: a timing
  control, on no path.
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
MAX_COLUMN_WORDS = 256   # widest column input of K3's and K4's kernels

# the rows route's arguments up to the stream (csrc/dual_rows.cuh):
# table1, n1, table2, n2, wp, rows1, rows2, P, geometry, edge_ok, cont_ok
ROWS_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64] * 2 +
                 [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int64] + [ctypes.c_void_p] * 7)

_LIB = None
_WINDOW_LIB = None
_STAGED_LIB = None


def load():
    """Build (nvcc, sm_90a) and load the dual-check kernels; returns the
    library."""
    global _LIB
    if _LIB is None:
        lib = kernels.load_cuda("dual_compare",
                                deps=["window.cuh", "dual_rows.cuh"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.disco_dual_compare.argtypes = [vp, vp, i32, i64] + [vp] * 8
        lib.disco_dual_compare.restype = ctypes.c_int
        lib.disco_dual_compare_fetch.argtypes = (
            [vp, i64, i32, vp, i32, vp, i64] + [vp] * 8)
        lib.disco_dual_compare_fetch.restype = ctypes.c_int
        lib.disco_dual_compare_rows.argtypes = ROWS_ARGTYPES + [vp]
        lib.disco_dual_compare_rows.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def load_window():
    """Build (nvcc, sm_90a) and load the single-check kernels (K3, K4, K6,
    K7); returns the library."""
    global _WINDOW_LIB
    if _WINDOW_LIB is None:
        lib = kernels.load_cuda("window_compare",
                                deps=["window.cuh", "tile_ring.cuh"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.disco_window_compare.argtypes = [vp, vp, i32, i64] + [vp] * 5
        lib.disco_window_compare_fetch.argtypes = (
            [vp, i64, i32, vp, i32, vp, i64] + [vp] * 5)
        lib.disco_window_compare_fetch_both.argtypes = (
            [vp, i64, i32, vp, vp, i64] + [vp] * 5)
        lib.disco_window_compare_fetch_both_direct.argtypes = (
            lib.disco_window_compare_fetch_both.argtypes)
        lib.disco_window_compare_aligned.argtypes = (
            [vp, vp, i32, i64] + [vp] * 5)
        lib.disco_window_compare_direct.argtypes = (
            lib.disco_window_compare.argtypes)
        lib.disco_window_compare_fetch_direct.argtypes = (
            lib.disco_window_compare_fetch.argtypes)
        lib.disco_window_compare_shape.argtypes = [i32, i32, i64] + [vp] * 3
        for fn in (lib.disco_window_compare, lib.disco_window_compare_fetch,
                   lib.disco_window_compare_fetch_both,
                   lib.disco_window_compare_fetch_both_direct,
                   lib.disco_window_compare_aligned,
                   lib.disco_window_compare_direct,
                   lib.disco_window_compare_fetch_direct,
                   lib.disco_window_compare_shape):
            fn.restype = ctypes.c_int
        _WINDOW_LIB = lib
    return _WINDOW_LIB


def load_staged():
    """Build (nvcc, sm_90a) and load the staged-window kernels (K5, T1,
    T3, and the controls of K5, T1 and T3); returns the library."""
    global _STAGED_LIB
    if _STAGED_LIB is None:
        lib = kernels.load_cuda("window_staged",
                                deps=["window.cuh", "tile_ring.cuh"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        both = [vp, i64, i32, i32, i32, vp, vp, i64] + [vp] * 6
        sync = [vp, i64, i32, i32, vp, i32, vp, i64] + [vp] * 6
        lib.disco_window_compare_staged_both.argtypes = both
        lib.disco_window_compare_staged_both_unpipelined.argtypes = both
        lib.disco_window_compare_staged.argtypes = sync
        lib.disco_window_compare_staged_unpipelined.argtypes = sync
        lib.disco_window_staged_shape.argtypes = ([i32, i32, i32, i64]
                                                  + [vp] * 3)
        checksum = [vp, i64, i32, vp, i64, vp, i32, vp, vp, vp]
        lib.disco_row_checksum.argtypes = checksum
        lib.disco_row_checksum_staged.argtypes = checksum
        lib.disco_row_checksum_shape.argtypes = [i32, i64, vp, vp]
        for fn in (lib.disco_window_compare_staged_both,
                   lib.disco_window_compare_staged_both_unpipelined,
                   lib.disco_window_compare_staged,
                   lib.disco_window_compare_staged_unpipelined,
                   lib.disco_window_staged_shape,
                   lib.disco_row_checksum,
                   lib.disco_row_checksum_staged,
                   lib.disco_row_checksum_shape):
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


def table_rows(table, rows):
    """table[rows] over a row-major (R, Wp) table, a row index outside the
    table giving a row of zeros (csrc/window.cuh table_row)."""
    r = rows.long()
    n_rows = table.shape[0]
    padded = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    return padded[torch.where((r >= 0) & (r < n_rows), r, n_rows)]


def fused_compare_dual_rows_plain(table1, rows1, table2, rows2, e_o1, e_o2,
                                  e_n, c_o1, c_n):
    """Plain version of `fused_compare_dual_rows`: the dual check over the
    gathered pairs (table1[rows1[p]], table2[rows2[p]])."""
    return dual_check_plain(table_rows(table1, rows1),
                            table_rows(table2, rows2), e_o1, e_o2, e_n,
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

def _rows_inputs(table1, rows1, table2, rows2, geo):
    if table1.dim() != 2 or table2.dim() != 2 or \
            table1.shape[1] != table2.shape[1]:
        raise ValueError(f"tables {tuple(table1.shape)} and "
                         f"{tuple(table2.shape)}: need (R1, Wp), (R2, Wp)")
    p = rows1.shape[0]
    if rows1.shape != (p,) or rows2.shape != (p,):
        raise ValueError(f"rows1 {tuple(rows1.shape)} and rows2 "
                         f"{tuple(rows2.shape)} must be equal (P,) vectors")
    return p, _check((table1, table2, rows1, rows2), geo, p)


def _rows_args(table1, rows1, table2, rows2, geo, out):
    """The rows route's C arguments up to the stream (ROWS_ARGTYPES)."""
    return (table1.data_ptr(), table1.shape[0], table2.data_ptr(),
            table2.shape[0], table1.shape[1], rows1.data_ptr(),
            rows2.data_ptr(), rows1.shape[0], *(g.data_ptr() for g in geo),
            *(o.data_ptr() for o in out))


def fused_compare_dual_rows(table1, rows1, table2, rows2, e_o1, e_o2, e_n,
                            c_o1, c_n):
    """K1 over row-major tables: table1 (R1, Wp) and table2 (R2, Wp) int32;
    rows1, rows2 (P,) int32 row indices (outside the table: a row of
    zeros); e_*/c_*: (P,) int32 window geometry.  Checks the pair
    (table1[rows1[p]], table2[rows2[p]]) on the live lanes (e_n > 0 or
    c_n > 0) only, with no host synchronisation; a dead lane gives True.
    Returns (edge_ok, cont_ok) bool (P,).  One launch lists each tile's
    live lanes in shared memory and checks them (csrc/dual_rows.cuh)."""
    geo = (e_o1, e_o2, e_n, c_o1, c_n)
    p, dev = _rows_inputs(table1, rows1, table2, rows2, geo)
    if dev.type == "cpu":
        return fused_compare_dual_rows_plain(table1, rows1, table2, rows2,
                                             *geo)
    out = _outputs(p, dev)
    if p == 0:
        return out
    with torch.cuda.device(dev):
        err = load().disco_dual_compare_rows(
            *_rows_args(table1, rows1, table2, rows2, geo, out), _stream(dev))
    _raise_on(err, "dual_compare_rows")
    fused_compare_dual_rows.launches += 1
    return out


fused_compare_dual_rows.launches = 0




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
def _column_words(w):
    if w > MAX_COLUMN_WORDS:
        raise ValueError(f"column inputs of {w} words: K3's and K4's tiled "
                         f"kernels take at most {MAX_COLUMN_WORDS}")


def _launchable(kernel, words):
    """`kernel`, or for a tiled kernel and column inputs wider than it
    takes (over MAX_COLUMN_WORDS), its one-thread-a-pair twin
    (`kernel`_direct), which takes any width."""
    if kernel.endswith("_direct") or words <= MAX_COLUMN_WORDS:
        return kernel
    return kernel + "_direct"


def _compare(kernel, a, b, o1, o2, n):
    """K3's checks, then its plain version (CPU) or `kernel` of the
    library (`_launchable` at a's width).  Returns (ok, whether a kernel
    was launched)."""
    if a.dim() != 2 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "be equal (Wp, P) column blocks")
    wp, p = a.shape
    geo = (o1, o2, n)
    dev = _check((a, b), geo, p)
    if dev.type == "cpu":
        return fused_compare_plain(a, b, *geo), False
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    if p == 0:
        return ok, False
    kernel = _launchable(kernel, wp)
    with torch.cuda.device(dev):
        err = getattr(load_window(), kernel)(
            a.data_ptr(), b.data_ptr(), wp, p, *(g.data_ptr() for g in geo),
            ok.data_ptr(), _stream(dev))
    _raise_on(err, kernel)
    return ok, True


def fused_compare(a, b, o1, o2, n):
    """a, b: (Wp, P) int32 row columns (pair p's packed row in column p);
    o1/o2: (P,) int32 base offsets of the windows; n: (P,) int32 window
    lengths (0 => True).  Returns (P,) bool.  Columns of up to
    MAX_COLUMN_WORDS words go to the tiled kernel, wider ones to the
    one-thread-a-pair kernel; either launch is counted here."""
    ok, launched = _compare("disco_window_compare", a, b, o1, o2, n)
    fused_compare.launches += launched
    return ok


fused_compare.launches = 0


def fused_compare_direct(a, b, o1, o2, n):
    """`fused_compare` through the one-thread-a-pair kernel it had before
    its columns were tiled: a timing control, on no path."""
    ok, launched = _compare("disco_window_compare_direct", a, b, o1, o2, n)
    fused_compare_direct.launches += launched
    return ok


fused_compare_direct.launches = 0


def tiled_shape(words, table_words, p):
    """The launch shape of K3's tiled kernel (table_words 0) or K4's (read1's
    rows table_words wide) over column inputs of `words` words and p pairs,
    on the current CUDA device: (pairs per tile, blocks, stages of the
    ring).  Raises ValueError for columns wider than the tiled kernels
    take (MAX_COLUMN_WORDS), which the wrappers send to the
    one-thread-a-pair kernels."""
    _column_words(words)
    out = [ctypes.c_int() for _ in range(3)]
    _raise_on(load_window().disco_window_compare_shape(
        words, table_words, p, *(ctypes.addressof(x) for x in out)),
        "window_compare_shape")
    return tuple(x.value for x in out)


def read_words(o, n, words):
    """The words of a `words`-word row that the kernels read for a window
    of n bases at base offset o (csrc/window.cuh window_equal_at: words
    o >> 4 to (o >> 4) + ceil(n / 16), the one-past word included), cut to
    [0, words): (first, last) int64 (P,) tensors, last < first where the
    window reads no word of the row."""
    o, n = o.long(), n.long()
    d = o >> 4
    live = n > 0
    first = torch.where(live, d.clamp(min=0), 0)
    last = torch.where(live, (d + ((n + 15) >> 4)).clamp(max=words - 1), -1)
    return first, last


def tile_rows(o, n, words, tile):
    """The word rows K3's and K4's kernels stage of a `words`-word column
    input for each tile of `tile` pairs (the last one partial): from the
    least to the greatest word `read_words` gives over the tile's pairs
    with n > 0 (csrc/window.cuh tile_rows).  Returns (lo, rows), int64
    tensors of ceil(P / tile); rows 0 where nothing is staged."""
    first, last = read_words(o, n, words)
    live = n > 0
    t = torch.arange(len(first), device=first.device) // tile
    nt = -(-len(first) // tile)
    big = torch.iinfo(torch.int64).max
    lo = torch.full((nt,), big, dtype=torch.int64,
                    device=first.device).scatter_reduce(
        0, t, torch.where(live, first, big), "amin")
    hi = torch.full((nt,), -1, dtype=torch.int64,
                    device=first.device).scatter_reduce(
        0, t, torch.where(live, last, -1), "amax")
    rows = (hi - lo + 1).clamp(min=0)
    return torch.where(rows > 0, lo, 0), rows


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
    of read2's rows (over MAX_COLUMN_WORDS words, the one-thread-a-pair
    kernel, counted here); rows1: (P,) int32 rows of read1 in `table`, best
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
    return _compare_fetch("disco_window_compare_fetch", table, b, rows1, o1,
                          o2, n)


def fused_compare_fetch_direct(table, b, rows1, o1, o2, n):
    """`fused_compare_fetch` through the one-thread-a-pair kernel it had
    before read2's columns were tiled: a timing control, on no path."""
    ok, launched = _compare_fetch("disco_window_compare_fetch_direct", table,
                                  b, rows1, o1, o2, n)
    fused_compare_fetch_direct.launches += launched
    return ok


fused_compare_fetch_direct.launches = 0


def _compare_fetch(kernel, table, b, rows1, o1, o2, n):
    """K4's checks, then its plain version (CPU) or `kernel` of the
    library (`_launchable` at b's width).  Returns (ok, whether a kernel
    was launched)."""
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
    kernel = _launchable(kernel, wb)
    with torch.cuda.device(dev):
        err = getattr(load_window(), kernel)(
            table.data_ptr(), n_rows, wt, b.data_ptr(), wb, rows1.data_ptr(),
            p, *(g.data_ptr() for g in geo), ok.data_ptr(), _stream(dev))
    _raise_on(err, kernel)
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


def _fused_mxu_both16(kernel, fn, packed_lines16, rows1, rows2, o1, o2, n,
                      n_words):
    """K6's checks, then its plain version (CPU) or `kernel` of the window
    library; counts the launch in fn.launches."""
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
        err = getattr(load_window(), kernel)(
            table.data_ptr(), table.shape[0], W16, rows1.data_ptr(),
            rows2.data_ptr(), p, o1.data_ptr(), o2.data_ptr(), n.data_ptr(),
            ok.data_ptr(), _stream(dev))
    _raise_on(err, kernel)
    fn.launches += 1
    return ok


def row_words(table, rows, d):
    """The words K6's kernel holds of each pair's row (csrc/window.cuh
    row_words): words d .. d + 16 of row `rows` of the
    (R, 16) int32 table, from the row's 16-B chunks (d & ~3) / 4 ..
    (d & ~3) / 4 + 4 shifted down by d & 3 words; a chunk outside the row,
    or a row outside the table, reads zeros.  rows, d: (P,) integer
    tensors.  Returns (P, 17) int32."""
    n_rows = table.shape[0]
    r, d = rows.long(), d.long()
    e = d & ~3
    chunk = (e >> 2)[:, None] + torch.arange(5, device=d.device)
    held = ((r >= 0) & (r < n_rows))[:, None] & (chunk >= 0) & (chunk < 4)
    quads = table.view(n_rows, 4, 4)[r.clamp(0, max(n_rows - 1, 0))]
    words = quads[torch.arange(len(r), device=d.device)[:, None],
                  chunk.clamp(0, 3)]
    words = torch.where(held[:, :, None], words, 0).reshape(len(r), 20)
    return words.gather(1, (d - e)[:, None] + torch.arange(17,
                                                            device=d.device))


def verify_windows_fused_mxu_both16(packed_lines16, rows1, rows2, o1, o2, n,
                                    *, n_words):
    """verify_windows with both rows fetched inside the kernel from the
    `pack_lines16` table: packed_lines16 (L, 128) int32; rows1/rows2 (P,)
    int32 rows of that table (after `relabel_workload`, both sides lie in
    narrow bands of rows); o1/o2/n (P,) int32.  Reads of at most 256 bp:
    raises for n_words > 16.  Returns (P,) bool.  A thread of the kernel
    takes four consecutive pairs and reads each row as the 16-B chunks
    that hold the window's words (`row_words`)."""
    return _fused_mxu_both16("disco_window_compare_fetch_both",
                             verify_windows_fused_mxu_both16, packed_lines16,
                             rows1, rows2, o1, o2, n, n_words)


verify_windows_fused_mxu_both16.launches = 0


def verify_windows_fused_mxu_both16_direct(packed_lines16, rows1, rows2, o1,
                                           o2, n, *, n_words):
    """`verify_windows_fused_mxu_both16` through its kernel of before, one
    thread a pair loading its rows' words from device memory: a timing
    control, on no path."""
    return _fused_mxu_both16("disco_window_compare_fetch_both_direct",
                             verify_windows_fused_mxu_both16_direct,
                             packed_lines16, rows1, rows2, o1, o2, n,
                             n_words)


verify_windows_fused_mxu_both16_direct.launches = 0


# ---------------------------------------------------------------------------
# staged row windows (csrc/window_staged.cu): K5 here, T1 and T3 in tools/
# ---------------------------------------------------------------------------
def staged_shape(kernel, words, ws, p):
    """The launch shape of K5's kernel (kernel "K5") or T1's ("T1", read2's
    columns `words` wide) at ws staged words a row and p pairs, on the
    current CUDA device: (pairs per tile, blocks, stages of the ring)."""
    out = [ctypes.c_int() for _ in range(3)]
    _raise_on(load_staged().disco_window_staged_shape(
        {"K5": 1, "T1": 0}[kernel], words, ws, p,
        *(ctypes.addressof(x) for x in out)), "window_staged_shape")
    return tuple(x.value for x in out)


def tile_min_max(rows, tile=TILE):
    """Per-tile (`tile` pairs, the last one partial) least and greatest row
    of (P,) int64 `rows`: two (ceil(P / tile),) int64 tensors."""
    t = torch.arange(rows.numel(), device=rows.device) // tile
    nt = -(-rows.numel() // tile)
    lo = torch.zeros(nt, dtype=torch.int64, device=rows.device).scatter_reduce(
        0, t, rows, "amin", include_self=False)
    hi = torch.zeros(nt, dtype=torch.int64, device=rows.device).scatter_reduce(
        0, t, rows, "amax", include_self=False)
    return lo, hi


def window_rows(first, last, cap, n_rows):
    """The rows a staged kernel stages (window.cuh: row_window): [lo, lo +
    count) with lo = max(first, 0) and lo + count = min(first + cap,
    last + 1, n_rows).  Returns (lo, count), count 0 where none."""
    lo = first.clamp(min=0)
    hi = torch.minimum(first + cap, last + 1).clamp(max=n_rows)
    return lo, (hi - lo).clamp(min=0)


def window_misses(rows, first, last, cap, n_rows):
    """The row reads a staged kernel makes outside its windows: tile t of
    TILE pairs stages `window_rows(first[t], last[t], cap, n_rows)`, and
    each of its rows outside that range is read from device memory.  rows:
    (P,) int64; first/last: (ceil(P / TILE),) int64.  Returns a 0-dim int64
    tensor."""
    return (~staged_mask(rows, *window_rows(first, last, cap,
                                            n_rows))).sum()


def staged_mask(rows, lo, count, tile=TILE):
    """(P,) bool: pair p's row lies in its tile's staged rows [lo[t], lo[t]
    + count[t]), t = p // tile."""
    t = torch.arange(rows.numel(), device=rows.device) // tile
    return (rows >= lo[t]) & (rows < lo[t] + count[t])


def both_windows(n_rows, rows1, rows2):
    """The rows K5's kernel stages for each tile of TILE pairs (csrc/
    window_staged.cu window_compare_ring_both), per side: rows [max(lo, 0),
    min(lo + cap, hi + 1, n_rows)) of the tile's least and greatest row lo,
    hi over all its pairs, cap 192 for read1 and 384 for read2 (BOTH_ROWS).
    Returns ((lo1, count1), (lo2, count2)), int64 tensors of ceil(P /
    TILE); a row outside them is read from device memory and counted."""
    return tuple(window_rows(*tile_min_max(r.long()), cap, n_rows)
                 for r, cap in zip((rows1, rows2), BOTH_ROWS))


def _both_misses(n_rows, rows1, rows2):
    total = 0
    for rows, (lo, count) in zip((rows1, rows2),
                                 both_windows(n_rows, rows1, rows2)):
        total = total + (~staged_mask(rows.long(), lo, count)).sum()
    return total


def verify_windows_fused_mxu_both_plain(packed_lines, rows1, rows2, o1, o2,
                                        n, *, n_words):
    """Plain version of `verify_windows_fused_mxu_both`: both rows gathered
    from the 32-word table and cut to its first W_CMP words."""
    table = packed_lines.view(-1, W32)[:, :W_CMP]
    return window_check_plain(table[rows1.long()], table[rows2.long()], o1,
                              o2, n)


def _fused_mxu_both(kernel, fn, packed_lines, rows1, rows2, o1, o2, n,
                    n_words):
    """K5's checks, then its plain version (CPU) or `kernel` of the staged
    library; sets fn.out_of_window and counts the launch in fn.launches."""
    _check_lines(packed_lines)
    p = rows1.numel()
    dev = _check((packed_lines,), (rows1, rows2, o1, o2, n), p)
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
        err = getattr(load_staged(), kernel)(
            table.data_ptr(), table.shape[0], W32, W_CMP, ws,
            rows1.data_ptr(), rows2.data_ptr(), p, o1.data_ptr(),
            o2.data_ptr(), n.data_ptr(), ok.data_ptr(), misses.data_ptr(),
            _stream(dev))
    _raise_on(err, kernel)
    fn.launches += 1
    fn.out_of_window = misses[0]
    return ok


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
    return _fused_mxu_both("disco_window_compare_staged_both",
                           verify_windows_fused_mxu_both, packed_lines,
                           rows1, rows2, o1, o2, n, n_words)


verify_windows_fused_mxu_both.launches = 0
verify_windows_fused_mxu_both.out_of_window = None


def verify_windows_fused_mxu_both_unpipelined(packed_lines, rows1, rows2, o1,
                                              o2, n, *, n_words):
    """`verify_windows_fused_mxu_both` through the kernel it had before its
    copies overlapped its compares (one block a tile: copy, wait, sync,
    compare): a timing control, on no path."""
    return _fused_mxu_both("disco_window_compare_staged_both_unpipelined",
                           verify_windows_fused_mxu_both_unpipelined,
                           packed_lines, rows1, rows2, o1, o2, n, n_words)


verify_windows_fused_mxu_both_unpipelined.launches = 0
verify_windows_fused_mxu_both_unpipelined.out_of_window = None
