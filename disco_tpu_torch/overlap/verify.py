"""Packed-word window verification on torch tensors (the counterpart of
disco_tpu/overlap/verify.py).

These are the plain versions the CUDA kernels of `overlap/fused_kernel.py`
and `overlap/pallas_kernel.py` are held against; `verify_windows_pallas`
puts the compare of pallas_kernel.py (K7) behind the same row-gather and
align preamble as disco_tpu.

The core check: fwd(read1)[o1 : o1+n] == s2[o2 : o2+n], where s2 is either
fwd(read2) or rc(read2).  Windows are aligned to word 0, bit 0 (word roll
plus a bit funnel over the successor word) and compared word by word with
the final partial word masked (reference: the byte-wise std::string::substr
compares of src/BuildGraph/src/OverlapGraph.cpp:534,549,581,593).

Packed words are int32 tensors carrying the uint32 bits: torch has no
uint32 shifts on the CPU, so every right shift is arithmetic and is masked
afterwards (`_srl32`).  Left shifts wrap, which gives the uint32 bits."""
import numpy as np
import torch


def _srl32(x: torch.Tensor, t) -> torch.Tensor:
    """Logical right shift of the uint32 bits in int32 `x` by `t` (int or
    tensor, 1 <= t <= 31).  The result is non-negative, so it fits int32."""
    t = torch.as_tensor(t, dtype=torch.int64, device=x.device)
    mask = (torch.ones_like(t) << (32 - t)) - 1
    return ((x.to(torch.int64) >> t) & mask).to(torch.int32)


def align_window(blk: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Align each row's window to word 0, bit 0: roll the (P, Wp) int32
    block left by o//16 words (log-step masked rolls; the roll wraps, and
    wrapped words only reach masked-off positions of a window that lies
    inside its row) and funnel-shift left by 2*(o%16) bits."""
    wp = blk.shape[1]
    o = o.to(torch.int32)
    d = o >> 4                                   # floor(o / 16)
    x = blk
    b = 0
    while (1 << b) < wp:
        sel = ((d >> b) & 1) == 1
        x = torch.where(sel[:, None], torch.roll(x, -(1 << b), dims=1), x)
        b += 1
    s = ((o & 15) << 1)[:, None]                 # 2 * (o % 16)
    nxt = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
    return _funnel(x, nxt, s)


def _funnel(x: torch.Tensor, nxt: torch.Tensor, s) -> torch.Tensor:
    """The top 32 bits of (x : nxt) << s, s in 0..31 (s == 0 gives x)."""
    # (nxt >> (32 - s)) in two steps: a shift by 32 is undefined
    lo = _srl32(_srl32(nxt, 31 - s), 1)
    return torch.where(s == 0, x, (x << s) | lo)


def _masked_equal(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor,
                  n_words: int) -> torch.Tensor:
    """AND over word steps of (a[:, wi] == b[:, wi]) under the window
    length mask; n == 0 rows come out True."""
    n = n.to(torch.int32)
    ok = torch.ones(a.shape[:1], dtype=torch.bool, device=a.device)
    full = torch.tensor(-1, dtype=torch.int32, device=a.device)
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    for wi in range(n_words):
        rem = n - 16 * wi
        partial = full << (2 * (16 - rem.clamp(1, 16)))
        mask = torch.where(rem >= 16, full,
                           torch.where(rem <= 0, zero, partial))
        ok &= ((a[:, wi] ^ b[:, wi]) & mask) == 0
    return ok


def verify_windows(packed_all, rows1, rows2, o1, o2, n, *, n_words):
    """packed_all: (2N, W+1) int32 — forward reads stacked over rc reads.
    rows1/rows2: (P,) row indices into packed_all (caller adds N for rc).
    o1/o2: (P,) base offsets; n: (P,) window lengths (0 => True).
    Returns (P,) bool."""
    blk1 = align_window(packed_all[rows1.long()], o1)
    blk2 = align_window(packed_all[rows2.long()], o2)
    return _masked_equal(blk1, blk2, n, n_words)


def _window_word(packed, rows, base_off, wi):
    """The word covering bases [base_off + 16 wi, +16) of each row, by
    per-element gathers.  Word indices outside the row follow JAX's gather:
    a negative index counts from the end, then it is clamped to the row."""
    w = packed.shape[1]

    def col(idx):
        idx = torch.where(idx < 0, idx + w, idx).clamp(0, w - 1)
        return packed[rows, idx]

    word_idx = (base_off >> 4) + wi
    bit = ((base_off & 15) << 1).to(torch.int32)
    return _funnel(col(word_idx), col(word_idx + 1), bit)


def verify_windows_gather(packed_all, rows1, rows2, o1, o2, n, *, n_words):
    """The per-element-gather formulation of `verify_windows`, a second
    independent implementation for cross-checking the aligned path."""
    rows1, rows2 = rows1.long(), rows2.long()
    o1, o2 = o1.long(), o2.long()
    n = n.to(torch.int32)
    ok = torch.ones(rows1.shape, dtype=torch.bool, device=rows1.device)
    for wi in range(n_words):
        x = _window_word(packed_all, rows1, o1, wi)
        y = _window_word(packed_all, rows2, o2, wi)
        ok &= _masked_equal(x[:, None], y[:, None], n - 16 * wi, 1)
    return ok


def verify_windows_pallas(packed_all, rows1, rows2, o1, o2, n, *, n_words):
    """Same contract as verify_windows: the row gathers and `align_window`
    as there, then the aligned (W+1, P) columns go through `compare_windows`
    (K7, overlap/pallas_kernel.py) with zero bit phases."""
    from .pallas_kernel import compare_windows

    a = align_window(packed_all[rows1.long()], o1).T.contiguous()
    b = align_window(packed_all[rows2.long()], o2).T.contiguous()
    zero = torch.zeros(a.shape[1], dtype=torch.int32, device=a.device)
    return compare_windows(a, b, zero, zero, n)


def as_words(x: np.ndarray, device=None) -> torch.Tensor:
    """A uint32 numpy array as an int32 tensor holding the same bits."""
    x = np.ascontiguousarray(x, np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def make_packed_all(packed: np.ndarray, packed_rc: np.ndarray,
                    device=None) -> torch.Tensor:
    """Stack forward and rc packed reads: rows [0,N) forward, [N,2N) rc,
    as one (2N, W+1) int32 tensor on `device`."""
    return as_words(np.concatenate([packed, packed_rc], axis=0), device)
