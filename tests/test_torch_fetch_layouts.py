"""The reads of K6's and T3's kernels, in numpy, through their Python
statements:

- K6 (disco_tpu_torch.overlap.fused_kernel.row_words, the statement of
  csrc/window.cuh row_words): for every word offset (before, inside and
  past the 16-word row) and rows outside the table, the words a thread
  holds of a row are the row's words d .. d + 16 with zeros past the row,
  so every word a window of at most 16 compared words reads is held;
- T3 (disco_tpu_torch.tools.exp_mxu_fetch.span_copies, the statement of
  csrc/window_staged.cu stage_span; `_window_word` and `_stage_words`
  restate sum_window and sum_stage_words): for every
  first row of a tile's window (rows past both ends of the table too) and
  every 16-B phase of the table, the copies move each word of the window's
  rows exactly once, to the stage word where the sum reads it, 16-B copies
  are aligned on both sides, and the window is the one checksum_misses
  counts."""
import numpy as np
import pytest
import torch

from disco_tpu_torch.overlap import fused_kernel as fk
from disco_tpu_torch.tools import exp_mxu_fetch as mf

N_ROWS = 300


def _stage_words(wt):
    """Words of one stage of T3's ring: the 32-row window at stride wt | 1
    and 4 words of room for the span copy's alignment shift."""
    return mf.SUM_ROWS * (wt | 1) + 4


def _window_word(wt, shift, k, c):
    """The stage word where T3's ring reads word c of the window's row k."""
    return shift + k * (wt | 1) + c
FIRSTS = [-40, -32, -31, -5, -1, 0, 1, 2, 3, 5, 101, 267, 268, 269, 271,
          298, 299, 300, 310]


def _words(start, width):
    """Every word the copies (start, width) move, in copy order."""
    return np.concatenate([s + np.arange(w) for s, w in zip(start, width)]
                          ) if len(start) else np.zeros(0, np.int64)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("wt", [17, 16, 400])
def test_t3_span_copies_cover_the_window(wt, offset):
    for first in FIRSTS:
        src, dst, width, shift = mf.span_copies(N_ROWS, wt, first, offset)
        lo, count = (int(x) for x in fk.window_rows(
            torch.tensor(first), torch.tensor(first + mf.SUM_ROWS - 1),
            mf.SUM_ROWS, N_ROWS))
        s, d = _words(src, width), _words(dst, width)
        want = (lo * wt + np.arange(count * wt))
        np.testing.assert_array_equal(np.sort(s), want, err_msg=str(first))
        k, c = np.divmod(s - lo * wt, wt)
        np.testing.assert_array_equal(d, _window_word(wt, shift, k, c))
        assert len(np.unique(d)) == len(d)
        wide = width == 4
        assert ((src[wide] + offset) % 4 == 0).all()
        assert (dst[wide] % 4 == 0).all()
        assert (d < _stage_words(wt)).all() and (d >= 0).all()
        if wt % 2:
            # one span: 4-B copies only up to the first 16-B boundary and
            # after the last
            assert (width == 1).sum() <= 6
            assert 0 <= shift < 4
        else:
            assert shift == 0 and (width == 1).all()


@pytest.mark.parametrize("wt", [17, 16, 400])
def test_t3_stages_are_16_byte_aligned(wt):
    """Each stage starts 16-B aligned and holds the window at its widest
    shift."""
    assert _stage_words(wt) % 4 == 0
    assert _window_word(wt, 3, mf.SUM_ROWS - 1, wt - 1) < \
        _stage_words(wt)


def _padded_words(table, rows, d):
    """Words d .. d + 16 of each row, zeros past the row and for a
    row outside the table (numpy, word by word)."""
    out = np.zeros((len(rows), 17), np.int64)
    for p, (r, dd) in enumerate(zip(rows, d)):
        for i in range(17):
            w = dd + i
            if 0 <= r < len(table) and 0 <= w < table.shape[1]:
                out[p, i] = table[r, w]
    return out


def _table16(n_rows, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 31, 2 ** 31, (n_rows, 16)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k6_holds_every_word_a_window_reads(seed):
    """Every word offset from before the row to past it, rows inside the
    table and outside it at both ends."""
    table = _table16(50, seed)
    d = np.arange(-24, 40)
    rows = np.resize([-3, -1, 0, 7, 49, 50, 53], len(d))
    got = fk.row_words(torch.from_numpy(table), torch.from_numpy(rows),
                       torch.from_numpy(d))
    assert got.shape == (len(d), 17) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _padded_words(table, rows, d))
