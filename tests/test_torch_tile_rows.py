"""The row range K3's and K4's tiled kernels stage for each tile of pairs
(disco_tpu_torch.overlap.fused_kernel.tile_rows, the Python statement of
csrc/window.cuh tile_rows), and chip_smoke.py's sector count built on the
same words (column_sectors).  Every word the compare reads inside the row
lies in its tile's staged rows, so the tiled kernels are exact; the count
lies between the words the windows span and the whole columns."""
import numpy as np
import pytest
import torch

import chip_smoke
from disco_tpu_torch.overlap import fused_kernel as fk

M32 = 0xFFFFFFFF


def _reads(a, d1, s1, b, d2, s2, n):
    """The word indices csrc/window.cuh window_equal_at reads of rows a and
    b (python ints), in order, with its early exit; a word outside the row
    reads as 0."""
    def word(row, w):
        return int(row[w]) if 0 <= w < len(row) else 0

    def funnel(cur, nxt, s):
        return (((cur << 32) | nxt) << s >> 32) & M32

    d1, s1, d2, s2, n = map(int, (d1, s1, d2, s2, n))
    if n <= 0:
        return [], []
    ra, rb = [d1], [d2]
    a_cur, b_cur = word(a, d1), word(b, d2)
    wi, rem = 0, n
    while rem > 0:
        ra.append(d1 + wi + 1)
        rb.append(d2 + wi + 1)
        a_nxt, b_nxt = word(a, d1 + wi + 1), word(b, d2 + wi + 1)
        mask = M32 if rem >= 16 else (M32 << (2 * (16 - rem))) & M32
        if (funnel(a_cur, a_nxt, s1) ^ funnel(b_cur, b_nxt, s2)) & mask:
            break
        a_cur, b_cur = a_nxt, b_nxt
        wi, rem = wi + 1, rem - 16
    return ra, rb


def _batch(seed, p, w, n_rows=64):
    """Random rows of w words and windows at any phase: inside the row,
    running past it, starting before it (negative offsets), n = 0 on every
    seventh pair and on a whole tile of 256, and true matches on every
    third pair (no early exit)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2 ** 32, (n_rows, w), dtype=np.uint64)
    rows1 = rng.integers(0, n_rows, p)
    rows2 = rng.integers(0, n_rows, p)
    o1 = rng.integers(-20, 16 * (w + 2), p)
    o2 = rng.integers(-20, 16 * (w + 2), p)
    n = rng.integers(0, 16 * (w + 1), p)
    same = np.arange(p) % 3 == 0
    rows2[same], o2[same] = rows1[same], o1[same]
    n[::7] = 0
    n[256:512] = 0
    return table, rows1, rows2, o1, o2, n


@pytest.mark.parametrize("p,w,tile", [(3001, 17, 256), (700, 2, 256),
                                      (1000, 32, 64)])
def test_every_word_read_lies_in_its_tiles_rows(p, w, tile):
    table, rows1, rows2, o1, o2, n = _batch(seed=p + w, p=p, w=w)
    t = torch.from_numpy
    lo1, rows_a = fk.tile_rows(t(o1), t(n), w, tile)
    lo2, rows_b = fk.tile_rows(t(o2), t(n), w, tile)
    first, last = fk.read_words(t(o1), t(n), w)
    reads = 0
    for i in range(p):
        ra, rb = _reads(table[rows1[i]], o1[i] >> 4, 2 * (o1[i] & 15),
                        table[rows2[i]], o2[i] >> 4, 2 * (o2[i] & 15), n[i])
        k = i // tile
        for got, lo, rows in ((ra, lo1[k], rows_a[k]), (rb, lo2[k],
                                                        rows_b[k])):
            inside = [x for x in got if 0 <= x < w]
            reads += len(inside)
            assert all(lo <= x < lo + rows for x in inside), (i, got)
        inside = sorted({x for x in ra if 0 <= x < w})
        if n[i] > 0 and rows1[i] == rows2[i] and o1[i] == o2[i] and inside:
            # no early exit: read_words is exactly the words read in the row
            assert (first[i], last[i]) == (inside[0], inside[-1]), i
    assert reads > 0
    if tile == 256:                      # the tile whose every n is 0
        assert int(rows_a[1]) == int(rows_b[1]) == 0


def test_tile_rows_are_the_tiles_hull():
    _, _, _, o1, _, n = _batch(seed=5, p=2000, w=17)
    lo, rows = fk.tile_rows(torch.from_numpy(o1), torch.from_numpy(n), 17,
                            256)
    for k in range(len(lo)):
        sl = slice(256 * k, 256 * (k + 1))
        live = n[sl] > 0
        d = o1[sl][live] >> 4
        last = d + (n[sl][live] + 15) // 16
        if not live.any() or max(d.min(), 0) > min(last.max(), 16):
            assert int(rows[k]) == 0
            continue
        want_lo, want_hi = max(d.min(), 0), min(last.max(), 16)
        assert (int(lo[k]), int(rows[k])) == (want_lo, want_hi - want_lo + 1)


def test_sector_count_between_span_and_whole_columns():
    """Windows inside rows of 17 words (P a multiple of 8): the words the
    windows span <= the read sectors <= the whole columns; a hand-made
    case counts exactly."""
    rng = np.random.default_rng(11)
    p, w = 4096, 17
    o = rng.integers(0, 16 * (w - 2), p)
    n = np.minimum(rng.integers(0, 300, p), 16 * (w - 1) - o)
    n[::7] = 0
    o, n = torch.from_numpy(o), torch.from_numpy(n)
    sectors = chip_smoke.column_sectors(o, n, w)
    span_bytes = 4 * int(chip_smoke.span(o, n).sum())
    assert span_bytes <= 32 * sectors <= 4 * w * p
    assert span_bytes < 32 * sectors          # the one-past words, groups
    # 9 pairs reading words 0..3 (n = 48 at offset 0): two groups of 4
    o9, n9 = torch.zeros(9, dtype=torch.int32), torch.full((9,), 48)
    assert chip_smoke.column_sectors(o9, n9, w) == 8
    assert chip_smoke.column_sectors(o9, torch.zeros(9), w) == 0
    floor = chip_smoke.sector_floor(9, 8, 96, 4)
    assert floor["sector_bytes"] == 32 * 8 + 9 * 17 + 96
    assert floor["sector_floor_ms"] == pytest.approx(
        1e3 * floor["sector_bytes"] / chip_smoke.HBM_BYTES_PER_S)
