"""The rows T1's and K5's kernels stage (disco_tpu_torch.tools.
exp_fetch_variants.sync_rows, overlap.fused_kernel.both_windows: the Python
statements of csrc/tile_ring.cuh AnchoredRows and csrc/window_staged.cu
window_compare_ring_both) against the window rules their counts follow
(sync_misses, _both_misses), written out here in numpy: a pair's row is
staged by its tile exactly when the rule counts it inside its window, so
`out_of_window` is the rule's count.

Rows sorted, random (some outside the table) and BFS-relabeled; P not a
multiple of 1024; pairs with n = 0, which the rules count like any other."""
import numpy as np
import pytest
import torch

from disco_tpu_torch.overlap import fused_kernel as fk
from disco_tpu_torch.overlap.locality import relabel_workload
from disco_tpu_torch.tools import exp_fetch_variants as fv

TILE = fk.TILE
N_ROWS = 4096


def _rows(order, p, seed):
    """(rows1, rows2, n): rows1 sorted, random or BFS-relabeled, rows2
    near rows1 (as a candidate's read2 lies near its read1 after the
    relabel) or random; n = 0 on every fifth pair."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, 200, p)
    n[::5] = 0
    if order == "random":
        return (rng.integers(-3, N_ROWS + 3, p), rng.integers(-3, N_ROWS + 3,
                                                              p), n)
    rows1 = np.sort(rng.integers(0, N_ROWS // 2, p))
    rows2 = np.clip(rows1 + rng.integers(-300, 300, p), 0, N_ROWS // 2 - 1)
    if order == "sorted":
        return rows1, rows2, n
    n_reads = N_ROWS // 4
    packed = rng.integers(0, 2 ** 32, (2 * n_reads, 17),
                          dtype=np.uint64).astype(np.uint32)
    r1, r2 = rows1 % n_reads, rows2 % (2 * n_reads)
    _, q1, q2, _, _, _, _, qn = relabel_workload(n_reads, packed, r1, r2,
                                                 np.zeros(p), np.zeros(p), n)
    return np.asarray(q1, np.int64), np.asarray(q2, np.int64), qn


def _in_window(rows, first, cap):
    """The window rule: the row lies in [max(first, 0), min(first + cap,
    N_ROWS)), first per pair."""
    return (rows >= np.maximum(first, 0)) & (rows < np.minimum(first + cap,
                                                               N_ROWS))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64))


ORDERS = ["sorted", "random", "relabeled"]
SIZES = [1, 255, 1023, 1025, 3001]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("p", SIZES)
def test_t1_stages_exactly_the_rows_inside_its_window(order, p):
    """T1: 64 rows from the 1024-pair tile's first row & ~3, staged per
    tile of 256 pairs (the main path's) and of the narrower tiles of wide
    columns."""
    rows1, _, _ = _rows(order, p, seed=p)
    first = (rows1[::TILE] & ~3)[np.arange(p) // TILE]
    want = _in_window(rows1, first, fv.SYNC_ROWS)
    assert int(fv.sync_misses(N_ROWS, _t(rows1))) == int((~want).sum())
    for tile in (256, 128, 32):
        lo, count = fv.sync_rows(N_ROWS, _t(rows1), tile)
        assert len(lo) == -(-p // tile)
        assert (count <= fv.SYNC_ROWS).all()
        staged = fk.staged_mask(_t(rows1), lo, count, tile).numpy()
        np.testing.assert_array_equal(staged, want, err_msg=str(tile))
    if order == "random" and p > 1:
        assert not want.all()


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("p", SIZES)
def test_k5_stages_exactly_the_rows_inside_its_windows(order, p):
    """K5: per 1024-pair tile, 192 rows from its least read1 row and 384
    from its least read2 row, over all its pairs."""
    rows1, rows2, _ = _rows(order, p, seed=p + 1)
    t = np.arange(p) // TILE
    missed = 0
    windows = fk.both_windows(N_ROWS, _t(rows1), _t(rows2))
    for rows, cap, (lo, count) in zip((rows1, rows2), fk.BOTH_ROWS, windows):
        first = np.minimum.reduceat(rows, np.arange(0, p, TILE))[t]
        want = _in_window(rows, first, cap)
        staged = fk.staged_mask(_t(rows), lo, count).numpy()
        np.testing.assert_array_equal(staged, want)
        assert (count <= cap).all()
        missed += int((~want).sum())
    assert int(fk._both_misses(N_ROWS, _t(rows1), _t(rows2))) == missed
    if order == "random" and p > 1:
        assert missed > 0

