"""The port's overlap-locality relabel (disco_tpu_torch.overlap.locality)
against disco_tpu.overlap.locality: the same labels, the same permutation
and the same relabeled table.  Tolerance: exact — integer arrays."""
import numpy as np
import pytest

from disco_tpu.overlap import locality as ref
from disco_tpu_torch.overlap import locality as port


def _graph(seed, n_reads=500, p=3000):
    """Candidate pairs over n_reads reads: a sorted read1 side, read2 rows
    of the stacked [fwd | rc] table, a few isolated reads, repeated pairs
    and pairs of a read with itself."""
    rng = np.random.default_rng(seed)
    r1 = np.sort(rng.integers(0, n_reads - 20, p)).astype(np.int32)
    r2 = (r1 + rng.integers(-15, 16, p)).clip(0, n_reads - 21)
    r2[::11] = r1[::11]
    r2[::7] = rng.integers(0, n_reads - 20, len(r2[::7]))
    rows2 = (r2 + n_reads * rng.integers(0, 2, p)).astype(np.int32)
    return rng, r1, rows2


@pytest.mark.parametrize("seed", [0, 1])
def test_bfs_labels_identical(seed):
    _, r1, rows2 = _graph(seed)
    r2 = rows2 % 500
    want = ref.bfs_labels(500, r1, r2)
    got = port.bfs_labels(500, r1, r2)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert sorted(got) == list(range(500))


def test_relabel_workload_identical():
    rng, r1, rows2 = _graph(seed=3)
    packed_all = rng.integers(0, 2**32, (1000, 17), dtype=np.uint64).astype(
        np.uint32)
    extra = [rng.integers(0, 250, len(r1)).astype(np.int32) for _ in range(3)]
    want = ref.relabel_workload(500, packed_all, r1, rows2, *extra)
    got = port.relabel_workload(500, packed_all, r1, rows2, *extra)
    assert len(got) == len(want) == 8
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
