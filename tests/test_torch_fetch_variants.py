"""The fetch-experiment kernels and tools of disco_tpu_torch.tools against
tools/exp_fetch_variants.py, exp_mxu_fetch.py and exp_locality.py, on the
CPU, where the wrappers run their plain versions.

- T1 (`verify_sync`) and T2 (`verify_pipe_nc`) against the tool's JAX
  functions under `force_tpu_interpret_mode()`, on the centred 4096-pair
  slice of the 20 kb set's r1-sorted candidates, where every tile's rows
  lie inside the TPU kernels' windows (they have no guard); and against the
  plain `verify_windows` on inputs that break that precondition;
- T3 (`fetch_checksum`) against the tool's numpy checksum;
- `bfs_order`, `tile_stats` and the window accounting against
  exp_locality.py;
- the staged kernels' out-of-window counts on batches built to miss;
- each entry point's `main` raises without a card.
Tolerance: exact — booleans and integers."""
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from disco_tpu.overlap import fused_kernel as jfk
from disco_tpu.overlap import verify as jv
from disco_tpu_torch import bench_verify as bv
from disco_tpu_torch.overlap import fused_kernel as fk
from disco_tpu_torch.overlap import verify as pv
from disco_tpu_torch.tools import exp_fetch_variants as fv
from disco_tpu_torch.tools import exp_locality as loc
from disco_tpu_torch.tools import exp_mxu_fetch as mf
from test_torch_native import private_native  # noqa: F401
from tools import exp_fetch_variants as jfv
from tools import exp_locality as jloc

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)

SLICE = 4096
TILE = fk.TILE


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """The 20 kb set of tests/test_torch_bench_verify.py: (store, r1,
    rows2, o1, o2, n) from bench_verify.candidate_batch (equal to
    bench.py's there)."""
    fasta = tmp_path_factory.mktemp("fetch_variants") / "small.fasta"
    subprocess.run(
        [sys.executable, str(bv.ROOT / "tools" / "make_testdata.py"),
         str(fasta), "--genome-len", "20000", "--coverage", "25",
         "--read-len", "250", "--insert", "600", "--seed", "7",
         "--error-rate", "0.002"],
        check=True, stdout=subprocess.DEVNULL)
    return bv.candidate_batch(fasta)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _slice(batch):
    store, *arrays = batch
    sl = bv.centred_slice(len(arrays[0]), SLICE)
    pa = np.concatenate([store.packed, store.packed_rc])
    return store, pa, [np.ascontiguousarray(x[sl], np.int32) for x in arrays]


@pytest.mark.parametrize("variant", ["sync", "pipe_nc"])
def test_t1_t2_match_the_tool(batch, variant):
    store, pa, args = _slice(batch)
    rows1 = args[0]
    # the TPU kernels' precondition (no guard): T1's rows within 64 of the
    # tile's first row & ~3, T2's within 128 of its 64-row block
    r1t = rows1.reshape(-1, TILE)
    assert (r1t - (r1t[:, :1] & ~3)).max() < 64
    assert (r1t - (r1t[:, :1] & ~63)).max() < 128
    lines = jfk.pack_lines(pa)[0]
    ref = {"sync": jfv.verify_sync, "pipe_nc": jfv.verify_pipe_nc}[variant]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref(lines, pa, *args))
    plain = np.asarray(jv.verify_windows(pa, *args, n_words=store.n_words))
    np.testing.assert_array_equal(want, plain)
    port = {"sync": fv.verify_sync, "pipe_nc": fv.verify_pipe_nc}[variant]
    got = port(pv.as_words(fk.pack_lines(pa)[0]), pv.as_words(pa),
               *map(_t, args))
    assert got.dtype == torch.bool and got.shape == (SLICE,)
    np.testing.assert_array_equal(got.numpy(), want)
    live = args[4] > 0
    assert want[live].any() and not want[live].all()
    assert port.launches == 0                       # no kernel on the CPU


@pytest.mark.parametrize("p", [1, 3001])
def test_t1_t2_exact_where_the_tpu_needs_its_window(batch, p):
    """Random rows1 (tiles far wider than any window), any P: both equal
    verify_windows, and T1 counts the reads outside its windows."""
    store, pa, _ = _slice(batch)
    rng = np.random.default_rng(p)
    rows1 = rng.integers(0, len(pa), p)
    rows2 = rng.integers(0, len(pa), p)
    o1 = rng.integers(0, 120, p)
    o2 = rng.integers(0, 120, p)
    n = rng.integers(0, 130, p)
    same = np.arange(p) % 3 == 0
    rows2[same], o2[same] = rows1[same], o1[same]
    args = [_t(x) for x in (rows1, rows2, o1, o2, n)]
    table = pv.as_words(pa)
    want = pv.verify_windows(table, *args, n_words=store.n_words)
    lines = pv.as_words(fk.pack_lines(pa)[0])
    for port in (fv.verify_sync, fv.verify_pipe_nc):
        np.testing.assert_array_equal(port(lines, table, *args).numpy(),
                                      want.numpy())
    first = (rows1[::TILE] & ~3)[np.arange(p) // TILE]
    outside = int(((rows1 < first) | (rows1 >= first + 64)).sum())
    assert int(fv.verify_sync.out_of_window) == outside
    if p > 1:
        assert outside > 0


def test_sync_counts_no_miss_on_sorted_tiles(batch):
    _, pa, args = _slice(batch)
    fv.verify_sync(pv.as_words(fk.pack_lines(pa)[0]), pv.as_words(pa),
                   *map(_t, args))
    assert int(fv.verify_sync.out_of_window) == 0


@pytest.mark.parametrize("salt", [0, 1])
def test_t3_matches_the_tool_checksum(batch, salt):
    store, r1, *_ = batch
    pa = np.concatenate([store.packed, store.packed_rc])
    rows, bases = mf.sorted_tiles(r1, max_tiles=4)
    assert len(bases) == 4 and (bases == rows[::TILE]).all()
    got = mf.fetch_checksum(pv.as_words(pa), _t(rows), _t(bases), salt)
    assert got.dtype == torch.int32
    want = mf.checksum_numpy(pa, rows, salt)
    # the tool's own expression, exp_mxu_fetch.py:159-161
    tool = np.sum((pa[rows + salt] & 0x7FFF).astype(np.int64), axis=1)
    np.testing.assert_array_equal(want, tool)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).all()
    assert int(mf.fetch_checksum.out_of_window) == 0
    assert mf.fetch_checksum.launches == 0


def test_t3_rows_outside_windows_and_table():
    rng = np.random.default_rng(3)
    table = rng.integers(0, 2 ** 32, (500, 17), dtype=np.uint64).astype(
        np.uint32)
    p = 2 * TILE + 100
    rows = rng.integers(-3, 503, p)
    bases = np.sort(rng.integers(0, 400, 3))
    got = mf.fetch_checksum(pv.as_words(table), _t(rows), _t(bases), 1)
    r = rows + 1
    inside = (r >= 0) & (r < 500)
    want = np.where(inside, mf.checksum_numpy(table, np.clip(r, 0, 499)),
                    0)
    np.testing.assert_array_equal(got.numpy(), want)
    first = (bases + 1)[np.arange(p) // TILE]
    lo, hi = np.maximum(first, 0), np.minimum(first + 32, 500)
    assert int(mf.fetch_checksum.out_of_window) == int(
        ((r < lo) | (r >= hi)).sum())
    with pytest.raises(ValueError, match="bases"):
        mf.fetch_checksum(pv.as_words(table), _t(rows), _t(bases[:2]), 0)


def test_locality_functions_are_the_tool_s(batch):
    store, r1, rows2, *_ = batch
    r1 = np.asarray(r1, np.int64)
    rows2 = np.asarray(rows2, np.int64)
    r2 = rows2 % store.n_reads
    label = loc.bfs_order(store.n_reads, r1, r2)
    np.testing.assert_array_equal(label,
                                  jloc.bfs_order(store.n_reads, r1, r2))
    for rows in (2 * r1, 2 * r2, 2 * label[r1], rows2[:5000]):
        assert loc.tile_stats(rows) == jloc.tile_stats(rows)


@pytest.mark.parametrize("wb", [256, 512, 1024])
def test_spill_percent_is_the_tool_s(batch, wb):
    """The window accounting of exp_locality.py:94-101, in numpy, against
    `spill_percent` over the relabeled read2 rows."""
    store, r1, rows2, *_ = batch
    r1 = np.asarray(r1, np.int64)
    rows2 = np.asarray(rows2, np.int64)
    r2, rc = rows2 % store.n_reads, rows2 // store.n_reads
    label = loc.bfs_order(store.n_reads, r1, r2)
    order = np.argsort(label[r1], kind="stable")
    nrows2s = (2 * label[r2] + rc)[order]
    nt = len(nrows2s) // TILE
    t2 = nrows2s[:nt * TILE].reshape(nt, TILE)
    med = np.median(t2, axis=1).astype(np.int64)
    base = np.maximum((med - wb // 2) & ~63, 0)
    inside = (t2 >= base[:, None]) & (t2 < base[:, None] + wb)
    want = 100 * (1 - inside.mean())
    assert loc.spill_percent(torch.from_numpy(nrows2s), wb) == want


@pytest.mark.parametrize("tool", [fv, mf, loc])
def test_main_needs_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main([])
    with pytest.raises(ValueError, match="CUDA card"):
        tool.main(["--device", "cpu"])
