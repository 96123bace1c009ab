"""Fetch experiments on one CUDA card (the counterpart of
tools/exp_fetch_variants.py): where read1's row of a verify pair comes from,
and what each choice costs.

    python -m disco_tpu_torch.tools.exp_fetch_variants [--device cuda]

The workload is bench.py's (bench_verify.candidate_batch over the 400 kb /
25x / 250 bp set, MinOverlap 40), its centred slice of 2^18 r1-sorted
pairs.  Variants, each bit-checked pair by pair against `fused` on the same
pairs:

    fused    bench_verify's `fused`: two row gathers, then K3
    sync     verify_sync (T1): read1's row from a 64-row window staged in
             shared memory, anchored at the tile's first row & ~3
    pipe     verify_windows_fused_mxu over (lines, packed_all) (K4)
    pipe_nc  verify_pipe_nc (T2): the same kernel as pipe, under its own
             launch count (on the TPU: K4's body without its guard)
    gather   read2's row gather alone (no check; the serial component)
    both     verify_windows_fused_mxu_both (K5) after the BFS relabel over
             the full candidate graph, checked against `fused` on the same
             relabeled pairs
    both16   verify_windows_fused_mxu_both16 (K6), the same relabel

Each rate is pairs over the mean device time of a call by CUDA events,
over many calls on the inputs rolled by (i % 4) tiles (the tool's
i-dependent indices; every tile keeps its rows).  The measurement is of a
card: --device must name a CUDA device.  On the CPU the wrappers run their
plain versions through tests/test_torch_fetch_variants.py."""
import argparse
import itertools
import pathlib
import sys
import tempfile

import numpy as np
import torch

from .. import bench_verify as bv
from ..overlap import fused_kernel as fk
from ..overlap.locality import relabel_workload
from ..overlap.verify import as_words

TILE = fk.TILE
SYNC_ROWS = 64   # T1's staged rows a tile (the TPU's 16 lines of 4 rows)


def _tables(lines, packed_orig, rows2):
    """The 32-word row view of `lines` and read2's (Wp, P) columns gathered
    from the packed table, as K4's wrapper and the tool gather them (the
    tool's zero words past Wp are the columns' reads past Wb)."""
    fk._check_lines(lines)
    if packed_orig.dim() != 2 or packed_orig.shape[1] > fk.W32:
        raise ValueError(f"packed table of shape {tuple(packed_orig.shape)},"
                         " not (2N, <= 32)")
    return fk._mxu_tables((lines, packed_orig), rows2)


def sync_misses(n_rows, rows1):
    """The row reads of `verify_sync` outside its windows."""
    r = rows1.long()
    first = r[::TILE] & ~3
    return fk.window_misses(r, first, first + SYNC_ROWS - 1, SYNC_ROWS,
                            n_rows)


def verify_sync_plain(lines, packed_orig, rows1, rows2, o1, o2, n):
    """Plain version of `verify_sync` (and of `verify_pipe_nc`)."""
    table, b = _tables(lines, packed_orig, rows2)
    return fk.fused_compare_fetch_plain(table, b, rows1, o1, o2, n)


def verify_sync(lines, packed_orig, rows1, rows2, o1, o2, n):
    """T1: verify_windows with read1's row read from a window of 64 rows of
    the `pack_lines` table staged for each tile of TILE pairs, anchored at
    the tile's first row & ~3, and read2's rows gathered from the packed
    table.  lines: (L, 128) int32; packed_orig: (2N, Wp) int32, Wp <= 32;
    rows1 (r1-sorted)/rows2/o1/o2/n: (P,) int32, any P.  Returns (P,) bool;
    `out_of_window` then holds the row reads outside the windows.  The TPU
    version needs P % TILE == 0 and every tile's rows inside its window
    (no guard); this one is exact for every input."""
    p = rows1.numel()
    fk._check((lines, packed_orig), (rows1, rows2, o1, o2, n), p)
    ok, misses, launched = compare_staged(
        *_tables(lines, packed_orig, rows2), rows1, o1, o2, n)
    verify_sync.launches += launched
    verify_sync.out_of_window = misses
    return ok


verify_sync.launches = 0
verify_sync.out_of_window = None


def compare_staged(table, b, rows1, o1, o2, n):
    """T1's launch without its count: table (R, Wt) int32 rows, of which
    the first Wb are staged; b (Wb, P) int32 columns of read2's rows;
    rows1/o1/o2/n (P,) int32.  Returns (ok, the row reads outside the
    windows as a 0-dim int64 tensor, whether the kernel was launched)."""
    p = rows1.numel()
    dev = fk._check((table, b, rows1), (o1, o2, n), p)
    if table.dim() != 2 or b.dim() != 2 or b.shape[1] != p:
        raise ValueError(f"table {tuple(table.shape)} and b "
                         f"{tuple(b.shape)}: need (R, Wt) and (Wb, P)")
    n_rows, wt = table.shape
    if dev.type == "cpu":
        return (fk.fused_compare_fetch_plain(table, b, rows1, o1, o2, n),
                sync_misses(n_rows, rows1), False)
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    if p == 0:
        return ok, misses[0], False
    with torch.cuda.device(dev):
        err = fk.load_staged().disco_window_compare_staged(
            table.data_ptr(), n_rows, wt, min(wt, b.shape[0]), b.data_ptr(),
            b.shape[0], rows1.data_ptr(), p, o1.data_ptr(), o2.data_ptr(),
            n.data_ptr(), ok.data_ptr(), misses.data_ptr(), fk._stream(dev))
    fk._raise_on(err, "window_compare_staged")
    return ok, misses[0], True


def verify_pipe_nc(lines, packed_orig, rows1, rows2, o1, o2, n):
    """T2: the tool's K4 call without the guard.  On the TPU it is K4's
    Pallas body (_mxu2_kernel) called directly; here it is K4's kernel
    (window_compare_fetch, which has no guard) counted under this wrapper's
    `launches`.  Arguments as `verify_sync`; returns (P,) bool."""
    p = rows1.numel()
    fk._check((lines, packed_orig), (rows1, rows2, o1, o2, n), p)
    table, b = _tables(lines, packed_orig, rows2)
    ok, launched = fk.compare_fetch(table, b, rows1, o1, o2, n)
    verify_pipe_nc.launches += launched
    return ok


verify_pipe_nc.launches = 0


# ---------------------------------------------------------------------------
def bench_batch():
    """bench.py's candidate batch (store, r1, rows2, o1, o2, n)."""
    with tempfile.TemporaryDirectory(prefix="exp_fetch_") as td:
        fasta = pathlib.Path(td) / "bench.fasta"
        bv.make_dataset(fasta)
        return bv.candidate_batch(fasta)


def rolled(args, n=4):
    """The argument tuples rolled by 0 .. n-1 whole tiles."""
    return [tuple(torch.roll(x, i * TILE) for x in args) for i in range(n)]


def cycled_ms(fn, variants, min_seconds: float = 1.0) -> float:
    """Mean device ms of fn over calls that cycle through `variants`."""
    it = itertools.cycle(variants)
    return bv.device_ms(lambda: fn(*next(it)), min_seconds)


def _report(label, fn, args, want=None, extra=""):
    """Time fn over the rolled args and print the tool's line; returns
    whether the pair-by-pair check against `want` held (True without
    one)."""
    tag, same = "", True
    if want is not None:
        got = fn(*args)
        bad = int((got != want).sum())
        same = bad == 0
        tag = " check=OK" if same else f" check=MISMATCH({bad} pairs)"
    ms = cycled_ms(fn, rolled(args))
    print(f"{label:10s} {len(args[0]) / (ms / 1e3):.4e} pairs/s "
          f"{ms:.4f} ms{tag}{extra}", flush=True)
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda)")
    args = ap.parse_args(argv)
    device = bv.cuda_device(args.device)
    store, r1, rows2, o1, o2, n = bench_batch()
    full = (r1, rows2, o1, o2, n)
    sl = bv.centred_slice(len(r1))
    pa = np.concatenate([store.packed, store.packed_rc])
    packed_all = as_words(pa, device)
    lines = as_words(fk.pack_lines(pa)[0], device)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    batch = tuple(dev(x[sl]) for x in full)
    nw = store.n_words
    print(f"device {torch.cuda.get_device_name(device)}; {len(r1)} pairs, "
          f"slice {sl.start}:{sl.stop}", flush=True)

    def f_fused(*a):
        return fk.verify_windows_fused(packed_all, *a, n_words=nw)

    def f_sync(*a):
        return verify_sync(lines, packed_all, *a)

    def f_pipe(*a):
        return fk.verify_windows_fused_mxu((lines, packed_all), *a,
                                           n_words=nw)

    def f_pipe_nc(*a):
        return verify_pipe_nc(lines, packed_all, *a)

    def f_gather(r1, rows2, o1, o2, n):
        return (packed_all[rows2.long(), 0] + o1) != 0

    want = f_fused(*batch)
    same = _report("fused", f_fused, batch)
    f_sync(*batch)
    misses = f" out_of_window={int(verify_sync.out_of_window)}"
    for label, fn in (("sync", f_sync), ("pipe", f_pipe),
                      ("pipe_nc", f_pipe_nc)):
        same &= _report(label, fn, batch, want,
                        misses if label == "sync" else "")
    _report("gather", f_gather, batch)

    # both-sides fetch over the relabeled workload: the relabel graph is
    # the full candidate set (a slice alone is too sparse a graph)
    pr, fr1, fr2, _, _, fo1, fo2, fn_ = relabel_workload(store.n_reads, pa,
                                                         *full)
    sl2 = bv.centred_slice(len(fr1))
    rbatch = tuple(dev(x[sl2]) for x in (fr1, fr2, fo1, fo2, fn_))
    want_r = fk.verify_windows_fused(as_words(pr, device), *rbatch,
                                     n_words=nw)
    lines2 = as_words(fk.pack_lines(pr)[0], device)
    lines16 = as_words(fk.pack_lines16(pr)[0], device)

    def f_both(*a):
        return fk.verify_windows_fused_mxu_both(lines2, *a, n_words=nw)

    def f_both16(*a):
        return fk.verify_windows_fused_mxu_both16(lines16, *a, n_words=nw)

    f_both(*rbatch)
    misses = (" out_of_window="
              f"{int(fk.verify_windows_fused_mxu_both.out_of_window)}")
    same &= _report("both", f_both, rbatch, want_r, misses)
    same &= _report("both16", f_both16, rbatch, want_r)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
