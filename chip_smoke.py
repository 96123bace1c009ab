#!/usr/bin/env python3
"""Smoke run of disco_tpu_torch's buildG on one NVIDIA card (H100).

    python3 chip_smoke.py [--genome-len 4600000] [--coverage 30]

Phases; any that fails ends the run with a non-zero exit and no result line:

1. card: fail unless torch sees a CUDA card; print its name and power
   limit, and the torch and CUDA versions;
2. build: the CUDA kernels (nvcc, sm_90a) and the C++ host libraries (g++)
   from the checkout's sources, timed, and `ptxas -v`'s registers, shared
   memory and spills for K3's, K4's, K6's, T1's, K5's and T3's kernels and
   K6's, T1's, K5's and T3's controls, with their tiles, stages and blocks
   at the main path's widths;
3. data: an E. coli-sized read set from tools/make_testdata.py (4.6 Mb
   genome, 30x, 250 bp paired reads, 500 bp insert, seed 42);
   MinOverlap4BuildGraph from the shipped cfg (30);
4. kernels: both dual-check kernels against their plain PyTorch versions
   on the card, exactly: on real candidate chunks at the main path's shape
   (2^20 windows, cand_cap 4M pairs, Wp = 17), on an edge-case batch
   (n = 0, every bit phase, windows ending at the read's last base, P not
   a multiple of 1024) and on windows running up to one word past the row,
   which the kernels read as zeros; kernel and plain times by CUDA events,
   the median over several chunks, the kernels' also held (below);
   reference: the device backend's outputs on the golden `mini` and
   `ecoli` inputs are byte-identical to the reference assembler's;
5. slice, the main path: with the launch counts set to 0, `run_buildg`
   with the device backend (`buildg -backend device`: every candidate
   through the K2 kernel; K1 only for the exact re-run of a chunk that
   overflows its caps) and then with the xla backend (`buildg -backend
   xla`: every candidate through the K1 kernel).  The counts are read right
   after those two runs and each must be above 0.  `run_buildg` with the
   native (C++) backend must give byte-identical files, and the xla
   relation must equal the device one.  Prints the stage walls, fallback
   chunks and peak device memory;
6. the device engine with its K1 check (fetch=False), its own count set
   to 0 before it: the relation must equal the K2 one;
7. verify paths, the main path of bench_verify (`python -m
   disco_tpu_torch.bench_verify`): every candidate pair of the same read
   set (bench_verify.candidate_batch, MinOverlap 30) and the BFS relabel
   over all of them, timed on the host.  With the K3, K4, K6 and K7 launch
   counts set to 0, all seven paths (xla, pallas = K7, fused and fused_t =
   K3, fused_mxu and fused_mxu2 = K4, fused_mxu3 = K6) verify the whole
   batch in slices of 2^22 pairs, as made (the reads carry no errors, so
   every live window matches) and with read2's window moved one base on
   every other pair (mismatches), and each slice's booleans must equal
   the plain verify_windows on the same pairs; the counts are read right
   after and each must be above 0, and the counts of K3's, K4's and K6's
   controls (their one-thread-a-pair kernels of before, `_direct`) must
   be 0.  Then each kernel against its plain version, timed by CUDA events
   at P = 2^22 (the median over 5 spread slices; K3, K4 and K6 in turns
   with their controls, plain, control, kernel, kernel, control, as made
   and moved apart, the controls held to the plain version too; K6 also
   held), each path's pairs/s, and edge-case batches (every bit phase,
   n = 0 and a whole tile of it, P = 1, 31, 255, 256, 257, 3001, 2^16 + 5
   and past the tiled kernels' ring, K3 on rows of 2, 17 and 32 words, K4
   with Wb = 17 and 32 and rows1 sorted and not, windows past the row, K6
   rows outside the table, K7's over-long windows; K3 and K4 on columns
   of 257 and 300 words, which their wrappers send to the
   one-thread-a-pair kernel and count as their own launch);
8. fetch experiments (`python -m disco_tpu_torch.tools.exp_fetch_variants`
   and `exp_mxu_fetch`) on phase 7's batch and relabel: with the K5, T1,
   T2 and T3 launch counts set to 0, K5 over the relabeled 32-word table
   (`verify_windows_fused_mxu_both`), T1 (`verify_sync`) and T2
   (`verify_pipe_nc`) over the r1-sorted batch with the (lines, packed)
   tables, in slices of 2^22 pairs, as made and with read2's window moved
   one base on odd pairs, each slice equal to the plain verify_windows;
   T3 (`fetch_checksum`) over the r1-sorted tiles with salt 0 and 1, equal
   to the tool's numpy checksum; K5's and T1's out-of-window row reads on
   each slice equal their window rules' counts (`_both_misses`,
   `sync_misses`).  The counts are read right after and each must be
   above 0, and the counts of the controls of K5, T1 and T3 (their kernels
   before the copies overlapped the compares or sums, `_unpipelined`) and
   of T2 (K4's `_direct`) must be 0.  Then each kernel against its plain
   version, timed at P = 2^22 in turns with its control (K5, T1 and T2 as
   made and moved, T3 with salt 0 and 1 and also held), its out-of-window
   row reads, and edge-case batches (every bit phase, n = 0, P = 1, 255,
   1023, 1025, 3001 and past the rings of K5, T1 and T3, rows outside
   every window, windows past the row, T3 on rows of 17 and 32 words and
   rows past both ends of the table; the controls too).

Each kernel's bound is the least time the card could take for its work:
the larger of its bytes over 3.35 TB/s and its 32-bit integer operations
over 67e12 a second (the H100 SXM figures of NVIDIA's data sheet).  Its
bytes are counted from the inputs it was timed on: 12 B of window geometry
a pair (20 B for the dual check), each row index, each output, the words
each window spans in a column input, and each distinct row a fetch kernel
reads (its Wp = n_words + 1 data words), each once.  Every kernel but
K1, K2 and K7 also carries a sector floor: what a kernel must read at the
card's 32-B sector granularity, the column inputs' sectors that some
window of each group of 8 neighbouring pairs reads, plus the same
geometry, indices and outputs and the fetched rows in whole sectors, over
3.35 TB/s (K5 and K6 have no column input: their floor is their distinct
rows of both sides in whole sectors and 21 B a pair; T3's the sectors its
distinct rows cover, 8 B a pair and its bases).  No single PyTorch call
computes a packed-window compare or the checksum, so `library_ms` is null.

Times are the mean of back-to-back calls through the wrappers, as a path
makes them.  A kernel shorter than its wrapper's host work is then timed on
the host, so K1, K2, K6, K7 and T3 also carry `held_ms`: the same calls
queued behind a sleep kernel, so that the events time the card alone (K6
and T3 in turns with their controls, which carry it too).

With --profile, one more device relation runs under cProfile and
torch.profiler: host functions by cumulative seconds, the device's busy
time (the union of its kernel and copy intervals), its idle share, and the
device operations by time.

Prints the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}."""
import argparse
import concurrent.futures
import dataclasses
import json
import logging
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
CHUNK = 1 << 20          # windows per device step on a card (main path)
CAND_FACTOR = 4          # cand_cap = 4 * chunk
VERIFY_SLICE = 1 << 22   # pairs per verify-path call
HOLD_CYCLES = 10_000_000  # cuda_ms's hold: some 5 ms at the H100's clocks
K1_REPLACES = "disco_tpu/overlap/fused_kernel.py:120"   # fused_compare_dual
K2_REPLACES = "disco_tpu/overlap/fused_kernel.py:737"   # fused_compare_dual_mxu
KERNEL_SOURCE = "disco_tpu_torch/csrc/dual_compare.cu"
WINDOW_SOURCE = "disco_tpu_torch/csrc/window_compare.cu"
STAGED_SOURCE = "disco_tpu_torch/csrc/window_staged.cu"
# the single-check kernels: (id, wrapper name, the TPU kernel it replaces)
SINGLE_KERNELS = (
    ("K3", "fused_compare", "disco_tpu/overlap/fused_kernel.py:148"),
    ("K4", "fused_compare_fetch", "disco_tpu/overlap/fused_kernel.py:362"),
    ("K6", "verify_windows_fused_mxu_both16",
     "disco_tpu/overlap/fused_kernel.py:667"),
    ("K7", "compare_windows", "disco_tpu/overlap/pallas_kernel.py:68"),
)
# phase 8: (id, wrapper name, the TPU kernel it replaces, source)
FETCH_KERNELS = (
    ("K5", "verify_windows_fused_mxu_both",
     "disco_tpu/overlap/fused_kernel.py:515", STAGED_SOURCE),
    ("T1", "verify_sync", "tools/exp_fetch_variants.py:80", STAGED_SOURCE),
    ("T2", "verify_pipe_nc", "tools/exp_fetch_variants.py:117",
     WINDOW_SOURCE),
    ("T3", "fetch_checksum", "tools/exp_mxu_fetch.py:28", STAGED_SOURCE),
)
# the kernels whose `ptxas -v` phase 2 prints, by source
PTXAS_KERNELS = {
    "window_compare.cu": ("window_compare_kernel",
                          "window_compare_fetch_kernel",
                          "window_compare_fetch_both_kernel",
                          "window_compare_fetch_both_direct_kernel"),
    "window_staged.cu": ("window_compare_anchored_kernel",
                         "window_compare_ring_both_kernel",
                         "window_compare_staged_kernel",
                         "window_compare_staged_both_kernel",
                         "row_checksum_ring_kernel",
                         "row_checksum_staged_kernel")}
# the kernels timed in turns with a control that are also timed held: near
# or below their wrappers' host work back to back (K1, K2 and K7, with no
# control, are held in their own timing)
HELD = ("K6", "T3")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
INT32_OPS_PER_S = 67e12      # H100 SXM 32-bit rate outside the tensor cores
OUTPUTS = ("_0_parGraph.txt", "_0_containedReads.txt", "_ReadIDMap.txt",
           "_CheckpointInfo.txt")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


class StageWalls(logging.Handler):
    """Collects the (stage, seconds) records of utils.logging.clock."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.walls = []

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("<<<"):
            self.walls.append((record.args[0], float(record.args[1])))


def cuda_ms(fn, reps, hold=False):
    """Mean device milliseconds of fn() over `reps` calls, after one warm-up
    call, by CUDA events.  Back to back, a call whose kernel is shorter than
    its wrapper's host work times the host.  With `hold`, a sleep kernel
    holds the stream while the host queues the calls, so the events time
    the card's work alone (the held time)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_same_relation(got, want, got_name, want_name):
    import numpy as np
    for f in ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok"):
        check(np.array_equal(getattr(got, f), getattr(want, f)),
              f"{got_name} and {want_name} relations differ in {f}")


def max_abs_err(got, want):
    import torch
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == torch.bool, "output shape")
        err = max(err, int((g.int() - w.int()).abs().max()) if len(g) else 0)
    return err


# ---------------------------------------------------------------------------
# bounds: bytes and operations of a kernel's work on the inputs it ran on
# ---------------------------------------------------------------------------
def span(o, n):
    """(P,) int64: the words a window of n bases at base offset o spans."""
    import torch
    o, n = o.long(), n.long()
    return torch.where(n > 0, ((o + n - 1) >> 4) - (o >> 4) + 1, 0)


def span_union(o_a, n_a, o_b, n_b):
    """(P,) int64: the words two windows of one row span together."""
    import torch
    a0, b0 = o_a.long() >> 4, o_b.long() >> 4
    a1, b1 = a0 + span(o_a, n_a) - 1, b0 + span(o_b, n_b) - 1
    both = (n_a > 0) & (n_b > 0)
    inter = (torch.minimum(a1, b1) - torch.maximum(a0, b0) + 1).clamp(min=0)
    return span(o_a, n_a) + span(o_b, n_b) - torch.where(both, inter, 0)


def distinct(*rows):
    import torch
    return int(torch.unique(torch.cat([r.long() for r in rows])).numel())


def compared_words(n):
    """Words a compare of n bases takes: ceil(n / 16)."""
    return int(((n.long().clamp(min=0) + 15) >> 4).sum())


def bound(nbytes, ops):
    """{bytes, bound_ms, bound_by}: the larger of the two times."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bytes": int(nbytes), "bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def window_bound(p, col_words, fetched_bytes, index_bytes, n, geo_bytes=12,
                 out_bytes=1, checks=1):
    """A window check's bound: per pair its geometry, row indices and
    output; the words its column inputs span; the distinct rows it fetches.
    About 5 operations (two funnel shifts, XOR, mask, compare) a compared
    word."""
    nbytes = (p * (geo_bytes + index_bytes + out_bytes) + 4 * int(col_words)
              + fetched_bytes)
    return bound(nbytes, 5 * n)


def column_sectors(o, n, words, group=8):
    """The 32-B sectors of a (words, P) int32 column input that some window
    of each group of 8 neighbouring pairs reads (the words window_equal_at
    reads, `fused_kernel.read_words`): the least any kernel reads of the
    input at the card's sector granularity, for P a multiple of 8."""
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    first, last = fk.read_words(o, n, words)
    w = torch.arange(words, device=first.device)
    reads = (w >= first[:, None]) & (w <= last[:, None])
    pad = (-len(first)) % group
    if pad:
        reads = torch.cat([reads, reads.new_zeros((pad, words))])
    return int(reads.view(-1, group, words).any(1).sum())


def sector_floor(p, sectors, fetched_bytes, index_bytes, geo_bytes=12,
                 out_bytes=1):
    """{sector_bytes, sector_floor_ms}: the column inputs' read sectors
    (`column_sectors`), per pair its geometry, row indices and output, and
    the fetched rows' bytes, over the card's memory rate.  Beside the bound,
    which counts the words the windows span: the floor says what reading
    whole sectors costs on top."""
    nbytes = 32 * sectors + p * (geo_bytes + index_bytes + out_bytes) + \
        fetched_bytes
    return {"sector_bytes": int(nbytes),
            "sector_floor_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def fetched_sectors(wp, rows):
    """The bytes of the distinct table rows a fetch kernel reads, each row's
    wp data words rounded up to whole 32-B sectors."""
    return 32 * (-(-4 * wp // 32)) * distinct(rows)


def median_bound(bounds, key="bytes"):
    """The bound of the median-`key` slice of several."""
    return sorted(bounds, key=lambda b: b[key])[len(bounds) // 2]


# ---------------------------------------------------------------------------
# phase 4: the kernels against their plain versions
# ---------------------------------------------------------------------------
def chunk_inputs(eng, starts):
    """The dual check's inputs for one window chunk at the main path's shape:
    (rows1, a, b, geo) as candidate_checks builds them."""
    import torch
    from disco_tpu_torch.overlap.device import (candidate_geometry,
                                                dense_candidates)
    part = torch.from_numpy(starts).to(eng.device)
    _, cread, cj, r2, orient, _, cvalid, n_cand = dense_candidates(
        eng.packed, part, eng.tmeta, eng.keys, k=eng.k,
        max_len=eng.store.max_len, cand_cap=CAND_FACTOR * CHUNK)
    rows2, geo, _, _ = candidate_geometry(eng.lengths, cread, cj, r2, orient,
                                          cvalid, k=eng.k)
    a = eng.packed_all[cread].T.contiguous()
    b = eng.packed_all[rows2].T.contiguous()
    return cread.to(torch.int32), a, b, geo, int(n_cand)


def edge_case_inputs(eng, p=3001, seed=0):
    """A synthetic batch over the real packed table: every pair of bit
    phases, windows ending at the read's last base, n = 0, self matches, P
    not a multiple of 1024."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n_rows = eng.packed_all.shape[0]
    lens = np.tile(eng.store.lengths.astype(np.int64), 2)
    rows1 = np.sort(rng.integers(0, n_rows, p))
    rows2 = rng.integers(0, n_rows, p)
    i = np.arange(p)
    same = i % 4 == 0
    rows2[same] = rows1[same]
    l1, l2 = lens[rows1], lens[rows2]
    e_o1 = (rng.integers(0, l1) & ~15) | (i & 15)
    e_o2 = (rng.integers(0, l2) & ~15) | ((i >> 4) & 15)
    e_o2[same] = e_o1[same]
    e_n = np.minimum(l1 - e_o1, l2 - e_o2)            # ends at a read end
    c_o1 = rng.integers(0, l1)
    c_n = np.minimum(l1 - c_o1, l2)
    e_n[::7] = 0
    c_n[::5] = 0
    geo = tuple(torch.from_numpy(np.clip(g, 0, None).astype(np.int32)).to(
        eng.device) for g in (e_o1, e_o2, e_n, c_o1, c_n))
    dev = torch.from_numpy(rows1.astype(np.int64)).to(eng.device)
    r2 = torch.from_numpy(rows2).to(eng.device)
    return (dev.to(torch.int32), eng.packed_all[dev].T.contiguous(),
            eng.packed_all[r2].T.contiguous(), geo)


def past_row_pairs(rng, n_rows, w, p=3001):
    """Windows that run into the last word of a w-word row and up to one
    word past it: sorted rows1 (the table's last row among them), rows2 (a
    quarter of them the row itself: true matches), offsets o1, o2 and
    lengths n (every seventh 0).  Returns (same, rows1, rows2, o1, o2, n),
    numpy arrays."""
    import numpy as np
    end = 16 * (w + 1)
    same = np.arange(p) % 4 == 0
    rows1 = np.sort(rng.integers(0, n_rows, p))
    rows1[-8:] = n_rows - 1
    rows2 = np.where(same, rows1, rng.integers(0, n_rows, p))
    o1 = rng.integers(16 * (w - 3), end, p)
    o2 = np.where(same, o1, rng.integers(16 * (w - 3), end, p))
    n = end - np.maximum(o1, o2)
    n[::7] = 0
    return same, rows1, rows2, o1, o2, n


def past_row_check(eng, errs, p=3001, seed=2):
    """Windows that run into the row's last word and up to one word past
    it: the kernels read a word past the row as 0 (the TPU kernels'
    zero-filled word roll) and K2 never reads the next row.  The reference
    is the plain version over rows padded with two zero words, where its
    word roll never wraps; over the unpadded rows it wraps, and must differ
    somewhere, or the batch does not test the semantic."""
    import numpy as np
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    rng = np.random.default_rng(seed)
    table = eng.packed_all
    n_rows, wp = table.shape
    same, rows1, rows2, e_o1, e_o2, e_n = past_row_pairs(rng, n_rows, wp, p)
    c_o1 = np.where(same, 0, rng.integers(0, 16 * (wp + 1), p))
    c_n = 16 * (wp + 1) - c_o1
    c_n[::5] = 0
    geo = tuple(torch.from_numpy(g.astype(np.int32)).to(DEVICE)
                for g in (e_o1, e_o2, e_n, c_o1, c_n))
    padded = torch.zeros((n_rows, wp + 2), dtype=torch.int32, device=DEVICE)
    padded[:, :wp] = table
    r1, r2 = (torch.from_numpy(r).to(DEVICE) for r in (rows1, rows2))
    a, b = table[r1].T.contiguous(), table[r2].T.contiguous()
    a_z, b_z = padded[r1].T.contiguous(), padded[r2].T.contiguous()
    r1 = r1.to(torch.int32)
    want = fk.fused_compare_dual_plain(a_z, b_z, *geo)
    wrapped = fk.fused_compare_dual_plain(a, b, *geo)
    check(want[0].any() and want[1].any(), "past-row batch has no match")
    check(max_abs_err(wrapped, want) > 0,
          "past-row batch: the wrapping plain version agrees with zero fill")
    for name, got, ref in (
            ("K1", fk.fused_compare_dual(a, b, *geo), want),
            ("K2", fk.fused_compare_dual_fetch(table, b, r1, *geo),
             fk.fused_compare_dual_fetch_plain(padded, b_z, r1, *geo))):
        err = max_abs_err(got, ref)
        check(err == 0, f"{name} disagrees with zero fill past the row on "
                        f"{int((got[0] != ref[0]).sum())} edge and "
                        f"{int((got[1] != ref[1]).sum())} containment flags")
        errs[name] = max(errs[name], err)
    del padded
    say(f"kernels: past-row batch P = {p} (up to one word past a {wp}-word "
        "row, the table's last row included): K1 and K2 == plain over "
        "zero-padded rows")


def dual_bounds(rows1, geo, wp):
    """K1's and K2's bounds on one chunk: K1 reads the words both windows
    span in both column inputs; K2 reads read1's distinct rows instead."""
    e_o1, e_o2, e_n, c_o1, c_n = geo
    p = len(e_n)
    n = compared_words(e_n) + compared_words(c_n)
    b_words = span_union(e_o2, e_n, 0 * c_n, c_n).sum()
    a_words = span_union(e_o1, e_n, c_o1, c_n).sum()
    k1 = window_bound(p, a_words + b_words, 0, 0, n, geo_bytes=20,
                      out_bytes=2)
    k2 = window_bound(p, b_words, 4 * wp * distinct(rows1), 4, n,
                      geo_bytes=20, out_bytes=2)
    return k1, k2


def kernel_phase(store, table):
    import numpy as np
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.overlap.device import DeviceOverlapEngine

    eng = DeviceOverlapEngine(store, table, device=DEVICE)
    starts = eng.window_starts()
    n_chunks = -(-len(starts) // CHUNK)
    picks = sorted({int(c) for c in np.linspace(0, max(n_chunks - 2, 0), 5)})
    times = {k: [] for k in ("K1", "K1_plain", "K1_held", "K2", "K2_plain",
                             "K2_held")}
    errs = {"K1": 0, "K2": 0}
    bounds = {"K1": [], "K2": []}

    def run_both(rows1, a, b, geo, timed):
        k1 = lambda: fk.fused_compare_dual(a, b, *geo)             # noqa
        k1p = lambda: fk.fused_compare_dual_plain(a, b, *geo)      # noqa
        k2 = lambda: fk.fused_compare_dual_fetch(                  # noqa
            eng.packed_all, b, rows1, *geo)
        k2p = lambda: fk.fused_compare_dual_fetch_plain(           # noqa
            eng.packed_all, b, rows1, *geo)
        for name, kern, plain in (("K1", k1, k1p), ("K2", k2, k2p)):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            check(err == 0, f"{name} kernel disagrees with its plain version "
                            f"on {int((got[0] != want[0]).sum())} edge and "
                            f"{int((got[1] != want[1]).sum())} containment "
                            "flags")
            errs[name] = max(errs[name], err)
            if timed:
                times[name].append(cuda_ms(kern, 20))
                times[name + "_held"].append(cuda_ms(kern, 20, hold=True))
                times[name + "_plain"].append(cuda_ms(plain, 5))
        return want

    for c in picks:
        rows1, a, b, geo, n_cand = chunk_inputs(
            eng, starts[c * CHUNK:(c + 1) * CHUNK])
        want = run_both(rows1, a, b, geo, timed=True)
        for name, bd in zip(("K1", "K2"), dual_bounds(
                rows1, geo, eng.packed_all.shape[1])):
            bounds[name].append(bd)
        e_live, c_live = geo[2] > 0, geo[4] > 0
        say(f"kernels: chunk {c}/{n_chunks}: {n_cand} candidates, "
            f"P = {b.shape[1]}, Wp = {b.shape[0]}; edge windows "
            f"{int((want[0] & e_live).sum())}/{int(e_live.sum())} and "
            f"containment windows {int((want[1] & c_live).sum())}/"
            f"{int(c_live.sum())} match: K1 == plain, K2 == plain")
    rows1, a, b, geo = edge_case_inputs(eng)
    want = run_both(rows1, a, b, geo, timed=False)
    check(want[0].any() and want[1].any(), "edge-case batch has no match")
    # K2 with b as the reference passes it: zero padded to 32 rows
    b32 = torch.zeros((32, b.shape[1]), dtype=torch.int32, device=DEVICE)
    b32[:b.shape[0]] = b
    got = fk.fused_compare_dual_fetch(eng.packed_all, b32, rows1, *geo)
    check(max_abs_err(got, want) == 0, "K2 with Wb = 32 disagrees")
    # unsorted rows1
    perm = torch.randperm(len(rows1), device=DEVICE,
                          generator=torch.Generator(DEVICE).manual_seed(1))
    geo_p = tuple(g[perm].contiguous() for g in geo)
    b_p = b[:, perm].contiguous()
    got = fk.fused_compare_dual_fetch(eng.packed_all, b_p, rows1[perm], *geo_p)
    want_p = fk.fused_compare_dual_fetch_plain(eng.packed_all, b_p,
                                               rows1[perm], *geo_p)
    check(max_abs_err(got, want_p) == 0, "K2 on unsorted rows disagrees")
    say(f"kernels: edge-case batch P = {len(rows1)}: K1 == plain, K2 == plain "
        "(Wb = 17 and 32, sorted and unsorted rows1)")
    past_row_check(eng, errs)
    med = {k: statistics.median(v) for k, v in times.items()}
    bounds = {k: median_bound(v) for k, v in bounds.items()}
    for name in ("K1", "K2"):
        say(f"kernels: {name} {med[name]:.4f} ms (held "
            f"{med[name + '_held']:.4f} ms), plain "
            f"{med[name + '_plain']:.4f} ms (median of {len(picks)} chunks); "
            f"{bounds[name]['bytes']} B, bound {bounds[name]['bound_ms']:.4f} "
            f"ms ({bounds[name]['bound_by']})")
    del eng
    torch.cuda.empty_cache()
    return med, errs, bounds


def golden_phase(tmp: pathlib.Path):
    """The device backend on the card against the reference assembler's
    committed outputs (tests/golden)."""
    from disco_tpu_torch.buildg.pipeline import run_buildg
    for case, wsize in (("mini", 1000), ("ecoli", 20000)):
        gdir = ROOT / "tests" / "golden" / case
        cwd = os.getcwd()
        os.chdir(gdir)    # _ReadIDMap.txt records the input path as given
        try:
            run_buildg(["reads.fasta"], [], str(tmp / case), min_overlap=30,
                       write_par_graph_size=wsize, backend="device",
                       device=DEVICE)
        finally:
            os.chdir(cwd)
        for suffix in OUTPUTS:
            check((tmp / (case + suffix)).read_bytes()
                  == (gdir / (case + suffix)).read_bytes(),
                  f"golden {case}{suffix} differs on the device backend")
        say(f"reference: golden {case}: device backend byte-identical to the "
            "reference outputs")


# ---------------------------------------------------------------------------
# phase 7: the verify paths of bench_verify
# ---------------------------------------------------------------------------
def single_kernels():
    """id -> wrapper of the four single-check kernels."""
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.overlap import pallas_kernel as pk
    return {"K3": fk.fused_compare, "K4": fk.fused_compare_fetch,
            "K6": fk.verify_windows_fused_mxu_both16,
            "K7": pk.compare_windows}


def direct_controls():
    """id -> wrapper of the one-thread-a-pair controls of K3, K4 and K6."""
    from disco_tpu_torch.overlap import fused_kernel as fk
    return {"K3": fk.fused_compare_direct, "K4": fk.fused_compare_fetch_direct,
            "K6": fk.verify_windows_fused_mxu_both16_direct}


def kernel_inputs(wls, sl):
    """Each single-check kernel's wrapper, plain version and arguments at
    pairs `sl` of its path's workload: K3 on fused's gathered columns, K4
    on fused_mxu's 32-word table and read2 columns, K6 on fused_mxu3's
    relabeled table, K7 on pallas's aligned columns with zero phases."""
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.overlap import pallas_kernel as pk
    from disco_tpu_torch.overlap.verify import align_window

    def geo(wl):
        return wl.rows1[sl], wl.rows2[sl], wl.o1[sl], wl.o2[sl], wl.n[sl]

    r1, r2, o1, o2, n = geo(wls["fused"])
    pa = wls["fused"].table
    cols = (pa[r1.long()].T.contiguous(), pa[r2.long()].T.contiguous())
    aligned = (align_window(pa[r1.long()], o1).T.contiguous(),
               align_window(pa[r2.long()], o2).T.contiguous())
    zero = torch.zeros_like(o1)
    nw = wls["fused"].n_words
    return {
        "K3": (fk.fused_compare, fk.fused_compare_plain,
               (*cols, o1, o2, n), {}),
        "K4": (fk.fused_compare_fetch, fk.fused_compare_fetch_plain,
               (*fk._mxu_tables(wls["fused_mxu"].table, r2), r1, o1, o2, n),
               {}),
        "K6": (fk.verify_windows_fused_mxu_both16,
               fk.verify_windows_fused_mxu_both16_plain,
               (wls["fused_mxu3"].table, *geo(wls["fused_mxu3"])),
               {"n_words": nw}),
        "K7": (pk.compare_windows, pk.compare_windows_plain,
               (*aligned, zero, zero, n), {}),
    }


def single_bound(k, args, wp):
    """The bound of single-check kernel k on its `kernel_inputs` args."""
    if k == "K3":
        _, _, o1, o2, n = args
        return window_bound(len(n), (span(o1, n) + span(o2, n)).sum(), 0, 0,
                            compared_words(n))
    if k == "K4":
        _, _, r1, _, o2, n = args
        return window_bound(len(n), span(o2, n).sum(),
                            4 * wp * distinct(r1), 4, compared_words(n))
    if k == "K6":
        _, r1, r2, _, _, n = args
        return window_bound(len(n), 0, 4 * min(wp, 16) * distinct(r1, r2), 8,
                            compared_words(n))
    a, _, bit1, bit2, n = args             # K7: aligned (W + 1, P) columns
    nn = n.clamp(max=16 * (a.shape[0] - 1))
    return window_bound(len(n), (span(bit1 >> 1, nn) + span(bit2 >> 1, nn)
                                 ).sum(), 0, 0, compared_words(nn))


def table_sectors(rows, wt, n_rows):
    """The bytes of the 32-B sectors of a row-major (n_rows, wt) int32
    table that its distinct rows `rows` inside the table cover (rows that
    share a sector share its bytes)."""
    import torch
    r = torch.unique(rows.long())
    r = r[(r >= 0) & (r < n_rows)]
    first, last = (r * wt * 4) // 32, ((r + 1) * wt * 4 - 1) // 32
    ks = torch.arange(-(-wt * 4 // 32) + 1, device=r.device)
    sec = first[:, None] + ks
    return 32 * int(torch.unique(sec[ks <= (last - first)[:, None]]).numel())


def column_floor(k, args, wp):
    """The sector floor of K3 (k "K3": `kernel_inputs` args a, b, o1, o2,
    n), of K5 and K6 ("K5", "K6": lines, rows1, rows2, o1, o2, n: both
    sides' distinct rows in whole sectors, their first wp and 16 words, and
    21 B a pair, no column input), of T3 ("T3": table, rows, bases, salt:
    the sectors of its distinct rows, 8 B a pair and its bases) or of K4's
    kernel (table, b, rows1, o1, o2, n; T1's and T2's too)."""
    import torch
    if k == "K3":
        a, _, o1, o2, n = args
        return sector_floor(len(n), column_sectors(o1, n, a.shape[0])
                            + column_sectors(o2, n, a.shape[0]), 0, 0)
    if k in ("K5", "K6"):
        _, r1, r2, _, _, n = args
        w = wp if k == "K5" else min(wp, 16)
        return sector_floor(len(n), 0, fetched_sectors(w, torch.cat((r1,
                                                                      r2))),
                            8)
    if k == "T3":
        table, rows, bases, salt = args
        return sector_floor(len(rows), 0, table_sectors(
            rows.long() + salt, table.shape[1], table.shape[0]) +
            4 * len(bases), 4, geo_bytes=0, out_bytes=4)
    _, b, r1, _, o2, n = args
    return sector_floor(len(n), column_sectors(o2, n, b.shape[0]),
                        fetched_sectors(wp, r1), 4)


def time_turns(kern, control, plain, reps=20, hold=False):
    """CUDA-event times in turns: plain (when given), control, kernel,
    kernel, control; held (`cuda_ms`) with `hold`.  Returns (kernel ms,
    control ms, plain ms or None), the first two the means of their two
    turns."""
    plain_ms = cuda_ms(plain, 5) if plain is not None else None
    c1, k1, k2, c2 = (cuda_ms(f, reps, hold) for f in (control, kern, kern,
                                                        control))
    return (k1 + k2) / 2, (c1 + c2) / 2, plain_ms


def turns(times, k, ctl, tag, kern, control, plain):
    """Kernel k and its control (suffix ctl) timed in turns into `times`
    under k + tag and k + ctl + tag, the plain version (when given) under
    k + "_plain"; the kernels of HELD also held, under k + "_held" + tag
    and k + ctl + "_held" + tag."""
    k_ms, c_ms, p_ms = time_turns(kern, control, plain)
    times.setdefault(k + tag, []).append(k_ms)
    times.setdefault(k + ctl + tag, []).append(c_ms)
    if p_ms is not None:
        times.setdefault(k + "_plain", []).append(p_ms)
    if k in HELD:
        k_ms, c_ms, _ = time_turns(kern, control, None, hold=True)
        times.setdefault(k + "_held" + tag, []).append(k_ms)
        times.setdefault(k + ctl + "_held" + tag, []).append(c_ms)


def turns_line(k, ctl, med, floors, moved="moved"):
    """The line of kernel k timed in turns with its control (suffix ctl),
    as made and `moved`, with its sector floor."""
    def pair(key):
        return f"{med[key]:.4f} ms ({moved} {med[key + '_moved']:.4f})"
    held = "" if k + "_held" not in med else (
        f"; held {pair(k + '_held')}, {ctl} {pair(k + '_' + ctl + '_held')}")
    return (f"{k} in turns with its control: {pair(k)}, {ctl} "
            f"{pair(k + '_' + ctl)}{held}; sector floor "
            f"{floors[k]['sector_bytes']} B, "
            f"{floors[k]['sector_floor_ms']:.4f} ms")


def edge_pairs(rng, n_rows, w, p):
    """Edge-case geometry over rows of w words: every bit phase of both
    offsets, windows ending inside the row (before word w - 1), n = 0 on
    every seventh pair and on the whole second tile of 256 pairs, true
    matches on every fourth pair; rows1 sorted.  Returns (rows1, rows2, o1,
    o2, n), numpy arrays."""
    import numpy as np
    i = np.arange(p)
    rows1 = np.sort(rng.integers(0, n_rows, p))
    same = i % 4 == 0
    rows2 = np.where(same, rows1, rng.integers(0, n_rows, p))
    end = 16 * (w - 1)
    o1 = rng.integers(0, end, p) & ~15 | (i & 15)
    o2 = np.where(same, o1, rng.integers(0, end, p) & ~15 | (i >> 4) & 15)
    n = np.minimum(end - np.maximum(o1, o2), rng.integers(0, 300, p))
    n[::7] = 0
    n[256:512] = 0
    return rows1, rows2, o1, o2, n


def single_edge_cases(pa, errs, seed=3):
    """Every bit phase of both offsets, n = 0 (and a whole tile of it),
    true matches, P = 1, 31, 255, 256, 257, 3001, 2^16 + 5 and past the
    tiled kernels' ring (more tiles than blocks x stages), over the batch's
    packed table, rows1 sorted and (K4) not; K3 on random rows of 2, 17 and
    32 words, K4 with read2's columns of 17 (the packed table) and 32 words
    (the line table); windows up to one word past the row (K3, K4, K6
    against the plain check over rows padded with two zero words); K7
    windows longer than its W compared words; K3 and K4 on columns of 257
    and 300 words, and the paths fused and fused_t on rows of 257 words
    (F1: the one-thread-a-pair kernel, counted under the wrapper).  The
    controls of K3 and K4 (`_direct`) take the same cases."""
    import numpy as np
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.overlap import pallas_kernel as pk
    from disco_tpu_torch.overlap.verify import align_window, verify_windows
    rng = np.random.default_rng(seed)
    n_rows, wp = pa.shape
    lines = {32: torch.from_numpy(fk.pack_lines(pa.cpu().numpy().view(
        np.uint32))[0].view(np.int32)).to(DEVICE),
             16: torch.from_numpy(fk.pack_lines16(pa.cpu().numpy().view(
                 np.uint32))[0].view(np.int32)).to(DEVICE)}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(DEVICE)

    def run(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        check(err == 0, f"{name} disagrees with its plain version on "
                        f"{int((got != want).sum())} of {len(got)} "
                        "edge-case pairs")
        errs[name] = max(errs.get(name, 0), err)

    def ring(w, table_words):
        tile, blocks, stages = fk.tiled_shape(w, table_words, 1 << 40)
        return blocks * stages * tile + 5

    sizes = [1, 31, 255, 256, 257, 3001, (1 << 16) + 5,
             max(ring(wp, 0), ring(32, 32), ring(wp, 32))]
    for p in sizes:
        rows1, rows2, o1, o2, n = edge_pairs(rng, n_rows, wp, p)
        r1, r2, g = t(rows1), t(rows2), [t(x) for x in (o1, o2, n)]
        cols = [pa[r.long()].T.contiguous() for r in (r1, r2)]
        want = fk.fused_compare_plain(*cols, *g)
        run("K3", fk.fused_compare(*cols, *g), want)
        run("K3_direct", fk.fused_compare_direct(*cols, *g), want)
        perm = torch.from_numpy(rng.permutation(p)).to(DEVICE)
        for order, (q1, q2, gg) in (("sorted", (r1, r2, g)),
                                    ("random", (r1[perm], r2[perm],
                                                [x[perm] for x in g]))):
            for tables in (lines[32], (lines[32], pa)):
                args = (*fk._mxu_tables(tables, q2), q1, *gg)
                want = fk.fused_compare_fetch_plain(*args)
                run("K4", fk.verify_windows_fused_mxu(tables, q1, q2, *gg,
                                                      n_words=wp - 1), want)
                run("K4_direct", fk.fused_compare_fetch_direct(*args), want)
        want = fk.verify_windows_fused_mxu_both16_plain(lines[16], r1, r2, *g,
                                                        n_words=wp - 1)
        for name, fn in (("K6", fk.verify_windows_fused_mxu_both16),
                         ("K6_direct",
                          fk.verify_windows_fused_mxu_both16_direct)):
            run(name, fn(lines[16], r1, r2, *g, n_words=wp - 1), want)
        if p > 1 << 16:
            continue            # K7 has no tiles: two sizes suffice
        word = [align_window(pa[r.long()], t(o & ~15)).T.contiguous()
                for r, o in ((r1, o1), (r2, o2))]
        bits = [t((o & 15) << 1) for o in (o1, o2)]
        n_long = t(rng.integers(0, 16 * (wp + 2), p))
        for nn in (g[2], n_long):
            run("K7", pk.compare_windows(*word, *bits, nn),
                pk.compare_windows_plain(*word, *bits, nn))
    # K3 and its control over random rows of 2, 17 and 32 words
    for w in (2, 17, 32):
        table = torch.from_numpy(rng.integers(
            0, 2 ** 32, (4096, w), dtype=np.uint64).astype(np.uint32).view(
                np.int32)).to(DEVICE)
        for p in (3001, ring(w, 0)):
            rows1, rows2, o1, o2, n = edge_pairs(rng, 4096, w, p)
            cols = [table[t(r).long()].T.contiguous() for r in (rows1, rows2)]
            g = [t(x) for x in (o1, o2, n)]
            want = fk.fused_compare_plain(*cols, *g)
            check(bool(want.any()) and not bool(want.all()),
                  f"K3 batch of {w}-word rows: all one answer")
            run("K3", fk.fused_compare(*cols, *g), want)
            run("K3_direct", fk.fused_compare_direct(*cols, *g), want)
    # columns wider than the tiled kernels take (F1): the wrappers launch
    # the one-thread-a-pair kernel and count it as their own
    for w in (257, 300):
        table = torch.from_numpy(rng.integers(
            0, 2 ** 32, (1024, w), dtype=np.uint64).astype(np.uint32).view(
                np.int32)).to(DEVICE)
        rows1, rows2, o1, o2, _ = edge_pairs(rng, 1024, w, 3001)
        n = np.minimum(16 * (w - 1) - np.maximum(o1, o2),
                       rng.integers(0, 16 * w, len(o1)))
        n[::7] = 0
        cols = [table[t(r).long()].T.contiguous() for r in (rows1, rows2)]
        g = [t(x) for x in (o1, o2, n)]
        for name, fn, control, args, plain in (
                ("K3", fk.fused_compare, fk.fused_compare_direct,
                 (*cols, *g), fk.fused_compare_plain),
                ("K4", fk.fused_compare_fetch, fk.fused_compare_fetch_direct,
                 (table, cols[1], t(rows1), *g),
                 fk.fused_compare_fetch_plain)):
            before = (fn.launches, control.launches)
            want = plain(*args)
            check(bool(want.any()) and not bool(want.all()),
                  f"{name} batch of {w}-word columns: all one answer")
            run(name, fn(*args), want)
            check((fn.launches, control.launches) == (before[0] + 1,
                                                      before[1]),
                  f"{name} on {w}-word columns: the launch was not counted "
                  "under its wrapper")
        if w > 257:
            continue
        # the paths fused and fused_t at this width, against the plain
        # verify_windows; each launches K3 once, counted as fused_compare's
        want = verify_windows(table, t(rows1), t(rows2), *g, n_words=w - 1)
        for name, fn, tbl in (
                ("fused", fk.verify_windows_fused, table),
                ("fused_t", fk.verify_windows_fused_t, table.T.contiguous())):
            before = (fk.fused_compare.launches,
                      fk.fused_compare_direct.launches)
            run("K3", fn(tbl, t(rows1), t(rows2), *g, n_words=w - 1), want)
            check((fk.fused_compare.launches,
                   fk.fused_compare_direct.launches) == (before[0] + 1,
                                                         before[1]),
                  f"path {name} on {w}-word rows: K3's launch was not "
                  "counted under fused_compare")
    # past the row: K3 on packed_all, K4 and K6 on their line tables
    for name, table in (("K3", pa), ("K4", lines[32].view(-1, 32)),
                        ("K6", lines[16].view(-1, 16))):
        w = table.shape[1]
        _, rows1, rows2, o1, o2, n = past_row_pairs(rng, n_rows, w)
        r1, r2, g = t(rows1), t(rows2), [t(x) for x in (o1, o2, n)]
        padded = torch.zeros((table.shape[0], w + 2), dtype=torch.int32,
                             device=DEVICE)
        padded[:, :w] = table
        want = fk.window_check_plain(padded[r1.long()], padded[r2.long()],
                                     *g)
        check(bool(want.any()), f"{name} past-row batch has no match")
        if name == "K3":
            cols = [table[r.long()].T.contiguous() for r in (r1, r2)]
            got = fk.fused_compare(*cols, *g)
            run("K3_direct", fk.fused_compare_direct(*cols, *g), want)
        elif name == "K4":
            got = fk.verify_windows_fused_mxu(lines[32], r1, r2, *g,
                                              n_words=wp - 1)
            run("K4_direct", fk.fused_compare_fetch_direct(
                *fk._mxu_tables(lines[32], r2), r1, *g), want)
        else:
            got = fk.verify_windows_fused_mxu_both16(lines[16], r1, r2, *g,
                                                     n_words=wp - 1)
            run("K6_direct", fk.verify_windows_fused_mxu_both16_direct(
                lines[16], r1, r2, *g, n_words=wp - 1), want)
        run(name, got, want)
    # K6 and its control on rows outside the table, which read as zeros:
    # the plain check over the table with three zero rows on either side
    t16 = lines[16].view(-1, 16)
    rows1, rows2, o1, o2, n = edge_pairs(rng, len(t16) + 6, wp, 3001)
    rows1[:5], rows1[-5:] = 0, len(t16) + 5       # rows1 stays sorted
    rows2[1::50] = rng.choice([0, 2, len(t16) + 3, len(t16) + 5],
                              len(rows2[1::50]))
    r1, r2, g = t(rows1 - 3), t(rows2 - 3), [t(x) for x in (o1, o2, n)]
    framed = torch.zeros((len(t16) + 6, 16), dtype=torch.int32, device=DEVICE)
    framed[3:-3] = t16
    want = fk.window_check_plain(framed[r1.long() + 3], framed[r2.long() + 3],
                                 *g)
    check(bool(((r1 < 0) | (r1 >= len(t16))).any()), "no K6 row outside")
    for name, fn in (("K6", fk.verify_windows_fused_mxu_both16),
                     ("K6_direct", fk.verify_windows_fused_mxu_both16_direct)):
        run(name, fn(lines[16], r1, r2, *g, n_words=wp - 1), want)
    # K6 and its control on windows of 257 to 300 bases (more than the 16
    # compared words K6's fast path holds: the checked readers), over the
    # same framed table padded with zero words; and K6 on a table that is
    # not 16-B aligned (its direct kernel, counted as K6's launch)
    n = rng.integers(257, 301, len(n))
    n[::7] = 0
    g[2] = t(n)
    wide = torch.zeros((len(framed), 40), dtype=torch.int32, device=DEVICE)
    wide[:, :16] = framed
    want = fk.window_check_plain(wide[r1.long() + 3], wide[r2.long() + 3],
                                 *g)
    check(bool(want.any()) and not bool(want.all()),
          "K6 batch of windows over 256 bases: all one answer")
    for name, fn in (("K6", fk.verify_windows_fused_mxu_both16),
                     ("K6_direct", fk.verify_windows_fused_mxu_both16_direct)):
        run(name, fn(lines[16], r1, r2, *g, n_words=wp - 1), want)
    flat = torch.zeros(lines[16].numel() + 4, dtype=torch.int32,
                       device=DEVICE)
    shifted = flat[1:1 + lines[16].numel()].view(lines[16].shape)
    shifted.copy_(lines[16])
    check(shifted.data_ptr() % 16 != 0, "the shifted table is 16-B aligned")
    before = (fk.verify_windows_fused_mxu_both16.launches,
              fk.verify_windows_fused_mxu_both16_direct.launches)
    run("K6", fk.verify_windows_fused_mxu_both16(shifted, r1, r2, *g,
                                                  n_words=wp - 1), want)
    check((fk.verify_windows_fused_mxu_both16.launches,
           fk.verify_windows_fused_mxu_both16_direct.launches) ==
          (before[0] + 1, before[1]),
          "K6 on a misaligned table: the launch was not counted as K6's")
    say(f"verify: edge-case batches (P = {', '.join(map(str, sizes))}; "
        "every bit phase, n = 0 and a tile of n = 0, K4 in both table forms "
        "(Wb = 32 and 17) with rows1 sorted and not, K3 on rows of 2, 17 "
        "and 32 words, K3 and K4 on columns of 257 and 300 words through "
        "the one-thread-a-pair kernel counted as theirs, the paths fused and "
        "fused_t on rows of 257 words, K7 windows longer "
        "than its words, windows up to one word past the row, K6 rows "
        "outside the table, K6 windows of 257 to 300 bases and a K6 table "
        "not 16-B aligned): K3, K4, K6, their _direct controls, K7 == "
        "plain")


def verify_paths_phase(fasta, min_ovl):
    """Phase 7.  Returns (times, errs, launches, bounds) keyed by kernel id,
    and what phase 8 reuses: the batch, the host workloads (fused_mxu3's
    holds the relabel), the plain booleans as made and moved, and the
    moved offsets."""
    import numpy as np
    import torch
    from disco_tpu_torch import bench_verify as bv
    from disco_tpu_torch.overlap.verify import verify_windows

    t0 = time.perf_counter()
    batch = bv.candidate_batch(fasta, min_overlap=min_ovl)
    t_batch = time.perf_counter() - t0
    store, r1 = batch[0], batch[1]
    n_pairs = len(r1)
    check(n_pairs > VERIFY_SLICE, f"only {n_pairs} candidate pairs")
    say(f"verify: candidate batch of {n_pairs} pairs ({store.n_reads} reads, "
        f"n_words {store.n_words}, {int((batch[5] > 0).sum())} live edge "
        f"windows) in {t_batch:.2f} s on the host; r1 tile spans "
        f"{bv.tile_spans(r1)}")
    wls = {}
    for path in bv.PATHS:
        t0 = time.perf_counter()
        wls[path] = bv.prepare(path, *batch)
        if path in bv.RELABELED:
            say(f"verify: {path}: BFS relabel over all {n_pairs} pairs and "
                f"pack_lines16 in {time.perf_counter() - t0:.2f} s on the "
                f"host; relabeled r1 tile spans {bv.tile_spans(wls[path].rows1)},"
                f" r2 {bv.tile_spans(wls[path].rows2)}")
    slices = [slice(s, min(s + VERIFY_SLICE, n_pairs))
              for s in range(0, n_pairs, VERIFY_SLICE)]

    # The plain verify_windows over the batch, in its own order: as made,
    # and with read2's window moved one base on (batch order) odd pairs.
    # The reads carry no errors, so every live window of the batch matches;
    # the moved windows give each path mismatches to find.  A moved window
    # still lies inside its row (o2 + n <= 250 bases of 256 or more).
    base = wls["xla"].to(DEVICE)
    odd = torch.arange(n_pairs, dtype=torch.int32, device=DEVICE) % 2
    want = []
    for moved in (0, 1):
        o2 = base.o2 + moved * odd
        want.append(torch.cat([verify_windows(
            base.table, base.rows1[sl], base.rows2[sl], base.o1[sl], o2[sl],
            base.n[sl], n_words=base.n_words) for sl in slices]))
    torch.cuda.synchronize()
    live = base.n > 0
    say(f"verify: plain verify_windows: {int(want[0][live].sum())} of "
        f"{int(live.sum())} live windows match; {int(want[1][live].sum())} "
        "with read2's window moved one base on odd pairs")
    check(not bool(want[1][live].all()), "no moved window mismatches")
    del base

    kern = single_kernels()
    controls = direct_controls()
    for k in (*kern.values(), *controls.values()):
        k.launches = 0
    on_card, moved_card = {}, {}
    for path, wl in wls.items():
        t0 = time.perf_counter()
        dwl = wl.to(DEVICE)
        perm = (None if wl.perm is None
                else torch.from_numpy(wl.perm).to(DEVICE))
        shift = odd if perm is None else odd[perm]
        for moved in (0, 1):
            mwl = (dataclasses.replace(dwl, o2=dwl.o2 + shift) if moved
                   else dwl)
            if moved and path in ("fused", "fused_mxu", "fused_mxu3"):
                moved_card[path] = mwl      # K3's, K4's and K6's inputs
            for sl in slices:
                got = mwl.verify(sl)
                ref = (want[moved][sl] if perm is None
                       else want[moved][perm[sl]])
                check(got.dtype == torch.bool and got.shape == ref.shape,
                      f"{path}: output {got.dtype} {tuple(got.shape)}")
                bad = int((got != ref).sum())
                check(bad == 0, f"{path}: {bad} of {len(got)} pairs of "
                                f"slice {sl.start}:{sl.stop} (moved "
                                f"{moved}) differ from the plain "
                                "verify_windows")
        torch.cuda.synchronize()
        on_card[path] = dwl
        say(f"verify: {path}: {len(slices)} slices of up to {VERIFY_SLICE} "
            "pairs, as made and with the moved windows, == plain "
            f"verify_windows ({time.perf_counter() - t0:.2f} s with the "
            "upload)")
    launches = {k: f.launches for k, f in kern.items()}
    say("verify: launches on the verify paths: " + ", ".join(
        f"{k} {n}" for k, n in launches.items()))
    for k, n in launches.items():
        check(n > 0, f"the verify paths never launched {k}")
    for k, f in controls.items():
        check(f.launches == 0, f"the verify paths launched {k}'s control")
        launches[k + "_direct"] = f.launches

    # each kernel against its plain version, and the times, at P = 2^22;
    # K3 and K4 in turns with their controls, as made and moved
    full = [sl for sl in slices if sl.stop - sl.start == VERIFY_SLICE]
    picks = [full[int(i)] for i in
             sorted({int(x) for x in np.linspace(0, len(full) - 1, 5)})]
    times = {}
    errs = {}
    bounds = {}
    floors = {}
    path_ms = {path: [] for path in on_card}
    wp = store.n_words + 1
    for sl in picks:
        made = kernel_inputs(on_card, sl)
        moved = kernel_inputs({**on_card, **moved_card}, sl)
        for k, (fn, plain, args, kw) in made.items():
            bounds.setdefault(k, []).append(single_bound(k, args, wp))
            control = controls.get(k)
            if control is not None:
                floors.setdefault(k, []).append(column_floor(k, args, wp))
            for tag, a in (("", args), ("_moved", moved[k][2])):
                if control is None and tag:
                    continue
                ref = plain(*a, **kw)
                for name, f in ((k, fn), (k + "_direct", control)):
                    if f is None:
                        continue
                    got = f(*a, **kw)
                    torch.cuda.synchronize()
                    err = max_abs_err([got], [ref])
                    check(err == 0, f"{name} disagrees with its plain "
                                    f"version on {int((got != ref).sum())} "
                                    f"pairs of slice {sl.start}:{sl.stop}"
                                    f"{tag}")
                    errs[name] = max(errs.get(name, 0), err)
                if control is None:
                    times.setdefault(k, []).append(
                        cuda_ms(lambda: fn(*a, **kw), 20))
                    times.setdefault(k + "_held", []).append(
                        cuda_ms(lambda: fn(*a, **kw), 20, hold=True))
                    times.setdefault(k + "_plain", []).append(
                        cuda_ms(lambda: plain(*a, **kw), 5))
                    continue
                turns(times, k, "_direct", tag, lambda: fn(*a, **kw),
                      lambda: control(*a, **kw),
                      None if tag else (lambda: plain(*a, **kw)))
        for path, dwl in on_card.items():
            path_ms[path].append(cuda_ms(lambda: dwl.verify(sl), 10))
    med = {k: statistics.median(v) for k, v in times.items()}
    bounds = {k: median_bound(v) for k, v in bounds.items()}
    floors = {k: median_bound(v, "sector_bytes") for k, v in floors.items()}
    for k, name, _ in SINGLE_KERNELS:
        held = (f" (held {med[k + '_held']:.4f} ms)"
                if k + "_held" in med else "")
        say(f"verify: {k} {name} {med[k]:.4f} ms{held}, plain "
            f"{med[k + '_plain']:.4f} ms (P = {VERIFY_SLICE}, median of "
            f"{len(picks)} slices); {bounds[k]['bytes']} B, bound "
            f"{bounds[k]['bound_ms']:.4f} ms ({bounds[k]['bound_by']})")
        if k in floors:
            say("verify: " + turns_line(k, "direct", med, floors))
    for path, ms in path_ms.items():
        m = statistics.median(ms)
        say(f"verify: path {path}: {m:.4f} ms per {VERIFY_SLICE} pairs, "
            f"{VERIFY_SLICE / (m / 1e3):.4e} pairs/s")
    single_edge_cases(on_card["fused"].table, errs)
    del on_card, moved_card
    torch.cuda.empty_cache()
    return med, errs, launches, bounds, floors, (batch, wls, want, odd)


# ---------------------------------------------------------------------------
# phase 8: the fetch experiments (K5, T1, T2, T3)
# ---------------------------------------------------------------------------
def fetch_kernels():
    """id -> wrapper of the phase 8 kernels (each with its launch count)."""
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.tools import exp_fetch_variants as fv
    from disco_tpu_torch.tools import exp_mxu_fetch as mf
    return {"K5": fk.verify_windows_fused_mxu_both, "T1": fv.verify_sync,
            "T2": fv.verify_pipe_nc, "T3": mf.fetch_checksum}


def unpipelined_controls():
    """id -> wrapper of the controls of K5, T1 and T3: their kernels before
    the copies overlapped the compares (T3: the sums)."""
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.tools import exp_fetch_variants as fv
    from disco_tpu_torch.tools import exp_mxu_fetch as mf
    return {"K5": fk.verify_windows_fused_mxu_both_unpipelined,
            "T1": fv.verify_sync_unpipelined,
            "T3": mf.fetch_checksum_unpipelined}


# phase 8's timing controls: the kernel id -> the control's name
FETCH_CONTROLS = {"K5": "unpipelined", "T1": "unpipelined", "T2": "direct",
                  "T3": "unpipelined"}


def fetch_inputs(d, sl, wp):
    """Each phase 8 kernel's launch, plain version, arguments, bound and
    timing control at pairs `sl`: K5 on the relabeled 32-word table, T1's
    and T2's launches on the (lines, packed) tables with read2's columns
    gathered, T3 on the r1-sorted rows with salt d["salt"].  The launches
    time the kernels alone: T1 and T2 gather read2's columns first, as
    K4's wrapper does."""
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.tools import exp_fetch_variants as fv
    from disco_tpu_torch.tools import exp_mxu_fetch as mf
    r1, r2, o1, o2, n = (x[sl] for x in d["batch"])
    q1, q2, p1, p2, pn = (x[sl] for x in d["relab"])
    table, b = fv._tables(d["lines"], d["packed"], r2)
    bases = r1[::fk.TILE].contiguous()
    p, nw = len(n), wp - 1
    k1 = window_bound(p, span(o2, n).sum(), 4 * wp * distinct(r1), 4,
                      compared_words(n))
    return {
        "K5": (lambda *a: fk.verify_windows_fused_mxu_both(*a, n_words=nw),
               lambda *a: fk.verify_windows_fused_mxu_both_plain(
                   *a, n_words=nw),
               (d["lines_relab"], q1, q2, p1, p2, pn),
               window_bound(p, 0, 4 * wp * distinct(q1, q2), 8,
                            compared_words(pn)),
               lambda *a: fk.verify_windows_fused_mxu_both_unpipelined(
                   *a, n_words=nw)),
        "T1": (lambda *a: fv.compare_staged(*a)[0],
               fk.fused_compare_fetch_plain, (table, b, r1, o1, o2, n), k1,
               lambda *a: fv.compare_staged_unpipelined(*a)[0]),
        "T2": (lambda *a: fk.compare_fetch(*a)[0],
               fk.fused_compare_fetch_plain, (table, b, r1, o1, o2, n), k1,
               fk.fused_compare_fetch_direct),
        "T3": (mf.fetch_checksum, mf.fetch_checksum_plain,
               (d["packed"], r1, bases, d["salt"]),
               bound(p * 8 + 4 * len(bases) + 4 * wp * distinct(r1),
                     2 * wp * p), mf.fetch_checksum_unpipelined),
    }


def window_rule_counts(kern, n_rows, r1, r2=None):
    """The window rule's count of K5's (kern "K5": both sides) or T1's row
    reads outside their windows, as a python int."""
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.tools import exp_fetch_variants as fv
    if kern == "K5":
        return int(fk._both_misses(n_rows, r1, r2))
    return int(fv.sync_misses(n_rows, r1))


def fetch_edge_cases(pa, errs, seed=5):
    """K5, T1, T2 and T3, and the controls of K5, T1 and T3, against their
    plain versions on synthetic batches over random 32-word rows (so that
    the words past the staged ones come from device memory): every bit
    phase, n = 0, P = 1, 255, 1023, 1025, 3001 and past the rings of K5, T1
    and T3 (more tiles than blocks x stages), sorted rows and random rows
    (outside every window), K5's, T1's and T3's out-of-window row reads
    equal to their rules' counts, windows up to one word past the compared
    row (the plain check over rows padded with two zero words), and T3 on
    rows of 17 and 32 words (one span, and row by row), rows past both
    ends of the table, salt 0 and 1."""
    import numpy as np
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.tools import exp_fetch_variants as fv
    from disco_tpu_torch.tools import exp_mxu_fetch as mf
    rng = np.random.default_rng(seed)
    n_rows = 4096
    lines = torch.from_numpy(rng.integers(
        0, 2 ** 32, (n_rows // 4, 128), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(DEVICE)
    table = lines.view(-1, 32)
    controls = unpipelined_controls()

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(DEVICE)

    def run(name, got, want, what):
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: output {got.dtype} {tuple(got.shape)}")
        err = int((got.long() - want.long()).abs().max()) if len(got) else 0
        check(err == 0, f"{name} disagrees with its plain version on "
                        f"{int((got != want).sum())} of {len(got)} {what}")
        errs[name] = max(errs.get(name, 0), err)

    def staged(k, fn, args, want, rule):
        """K5 or T1 (fn its kernel or control) == plain, and its count of
        row reads outside the windows == the rule's."""
        name = k if fn is fetch_kernels()[k] else k + "_unpipelined"
        kw = {"n_words": 16} if k == "K5" else {}
        run(name, fn(*args, **kw), want, "pairs")
        got = int(fn.out_of_window)
        check(got == rule, f"{name}: {got} row reads outside its windows, "
                           f"its rule counts {rule}")
        return got

    rings = max([tile * blocks * stages + 5 for tile, blocks, stages in (
        fk.staged_shape("T1", 32, 32, 1 << 40),
        fk.staged_shape("K5", 0, 17, 1 << 40))] + [
            fk.TILE * blocks * stages + 5 for stages, blocks in (
                mf.checksum_shape(w, 1 << 40) for w in (17, 32))])
    sizes = (1, 255, 1023, 1025, 3001, rings)
    missed = {k: 0 for k in ("K5", "T1", "T3")}
    # T3 on the 32-word rows (an even width: copied row by row) and on 17
    # (odd: one span); past both ends of the table
    table17 = table[:, :17].contiguous()
    for p in sizes:
        for order in ("sorted", "random"):
            i = np.arange(p)
            rows1 = rng.integers(0, n_rows, p)
            if order == "sorted":
                rows1 = np.sort(rng.integers(0, min(n_rows, 200 + p // 64),
                                             p))
            rows2 = np.where(i % 4 == 0, rows1, rng.integers(0, n_rows, p))
            o1 = rng.integers(0, 16 * 20, p) & ~15 | (i & 15)
            o2 = np.where(i % 4 == 0, o1,
                          rng.integers(0, 16 * 20, p) & ~15 | (i >> 4) & 15)
            n = np.minimum(16 * 22 - np.maximum(o1, o2),
                           rng.integers(0, 300, p))
            n[::7] = 0
            r1, r2, g = t(rows1), t(rows2), [t(x) for x in (o1, o2, n)]
            want = fk.verify_windows_fused_mxu_both_plain(lines, r1, r2, *g,
                                                          n_words=16)
            rule = window_rule_counts("K5", n_rows, r1, r2)
            for fn in (fk.verify_windows_fused_mxu_both, controls["K5"]):
                missed["K5"] += staged("K5", fn, (lines, r1, r2, *g), want,
                                       rule)
            want = fv.verify_sync_plain(lines, table, r1, r2, *g)
            rule = window_rule_counts("T1", n_rows, r1)
            for fn in (fv.verify_sync, controls["T1"]):
                missed["T1"] += staged("T1", fn, (lines, table, r1, r2, *g),
                                       want, rule)
            run("T2", fv.verify_pipe_nc(lines, table, r1, r2, *g), want,
                "pairs")
            bases = t(np.sort(rows1)[::fk.TILE])
            rows = t(rows1 + rng.integers(-1, 2, p) * (i % 50 == 0) * n_rows)
            for salt, tab in ((0, table), (1, table), (0, table17),
                              (1, table17)):
                want = mf.fetch_checksum_plain(tab, rows, bases, salt)
                rule = int(mf.checksum_misses(n_rows, rows, bases, salt))
                for fn in (mf.fetch_checksum, controls["T3"]):
                    name = "T3" if fn is mf.fetch_checksum else \
                        "T3_unpipelined"
                    run(name, fn(tab, rows, bases, salt), want, "rows")
                    got = int(fn.out_of_window)
                    check(got == rule, f"{name}: {got} row reads outside "
                                       f"its windows, its rule counts {rule}")
                missed["T3"] += got
    check(all(m > 0 for m in missed.values()),
          f"the random rows missed no window: {missed}")
    # past the compared row: K5 compares 24 words, T1 and T2 32
    for name, w in (("K5", fk.W_CMP), ("T1", 32), ("T2", 32)):
        _, rows1, rows2, o1, o2, n = past_row_pairs(rng, n_rows, w)
        r1, r2, g = t(rows1), t(rows2), [t(x) for x in (o1, o2, n)]
        padded = torch.zeros((n_rows, w + 2), dtype=torch.int32,
                             device=DEVICE)
        padded[:, :w] = table[:, :w]
        want = fk.window_check_plain(padded[r1.long()], padded[r2.long()],
                                     *g)
        if name == "K5":
            for fn in (fk.verify_windows_fused_mxu_both, controls["K5"]):
                staged("K5", fn, (lines, r1, r2, *g), want,
                       window_rule_counts("K5", n_rows, r1, r2))
        elif name == "T1":
            for fn in (fv.verify_sync, controls["T1"]):
                staged("T1", fn, (lines, table, r1, r2, *g), want,
                       window_rule_counts("T1", n_rows, r1))
        else:
            run(name, fv.verify_pipe_nc(lines, table, r1, r2, *g), want,
                "past-row pairs")
    say(f"fetch: edge-case batches (P = {', '.join(map(str, sizes))}; every "
        "bit phase, n = 0, sorted and random rows, windows up to one word "
        "past the row, T3 on rows of 17 and 32 words and rows past both "
        "ends of the table, salt 0 and 1): K5, T1, T3, their _unpipelined "
        "controls, T2 == plain, and K5's, T1's and T3's row reads outside "
        "their windows == their rules' counts; out-of-window "
        "row reads on them " + ", ".join(f"{k} {m}"
                                         for k, m in missed.items()))


def fetch_phase(batch, wls, want, odd):
    """Phase 8.  Returns (times, errs, launches, bounds, floors) keyed by
    kernel id."""
    import numpy as np
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.tools import exp_mxu_fetch as mf

    t0 = time.perf_counter()
    store = batch[0]
    wp = store.n_words + 1
    orig, relab = wls["xla"].to(DEVICE), wls["fused_mxu3"]
    check(relab.packed is not None, "fused_mxu3 kept no relabeled table")
    perm = torch.from_numpy(relab.perm).to(DEVICE)
    rdev = relab.to(DEVICE)
    pa = orig.table
    d = {"batch": (orig.rows1, orig.rows2, orig.o1, orig.o2, orig.n),
         "relab": (rdev.rows1, rdev.rows2, rdev.o1, rdev.o2, rdev.n),
         "packed": pa,
         "lines": torch.from_numpy(fk.pack_lines(
             pa.cpu().numpy().view(np.uint32))[0].view(np.int32)).to(DEVICE),
         "lines_relab": torch.from_numpy(fk.pack_lines(
             relab.packed)[0].view(np.int32)).to(DEVICE),
         "salt": 0}
    n_rows = {"T1": d["lines"].numel() // fk.W32,
              "K5": d["lines_relab"].numel() // fk.W32}
    n_pairs = len(orig.n)
    slices = [slice(s, min(s + VERIFY_SLICE, n_pairs))
              for s in range(0, n_pairs, VERIFY_SLICE)]
    # the tool's checksum per table row: a pair's is its row's
    row_sums = torch.from_numpy(mf.checksum_numpy(
        pa.cpu().numpy().view(np.uint32), np.arange(len(pa)))).to(DEVICE)
    say(f"fetch: set-up {time.perf_counter() - t0:.2f} s (32-word line "
        "tables of the batch and of phase 7's relabel)")

    kern = fetch_kernels()
    controls = {**unpipelined_controls(), "T2": fk.fused_compare_fetch_direct}
    for k in (*kern.values(), *controls.values()):
        k.launches = 0
    misses = {"K5": 0, "T1": 0, "T3": 0}
    t0 = time.perf_counter()
    r1, r2, o1, o2, n = d["batch"]
    q1, q2, p1, p2, pn = d["relab"]
    for moved in (0, 1):
        o2m, p2m = o2 + moved * odd, p2 + moved * odd[perm]
        for sl in slices:
            ref, ref_r = want[moved][sl], want[moved][perm[sl]]
            got = {
                "K5": (fk.verify_windows_fused_mxu_both(
                    d["lines_relab"], q1[sl], q2[sl], p1[sl], p2m[sl],
                    pn[sl], n_words=store.n_words), ref_r),
                "T1": (kern["T1"](d["lines"], pa, r1[sl], r2[sl], o1[sl],
                                  o2m[sl], n[sl]), ref),
                "T2": (kern["T2"](d["lines"], pa, r1[sl], r2[sl], o1[sl],
                                  o2m[sl], n[sl]), ref),
                "T3": (kern["T3"](pa, r1[sl], r1[sl][::fk.TILE].contiguous(),
                                  moved),
                       row_sums[r1[sl].long() + moved].to(torch.int32)),
            }
            for k, m in misses.items():
                misses[k] = m + int(kern[k].out_of_window)
            for k, rule in (("K5", window_rule_counts(
                    "K5", n_rows["K5"], q1[sl], q2[sl])),
                            ("T1", window_rule_counts("T1", n_rows["T1"],
                                                      r1[sl]))):
                c = int(kern[k].out_of_window)
                check(c == rule, f"{k}: {c} row reads outside its windows "
                                 f"on slice {sl.start}:{sl.stop}, its rule "
                                 f"counts {rule}")
            for k, (g, w) in got.items():
                check(g.dtype == w.dtype and g.shape == w.shape,
                      f"{k}: output {g.dtype} {tuple(g.shape)}")
                bad = int((g != w).sum())
                check(bad == 0, f"{k}: {bad} of {len(g)} pairs of slice "
                                f"{sl.start}:{sl.stop} (moved {moved}) differ "
                                "from " + ("the numpy checksum" if k == "T3"
                                           else "the plain verify_windows"))
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in kern.items()}
    say(f"fetch: K5 (relabeled), T1, T2 on {len(slices)} slices of up to "
        f"{VERIFY_SLICE} pairs, as made and with the moved windows, == plain "
        "verify_windows; T3 with salt 0 and 1 == the numpy checksum "
        f"({time.perf_counter() - t0:.2f} s)")
    say("fetch: launches on the fetch experiments: " + ", ".join(
        f"{k} {c}" for k, c in launches.items()))
    say("fetch: out-of-window row reads over the batch (both passes): " +
        ", ".join(f"{k} {m} of {2 * n_pairs * (2 if k == 'K5' else 1)}"
                  for k, m in misses.items()) +
        "; K5's and T1's == their window rules' counts on every slice")
    for k, c in launches.items():
        check(c > 0, f"the fetch experiments never launched {k}")
    for k, f in controls.items():
        check(f.launches == 0, f"the fetch experiments launched {k}'s "
                               "control")
        launches[f"{k}_{FETCH_CONTROLS[k]}"] = f.launches

    # each kernel against its plain version, and the times, at P = 2^22;
    # K5, T1 and T2 in turns with their controls, as made and moved
    full = [sl for sl in slices if sl.stop - sl.start == VERIFY_SLICE]
    picks = [full[int(i)] for i in
             sorted({int(x) for x in np.linspace(0, len(full) - 1, 5)})]
    d_moved = dict(d, batch=(r1, r2, o1, o2 + odd, n),
                   relab=(q1, q2, p1, p2 + odd[perm], pn), salt=1)
    times, errs, bounds, floors = {}, {}, {}, {}
    for sl in picks:
        moved = fetch_inputs(d_moved, sl, wp)
        for k, (fn, plain, args, bd, control) in fetch_inputs(
                d, sl, wp).items():
            bounds.setdefault(k, []).append(bd)
            floors.setdefault(k, []).append(column_floor(k, args, wp))
            ctl = f"_{FETCH_CONTROLS[k]}"
            for tag, a in (("", args), ("_moved", moved[k][2])):
                ref = plain(*a)
                for name, f in ((k, fn), (k + ctl, control)):
                    got = f(*a)
                    torch.cuda.synchronize()
                    err = int((got.long() - ref.long()).abs().max())
                    check(err == 0, f"{name} disagrees with its plain "
                                    f"version on {int((got != ref).sum())} "
                                    f"pairs of slice {sl.start}:{sl.stop}"
                                    f"{tag}")
                    errs[name] = max(errs.get(name, 0), err)
                turns(times, k, ctl, tag, lambda: fn(*a),
                      lambda: control(*a), None if tag else (
                          lambda: plain(*a)))
    med = {k: statistics.median(v) for k, v in times.items()}
    bounds = {k: median_bound(v) for k, v in bounds.items()}
    floors = {k: median_bound(v, "sector_bytes") for k, v in floors.items()}
    for k, name, _, _ in FETCH_KERNELS:
        held = (f" (held {med[k + '_held']:.4f} ms)"
                if k + "_held" in med else "")
        say(f"fetch: {k} {name} {med[k]:.4f} ms{held}, plain "
            f"{med[k + '_plain']:.4f} ms (P = {VERIFY_SLICE}, median of "
            f"{len(picks)} slices); {bounds[k]['bytes']} B, bound "
            f"{bounds[k]['bound_ms']:.4f} ms ({bounds[k]['bound_by']})")
        say("fetch: " + turns_line(k, FETCH_CONTROLS[k], med, floors,
                                   "salt 1" if k == "T3" else "moved"))
    fetch_edge_cases(pa, errs)
    del d, d_moved, orig, rdev, row_sums
    torch.cuda.empty_cache()
    return med, errs, launches, bounds, floors


# ---------------------------------------------------------------------------
# --profile: where one device relation spends its time
# ---------------------------------------------------------------------------
def profile_phase(store, table, top=8):
    """One more `_device_relation` under cProfile (host) and torch.profiler
    (card).  The device's busy time is the union of its kernel and copy
    intervals, so an interval that overlaps another counts once."""
    import cProfile
    import pstats
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from disco_tpu_torch.overlap.relation import _device_relation

    host = cProfile.Profile()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        host.enable()
        _device_relation(store, table, device=DEVICE)
        torch.cuda.synchronize()
        host.disable()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        n, us = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    check(spans, "the profiled relation ran nothing on the card")
    busy, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    busy /= 1e6
    say(f"profile: relation wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(union of {len(spans)} kernel and copy intervals), idle share "
        f"{1 - busy / wall:.4f}")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        say(f"profile: device {us / 1e3:.3f} ms in {n} x {name[:100]}")
    rows = sorted(((ct, nc, f"{func} ({pathlib.Path(fn).name}:{line})")
                   for (fn, line, func), (_, nc, _, ct, _)
                   in pstats.Stats(host).stats.items()
                   if "disco_tpu_torch" in fn or fn == "~"), reverse=True)
    for ct, nc, where in rows[:2 * top]:
        say(f"profile: host {ct:.3f} s cumulative in {nc} x {where}")


def ptxas_report(source, names):
    """{kernel: (registers, static shared bytes, spill store bytes, spill
    load bytes)} of the named kernels of csrc/<source>, from `ptxas -v` on
    a compile with kernels.load_cuda's target and flags (to a cubin that is
    discarded)."""
    import re
    from disco_tpu_torch import kernels
    res = subprocess.run(
        [kernels.nvcc(), "-arch=sm_90a", "-std=c++17", "-O3", "-cubin",
         "-Xptxas", "-v", "-o", os.devnull, str(kernels.CSRC / source)],
        check=True, capture_output=True, text=True)
    out, fn = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            k = re.search(r"((?:window|row)_[a-z_]*_kernel)", m.group(1))
            fn = k.group(1) if k else None
            continue
        if fn not in names:
            continue
        regs, smem, spills = out.get(fn, (0, 0, (0, 0)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            smem = int(s.group(1)) if s else 0
        out[fn] = (regs, smem, spills)
    check(sorted(out) == sorted(names), f"ptxas -v reported {sorted(out)}:"
          f" {(res.stdout + res.stderr)[-2000:]}")
    return {k: (r, s, *sp) for k, (r, s, sp) in out.items()}


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more device relation (host and card)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA card: torch.cuda.is_available() is false")
    say(f"card: {card_line()}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import numpy as np
    from disco_tpu_torch import native
    from disco_tpu_torch.buildg.pipeline import run_buildg
    from disco_tpu_torch.cli import _cfg_min_overlap
    from disco_tpu_torch.index.table import FingerprintTable
    from disco_tpu_torch.io.readstore import ReadStore
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.overlap.relation import _device_relation
    from disco_tpu_torch.tools import exp_mxu_fetch as mf

    walls = StageWalls()
    tlog = logging.getLogger("disco_tpu_torch")
    tlog.addHandler(walls)
    tlog.setLevel(logging.INFO)

    # ---- 2. build: one compiler per library, all started together -----
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        builds = {name: pool.submit(timed, fn) for name, fn in (
            ("dual_compare.cu (nvcc, sm_90a)", fk.load),
            ("window_compare.cu (nvcc, sm_90a)", fk.load_window),
            ("window_staged.cu (nvcc, sm_90a)", fk.load_staged),
            ("host libraries (g++)", native.build_all))}
        reports = [pool.submit(ptxas_report, source, names)
                   for source, names in PTXAS_KERNELS.items()]
        done = {name: f.result() for name, f in builds.items()}
        report = {k: v for f in reports for k, v in f.result().items()}
    say(f"build: {time.perf_counter() - t0:.2f} s in all: " + ", ".join(
        f"{name} {t:.2f} s" for name, t in done.items()))
    def ring(shape):
        return "{} pairs a tile, {} stages, {} blocks".format(
            shape[0], shape[2], shape[1])

    tile = "one block of 256 threads a 1024-pair tile"
    shapes = {  # at the main path's widths: Wp = 17, fused_mxu's Wb = 32
        "window_compare_kernel": ("K3", ring(fk.tiled_shape(17, 0, 1 << 22))),
        "window_compare_fetch_kernel": ("K4, T2", ring(
            fk.tiled_shape(32, 32, 1 << 22))),
        "window_compare_fetch_both_kernel": (
            "K6", "four pairs a thread, 1024 pairs a block of 256 threads"),
        "window_compare_fetch_both_direct_kernel": (
            "K6's control", "one pair a thread"),
        "window_compare_anchored_kernel": ("T1", ring(fk.staged_shape(
            "T1", 17, 17, 1 << 22))),
        "window_compare_ring_both_kernel": ("K5", ring(fk.staged_shape(
            "K5", 0, 17, 1 << 22))),
        "window_compare_staged_kernel": ("T1's control", tile),
        "window_compare_staged_both_kernel": ("K5's control", tile),
        "row_checksum_ring_kernel": ("T3", ring((fk.TILE, *mf.checksum_shape(
            17, 1 << 22)[::-1]))),
        "row_checksum_staged_kernel": ("T3's control", tile)}
    for k, (regs, smem, st, ld) in report.items():
        kid, where = shapes[k]
        say(f"build: ptxas -v {k} ({kid}): {regs} registers, {smem} B static "
            f"shared memory, spills {st} B stored and {ld} B loaded; at the "
            f"main path's widths {where}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        tmp = pathlib.Path(tmpdir)
        # ---- 3. data ---------------------------------------------------
        fasta = tmp / "reads.fasta"
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, str(ROOT / "tools" / "make_testdata.py"),
             str(fasta), "--genome-len", str(args.genome_len), "--coverage",
             str(args.coverage), "--read-len", "250", "--insert", "500",
             "--seed", "42"], check=True, stdout=subprocess.DEVNULL)
        min_ovl = _cfg_min_overlap(
            str(ROOT / "tests" / "golden" / "thresh146" / "cfg.cfg"))
        check(min_ovl == 30, f"MinOverlap4BuildGraph = {min_ovl}")
        t1 = time.perf_counter()
        store = ReadStore.from_files([str(fasta)], [], min_ovl)
        table = FingerprintTable.build(store, min_ovl - 1)
        n_win = int(store.lengths.sum()) - store.n_reads * table.k
        say(f"data: {args.genome_len} bp genome, {args.coverage}x, 250 bp: "
            f"{store.n_reads} reads, {n_win} windows, {len(table.keys)} "
            f"table entries (made in {t1 - t0:.2f} s, loaded in "
            f"{time.perf_counter() - t1:.2f} s)")

        # ---- 4. kernels ------------------------------------------------
        med, errs, bounds = kernel_phase(store, table)
        golden_phase(tmp)

        # ---- 5. slice: the main path, with the launch counts ------------
        def buildg(backend):
            walls.walls.clear()
            t0 = time.perf_counter()
            _, rel, _ = run_buildg([str(fasta)], [], str(tmp / backend),
                                   min_overlap=min_ovl,
                                   write_par_graph_size=20000,
                                   backend=backend, device=DEVICE)
            torch.cuda.synchronize()
            return rel, time.perf_counter() - t0, list(walls.walls)

        def counts():
            return (fk.fused_compare_dual.launches,
                    fk.fused_compare_dual_fetch.launches)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.fused_compare_dual.launches = 0
        fk.fused_compare_dual_fetch.launches = 0
        rel_dev, t_dev, dev_walls = buildg("device")
        k1_dev, k2_dev = counts()
        rel_xla, t_xla, xla_walls = buildg("xla")
        k1_all, k2_all = counts()
        launches = {"K1": k1_all, "K2": k2_all}
        peak = torch.cuda.max_memory_allocated()
        say(f"slice: launches on the main path: K2 {k2_all} (-backend device "
            f"{k2_dev}, -backend xla {k2_all - k2_dev}); K1 {k1_all} "
            f"(-backend device {k1_dev}, the exact re-run of "
            f"{rel_dev.stats['fallback_chunks']} overflowing of "
            f"{rel_dev.stats['chunks']} chunks; -backend xla "
            f"{k1_all - k1_dev})")
        check(k2_dev > 0, "the device buildG never launched K2")
        check(k2_all == k2_dev, "the xla buildG launched K2")
        check(k1_all > k1_dev, "the xla buildG never launched K1")
        check_same_relation(rel_xla, rel_dev, "xla", "device")

        _, t_nat, nat_walls = buildg("native")
        for suffix in OUTPUTS:
            want = (tmp / ("native" + suffix)).read_bytes()
            check(len(want) > 0, f"empty {suffix}")
            for backend in ("device", "xla"):
                check((tmp / (backend + suffix)).read_bytes() == want,
                      f"{backend} and native {suffix} differ")
        say("slice: device, xla and native buildG outputs byte-identical: "
            + ", ".join(f"{s} ({(tmp / ('native' + s)).stat().st_size} B)"
                        for s in OUTPUTS))
        for name, w, total in (("device", dev_walls, t_dev),
                               ("xla", xla_walls, t_xla),
                               ("native", nat_walls, t_nat)):
            say(f"slice: {name} buildG {total:.2f} s: " + ", ".join(
                f"{s} {t:.2f} s" for s, t in w))
        say(f"slice: peak device memory {peak / 2**20:.1f} MiB")

        # ---- 6. the device engine with its K1 check ----------------------
        fk.fused_compare_dual.launches = 0
        t0 = time.perf_counter()
        rel_k1 = _device_relation(store, table, device=DEVICE, fetch=False)
        torch.cuda.synchronize()
        t_k1 = time.perf_counter() - t0
        check(fk.fused_compare_dual.launches > 0,
              "the device engine's K1 check never launched K1")
        check_same_relation(rel_k1, rel_dev, "K1 engine", "device")
        say(f"engine: K1 check (fetch=False) {fk.fused_compare_dual.launches} "
            f"launches, relation == K2 relation ({len(rel_dev)} rows) in "
            f"{t_k1:.2f} s; fallback chunks "
            f"{rel_k1.stats['fallback_chunks']} of {rel_k1.stats['chunks']}")
        if args.profile:
            profile_phase(store, table)
        del store, table, rel_dev, rel_xla, rel_k1
        torch.cuda.empty_cache()

        # ---- 7. the verify paths of bench_verify ------------------------
        t0 = time.perf_counter()
        v_med, v_errs, v_launches, v_bounds, v_floors, reuse = \
            verify_paths_phase(fasta, min_ovl)
        say(f"verify: phase {time.perf_counter() - t0:.2f} s")

        # ---- 8. the fetch experiments -----------------------------------
        t0 = time.perf_counter()
        f_med, f_errs, f_launches, f_bounds, f_floors = fetch_phase(*reuse)
        del reuse
        say(f"fetch: phase {time.perf_counter() - t0:.2f} s")

    def entry(k, name, source, replaces, n, errs, times, bd, floors=None):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": n, "max_abs_err": errs[k],
             "ms": times[k], "plain_ms": times[k + "_plain"],
             "bytes": bd["bytes"], "bound_ms": bd["bound_ms"],
             "bound_by": bd["bound_by"], "library_ms": None}
        if k + "_held" in times:        # K1, K2, K6, K7, T3
            e["held_ms"] = times[k + "_held"]
        if floors and k in floors:      # all but K1, K2, K7: the control
            ctl = FETCH_CONTROLS.get(k, "direct")
            e.update(floors[k], **{
                f"{ctl}_launches": n_all[f"{k}_{ctl}"],
                f"{ctl}_ms": times[f"{k}_{ctl}"],
                f"{ctl}_max_abs_err": errs[f"{k}_{ctl}"],
                "ms_moved": times[k + "_moved"],
                f"{ctl}_ms_moved": times[f"{k}_{ctl}_moved"]})
            if k + "_held" in times:    # K6, T3
                e.update({f"{ctl}_held_ms": times[f"{k}_{ctl}_held"],
                          "held_ms_moved": times[k + "_held_moved"],
                          f"{ctl}_held_ms_moved":
                              times[f"{k}_{ctl}_held_moved"]})
        for kernel, (kid, _) in shapes.items():
            if k in kid.split(", "):
                regs, smem, st, ld = report[kernel]
                e.update(registers=regs, spill_store_bytes=st,
                         spill_load_bytes=ld)
            elif kid == f"{k}'s control":
                ctl = FETCH_CONTROLS.get(k, "direct")
                regs, smem, st, ld = report[kernel]
                e.update({f"{ctl}_registers": regs,
                          f"{ctl}_spill_store_bytes": st,
                          f"{ctl}_spill_load_bytes": ld})
        return e

    n_all = {**v_launches, **f_launches}
    kernels = [
        entry("K1", "fused_compare_dual", KERNEL_SOURCE, K1_REPLACES,
              launches["K1"], errs, med, bounds["K1"]),
        entry("K2", "fused_compare_dual_fetch", KERNEL_SOURCE, K2_REPLACES,
              launches["K2"], errs, med, bounds["K2"]),
    ] + [entry(k, name, WINDOW_SOURCE, replaces, v_launches[k], v_errs,
               v_med, v_bounds[k], v_floors)
         for k, name, replaces in SINGLE_KERNELS] + [
        entry(k, name, source, replaces, f_launches[k], f_errs, f_med,
              f_bounds[k], f_floors)
        for k, name, replaces, source in FETCH_KERNELS]
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
