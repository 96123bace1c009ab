#!/usr/bin/env python3
"""Smoke run of disco_tpu_torch's buildG and assemble on one NVIDIA card
(H100).

    python3 chip_smoke.py [--genome-len 4600000] [--coverage 30]

Phases; any that fails ends the run with a non-zero exit and no result line:

1. card: fail unless torch sees a CUDA card; print its name and power
   limit, and the torch and CUDA versions;
2. build: the CUDA kernels (nvcc, sm_90a) and the C++ host libraries (g++)
   from the checkout's sources, timed, and `ptxas -v`'s registers, shared
   memory and spills for K1's rows route (compaction and check), K3's,
   K4's, K6's, T1's, K5's and T3's kernels and
   K6's, T1's, K5's and T3's controls, with their tiles, stages and blocks
   at the main path's widths;
3. data: an E. coli-sized read set from tools/make_testdata.py (4.6 Mb
   genome, 30x, 250 bp paired reads, 500 bp insert, seed 42), and the cut
   set of phases 5 (xla), 7, 8, 9, 10 and 11 (the same make of a 1 Mb
   genome, CUT_GENOME);
   MinOverlap4BuildGraph from the shipped cfg (30);
4. kernels: both dual-check kernels (and, past the row, K1's rows route)
   against their plain PyTorch versions
   on the card, exactly: on real candidate chunks at the main path's shape
   (2^20 windows, cand_cap 4M pairs, Wp = 17), on an edge-case batch
   (n = 0, every bit phase, windows ending at the read's last base, P not
   a multiple of 1024) and on windows running up to one word past the row,
   which the kernels read as zeros; kernel and plain times by CUDA events,
   the median over several chunks, the kernels' also held (below);
   reference: the device backend's outputs on the golden `mini` and
   `ecoli` inputs are byte-identical to the reference assembler's, as it
   runs and with its caps forced small (chunks of 4096 windows, cand_cap
   under one candidate a window: some chunks, not all, re-run exactly
   through K1's column kernel, which must launch);
5. slice, the main path: with the launch counts set to 0, `run_buildg`
   with the device backend (`buildg -backend device`: every candidate
   through the K2 kernel; K1 only for the exact re-run of a chunk that
   overflows its caps) and then with the xla backend on the cut set
   (`buildg -backend xla`: every candidate through the K1 kernel; the
   4.6 Mb set until phase 13 needed the time).  The counts are read right
   after those two runs and each must be above 0.  `run_buildg` with the
   native (C++) backend on both sets must give byte-identical files (the
   cut set's are also what phases 9 to 11 are held to), and the xla
   relation must equal the device relation of the cut set.  Prints the
   stage walls, fallback chunks and peak device memory;
6. the device engine with its K1 check (fetch=False: K1's rows route,
   `fused_compare_dual_rows`), its count set to 0 before it: the
   relation must equal the K2 one; then the 8-byte wire rows (`wire64`,
   which sets of 2^23 reads and more take): the relation must equal the
   4-byte one with no chunk re-run, its wall printed beside the 4-byte
   run's overlapRelation;
7. verify paths, the main path of bench_verify (`python -m
   disco_tpu_torch.bench_verify`): every candidate pair of the cut set
   (bench_verify.candidate_batch, MinOverlap 30; the 4.6 Mb set until
   phase 14 needed the time) and the BFS relabel
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
   at P = 2^22 (the median over up to 5 spread slices; K3, K4 and K6 in turns
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
   rows past both ends of the table; the controls too);
9. assemble, reads to contigs and scaffolds (`python -m disco_tpu_torch
   assemble -backend device`, through `cli.main` in this process, with
   the shipped tests/golden/thresh146/cfg{,_2,_3}.cfg): on the golden
   `mini`, run from its directory, every buildG file and every
   fullsimplify output the reference's goldens hold must be equal; then
   on the cut set (`--write-par-graph-size 20000`; the 4.6 Mb set until
   phase 13 needed the time), with the K1 and K2 counts set to 0 just
   before and read just after (K2 must be above 0), its graph must equal
   phase 5's native files of the cut set, and every file under assembly/
   and the two FinalCombined files must equal `simplify` over those
   native files.  Prints the buildG and fullsimplify walls,
   each `clock` stage, the host's peak RSS during the run (sampled every
   10 ms, after the heap earlier phases freed is returned to the OS) and
   at its start, the contigs' and scaffolds' counts and N50 from the port's
   `stats`, the genome check (the reads carry no errors: the genome drawn
   again from the seed, every contig and every scaffold piece between runs
   of N an exact substring of it or its reverse complement,
   tools/assemble_scale.py's `genome_check`), and the card's name and
   power limit;
10. the distributed buildG (`python -m disco_tpu_torch buildg -n 4
   [-rma]`, dist/builder.py), four shards on the one card:
   __graft_entry__.py's three dryrun_multichip runs (replicated, dist-mem,
   and a forced overflow, route_cap 8, re-run exactly through K1's column
   kernel) at a budget of 2^13, each with at least 3 chunks and its files
   equal to the single-device buildG's, the supersteps through K1's rows
   route (the column kernel 0 outside the forced overflow); the golden
   `mini` through `buildg -n 4` and `-n 4 -rma`, equal to the reference's
   outputs; then the cut set (1 Mb; the 4.6 Mb set until phase 13 needed
   the time) through `buildg -n 4 -rma` and `buildg -n 4` (`-w 20000`),
   each with the K1 (rows route and column kernel) and K2 counts set to 0
   just before and read just after (the rows route above 0, the column
   kernel, the rows route's timing designs and K2 0) and its files equal
   to phase 5's native files of the cut set.  Prints each run's wall (no
   profiler runs during the timed runs) and `clock` stages, chunks and
   fallback chunks, the bytes a shard moves through the collectives a
   superstep (`tools.bench_scaling.superstep_bytes`) and the peak device
   memory; then three supersteps of each engine on phase 3's 4.6 Mb set
   under torch.profiler and cProfile (the device's busy time and idle
   share, device operations and host functions by time).  Last, K1 at the dist path's shape on shard
   0's grid of the first dist-mem superstep (the rows route's inputs,
   captured): the rows route, run once with host synchronisation made an
   error, equal to its plain version, to the column route (the engine's
   expand, gathers and transposes, then the column kernel), to the column
   kernel on the live lanes alone and to the route's other designs; then,
   in turns, back to back and held, the column route, the rows route, its
   compaction and its check alone, its designs and the column kernels,
   each against the bound and row-layout sector floor of PERF.md
   section 2 (`rows_work`);
11. one process per rank on the one card (`python -m
   disco_tpu_torch.dist.multiproc --dist-backend gloo`, dist/multiproc.py):
   two ranks, one shard each on the card (CUDA_VISIBLE_DEVICES pinned to
   the first card), launched on a free port of 127.0.0.1 through
   tools/multicard.py's RANK_LAUNCHER, which prints each rank's launch
   counts, the bytes it receives from its peer through each collective
   (the kept rows' gathers apart) and its seconds in each, its chunks,
   `clock` stages, wall and peak device memory after `multiproc.main`
   returns.  The golden `mini` in both modes, rank 0's
   files equal to the reference's outputs; NCCL, the default backend, must
   refuse the two ranks on one card (no switch to gloo); then the cut set
   (1 Mb; the 4.6 Mb set until phase 13 needed the time) through `-rma`
   and the replicated mode (`-w 20000`), rank 0's files equal to phase 5's
   native files of the cut set.  In every run each rank's rows route
   above 0, its column kernel, K2 and the route's designs 0, the ranks'
   chunk counts equal and rank 1's directory empty; a rank that fails or
   outlives its timeout fails the smoke.  Last, `assemble -ecc -backend
   device` on `mini` with stand-in BBTools scripts (copy in= to out=),
   every file equal to the same command with `-backend native`, K2 above
   0;
12. the hit-cap grid engine (overlap/device.py's `run*` steps), on phase
   3's set with disco_tpu's defaults (hit_cap 16, chunks of 2^21
   windows): with the K1 (rows route and column kernel) and K2 counts set
   to 0, `run_packed_chunked` over every window, each chunk's hits decoded
   on the card (at most out_cap a chunk); the rows route above 0, the
   column kernel and K2 0; the hits of the windows that do not overflow
   must equal phase 5's relation there.  Prints the wall, the overflowing
   windows and the peak device memory.  Then `run`, `run_compact` and
   `run_packed` must agree on the first three chunks; `device_overlap` on
   2^16 windows must equal the same call on the CPU in every field; K1's
   rows route on the first chunk's grid (P = 2^21 x 16, its inputs
   captured) equal to its plain version and timed back to back and held,
   against the bound and floors of `rows_work`; `buildg -backend device`
   on `mini` under DISCO_TPU_TORCH_TRACE (the CLI's trace wrap) with files
   equal to the untraced run's and a Chrome trace that names K2's kernel;
13. scale, the main path at the size its users run: on the JAX package's
   verified set (100 Mb genome, 25x, 250 bp pairs, 500 bp insert, seed 99:
   10,000,000 reads, 2,210,000,000 windows at MinOverlap 30), made once
   into the smoke's temporary directory, `buildg -backend device` and then
   `buildg -backend native`, each in a fresh process through
   disco_tpu_torch/tools/bench_e2e.py's `run_child` (its `child_main`).
   The reads must pass 2^23 and the windows 2^31; the device run must
   choose the 8-byte wire by itself and launch K2 (its child reports the
   count); every file both runs write must be byte-identical.  Prints the
   host's MemTotal, the reads, windows, wire, chunks and fallback chunks,
   K2's launches, each run's wall, `clock` stages and peak host RSS
   (sampled every 10 ms, as phase 9's), the device run's peak device
   memory and the seconds the reads took to make.  The device run peaks
   at some 21 GiB of host memory and the native one at 17 GiB, one after
   the other (an H100's host, PERF.md section 5);
14. dist scale, the distributed buildG at that size: `python -m
   disco_tpu_torch buildg -pe reads.fasta -n 4 -rma -m-ovl 30` on phase
   13's reads in a fresh process (`run_child`), four shards on the one
   card, with the counts of that process.  Every file must be
   byte-identical to phase 13's native files (no second native run), the
   reads past 2^23 and the windows past 2^31, K1's rows route launched, K2
   never, and K1's column kernel exactly once a re-run (fallback) chunk.
   Prints the chunks, chunk plan, fallback chunks, hit_cap, kept rows,
   wall and `clock` stages, peak host RSS (sampled every 10 ms) and peak
   device memory, and the relation's host seconds a chunk by stage
   (`dist.builder.HOST_STAGES`).

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

Prints the kernels' JSON line (K1 and K2 also with `assemble_launches`,
phase 9's counts, and `dist_launches`, phase 10's; K1 with
`multiproc_launches`, phase 11's rows-route launches over its runs and
ranks, and `multiproc_rank_launches` by run and rank; K2 with
`ecc_launches`, phase 11's `assemble -ecc`, and `scale_launches`, phase
13's device run; K1 with `dist_scale_launches`, its rows route's launches
in phase 14; K1 with its rows
route's `dist_rows_*` times, bound, sector floor, live lanes and launches
at the dist shape, and the column route and column kernels there; K1
with phase 12's `grid_launches` and its rows route's `grid_rows_*` times,
bound and floors at the grid's shape), the card's name and power limit,
and last {"ok": true, "device": {...}}."""
import argparse
import concurrent.futures
import contextlib
import dataclasses
import filecmp
import gc
import json
import logging
import os
import pathlib
import resource
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
    "dual_compare.cu": ("dual_compare_rows_fused_kernel",),
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
# phase 5's xla buildG, phases 7 and 8 (the verify paths' and fetch
# experiments' batch), phase 9's assemble and the builds of phases 10 and
# 11 (`buildg -n 4 [-rma]`, two ranks) run on a 1 Mb set of phase 3's make
# (30x, 250 bp, insert 500, seed 42) instead of the 4.6 Mb set, to leave
# phases 13 and 14 room in the smoke's time limit
CUT_GENOME = 1_000_000
SET_SEED = 42                # phase 3's seed, of both sets
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
INT32_OPS_PER_S = 67e12      # H100 SXM 32-bit rate outside the tensor cores
OUTPUTS = ("_0_parGraph.txt", "_0_containedReads.txt", "_ReadIDMap.txt",
           "_CheckpointInfo.txt")
# phase 9: the parameter files of every iteration (the reference's
# disco*.cfg), and the fullsimplify outputs the reference's goldens hold
# (tests/test_fullsimplify_parity.py::OUTPUTS)
CFG_DIR = ROOT / "tests" / "golden" / "thresh146"
CFG_ARGS = ("-p", str(CFG_DIR / "cfg.cfg"), "-p2", str(CFG_DIR / "cfg_2.cfg"),
            "-p3", str(CFG_DIR / "cfg_3.cfg"))
SIMPLIFY_OUTPUTS = (
    "phase_parsimplify_1.txt", "phase_initial_1.txt",
    "phase_aggressive_1.txt", "phase_flow_1.txt", "phase_postflow_1.txt",
    "phase_scaffold_1.txt", "dimacs_dump.txt", "scaffoldsFinal_1.fasta",
    "UsedReads_1.txt", "scaffoldEdgesFinal_1.txt",
    "scaffoldEdgeCoverageFinal_1.txt")


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


def read_sectors(windows, words):
    """The 32-B sectors of a (words, P) int32 column input, stored row after
    row, that the pairs' windows read (`fused_kernel.read_words`; windows:
    (o, n) tensor pairs, each window of a pair read): exact for any P, the
    least any kernel reads of the input at the card's sector granularity."""
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    reads = None
    for o, n in windows:
        first, last = fk.read_words(o, n, words)
        w = torch.arange(words, device=first.device)
        r = (w >= first[:, None]) & (w <= last[:, None])
        reads = r if reads is None else reads | r
    lane, w = torch.nonzero(reads, as_tuple=True)
    return int(torch.unique((w * len(reads) + lane) >> 3).numel())


def dual_floor(geo, wp):
    """K1's sector floor over its (wp, P) column inputs: a's sectors under
    the edge and containment windows, b's under the edge window and the
    containment window at offset 0, and 20 B of geometry and 2 B of output
    a pair."""
    e_o1, e_o2, e_n, c_o1, c_n = geo
    sectors = (read_sectors(((e_o1, e_n), (c_o1, c_n)), wp)
               + read_sectors(((e_o2, e_n), (0 * c_n, c_n)), wp))
    return sector_floor(len(e_n), sectors, 0, 0, geo_bytes=20, out_bytes=2)


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
    r1, r2 = r1.to(torch.int32), r2.to(torch.int32)
    want = fk.fused_compare_dual_plain(a_z, b_z, *geo)
    wrapped = fk.fused_compare_dual_plain(a, b, *geo)
    check(want[0].any() and want[1].any(), "past-row batch has no match")
    check(max_abs_err(wrapped, want) > 0,
          "past-row batch: the wrapping plain version agrees with zero fill")
    for name, got, ref in (
            ("K1", fk.fused_compare_dual(a, b, *geo), want),
            ("K2", fk.fused_compare_dual_fetch(table, b, r1, *geo),
             fk.fused_compare_dual_fetch_plain(padded, b_z, r1, *geo)),
            ("K1", fk.fused_compare_dual_rows(table, r1, table, r2, *geo),
             fk.fused_compare_dual_rows_plain(padded, r1, padded, r2,
                                              *geo))):
        err = max_abs_err(got, ref)
        check(err == 0, f"{name} disagrees with zero fill past the row on "
                        f"{int((got[0] != ref[0]).sum())} edge and "
                        f"{int((got[1] != ref[1]).sum())} containment flags")
        errs[name] = max(errs[name], err)
    del padded
    say(f"kernels: past-row batch P = {p} (up to one word past a {wp}-word "
        "row, the table's last row included): K1, K2 and K1's rows route "
        "== plain over zero-padded rows")


def dual_bounds(rows1, geo, wp):
    """K1's and K2's bounds on one chunk: K1 reads the words both windows
    span in both column inputs; K2 reads read1's distinct rows instead
    (None without rows1)."""
    e_o1, e_o2, e_n, c_o1, c_n = geo
    p = len(e_n)
    n = compared_words(e_n) + compared_words(c_n)
    b_words = span_union(e_o2, e_n, 0 * c_n, c_n).sum()
    a_words = span_union(e_o1, e_n, c_o1, c_n).sum()
    k1 = window_bound(p, a_words + b_words, 0, 0, n, geo_bytes=20,
                      out_bytes=2)
    if rows1 is None:
        return k1, None
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


@contextlib.contextmanager
def forced_caps(chunk, cand_factor):
    """While open, run_buildg's device relation runs in chunks of `chunk`
    windows with cand_cap = cand_factor * chunk candidates: the goldens
    hold under one candidate a window, so a cand_factor below 1 makes
    chunks overflow and be re-run exactly (`relation._xla_rows`, K1's
    column kernel)."""
    from disco_tpu_torch.buildg import pipeline
    from disco_tpu_torch.overlap.relation import _device_relation
    real = pipeline.compute_relation

    def forced(store, table, backend=None, device=None):
        check(backend == "device", f"backend {backend}, not device")
        return _device_relation(store, table, chunk=chunk,
                                cand_factor=cand_factor, device=device)

    pipeline.compute_relation = forced
    try:
        yield
    finally:
        pipeline.compute_relation = real


# the golden cases, their writeParGraphSize and their forced caps (chunk,
# cand_factor): re-runs of some chunks, not all (mini's chunks of 4096
# windows hold 213-761 candidates, ecoli's 189-984)
GOLDEN_CASES = (("mini", 1000, (1 << 12, 1 / 6)),
                ("ecoli", 20000, (1 << 12, 1 / 5)))


def golden_phase(tmp: pathlib.Path):
    """The device backend on the card against the reference assembler's
    committed outputs (tests/golden), as it runs and with its caps forced
    small."""
    from disco_tpu_torch.buildg.pipeline import run_buildg
    from disco_tpu_torch.overlap import fused_kernel as fk
    for case, wsize, (chunk, factor) in GOLDEN_CASES:
        gdir = ROOT / "tests" / "golden" / case
        for tag in ("", "_forced"):
            cwd = os.getcwd()
            os.chdir(gdir)   # _ReadIDMap.txt records the input path as given
            k1 = fk.fused_compare_dual.launches
            try:
                with (forced_caps(chunk, factor) if tag
                      else contextlib.nullcontext()):
                    _, rel, _ = run_buildg(
                        ["reads.fasta"], [], str(tmp / (case + tag)),
                        min_overlap=30, write_par_graph_size=wsize,
                        backend="device", device=DEVICE)
            finally:
                os.chdir(cwd)
            for suffix in OUTPUTS:
                check((tmp / (case + tag + suffix)).read_bytes()
                      == (gdir / (case + suffix)).read_bytes(),
                      f"golden {case}{suffix} differs on the device backend"
                      + (" with its caps forced small" if tag else ""))
            fb, n = rel.stats["fallback_chunks"], rel.stats["chunks"]
            k1 = fk.fused_compare_dual.launches - k1
            if not tag:
                say(f"reference: golden {case}: device backend "
                    "byte-identical to the reference outputs")
                continue
            check(0 < fb < n, f"golden {case} with the caps forced small: "
                              f"{fb} of {n} chunks re-run")
            check(k1 > 0, f"golden {case}'s forced re-runs never launched "
                          "K1's column kernel")
            say(f"reference: golden {case}, caps forced small (chunk {chunk},"
                f" cand_cap {int(factor * chunk)}): {fb} of {n} chunks re-run "
                f"exactly through K1's column kernel ({k1} launches), "
                "byte-identical to the reference outputs")


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
def profiled(fn, top=8, tag="profile"):
    """fn() under cProfile (host) and torch.profiler (card); prints the
    wall, the device's busy time (the union of its kernel and copy
    intervals, so an interval that overlaps another counts once), its idle
    share, the device operations and the host functions by time."""
    import cProfile
    import pstats
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host = cProfile.Profile()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        host.enable()
        fn()
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
    check(spans, f"{tag}: the profiled run ran nothing on the card")
    busy, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    busy /= 1e6
    say(f"{tag}: wall {wall:.3f} s, device busy {busy:.3f} s (union of "
        f"{len(spans)} kernel and copy intervals), idle share "
        f"{1 - busy / wall:.4f}")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        say(f"{tag}: device {us / 1e3:.3f} ms in {n} x {name[:100]}")
    rows = sorted(((ct, nc, f"{func} ({pathlib.Path(fn).name}:{line})")
                   for (fn, line, func), (_, nc, _, ct, _)
                   in pstats.Stats(host).stats.items()
                   if "disco_tpu_torch" in fn or fn == "~"), reverse=True)
    for ct, nc, where in rows[:2 * top]:
        say(f"{tag}: host {ct:.3f} s cumulative in {nc} x {where}")


def profile_phase(store, table):
    """One more `_device_relation` under `profiled`."""
    from disco_tpu_torch.overlap.relation import _device_relation
    profiled(lambda: _device_relation(store, table, device=DEVICE))


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
            k = re.search(r"((?:window|row|dual)_[a-z_]*_kernel)",
                          m.group(1))
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
# phase 9: assemble, reads to contigs and scaffolds
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def timed_calls(module, name, walls):
    """While open, every call of module.<name> stores its wall seconds in
    walls[name]."""
    real = getattr(module, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            walls[name] = time.perf_counter() - t0

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def assemble_phase(tmp: pathlib.Path, cut: pathlib.Path, walls):
    """`assemble -backend device` through the command line, in this
    process: on the golden `mini` against the reference's outputs, then on
    the cut set (`cut`, CUT_GENOME) with the K1 and K2 counts set to 0 just
    before, its graph against phase 5's native files of the cut set, its
    assembly against `simplify` over those native files and its contigs
    and scaffold pieces against the genome.  Returns the
    launches."""
    import torch
    from disco_tpu_torch import cli
    from disco_tpu_torch.buildg import pipeline
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.simplify import driver
    from disco_tpu_torch.tools.assemble_scale import draw_genome, genome_check
    from disco_tpu_torch.tools.bench_e2e import RssPeak
    from disco_tpu_torch.utils.logging import malloc_trim
    from disco_tpu_torch.utils.stats import assembly_stats

    gdir = ROOT / "tests" / "golden" / "mini"
    out = tmp / "assemble_mini"
    cwd = os.getcwd()
    os.chdir(gdir)    # _ReadIDMap.txt records the input path as given
    try:
        rc = cli.main(["assemble", "-inP", "reads.fasta", "-d", str(out),
                       "-o", "mini", *CFG_ARGS, "-backend", "device"])
    finally:
        os.chdir(cwd)
    check(rc == 0, f"assemble on mini exited {rc}")
    for suffix in OUTPUTS:
        check((out / "graph" / f"mini{suffix}").read_bytes()
              == (gdir / f"mini{suffix}").read_bytes(),
              f"assemble: golden mini{suffix} differs")
    for name in SIMPLIFY_OUTPUTS:
        check((out / "assembly" / f"mini_{name}").read_bytes()
              == (gdir / "simplify" / f"mini_{name}").read_bytes(),
              f"assemble: golden mini_{name} differs")
    say(f"assemble: golden mini: -backend device byte-identical to the "
        f"reference's buildG ({len(OUTPUTS)} files) and fullsimplify "
        f"({len(SIMPLIFY_OUTPUTS)} files) outputs")

    # the cut set, the counts set to 0 just before; the heap that
    # earlier phases freed goes back to the OS first, so that the resident
    # set at the start is what the run inherits
    out = tmp / "assemble"
    calls = {}
    walls.walls.clear()
    gc.collect()
    malloc_trim()
    torch.cuda.synchronize()
    fk.fused_compare_dual.launches = 0
    fk.fused_compare_dual_fetch.launches = 0
    t0 = time.perf_counter()
    with timed_calls(pipeline, "run_buildg", calls), \
            timed_calls(driver, "run_fullsimplify", calls), RssPeak() as rss:
        rc = cli.main(["assemble", "-inP", str(cut), "-d", str(out),
                       "-o", "E", *CFG_ARGS, "-backend", "device",
                       "--write-par-graph-size", "20000"])
        torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = {"K1": fk.fused_compare_dual.launches,
                "K2": fk.fused_compare_dual_fetch.launches}
    stages = list(walls.walls)
    check(rc == 0, f"assemble exited {rc}")
    say(f"assemble: launches: K2 {launches['K2']}, K1 {launches['K1']}")
    check(launches["K2"] > 0, "assemble -backend device never launched K2")
    for suffix in OUTPUTS:
        check((out / "graph" / f"E{suffix}").read_bytes()
              == (tmp / f"native_cut{suffix}").read_bytes(),
              f"assemble's graph E{suffix} differs from the native buildG's")

    # simplify over phase 5's native graph of the cut set
    simp = tmp / "simplify"
    simp.mkdir()
    t0 = time.perf_counter()
    check(cli.main(["simplify", "-fpi", str(cut),
                    "-e", str(tmp / "native_cut_0_parGraph.txt"),
                    "-crd", str(tmp / "native_cut_0_containedReads.txt"),
                    "-o", str(simp / "E"), *CFG_ARGS]) == 0,
          "simplify exited non-zero")
    t_simp = time.perf_counter() - t0
    asm = out / "assembly"
    combined = {f"E_{k}FinalCombined.fasta": k
                for k in ("contigs", "scaffolds")}
    names = sorted(p.name for p in asm.iterdir())
    check(sorted(set(names) - set(combined))
          == sorted(p.name for p in simp.iterdir()),
          f"assemble and simplify wrote other files: {names}")
    for name in names:
        if name in combined:
            parts = sorted(simp.glob(f"E_{combined[name]}Final_*.fasta"))
            want = b"".join(p.read_bytes() for p in parts)
            check((out / name).read_bytes() == want,
                  f"assemble's top-level {name} differs")
        else:
            want = (simp / name).read_bytes()
        check((asm / name).read_bytes() == want,
              f"assemble's {name} differs from simplify's")
    say(f"assemble: graph equals the native buildG's ({len(OUTPUTS)} "
        f"files); all {len(names)} files under assembly/ and the two "
        "FinalCombined files equal simplify over the native graph")

    say(f"assemble: wall {t_all:.2f} s: buildG {calls['run_buildg']:.2f} s, "
        f"fullsimplify {calls['run_fullsimplify']:.2f} s; simplify alone "
        f"{t_simp:.2f} s")
    say("assemble: stages: " + ", ".join(f"{n} {t:.3f} s" for n, t in stages))
    say(f"assemble: host peak RSS during assemble {rss.peak / 2**20:.0f} MiB, "
        f"{rss.start / 2**20:.0f} MiB at its start, so the run added "
        f"{(rss.peak - rss.start) / 2**20:.0f} MiB (sampled every "
        f"{rss.period * 1000:.0f} ms; the process's peak since it started "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f} "
        "MiB)")
    for kind in ("contigs", "scaffolds"):
        st = assembly_stats(str(out / f"E_{kind}FinalCombined.fasta"))
        check(st.n_contigs > 0 and st.n50 > 0, f"no {kind}")
        say(f"assemble: {kind}: {st.n_contigs} sequences, N50 {st.n50} bp, "
            f"{st.total_len} bp in all, longest {st.max_len} bp")
    # the reads carry no errors: every contig and scaffold piece lies in
    # the genome they were drawn from, or in its reverse complement
    t0 = time.perf_counter()
    held = genome_check(draw_genome(CUT_GENOME, SET_SEED),
                        sorted(asm.glob("E_contigsFinal_*.fasta")),
                        sorted(asm.glob("E_scaffoldsFinal_*.fasta")))
    check(held["ok"], f"assemble: the genome check failed: {held}")
    ctg, scf = held["contigs"], held["scaffolds"]
    say(f"assemble: genome check ({CUT_GENOME} bp, seed {SET_SEED}, drawn "
        f"again): all {ctg['pieces']} contigs of {ctg['files']} files and "
        f"all {scf['pieces']} scaffold pieces between runs of N (of "
        f"{scf['sequences']} scaffolds, longest {scf['longest']} bp, "
        f"covering {scf['longest_covers']:.6f} of the genome) lie exactly "
        f"in the genome or its reverse complement; "
        f"{time.perf_counter() - t0:.2f} s")
    say(f"assemble: card {card_line()}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the distributed buildG, four shards on the one card
# ---------------------------------------------------------------------------
DIST_SHARDS = 4
DIST_OUTPUTS = ("_0_parGraph.txt", "_0_containedReads.txt",
                "_0_startRead.txt")


def dryrun_reads(path: pathlib.Path):
    """__graft_entry__.py's dryrun_multichip reads: 600 of 36-56 bp from a
    3 kb genome, half reverse-complemented, so that the runs have
    containment rows and all four orientations."""
    import numpy as np
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    rc = dict(zip("ACGT", "TGCA"))
    recs = []
    for _ in range(600):
        ln = int(rng.integers(36, 57))
        s = int(rng.integers(0, len(genome) - ln))
        seq = genome[s:s + ln]
        if rng.random() < 0.5:
            seq = "".join(rc[c] for c in reversed(seq))
        recs.append(seq)
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))


@contextlib.contextmanager
def sharded_record(builder, rec):
    """While open, every run_buildg_sharded call (the CLI's too) counts its
    chunks into rec["stats"], and chunk_plan's (hit_cap, chunk, route_cap)
    lands in rec["plan"]."""
    real_run, real_plan = builder.run_buildg_sharded, builder.chunk_plan

    def run(*a, **kw):
        rec["stats"] = kw["stats"] = {}
        return real_run(*a, **kw)

    def plan(*a, **kw):
        rec["plan"] = real_plan(*a, **kw)
        return rec["plan"]

    builder.run_buildg_sharded, builder.chunk_plan = run, plan
    try:
        yield rec
    finally:
        builder.run_buildg_sharded, builder.chunk_plan = real_run, real_plan


def rows_work(t1, r1, t2, r2, geo):
    """The work of K1's rows route on one grid (one rule for both routes,
    PERF.md section 2): every lane's e_n and c_n read and its two flags
    written (10 B); a live lane's two row indices and the offsets of its
    windows with a length (4 B each); the words its windows span, each
    word of each distinct (table, row) once (by address: one table passed
    twice counts once); about 5 operations a compared word.  Returns
    {lanes, live, words, row_sectors, geo_sectors, compared}: the bytes of
    the first two, of the words, of the tables' 32-B sectors under the
    windows, and of the sectors of the index and offset arrays under the
    live lanes, the live lanes and the compared words."""
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    e_o1, e_o2, e_n, c_o1, c_n = geo
    p, wp = len(e_n), t1.shape[1]
    sel = torch.nonzero((e_n > 0) | (c_n > 0)).squeeze(1)
    e_sel, c_sel = sel[e_n[sel] > 0], sel[c_n[sel] > 0]
    addrs = []
    w = torch.arange(wp, device=sel.device)
    for table, rows, windows in ((t1, r1, ((e_o1, e_n), (c_o1, c_n))),
                                 (t2, r2, ((e_o2, e_n), (0 * c_o1, c_n)))):
        row = rows[sel].long()
        inside = (row >= 0) & (row < table.shape[0])   # else: zeros, no read
        base = table.data_ptr() // 4 + row * wp
        for o, n in windows:
            first, last = fk.read_words(o[sel], n[sel], wp)
            m = (w >= first[:, None]) & (w <= last[:, None]) & inside[:, None]
            addrs.append((base[:, None] + w)[m])
    words = torch.unique(torch.cat(addrs))
    geo_sectors = sum(
        int(torch.unique((a.data_ptr() // 4 + lanes) >> 3).numel())
        for a, lanes in ((r1, sel), (r2, sel), (e_o1, e_sel), (e_o2, e_sel),
                         (c_o1, c_sel)))
    return {"lanes": 10 * p,
            "live": 4 * (2 * len(sel) + 2 * len(e_sel) + len(c_sel)),
            "live_lanes": len(sel), "words": 4 * len(words),
            "row_sectors": 32 * int(torch.unique(words >> 3).numel()),
            "geo_sectors": 32 * geo_sectors,
            "compared": compared_words(e_n[sel]) + compared_words(c_n[sel])}


def rows_bounds(work):
    """{route, check}: the bound of the whole route, its row-layout sector
    floor (the tables' sectors under the windows in place of their words)
    and its whole-sector floor (also the index and offset arrays' sectors
    under the live lanes in place of their bytes); the same for a
    two-kernel design's check alone on the live list (per live lane its
    id, e_n, c_n and two flags, 14 B, beside its indices and offsets)."""
    out = {}
    for name, per in (("route", work["lanes"]),
                      ("check", 14 * work["live_lanes"])):
        bd = bound(per + work["live"] + work["words"], 5 * work["compared"])
        bd["sector_floor_ms"] = 1e3 * (per + work["live"] +
                                       work["row_sectors"]) / HBM_BYTES_PER_S
        bd["whole_sector_floor_ms"] = 1e3 * (
            per + work["geo_sectors"] + work["row_sectors"]) / HBM_BYTES_PER_S
        out[name] = bd
    return out


def rows_turns(fns, reps=20):
    """Each fn timed back to back and held, in turns: forward, then
    backward; the mean of the two passes.  Returns {name: (ms, held_ms)}."""
    order = list(fns)
    got = {k: [] for k in order}
    for names in (order, order[::-1]):
        for k in names:
            got[k].append((cuda_ms(fns[k], reps),
                           cuda_ms(fns[k], reps, hold=True)))
    return {k: tuple(sum(x) / 2 for x in zip(*v)) for k, v in got.items()}


def dist_rows_check(t1, r1, t2, r2, geo, h):
    """K1 at the dist shape, on the grid captured from the dist-mem
    superstep (shard 0's inputs to the rows route): the rows route against
    its plain version, the column route (the engine's expand, gathers,
    transposes and the column kernel, `_dual_check`), the column kernel
    over the live lanes' columns gathered densely and the route's other
    designs, every flag equal; the route once with host synchronisation
    made an error; then each timed in turns, with the bound and sector
    floor of section 2.  Returns (times, errs, bounds, shape)."""
    import torch
    from disco_tpu_torch.overlap import device as dv
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.tools import exp_k1_rows_designs as k1d
    p, (q, wp) = len(r1), t1.shape
    lane = torch.arange(p, device=r1.device)
    check(p == q * h and torch.equal(r1.long(), lane // h)
          and torch.equal(r2.long(), lane) and t2.shape[0] == p,
          "the captured dist-mem grid is not (rows1[p // H], rows2[p])")
    route = lambda: fk.fused_compare_dual_rows(t1, r1, t2, r2, *geo)  # noqa
    plain = lambda: fk.fused_compare_dual_rows_plain(        # noqa: E731
        t1, r1, t2, r2, *geo)

    def column_route():    # read1's rows expanded, both blocks transposed
        blk1 = t1[:, None, :].expand(q, h, wp).reshape(-1, wp)
        return dv._dual_check(blk1, t2, *geo)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = route()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = plain()
    torch.cuda.synchronize()
    errs = {"rows": max_abs_err(got, want)}
    check(errs["rows"] == 0, "K1's rows route at the dist shape disagrees "
          f"with its plain version on {int((got[0] != want[0]).sum())} edge "
          f"and {int((got[1] != want[1]).sum())} containment flags")
    errs["column_route"] = max_abs_err(column_route(), got)
    check(errs["column_route"] == 0,
          "the column route disagrees with the rows route at the dist shape")
    # the column kernel on the live pairs' columns gathered densely
    sel = torch.nonzero((geo[2] > 0) | (geo[4] > 0)).squeeze(1)
    a_l = t1[(sel // h)].T.contiguous()
    b_l = t2[sel].T.contiguous()
    geo_l = tuple(g[sel].contiguous() for g in geo)
    live = lambda: fk.fused_compare_dual(a_l, b_l, *geo_l)     # noqa: E731
    got_l = live()
    errs["live"] = max(max_abs_err(got_l, tuple(g[sel] for g in got)),
                       max_abs_err(got_l, fk.fused_compare_dual_plain(
                           a_l, b_l, *geo_l)))
    check(errs["live"] == 0, "K1 on the live lanes disagrees with the rows "
                             "route or its plain version")
    out = (torch.empty(p, dtype=torch.bool, device=r1.device),
           torch.empty(p, dtype=torch.bool, device=r1.device))
    scratch = (torch.empty(p, dtype=torch.int32, device=r1.device),
               torch.empty(1, dtype=torch.int32, device=r1.device))
    fns = {"column_route": column_route, "route": route}
    for name in k1d.DESIGNS:
        errs[name] = max_abs_err(
            k1d.design(name, "route", t1, r1, t2, r2, *geo), got)
        check(errs[name] == 0, f"the rows route's design {name} disagrees "
                               "at the dist shape")
        fns[name] = (lambda d=name: k1d.design(d, "route", t1, r1, t2, r2,
                                               *geo))
    k1d.design("scalar", "compact", t1, r1, t2, r2, *geo, out=out,
               scratch=scratch)
    torch.cuda.synchronize()
    n_live = int(scratch[1])
    check(n_live == len(sel), f"the compaction listed {n_live} live lanes, "
                              f"not {len(sel)}")
    # the listing designs' stages apart: the compaction into the list, and
    # each design's check of that list
    fns["compact"] = lambda: k1d.design(                      # noqa: E731
        "scalar", "compact", t1, r1, t2, r2, *geo, out=out, scratch=scratch)
    for name in k1d.LISTED:
        fns["check_" + name] = (
            lambda d=name: k1d.design(d, "check", t1, r1, t2, r2, *geo,
                                      out=out, scratch=scratch))
    a, b = columns = (
        t1[:, None, :].expand(q, h, wp).reshape(-1, wp).T.contiguous(),
        t2.T.contiguous())
    fns["column"] = lambda: fk.fused_compare_dual(a, b, *geo)  # noqa: E731
    fns["live"] = live
    times = rows_turns(fns)
    times["plain"] = (cuda_ms(plain, 3), None)
    del a_l, b_l, a, b, columns
    bds = rows_bounds(rows_work(t1, r1, t2, r2, geo))
    shape = {"P": p, "Wp": wp, "hit_cap": h, "live_P": len(sel),
             "edge_windows": int((geo[2] > 0).sum()),
             "containment_windows": int((geo[4] > 0).sum())}
    return times, errs, bds, shape


def dist_supersteps(fasta: pathlib.Path, min_ovl: int, n_profiled=3):
    """Both engines' supersteps on the full set, four shards on the card,
    as `buildg -n 4 [-rma]` makes them (`make_chunk_step`, `compact`,
    `builder._pull`): the first chunk once, then chunks 1 .. n_profiled
    under `profiled`.  The first dist-mem superstep's inputs to K1's rows
    route (shard 0's) are kept for `dist_rows_check`."""
    import numpy as np
    import torch
    from disco_tpu_torch.dist import builder
    from disco_tpu_torch.dist.mesh import make_mesh
    from disco_tpu_torch.dist.overlap_shard import (DistMemOverlapEngine,
                                                    ShardedOverlapEngine,
                                                    compact)
    from disco_tpu_torch.index.table import FingerprintTable
    from disco_tpu_torch.io.readstore import ReadStore
    from disco_tpu_torch.overlap import device as dv

    store = ReadStore.from_files([str(fasta)], [], min_ovl)
    table = FingerprintTable.build(store, min_ovl - 1)
    q = int(store.lengths.sum()) - store.n_reads * table.k
    hit_cap, chunk, route_cap = builder.chunk_plan(
        table, q, DIST_SHARDS, None, 1 << 25)
    marked = np.zeros(store.n_reads + (-store.n_reads) % DIST_SHARDS,
                      np.int32)
    mesh = make_mesh(DIST_SHARDS)
    seen = []
    real = dv.fused_compare_dual_rows

    def capture(*args):
        if not seen:
            seen.append(args)
        return real(*args)

    def chunks(windows, run, first, last):
        for c in range(first, last):
            inputs = windows(c * chunk, min((c + 1) * chunk, q))
            out = run(inputs, marked)
            builder._pull(mesh, *compact(inputs[0], inputs[1], out))

    n_chunks = -(-q // chunk)
    profiled_chunks = (min(1, n_chunks - 1), min(1 + n_profiled, n_chunks))

    for name, engine in (("dist-mem", DistMemOverlapEngine),
                         ("replicated", ShardedOverlapEngine)):
        eng = engine.build(store, table, mesh, hit_cap=hit_cap,
                           route_cap=route_cap, prune_marked=True)
        step = eng.make_chunk_step(store, chunk)
        dv.fused_compare_dual_rows = capture
        try:
            chunks(*step, 0, 1)
        finally:
            dv.fused_compare_dual_rows = real
        profiled(lambda: chunks(*step, *profiled_chunks),
                 tag=f"dist: {name}: supersteps {profiled_chunks[0]} to "
                     f"{profiled_chunks[1] - 1} profiled")
        del step, eng
    torch.cuda.synchronize()
    t1, r1, t2, r2, *geo = seen[0]
    del seen
    return dist_rows_check(t1, r1, t2, r2, tuple(geo), hit_cap)


def dist_phase(tmp: pathlib.Path, fasta: pathlib.Path, cut: pathlib.Path,
               min_ovl: int, walls, n_reads: int, wp: int):
    """Phase 10.  Returns K1's and K2's launches on the cut set (`cut`,
    CUT_GENOME, of n_reads reads and rows of wp words; both runs) and K1's
    timing at the dist shape, on the supersteps of the full set
    (`fasta`)."""
    import torch
    from disco_tpu_torch import cli
    from disco_tpu_torch.buildg.pipeline import run_buildg
    from disco_tpu_torch.dist import builder
    from disco_tpu_torch.dist.overlap_shard import fetch_cap_for
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.tools import exp_k1_rows_designs as k1d
    from disco_tpu_torch.tools.bench_scaling import superstep_bytes

    n = DIST_SHARDS
    # ---- dryrun_multichip's three runs against the single-device run ----
    dry = tmp / "dryrun"
    dry.mkdir()
    reads = dry / "reads.fasta"
    dryrun_reads(reads)
    kw = dict(min_overlap=13, write_par_graph_size=1000)
    run_buildg([str(reads)], [], str(dry / "REF"), backend="device",
               device=DEVICE, **kw)
    for name, extra in (("replicated", {}), ("dist-mem", {"dist_mem": True}),
                        ("forced overflow", {"route_cap": 8})):
        stats = {}
        fk.fused_compare_dual.launches = 0
        fk.fused_compare_dual_rows.launches = 0
        t0 = time.perf_counter()
        builder.run_buildg_sharded([str(reads)], [], str(dry / name), n,
                                   budget=1 << 13, stats=stats, **kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        columns = fk.fused_compare_dual.launches
        rows = fk.fused_compare_dual_rows.launches
        check(stats["chunks"] >= 3, f"dryrun {name}: {stats}")
        if name == "forced overflow":
            check(stats["fallback_chunks"] >= 1 and columns > 0,
                  f"dryrun {name}: {stats}, column kernel {columns}")
        else:
            check(columns == 0 and rows > 0,
                  f"dryrun {name}: column kernel {columns}, rows {rows}")
        if name == "replicated":
            check(stats["fallback_chunks"] == 0, f"dryrun {name}: {stats}")
        for o in DIST_OUTPUTS:
            check((dry / f"{name}{o}").read_bytes()
                  == (dry / f"REF{o}").read_bytes(),
                  f"dryrun {name}{o} differs from the single-device run")
        say(f"dist: dryrun {name}, {n} shards on the card: {wall:.2f} s, "
            f"{stats['chunks']} chunks, {stats['fallback_chunks']} fallback; "
            f"K1's rows route {rows} launches, column kernel {columns}; "
            "files byte-identical to the single-device buildG")

    # ---- the golden mini through the command line -----------------------
    gdir = ROOT / "tests" / "golden" / "mini"
    for extra in ([], ["-rma"]):
        flag = "".join(" " + x for x in extra)
        tag = "mini_n4" + "".join(extra)
        cwd = os.getcwd()
        os.chdir(gdir)    # _ReadIDMap.txt records the input path as given
        t0 = time.perf_counter()
        try:
            rc = cli.main(["buildg", "-pe", "reads.fasta", "-f",
                           str(tmp / tag), "-p", "buildg.cfg", "-n", str(n),
                           *extra])
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t0
        check(rc == 0, f"buildg -n {n}{flag} on mini exited {rc}")
        for suffix in OUTPUTS:
            check((tmp / f"{tag}{suffix}").read_bytes()
                  == (gdir / f"mini{suffix}").read_bytes(),
                  f"buildg -n {n}{flag}: golden mini{suffix} differs")
        say(f"dist: golden mini: buildg -n {n}{flag}: {wall:.2f} s, "
            "byte-identical to the reference outputs")

    # ---- the cut set: buildg -n 4 -rma, then buildg -n 4 -----------------
    launches = {"K1": 0, "K2": 0, "K1_rows": 0}
    for extra in (["-rma"], []):
        flag = "".join(" " + x for x in extra)
        prefix = tmp / ("dist" + "".join(extra))
        rec = {}
        walls.walls.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.fused_compare_dual.launches = 0
        fk.fused_compare_dual_fetch.launches = 0
        fk.fused_compare_dual_rows.launches = 0
        k1d.design.launches = 0
        argv = ["buildg", "-pe", str(cut), "-f", str(prefix), "-p",
                str(CFG_DIR / "cfg.cfg"), "-w", "20000", "-n", str(n), *extra]
        t0 = time.perf_counter()
        with sharded_record(builder, rec):
            rc = cli.main(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = fk.fused_compare_dual.launches
        k2 = fk.fused_compare_dual_fetch.launches
        k1_rows = fk.fused_compare_dual_rows.launches
        peak = torch.cuda.max_memory_allocated()
        stages = list(walls.walls)
        check(rc == 0, f"buildg -n {n}{flag} exited {rc}")
        check(k1_rows > 0, f"buildg -n {n}{flag} never launched K1's rows "
                           "route")
        check(k1 == 0, f"buildg -n {n}{flag} launched K1's column kernel")
        check(k2 == 0, f"buildg -n {n}{flag} launched K2")
        check(k1d.design.launches == 0,
              f"buildg -n {n}{flag} launched a timing design of the rows "
              "route")
        launches["K1"] += k1
        launches["K2"] += k2
        launches["K1_rows"] += k1_rows
        for suffix in OUTPUTS:
            check((tmp / f"{prefix.name}{suffix}").read_bytes()
                  == (tmp / f"native_cut{suffix}").read_bytes(),
                  f"buildg -n {n}{flag}: {suffix} differs from the native "
                  "buildG's")
        hit_cap, chunk, route_cap = rec["plan"]
        dist_mem = bool(extra)
        fetch_cap = fetch_cap_for(chunk, n, hit_cap) if dist_mem else 0
        nbytes, _ = superstep_bytes(n, chunk, route_cap, hit_cap, n_reads, wp,
                                    dist_mem, fetch_cap)
        stats = rec["stats"]
        mode = "dist-mem (-rma)" if dist_mem else "replicated"
        say(f"dist: buildg -n {n}{flag} ({mode}) on the cut set: "
            f"{wall:.2f} s: " + ", ".join(f"{st} {t:.2f} s"
                                          for st, t in stages))
        say(f"dist: {mode}: files byte-identical to the native buildG's; "
            f"launches K1's rows route {k1_rows}, K1's column kernel {k1}, "
            f"K2 {k2}; {stats['chunks']} chunks, "
            f"{stats['fallback_chunks']} fallback; hit_cap {hit_cap}, chunk "
            f"{chunk} windows, route_cap {route_cap}, fetch_cap {fetch_cap}; "
            f"{nbytes} B a shard a superstep through the collectives "
            f"(bench_scaling.superstep_bytes); peak device memory "
            f"{peak / 2**20:.1f} MiB")

    times, errs, bds, shape = dist_supersteps(fasta, min_ovl)
    route, chk = bds["route"], bds["check"]
    say(f"dist: K1 at the dist shape, shard 0's grid of the first -rma "
        f"superstep: P = {shape['P']}, Wp = {shape['Wp']}, hit_cap "
        f"{shape['hit_cap']}, {shape['live_P']} live lanes "
        f"({shape['edge_windows']} edge and {shape['containment_windows']} "
        "containment windows); the rows route == its plain version == the "
        "column route == the live-lane launch == every design, "
        "and it ran with host synchronisation made an error")
    say(f"dist: the route's work (PERF.md section 2): {route['bytes']} B, "
        f"bound {route['bound_ms']:.4f} ms ({route['bound_by']}), row-layout "
        f"sector floor {route['sector_floor_ms']:.4f} ms, whole-sector floor "
        f"{route['whole_sector_floor_ms']:.4f} ms; the check alone on the "
        f"live list {chk['bytes']} B, bound {chk['bound_ms']:.4f} ms, sector "
        f"floor {chk['sector_floor_ms']:.4f} ms, whole-sector floor "
        f"{chk['whole_sector_floor_ms']:.4f} ms")
    what = {"column_route": "the column route (expand, gathers, transposes, "
                      "column kernel)",
            "route": "the rows route (one launch: compaction, check, "
                     "flags)",
            "compact": "the two-kernel designs' compaction alone",
            "column": "the column kernel alone on the transposed gathers",
            "live": "the column kernel on the live lanes' columns alone"}
    for k, (ms, held) in times.items():
        if k == "plain":
            continue
        ref = chk if k.startswith("check_") else route
        if k.startswith("check_"):
            what[k] = f"design {k[6:]}'s check alone on the live list"
        say(f"dist: {what.get(k, f'design {k} of the rows route')}: "
            f"{ms:.4f} ms, held {held:.4f} ms; "
            f"{ref['bound_ms'] / held:.0%} of its bound, "
            f"{ref['sector_floor_ms'] / held:.0%} of its sector floor, "
            f"{ref['whole_sector_floor_ms'] / held:.0%} of its whole-sector "
            "floor")
    say(f"dist: the rows route's plain version {times['plain'][0]:.4f} ms")
    say(f"dist: card {card_line()}")
    d_k1 = {"dist_rows_ms": times["route"][0],
            "dist_rows_held_ms": times["route"][1],
            "dist_rows_plain_ms": times["plain"][0],
            "dist_rows_max_abs_err": errs["rows"],
            "dist_rows_bytes": route["bytes"],
            "dist_rows_bound_ms": route["bound_ms"],
            "dist_rows_sector_floor_ms": route["sector_floor_ms"],
            "dist_rows_whole_sector_floor_ms":
                route["whole_sector_floor_ms"],
            "dist_rows_live_P": shape["live_P"], "dist_P": shape["P"],
            "dist_rows_launches": launches["K1_rows"],
            "dist_rows_check_held_ms": times["check_scalar"][1],
            "dist_rows_check_bound_ms": chk["bound_ms"],
            "dist_rows_check_sector_floor_ms": chk["sector_floor_ms"],
            "dist_column_route_ms": times["column_route"][0],
            "dist_column_route_held_ms": times["column_route"][1],
            "dist_ms": times["column"][0], "dist_held_ms": times["column"][1],
            "dist_live_ms": times["live"][0],
            "dist_live_held_ms": times["live"][1],
            "dist_live_max_abs_err": errs["live"]}
    d_k1.update({f"dist_rows_{k}_held_ms": times[k][1]
                 for k in (*k1d.DESIGNS, *(
                     "check_" + d for d in k1d.LISTED))
                 if k in times})
    d_k1["dist_rows_compact_held_ms"] = times["compact"][1]
    return launches, d_k1


# ---------------------------------------------------------------------------
# phase 11: one process per rank on the one card
# ---------------------------------------------------------------------------
MP_RANKS = 2
MP_TIMEOUT = 600         # seconds a rank may take before the phase fails
MP_GRAPH = OUTPUTS + ("_0_startRead.txt",)
# the copy-in-to-out stand-in for the BBTools scripts
# (tests/test_preprocess.py::STUB): each in=/in2= file to its out=/out2=
STUB_TOOL = """#!/bin/sh
ins=""; outs=""
for a in "$@"; do
  case "$a" in
    in=*)  ins="${a#in=}" ;;
    in2=*) ins="$ins,${a#in2=}" ;;
    out=*) outs="${a#out=}" ;;
    out2=*) outs="$outs,${a#out2=}" ;;
  esac
done
echo "$0 $@" >> "$(dirname "$0")/cmds.log"
oldIFS=$IFS; IFS=,
set -- $outs
for i in $ins; do
  [ -n "$1" ] && cp "$i" "$1" && shift
done
IFS=$oldIFS
exit 0
"""


def run_ranks(tmp: pathlib.Path, tag: str, argv, cwd, backend="gloo",
              timeout=MP_TIMEOUT):
    """MP_RANKS ranks of tools/multicard.py's RANK_LAUNCHER on the first
    card, under tmp/<tag>/ (`multicard.launch_ranks`): (each rank's exit
    code and output, the ranks' prefixes).  A rank that outlives `timeout`
    seconds fails the phase; every rank still running is killed."""
    from disco_tpu_torch.tools.multicard import launch_ranks
    env = dict(os.environ)
    # every rank on the one card, whatever the host holds
    env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES",
                                          "0").split(",")[0]
    try:
        return launch_ranks(MP_RANKS, tmp / tag, argv, cwd, backend=backend,
                            timeout=timeout, env=env)
    except TimeoutError as e:
        raise SmokeFailure(f"multiproc {tag}: {e}") from None


def multiproc_run(tmp, tag, argv, cwd, want_dir, want_name):
    """One distributed buildG of MP_RANKS processes on the card over gloo:
    every rank's rows route above 0, its column kernel, K2 and the route's
    designs 0, rank 0's files equal want_dir/want_name*, the other ranks'
    directories empty.  Prints the walls, rank 0's stages, the bytes a rank
    receives a superstep, the seconds each rank spends in the collectives
    and each rank's peak device memory.  Returns each
    rank's rows-route launches."""
    from disco_tpu_torch.tools.multicard import rank_records
    t0 = time.perf_counter()
    results, prefixes = run_ranks(tmp, tag, argv, cwd)
    wall = time.perf_counter() - t0
    try:
        recs = rank_records(results)
    except RuntimeError as e:
        raise SmokeFailure(f"multiproc {tag}: {e}") from None
    for r, rec in enumerate(recs):
        check(rec["rows"] > 0, f"multiproc {tag}: rank {r} never launched "
                               "K1's rows route")
        check(rec["columns"] == 0 and rec["k2"] == 0 and rec["designs"] == 0,
              f"multiproc {tag}: rank {r} launched K1's column kernel "
              f"({rec['columns']}), K2 ({rec['k2']}) or a design "
              f"({rec['designs']})")
        check(rec["stats"] == recs[0]["stats"],
              f"multiproc {tag}: the ranks' chunks differ: "
              f"{[x['stats'] for x in recs]}")
    for suffix in MP_GRAPH:
        check(pathlib.Path(f"{prefixes[0]}{suffix}").read_bytes()
              == (want_dir / f"{want_name}{suffix}").read_bytes(),
              f"multiproc {tag}: rank 0's {suffix} differs from "
              f"{want_name}{suffix}")
    for r, p in enumerate(prefixes[1:], 1):
        check(not list(p.parent.iterdir()),
              f"multiproc {tag}: rank {r} wrote files")
    chunks = recs[0]["stats"]["chunks"]
    say(f"multiproc: {tag}: {MP_RANKS} ranks over gloo on the card, "
        f"{wall:.2f} s (the ranks' own walls "
        + ", ".join(f"{x['wall']:.2f}" for x in recs) + " s); "
        f"{chunks} chunks, {recs[0]['stats']['fallback_chunks']} fallback; "
        f"rank 0's {len(MP_GRAPH)} files equal {want_name}'s, rank 1 "
        "wrote none")
    say(f"multiproc: {tag}: rank 0's stages: " + ", ".join(
        f"{n} {t:.2f} s" for n, t in recs[0]["stages"]))
    for r, rec in enumerate(recs):
        say(f"multiproc: {tag}: rank {r}: K1's rows route {rec['rows']} "
            f"launches (column kernel {rec['columns']}, K2 {rec['k2']}); "
            f"received from its peer a superstep: all_to_all "
            f"{rec['all_to_all'] / chunks:.0f} B, all_gather "
            f"{rec['all_gather'] / chunks:.0f} B, of which the kept rows, "
            f"counts and overflows {rec['collect'] / chunks:.0f} B; in the "
            f"collectives over the run (card synchronised around each): "
            f"all_to_all {rec['all_to_all_s']:.2f} s, all_gather "
            f"{rec['all_gather_s']:.2f} s; peak device memory "
            f"{rec['peak'] / 2**20:.1f} MiB")
    return [rec["rows"] for rec in recs]


def multiproc_phase(tmp: pathlib.Path, cut: pathlib.Path, min_ovl: int):
    """Phase 11, its two-rank builds on the cut set (`cut`, CUT_GENOME).
    Returns the rows-route launches of every run's ranks and K2's launches
    in the `assemble -ecc -backend device` run."""
    import torch
    from disco_tpu_torch import cli
    from disco_tpu_torch.overlap import fused_kernel as fk

    gdir = ROOT / "tests" / "golden" / "mini"
    launches = {}
    # ---- the golden mini, both modes --------------------------------------
    for extra in ([], ["-rma"]):
        tag = "mini" + "".join(extra)
        launches[tag] = multiproc_run(
            tmp, tag, ["-pe", "reads.fasta", "-m-ovl", "30", "-w", "1000",
                       *extra], gdir, gdir, "mini")
    # ---- NCCL refuses two ranks on one card: no switch to gloo ------------
    results, _ = run_ranks(tmp, "nccl", ["-pe", "reads.fasta"], gdir,
                           backend=None, timeout=180)
    check(all(rc != 0 for rc, _ in results)
          and any("Duplicate GPU" in out for _, out in results),
          "multiproc over NCCL with two ranks on one card did not fail "
          "with NCCL's duplicate-GPU error")
    say("multiproc: NCCL (the default backend) with two ranks on one card: "
        "both ranks failed with NCCL's duplicate-GPU error")
    # ---- the cut set, -rma then replicated ---------------------------------
    for extra in (["-rma"], []):
        tag = "cut" + "".join(extra)
        launches[tag] = multiproc_run(
            tmp, tag, ["-pe", str(cut), "-m-ovl", str(min_ovl), "-w",
                       "20000", *extra], tmp, tmp, "native_cut")
    say(f"multiproc: card {card_line()}")

    # ---- assemble -ecc: device against native ------------------------------
    bb = tmp / "bbmap"
    (bb / "resources").mkdir(parents=True)
    for name in ("bbduk.sh", "bbmerge.sh", "tadpole.sh"):
        (bb / name).write_text(STUB_TOOL)
        (bb / name).chmod(0o755)
    for res in ("adapters.fa", "sequencing_artifacts.fa.gz",
                "phix174_ill.ref.fa.gz"):
        (bb / "resources" / res).write_text(">r\nACGT\n")
    trees, k2 = {}, 0
    for backend in ("native", "device"):
        run = tmp / f"ecc_{backend}"
        run.mkdir()
        cwd = os.getcwd()
        os.chdir(run)     # the same relative -d: _ReadIDMap.txt's paths
        fk.fused_compare_dual_fetch.launches = 0
        t0 = time.perf_counter()
        try:
            rc = cli.main(["assemble", "-inP", str(gdir / "reads.fasta"),
                           "-d", "out", "-o", "mini", *CFG_ARGS, "-ecc",
                           "-bbmap", str(bb), "-backend", backend])
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t0
        k2 = fk.fused_compare_dual_fetch.launches
        check(rc == 0, f"assemble -ecc -backend {backend} exited {rc}")
        out = run / "out"
        trees[backend] = {p.relative_to(out): p.read_bytes()
                          for p in sorted(out.rglob("*")) if p.is_file()}
        say(f"multiproc: assemble -ecc -backend {backend} on mini: "
            f"{wall:.2f} s, {len(trees[backend])} files, K2 {k2} launches")
    check(k2 > 0, "assemble -ecc -backend device never launched K2")
    check(trees["device"] == trees["native"],
          "assemble -ecc: -backend device and -backend native differ")
    check(trees["device"][pathlib.Path("graph/mini_0_parGraph.txt")]
          == (gdir / "mini_0_parGraph.txt").read_bytes(),
          "assemble -ecc: the graph differs from the golden's")
    say(f"multiproc: assemble -ecc: every file of -backend device equals "
        f"-backend native's ({len(trees['device'])} files), the graph the "
        "golden's")
    return launches, k2


# ---------------------------------------------------------------------------
# phase 12: the hit-cap grid engine and the CLI's trace wrap
# ---------------------------------------------------------------------------
GRID_HIT_CAP = 16      # disco_tpu's DeviceOverlapEngine default
GRID_CHUNK = 1 << 21   # disco_tpu's run_packed_chunked default
GRID_CHECKED = 3       # chunks on which run, run_compact and run_packed meet
GRID_CPU = 1 << 16     # windows of the chunk held against the CPU


def hit_keys(gw, r2, orient, typ, flags, n_reads):
    """One int64 a hit: its global window, r2, orient, typ and flags."""
    return ((gw * n_reads + r2) << 5) | (orient << 3) | (typ << 2) | flags


def grid_chunks(eng, starts, n_reads):
    """run_packed_chunked over `starts`, each chunk's hits decoded on the
    card into hit_keys (the pad windows' dropped).  Returns (keys, the
    overflowing windows' global indices, the hits a chunk)."""
    import numpy as np
    import torch
    keys, over, counts = [], [], []
    s = 0
    for n_real, data, meta in eng.run_packed_chunked(starts,
                                                     chunk=GRID_CHUNK):
        meta = meta.cpu().numpy().view(np.uint32)      # count, overflow bits
        count = int(meta[0])
        check(count <= data.shape[1], f"the chunk at window {s} holds "
                                      f"{count} hits, out_cap {data.shape[1]}")
        counts.append(count)
        bits = np.unpackbits(meta[1:].view(np.uint8), bitorder="little")
        over.append(s + np.flatnonzero(bits[:n_real]))
        w0, r2 = data[:, :count].long()
        wi = w0 & 0x1FFFFF
        sel = wi < n_real
        w0 = w0[sel]
        keys.append(hit_keys(s + wi[sel], r2[sel], (w0 >> 21) & 3,
                             (w0 >> 23) & 1, (w0 >> 24) & 3, n_reads))
        s += n_real
    return torch.cat(keys), np.concatenate(over), counts


def grid_agree(eng, part):
    """run, run_compact and run_packed on one chunk: the grid's verified
    slots of the windows that do not overflow, in (window, slot) order, are
    the compact rows, and the packed rows and overflow bits are the compact
    ones.  Returns the chunk's hits and overflowing windows."""
    import torch
    q = len(part)
    grid = eng.run(part)
    comp = eng.run_compact(part, GRID_CHUNK)
    data, meta = eng.run_packed(part, GRID_CHUNK)
    count = int(comp.count)
    live = (grid.edge_ok | grid.cont_ok) & ~comp.over[:, None]
    wi, _ = torch.nonzero(live, as_tuple=True)
    flags = grid.edge_ok[live].int() | (grid.cont_ok[live].int() << 1)
    check(len(wi) == count and count <= GRID_CHUNK,
          f"the grid holds {len(wi)} verified slots, compact {count}")
    for name, g, c in (("wi", wi.int(), comp.wi), ("r2", grid.r2[live],
                       comp.r2), ("orient", grid.orient[live], comp.orient),
                       ("typ", grid.typ[live], comp.typ),
                       ("flags", flags, comp.flags)):
        check(torch.equal(g, c[:count]), f"the grid's {name} differ from "
                                         "the compact rows")
    word0 = comp.wi | (comp.orient << 21) | (comp.typ << 23) | (
        comp.flags << 24)
    check(torch.equal(data, torch.stack([word0, comp.r2])),
          "the packed rows differ from the compact rows")
    words = meta.long() & 0xFFFFFFFF
    bits = (words[1:, None] >> torch.arange(32, device=words.device)) & 1
    check(int(words[0]) == count
          and torch.equal(bits.reshape(-1)[:q].bool(), comp.over)
          and int(grid.overflow) == int(comp.over.sum()),
          "the packed count or overflow bits differ from the compact ones")
    return count, int(grid.overflow)


def grid_phase(tmp: pathlib.Path, store, table, rel_dev):
    """The hit-cap grid engine (overlap/device.py's run* steps, K1's rows
    route) on the full set, against phase 5's relation; a chunk against the
    CPU; K1's rows route at the grid's shape; the CLI's trace wrap.
    Returns K1's grid_* entries."""
    import numpy as np
    import torch
    from disco_tpu_torch.cli import TRACE_ENV
    from disco_tpu_torch.cli import main as cli_main
    from disco_tpu_torch.overlap import device as dv
    from disco_tpu_torch.overlap import fused_kernel as fk
    n_reads = store.n_reads
    eng = dv.DeviceOverlapEngine(store, table, hit_cap=GRID_HIT_CAP,
                                 device=DEVICE)
    starts = eng.window_starts()
    check(len(starts) * n_reads < 1 << 58, "hit keys past 63 bits")

    # ---- every window through run_packed_chunked, the counts set to 0 ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.fused_compare_dual_rows.launches = 0
    fk.fused_compare_dual.launches = 0
    fk.fused_compare_dual_fetch.launches = 0
    t0 = time.perf_counter()
    keys, over, counts = grid_chunks(eng, starts, n_reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    grid_launches = fk.fused_compare_dual_rows.launches
    check(grid_launches > 0, "the grid engine never launched K1's rows route")
    check(fk.fused_compare_dual.launches == 0
          and fk.fused_compare_dual_fetch.launches == 0,
          "the grid engine launched K1's column kernel or K2")
    say(f"grid: run_packed_chunked over {len(starts)} windows (hit_cap "
        f"{GRID_HIT_CAP}, {len(counts)} chunks of {GRID_CHUNK}): {wall:.2f} s"
        f" with the decode on the card; {len(over)} windows overflow; "
        f"{sum(counts)} hits, at most {max(counts)} a chunk; K1's rows route "
        f"{grid_launches} launches, its column kernel and K2 0; peak device "
        f"memory {peak / 2**20:.1f} MiB")
    woff = np.concatenate([[0], np.cumsum(store.lengths.astype(np.int64)
                                          - table.k)])
    gw = woff[rel_dev.r1] + rel_dev.j
    keep = ~np.isin(gw, over)
    want = hit_keys(
        gw[keep], rel_dev.r2[keep].astype(np.int64),
        rel_dev.orient[keep].astype(np.int64),
        rel_dev.typ[keep].astype(np.int64),
        rel_dev.edge_ok[keep].astype(np.int64)
        | (rel_dev.cont_ok[keep].astype(np.int64) << 1), n_reads)
    want = torch.from_numpy(want).to(DEVICE)
    check(torch.equal(keys.sort().values, want.sort().values),
          "the grid engine's hits differ from phase 5's relation on the "
          "windows that do not overflow")
    say(f"grid: its {len(keys)} hits == phase 5's relation on the "
        f"{len(starts) - len(over)} windows that do not overflow")
    del keys, want, gw, keep

    # ---- run, run_compact and run_packed agree; K1's inputs captured ------
    real, seen = dv.fused_compare_dual_rows, []

    def capture(*args):
        if not seen:
            seen.append(args)
        return real(*args)

    dv.fused_compare_dual_rows = capture
    try:
        got = [grid_agree(eng, starts[c * GRID_CHUNK:(c + 1) * GRID_CHUNK])
               for c in range(GRID_CHECKED)]
    finally:
        dv.fused_compare_dual_rows = real
    say(f"grid: run, run_compact and run_packed agree on the first "
        f"{GRID_CHECKED} chunks: (hits, overflowing windows) {got}")

    # ---- one chunk on the card against the same call on the CPU ----------
    at = max(0, int(over[0]) - GRID_CPU // 2) if len(over) else \
        len(starts) // 2
    part = starts[at:at + GRID_CPU]
    cpu = dv.DeviceOverlapEngine(store, table, hit_cap=GRID_HIT_CAP,
                                 device="cpu")
    t0 = time.perf_counter()
    want = cpu.run(part)
    t_cpu = time.perf_counter() - t0
    got = eng.run(part)
    for f in want._fields:
        check(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
              f"device_overlap's {f} on the card differs from the CPU's")
    say(f"grid: device_overlap on {GRID_CPU} windows from window {at}: the "
        f"card == the CPU in every field ({int(want.overflow)} overflowing, "
        f"{int(want.n_hits)} slots; the CPU {t_cpu:.2f} s)")
    del cpu, got, want

    # ---- K1's rows route at the grid's shape -----------------------------
    t1, r1, t2, r2, *geo = seen[0]
    del seen
    route = lambda: fk.fused_compare_dual_rows(t1, r1, t2, r2, *geo)  # noqa
    plain = lambda: fk.fused_compare_dual_rows_plain(        # noqa: E731
        t1, r1, t2, r2, *geo)
    err = max_abs_err(route(), plain())
    check(err == 0, "K1's rows route at the grid's shape disagrees with "
                    "its plain version")
    ms, held = rows_turns({"route": route})["route"]
    plain_ms = cuda_ms(plain, 1)
    work = rows_work(t1, r1, t2, r2, tuple(geo))
    bd = rows_bounds(work)["route"]
    p = len(r1)
    say(f"grid: K1's rows route at P = {p} (Wp {t1.shape[1]}), "
        f"{work['live_lanes']} live lanes ({work['live_lanes'] / p:.4f}): "
        f"{ms:.4f} ms ({held:.4f} held), plain {plain_ms:.4f} ms, == plain; "
        f"{bd['bytes']} B, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}),"
        f" row-layout floor {bd['sector_floor_ms']:.4f} ms, whole-sector "
        f"floor {bd['whole_sector_floor_ms']:.4f} ms")
    del t1, r1, t2, r2, geo, eng
    torch.cuda.empty_cache()
    out = {"grid_launches": grid_launches, "grid_P": p,
           "grid_rows_live_P": work["live_lanes"], "grid_rows_ms": ms,
           "grid_rows_held_ms": held, "grid_rows_plain_ms": plain_ms,
           "grid_rows_max_abs_err": err, "grid_rows_bytes": bd["bytes"],
           "grid_rows_bound_ms": bd["bound_ms"],
           "grid_rows_bound_by": bd["bound_by"],
           "grid_rows_sector_floor_ms": bd["sector_floor_ms"],
           "grid_rows_whole_sector_floor_ms": bd["whole_sector_floor_ms"],
           "grid_wall_s": wall, "grid_overflow_windows": len(over),
           "grid_peak_bytes": peak}

    # ---- the CLI's trace wrap: buildg -backend device on mini -------------
    gdir = ROOT / "tests" / "golden" / "mini"
    trace = tmp / "trace"
    cwd = os.getcwd()
    os.chdir(gdir)       # _ReadIDMap.txt records the input path as given
    try:
        for tag in ("untraced", "traced"):
            if tag == "traced":
                os.environ[TRACE_ENV] = str(trace)
            k2 = fk.fused_compare_dual_fetch.launches
            check(cli_main(["buildg", "-pe", "reads.fasta", "-f",
                            str(tmp / f"{tag}_mini"), "-p", "buildg.cfg",
                            "-backend", "device"]) == 0, f"{tag} buildg")
            check(fk.fused_compare_dual_fetch.launches > k2,
                  f"the {tag} buildg never launched K2")
    finally:
        os.environ.pop(TRACE_ENV, None)
        os.chdir(cwd)
    for suffix in OUTPUTS:
        check((tmp / f"traced_mini{suffix}").read_bytes()
              == (tmp / f"untraced_mini{suffix}").read_bytes()
              == (gdir / f"mini{suffix}").read_bytes(),
              f"the traced buildg's {suffix} differs")
    traces = list(trace.iterdir())
    check(len(traces) == 1, f"{len(traces)} trace files")
    text = traces[0].read_text()
    events = json.loads(text)["traceEvents"]
    check("dual_compare_fetch_kernel" in text,
          "the trace does not name K2's kernel")
    say(f"grid: buildg -backend device on mini under {TRACE_ENV}: files == "
        f"the untraced run's and the goldens; {traces[0].name} "
        f"({len(text)} B, {len(events)} events) names "
        "dual_compare_fetch_kernel")
    return out


# ---------------------------------------------------------------------------
# phase 13: the main path at the size its users run
# ---------------------------------------------------------------------------
# the JAX package's verified set (scale100/PARITY_STATUS.md): 100 Mb genome,
# 25x, 250 bp pairs, 500 bp insert, seed 99; 10,000,000 reads
SCALE_SET = ("--genome-len", "100000000", "--coverage", "25", "--read-len",
             "250", "--insert", "500", "--seed", "99")
SCALE_TIMEOUT = 900     # seconds for the data, and for each buildG run
SCALE_FILES = ("_0_containedReads.txt", "_0_parGraph.txt", "_0_startRead.txt",
               "_CheckpointInfo.txt", "_ReadIDMap.txt")


def meminfo(*names):
    """The named /proc/meminfo fields, in bytes."""
    with open("/proc/meminfo") as f:
        fields = dict(line.split(":", 1) for line in f)
    return {n: int(fields[n].split()[0]) * 1024 for n in names}


def scale_phase(tmp: pathlib.Path, min_ovl: int):
    """`buildg -backend device` and `buildg -backend native` on SCALE_SET,
    each in a fresh process through tools/bench_e2e.py's `run_child`, at
    the smoke's MinOverlap: past 2^23 reads (the 8-byte wire, chosen by the
    read count) and 2^31 windows.  Every file both runs write must be
    equal.  Returns K2's launches in the device run and the directory that
    keeps the reads and the native run's files (prefix `native`) for
    phase 14."""
    from disco_tpu_torch.tools.bench_e2e import run_child

    mem = meminfo("MemTotal", "MemAvailable")
    say(f"scale: host MemTotal {mem['MemTotal'] / 2**30:.1f} GiB, "
        f"MemAvailable {mem['MemAvailable'] / 2**30:.1f} GiB")
    t0 = time.perf_counter()
    scale = tmp / "scale"
    scale.mkdir()
    fasta = scale / "reads.fasta"
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_testdata.py"),
                    str(fasta), *SCALE_SET], check=True,
                   stdout=subprocess.DEVNULL, timeout=SCALE_TIMEOUT)
    data_s = time.perf_counter() - t0
    walls, runs = {}, {}
    for name in ("device", "native"):
        walls[name], runs[name] = run_child(
            str(scale), str(scale / name), ["-pe", str(fasta), "-backend",
                                            name, "-m-ovl", str(min_ovl)],
            timeout=SCALE_TIMEOUT)
    dev, nat = runs["device"], runs["native"]
    rel = dev["relation"]
    same_files(scale, "device", "native", "at 100 Mb")
    check(dev["reads"] > 1 << 23, f"{dev['reads']} reads: not past 2^23")
    check(dev["windows"] > 1 << 31, f"{dev['windows']} windows: not past "
                                    "2^31")
    check(rel["wire_bytes"] == 8, f"the {rel['wire_bytes']}-byte wire at "
                                  f"{dev['reads']} reads")
    k2 = dev["launches"]["K2"]
    check(k2 > 0, "the device buildG at 100 Mb never launched K2")
    check(set(nat["launches"].values()) == {0},
          f"the native buildG launched {nat['launches']}")
    say(f"scale: {dev['reads']} reads (2^23 = {1 << 23}), {dev['windows']} "
        f"windows (2^31 = {1 << 31}); the {rel['wire_bytes']}-byte wire, "
        f"unforced; {rel['chunks']} chunks, {rel['fallback_chunks']} "
        f"fallback; {dev['rows']} kept rows; K2 {k2} launches, K1 "
        f"{dev['launches']['K1']}; the reads made in {data_s:.2f} s")
    say(f"scale: every file buildG writes is byte-identical between -backend "
        f"device and -backend native: {', '.join(SCALE_FILES)}")
    for name, run in (("device", dev), ("native", nat)):
        say(f"scale: buildg -backend {name} {walls[name]:.2f} s in a fresh "
            f"process, {run_line(run)}")
    for f in scale.glob("device_*"):          # the disk phase 14 needs
        f.unlink()
    say(f"scale: the device run's peak device memory "
        f"{dev['device_peak_bytes'] / 2**20:.1f} MiB; phase "
        f"{time.perf_counter() - t0:.2f} s; card {card_line()}")
    return k2, scale


def same_files(d: pathlib.Path, got: str, want: str, where: str):
    """Fail unless the runs `got` and `want` in `d` wrote exactly
    SCALE_FILES, byte for byte the same."""
    for tag in (got, want):
        files = tuple(sorted(p.name[len(tag):] for p in d.glob(tag + "_*")))
        check(files == SCALE_FILES, f"{tag} wrote {files} {where}")
    for suffix in SCALE_FILES:
        check(filecmp.cmp(d / (got + suffix), d / (want + suffix),
                          shallow=False),
              f"{got} and {want} {suffix} differ {where}")


def run_line(run) -> str:
    """A child's peak host RSS and `clock` stages, as phase 13 prints
    them."""
    return (f"host peak RSS {run['rss_peak_bytes'] / 2**20:.0f} MiB "
            f"({run['rss_start_bytes'] / 2**20:.0f} MiB at the command's "
            "start, sampled every 10 ms): " + ", ".join(
                f"{st} {t:.2f} s" for st, t in run["stages"]))


# ---------------------------------------------------------------------------
# phase 14: the distributed buildG at the size its users run
# ---------------------------------------------------------------------------
def dist_scale_phase(scale: pathlib.Path, min_ovl: int):
    """`buildg -n 4 -rma` on phase 13's reads in a fresh process
    (`run_child`), four shards on the one card: every file equal to phase
    13's native files; the rows route launched, K2 not, K1's column kernel
    once a re-run chunk.  Returns the rows route's launches."""
    from disco_tpu_torch.tools.bench_e2e import run_child

    t0 = time.perf_counter()
    wall, run = run_child(str(scale), str(scale / "dist"), [
        "-pe", str(scale / "reads.fasta"), "-n", str(DIST_SHARDS), "-rma",
        "-m-ovl", str(min_ovl)], timeout=SCALE_TIMEOUT)
    rel, prof, n = run["relation"], run["profile"], run["launches"]
    same_files(scale, "dist", "native", "at 100 Mb")
    check(run["reads"] > 1 << 23, f"{run['reads']} reads: not past 2^23")
    check(run["windows"] > 1 << 31,
          f"{run['windows']} windows: not past 2^31")
    check(n["K1_rows"] > 0, "buildg -n 4 -rma at 100 Mb never launched K1's "
                            "rows route")
    check(n["K2"] == 0, f"buildg -n 4 -rma launched K2 {n['K2']} times")
    check(n["K1"] == rel["fallback_chunks"],
          f"K1's column kernel launched {n['K1']} times for "
          f"{rel['fallback_chunks']} re-run chunks")
    say(f"dist scale: buildg -n {DIST_SHARDS} -rma on {run['reads']} reads, "
        f"{run['windows']} windows: every file byte-identical to phase 13's "
        f"native files ({', '.join(SCALE_FILES)}); {rel['chunks']} chunks "
        f"of {prof['chunk']} windows, {rel['fallback_chunks']} fallback, "
        f"hit_cap {rel['hit_cap']}, route_cap {prof['route_cap']}; "
        f"{run['rows']} kept rows; launches: K1's rows route {n['K1_rows']}, "
        f"K1's column kernel {n['K1']}, K2 {n['K2']}")
    say(f"dist scale: {wall:.2f} s in a fresh process, {run_line(run)}")
    say("dist scale: the relation's host seconds a chunk by stage (total): "
        + ", ".join(f"{st} {t / rel['chunks'] * 1e3:.2f} ms ({t:.2f} s)"
                    for st, t in prof["host_s"].items()))
    win_s, codes_s = host_codes_chunk(scale / "reads.fasta", prof["chunk"],
                                      min_ovl - 1)
    say(f"dist scale: what the card does instead of the host: one chunk's "
        f"windows (`chunk_windows`) {win_s:.3f} s and codes "
        f"(`window_codes_at`) {codes_s:.3f} s on this host, "
        f"{(win_s + codes_s) / prof['chunk'] * 1e9:.1f} ns a window, "
        f"{(win_s + codes_s) * rel['chunks']:.1f} s over the "
        f"{rel['chunks']} chunks")
    say(f"dist scale: peak device memory "
        f"{run['device_peak_bytes'] / 2**20:.1f} MiB; phase "
        f"{time.perf_counter() - t0:.2f} s; card {card_line()}")
    return n["K1_rows"]


def host_codes_chunk(fasta: pathlib.Path, chunk: int, k: int):
    """The host's seconds for one chunk's windows and their codes, the
    work `shard_windows` does on the card: `chunk_windows` and
    `window_codes_at` over the set's first reads, as many as one chunk's
    windows span."""
    from disco_tpu_torch.io.readstore import ReadStore
    from disco_tpu_torch.overlap.device import chunk_windows, window_offsets
    from disco_tpu_torch.overlap.relation import window_codes_at

    seqs, windows = [], 0
    with open(fasta) as f:
        for line in f:
            if not line.startswith(">"):
                seqs.append(line.strip())
                windows += len(seqs[-1]) - k
                if windows >= chunk:
                    break
    store = ReadStore.from_sequences(seqs)
    woff = window_offsets(store.lengths, k)
    t0 = time.perf_counter()
    read, j = chunk_windows(woff, 0, chunk)
    t1 = time.perf_counter()
    window_codes_at(store, read, j, k)
    return t1 - t0, time.perf_counter() - t1


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more device relation (host and card)")
    args = ap.parse_args(argv)

    t_smoke = time.perf_counter()
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
    from disco_tpu_torch.tools import exp_k1_rows_designs as k1d
    from disco_tpu_torch.tools import exp_mxu_fetch as mf
    from disco_tpu_torch.tools.bench_e2e import StageWalls

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
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        builds = {name: pool.submit(timed, fn) for name, fn in (
            ("dual_compare.cu (nvcc, sm_90a)", fk.load),
            ("k1_rows_designs.cu (nvcc, sm_90a)", k1d.load),
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
        "dual_compare_rows_fused_kernel": (
            "K1's rows route", "16 lanes a thread, a 4096-lane tile a block "
            "of 256 threads (of its two instances, the last ptxas lists)"),
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
        def make_set(path, genome_len):
            subprocess.run(
                [sys.executable, str(ROOT / "tools" / "make_testdata.py"),
                 str(path), "--genome-len", str(genome_len), "--coverage",
                 str(args.coverage), "--read-len", "250", "--insert", "500",
                 "--seed", str(SET_SEED)], check=True,
                stdout=subprocess.DEVNULL)

        fasta = tmp / "reads.fasta"
        cut = tmp / "cut.fasta"      # CUT_GENOME
        t0 = time.perf_counter()
        make_set(fasta, args.genome_len)
        make_set(cut, CUT_GENOME)
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
        t0 = time.perf_counter()
        med, errs, bounds = kernel_phase(store, table)
        golden_phase(tmp)
        say(f"kernels: phase {time.perf_counter() - t0:.2f} s")

        # ---- 5. slice: the main path, with the launch counts ------------
        def buildg(backend, reads, tag):
            walls.walls.clear()
            t0 = time.perf_counter()
            store, rel, _ = run_buildg([str(reads)], [], str(tmp / tag),
                                       min_overlap=min_ovl,
                                       write_par_graph_size=20000,
                                       backend=backend, device=DEVICE)
            torch.cuda.synchronize()
            return store, rel, time.perf_counter() - t0, list(walls.walls)

        def counts():
            return (fk.fused_compare_dual.launches,
                    fk.fused_compare_dual_fetch.launches)

        t_slice = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.fused_compare_dual.launches = 0
        fk.fused_compare_dual_fetch.launches = 0
        _, rel_dev, t_dev, dev_walls = buildg("device", fasta, "device")
        k1_dev, k2_dev = counts()
        _, rel_xla, t_xla, xla_walls = buildg("xla", cut, "xla_cut")
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

        _, _, t_nat, nat_walls = buildg("native", fasta, "native")
        # the cut set's native files, which the xla run and phases 9 to 11
        # are held to
        cut_store, _, _, _ = buildg("native", cut, "native_cut")
        cut_reads, cut_wp = cut_store.n_reads, cut_store.packed.shape[1]
        for tag, want in (("device", "native"), ("xla_cut", "native_cut")):
            for suffix in OUTPUTS:
                data = (tmp / (want + suffix)).read_bytes()
                check(len(data) > 0, f"empty {want}{suffix}")
                check((tmp / (tag + suffix)).read_bytes() == data,
                      f"{tag} and {want} {suffix} differ")
        say("slice: the device buildG's outputs byte-identical to native's "
            "on phase 3's set, the xla buildG's on the cut set: " + ", ".join(
                f"{s} ({(tmp / ('native' + s)).stat().st_size} B, cut "
                f"{(tmp / ('native_cut' + s)).stat().st_size} B)"
                for s in OUTPUTS))
        rel_cut = _device_relation(
            cut_store, FingerprintTable.build(cut_store, min_ovl - 1),
            device=DEVICE)
        check_same_relation(rel_xla, rel_cut, "xla", "device")
        say(f"slice: the cut set, {CUT_GENOME} bp, {cut_reads} reads: the "
            f"xla relation == the device relation ({len(rel_cut)} rows)")
        del cut_store, rel_cut
        for name, w, total in (("device", dev_walls, t_dev),
                               ("xla (the cut set)", xla_walls, t_xla),
                               ("native", nat_walls, t_nat)):
            say(f"slice: {name} buildG {total:.2f} s: " + ", ".join(
                f"{s} {t:.2f} s" for s, t in w))
        say(f"slice: peak device memory {peak / 2**20:.1f} MiB; phase "
            f"{time.perf_counter() - t_slice:.2f} s")

        # ---- 6. the device engine with its K1 check ----------------------
        t_engine = time.perf_counter()
        fk.fused_compare_dual_rows.launches = 0
        t0 = time.perf_counter()
        rel_k1 = _device_relation(store, table, device=DEVICE, fetch=False)
        torch.cuda.synchronize()
        t_k1 = time.perf_counter() - t0
        k1_rows = fk.fused_compare_dual_rows.launches
        check(k1_rows > 0,
              "the device engine's K1 check never launched K1's rows route")
        check_same_relation(rel_k1, rel_dev, "K1 engine", "device")
        say(f"engine: K1 check (fetch=False, the rows route) {k1_rows} "
            f"launches, relation == K2 relation ({len(rel_dev)} rows) in "
            f"{t_k1:.2f} s; fallback chunks "
            f"{rel_k1.stats['fallback_chunks']} of {rel_k1.stats['chunks']}")
        # the 8-byte wire rows, which sets of 2^23 reads and more take
        t0 = time.perf_counter()
        rel_w64 = _device_relation(store, table, device=DEVICE, wire64=True)
        torch.cuda.synchronize()
        t_w64 = time.perf_counter() - t0
        check(rel_w64.stats["fallback_chunks"] == 0,
              "the wire64 relation re-ran chunks")
        check_same_relation(rel_w64, rel_dev, "wire64", "device")
        say(f"engine: wire64 (8-byte rows) relation == the 4-byte one "
            f"({len(rel_dev)} rows) in {t_w64:.2f} s, against the 4-byte "
            f"run's overlapRelation {dict(dev_walls)['overlapRelation']:.2f}"
            f" s; fallback chunks 0 of {rel_w64.stats['chunks']}")
        say(f"engine: phase {time.perf_counter() - t_engine:.2f} s")
        if args.profile:
            profile_phase(store, table)
        del rel_xla, rel_k1, rel_w64     # store, table, rel_dev: phase 12
        torch.cuda.empty_cache()

        # ---- 7. the verify paths of bench_verify ------------------------
        t0 = time.perf_counter()
        v_med, v_errs, v_launches, v_bounds, v_floors, reuse = \
            verify_paths_phase(cut, min_ovl)
        say(f"verify: phase {time.perf_counter() - t0:.2f} s")

        # ---- 8. the fetch experiments -----------------------------------
        t0 = time.perf_counter()
        f_med, f_errs, f_launches, f_bounds, f_floors = fetch_phase(*reuse)
        del reuse
        say(f"fetch: phase {time.perf_counter() - t0:.2f} s")

        # ---- 9. assemble: reads to contigs and scaffolds ----------------
        t0 = time.perf_counter()
        a_launches = assemble_phase(tmp, cut, walls)
        say(f"assemble: phase {time.perf_counter() - t0:.2f} s")

        # ---- 10. the distributed buildG ----------------------------------
        t0 = time.perf_counter()
        d_launches, d_k1 = dist_phase(tmp, fasta, cut, min_ovl, walls,
                                      cut_reads, cut_wp)
        say(f"dist: phase {time.perf_counter() - t0:.2f} s")

        # ---- 11. one process per rank -------------------------------------
        gc.collect()
        torch.cuda.empty_cache()     # the ranks' room on the card
        t0 = time.perf_counter()
        mp_launches, ecc_k2 = multiproc_phase(tmp, cut, min_ovl)
        say(f"multiproc: phase {time.perf_counter() - t0:.2f} s")

        # ---- 12. the hit-cap grid engine -----------------------------------
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        g_k1 = grid_phase(tmp, store, table, rel_dev)
        del store, table, rel_dev
        say(f"grid: phase {time.perf_counter() - t0:.2f} s")

        # ---- 13. the main path at the size its users run -------------------
        gc.collect()
        torch.cuda.empty_cache()     # the children's room on the card
        s_k2, scale = scale_phase(tmp, min_ovl)

        # ---- 14. the distributed buildG at the size its users run ----------
        ds_k1 = dist_scale_phase(scale, min_ovl)

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
        dict(entry("K1", "fused_compare_dual", KERNEL_SOURCE, K1_REPLACES,
                   launches["K1"], errs, med, bounds["K1"]),
             assemble_launches=a_launches["K1"],
             dist_launches=d_launches["K1"],
             multiproc_launches=sum(map(sum, mp_launches.values())),
             multiproc_rank_launches=mp_launches, **d_k1, **g_k1,
             dist_scale_launches=ds_k1),
        dict(entry("K2", "fused_compare_dual_fetch", KERNEL_SOURCE,
                   K2_REPLACES, launches["K2"], errs, med, bounds["K2"]),
             assemble_launches=a_launches["K2"],
             dist_launches=d_launches["K2"], ecc_launches=ecc_k2,
             scale_launches=s_k2),
    ] + [entry(k, name, WINDOW_SOURCE, replaces, v_launches[k], v_errs,
               v_med, v_bounds[k], v_floors)
         for k, name, replaces in SINGLE_KERNELS] + [
        entry(k, name, source, replaces, f_launches[k], f_errs, f_med,
              f_bounds[k], f_floors)
        for k, name, replaces, source in FETCH_KERNELS]
    say(f"smoke: wall {time.perf_counter() - t_smoke:.2f} s")
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
