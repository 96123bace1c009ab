#!/usr/bin/env python3
"""Smoke run of disco_tpu_torch's buildG on one NVIDIA card (H100).

    python3 chip_smoke.py [--genome-len 4600000] [--coverage 30]

Phases; any that fails ends the run with a non-zero exit and no result line:

1. card: fail unless torch sees a CUDA card; print its name and power
   limit, and the torch and CUDA versions;
2. build: the CUDA kernels (nvcc, sm_90a) and the C++ host libraries (g++)
   from the checkout's sources, timed;
3. data: an E. coli-sized read set from tools/make_testdata.py (4.6 Mb
   genome, 30x, 250 bp paired reads, 500 bp insert, seed 42);
   MinOverlap4BuildGraph from the shipped cfg (30);
4. kernels: both dual-check kernels against their plain PyTorch versions
   on the card, exactly: on real candidate chunks at the main path's shape
   (2^20 windows, cand_cap 4M pairs, Wp = 17), on an edge-case batch
   (n = 0, every bit phase, windows ending at the read's last base, P not
   a multiple of 1024) and on windows running up to one word past the row,
   which the kernels read as zeros; kernel and plain times by CUDA events,
   the median over several chunks;
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
   to 0 before it: the relation must equal the K2 one.

With --profile, one more device relation runs under cProfile and
torch.profiler: host functions by cumulative seconds, the device's busy
time (the union of its kernel and copy intervals), its idle share, and the
device operations by time.

Prints the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}."""
import argparse
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
K1_REPLACES = "disco_tpu/overlap/fused_kernel.py:120"   # fused_compare_dual
K2_REPLACES = "disco_tpu/overlap/fused_kernel.py:737"   # fused_compare_dual_mxu
KERNEL_SOURCE = "disco_tpu_torch/csrc/dual_compare.cu"
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


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over `reps` calls, after one warm-up
    call, by CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    end = 16 * (wp + 1)
    i = np.arange(p)
    same = i % 4 == 0
    rows1 = np.sort(rng.integers(0, n_rows, p))
    rows1[-8:] = n_rows - 1
    rows2 = np.where(same, rows1, rng.integers(0, n_rows, p))
    e_o1 = rng.integers(16 * (wp - 3), end, p)
    e_o2 = np.where(same, e_o1, rng.integers(16 * (wp - 3), end, p))
    e_n = end - np.maximum(e_o1, e_o2)
    c_o1 = np.where(same, 0, rng.integers(0, end, p))
    c_n = end - c_o1
    e_n[::7] = 0
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


def kernel_phase(store, table):
    import numpy as np
    import torch
    from disco_tpu_torch.overlap import fused_kernel as fk
    from disco_tpu_torch.overlap.device import DeviceOverlapEngine

    eng = DeviceOverlapEngine(store, table, device=DEVICE)
    starts = eng.window_starts()
    n_chunks = -(-len(starts) // CHUNK)
    picks = sorted({int(c) for c in np.linspace(0, max(n_chunks - 2, 0), 5)})
    times = {"K1": [], "K1_plain": [], "K2": [], "K2_plain": []}
    errs = {"K1": 0, "K2": 0}

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
                times[name + "_plain"].append(cuda_ms(plain, 5))
        return want

    for c in picks:
        rows1, a, b, geo, n_cand = chunk_inputs(
            eng, starts[c * CHUNK:(c + 1) * CHUNK])
        want = run_both(rows1, a, b, geo, timed=True)
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
    for name in ("K1", "K2"):
        say(f"kernels: {name} {med[name]:.4f} ms, plain "
            f"{med[name + '_plain']:.4f} ms (median of {len(picks)} chunks)")
    del eng
    torch.cuda.empty_cache()
    return med, errs


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

    walls = StageWalls()
    tlog = logging.getLogger("disco_tpu_torch")
    tlog.addHandler(walls)
    tlog.setLevel(logging.INFO)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    fk.load()
    t1 = time.perf_counter()
    native.build_all()
    t2 = time.perf_counter()
    say(f"build: CUDA kernels (nvcc, sm_90a) {t1 - t0:.2f} s, host libraries "
        f"(g++) {t2 - t1:.2f} s")

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
        med, errs = kernel_phase(store, table)
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

    kernels = [
        {"name": "fused_compare_dual", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": med["K1"], "plain_ms": med["K1_plain"]},
        {"name": "fused_compare_dual_fetch", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": K2_REPLACES,
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": med["K2"], "plain_ms": med["K2_plain"]},
    ]
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
