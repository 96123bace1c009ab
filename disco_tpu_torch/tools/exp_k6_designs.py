"""The designs of K6's kernel, timed in turns on one CUDA card.

    python -m disco_tpu_torch.tools.exp_k6_designs [--designs all]
        [--genome-len 4600000] [--coverage 30] [--device cuda]

K6 (`verify_windows_fused_mxu_both16`) checks a packed window of two rows
of the `pack_lines16` table for each pair.  This tool runs the kernel it
keeps (`kept`), its control (`direct`, one thread a pair loading each word)
and the designs of csrc/k6_designs.cu (`DESIGNS`) on `chip_smoke.py`'s
E. coli set (tools/make_testdata.py, 4.6 Mb / 30x / 250 bp, MinOverlap 30)
after the BFS relabel, in slices of 2^22 pairs.  Every design is held to
the plain version on every slice, as made and with read2's window moved
one base on odd pairs; then each slice times every design held (a sleep
kernel holds the stream while the host queues the calls, so CUDA events
time the card's work alone), in turns: forward on even slices, backward
on odd ones.  It prints one line a design (median over slices, as made and
moved, against `kept` and `direct` from the same slices, with the kernel's
registers, spills and resident blocks an SM) and, last, one JSON object of
the same.  The measurement is of a card: --device must name a CUDA device.
"""
import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import bench_verify as bv
from .. import kernels
from ..overlap import fused_kernel as fk

SLICE = 1 << 22
HOLD_CYCLES = 10_000_000    # the sleep kernel's hold: some 5 ms on an H100

# name -> (id in csrc/k6_designs.cu, what the design does)
DESIGNS = {
    "staged16": (0, "a warp stages both rows of its 32 pairs by 16-B "
                    "cp.async, 4 lanes a row, at stride 20 (4-way bank "
                    "conflicts); staged_rows_equal"),
    "staged4": (1, "the same by 4-B cp.async at stride 17 (no bank "
                   "conflict)"),
    "staged4_read1_once": (2, "staged4 with each run of equal read1 rows "
                              "staged once a warp"),
    "staged16_read2": (3, "read2's rows alone staged as in staged16; "
                          "read1's by 16-B loads into registers"),
    "regs_one_pair": (4, "one pair a thread, both rows by 16-B loads "
                         "aligned in registers; geometry by 4-B loads"),
    "regs_four_pairs": (5, "four pairs a thread, geometry by 16-B loads "
                           "through L1, four flags by one 4-B store"),
    "regs_limited": (6, "kept, loading only the 16-B chunks up to the "
                        "window's last word"),
    "regs_3_blocks": (7, "kept, with room for 3 blocks an SM (80 "
                         "registers)"),
    "regs_2_blocks": (8, "kept, with room for 2 blocks an SM (128 "
                         "registers)"),
    "lanes8": (9, "8 lanes a pair, two window words a lane, one "
                  "__ballot_sync a pair"),
    "lanes16": (10, "16 lanes a pair, one window word a lane, one "
                    "__ballot_sync a pair"),
    "runs": (11, "direct's body on a persistent grid, each block one "
                 "contiguous run of pairs (read2's band kept in L1)"),
}
REFERENCES = {
    "direct": "one thread a pair, each word of both rows by its own 4-B "
              "load, early exit (K6's kernel of before; the control)",
    "kept": "four pairs a thread, geometry by streaming 16-B loads, rows by "
            "16-B loads aligned in registers, no early exit (the path's)",
}

_LIB = None


def load():
    """Build (nvcc, sm_90a) and load csrc/k6_designs.cu; returns the
    library."""
    global _LIB
    if _LIB is None:
        lib = kernels.load_cuda("k6_designs", deps=["window.cuh"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.disco_k6_design.argtypes = [i32, vp, i64, vp, vp, i64] + [vp] * 5
        lib.disco_k6_design_attrs.argtypes = [i32] + [vp] * 4
        for fn in (lib.disco_k6_design, lib.disco_k6_design_attrs,
                   lib.disco_k6_design_count):
            fn.restype = ctypes.c_int
        if lib.disco_k6_design_count() != len(DESIGNS):
            raise RuntimeError("csrc/k6_designs.cu and DESIGNS disagree")
        _LIB = lib
    return _LIB


def design(name, packed_lines16, rows1, rows2, o1, o2, n, *, n_words):
    """K6's function (`verify_windows_fused_mxu_both16`'s arguments and
    booleans) through design `name`: one of DESIGNS, or "kept" and "direct"
    (K6's wrapper and its control).  A CPU tensor takes the plain version;
    a CUDA tensor launches the design's kernel or raises."""
    if name == "kept":
        return fk.verify_windows_fused_mxu_both16(
            packed_lines16, rows1, rows2, o1, o2, n, n_words=n_words)
    if name == "direct":
        return fk.verify_windows_fused_mxu_both16_direct(
            packed_lines16, rows1, rows2, o1, o2, n, n_words=n_words)
    ident = DESIGNS[name][0]
    if n_words > fk.W16:
        raise ValueError(f"n_words = {n_words}: the 16-word table holds "
                         "reads of at most 256 bp")
    fk._check_lines(packed_lines16)
    p = rows1.numel()
    dev = fk._check((packed_lines16,), (rows1, rows2, o1, o2, n), p)
    if dev.type == "cpu":
        return fk.verify_windows_fused_mxu_both16_plain(
            packed_lines16, rows1, rows2, o1, o2, n, n_words=n_words)
    table = packed_lines16.view(-1, fk.W16)
    if table.data_ptr() % 16:
        raise ValueError("the designs take a 16-B aligned table")
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    if p == 0:
        return ok
    with torch.cuda.device(dev):
        err = load().disco_k6_design(
            ident, table.data_ptr(), table.shape[0], rows1.data_ptr(),
            rows2.data_ptr(), p, o1.data_ptr(), o2.data_ptr(), n.data_ptr(),
            ok.data_ptr(), fk._stream(dev))
    fk._raise_on(err, f"k6 design {name}")
    return ok


def attrs(name):
    """{registers, local bytes a thread, static shared bytes a block,
    resident blocks an SM} of design `name`'s kernel on the current CUDA
    device."""
    out = [ctypes.c_int() for _ in range(4)]
    fk._raise_on(load().disco_k6_design_attrs(
        DESIGNS[name][0], *(ctypes.addressof(x) for x in out)),
        "k6_design_attrs")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), (x.value for x in out)))


def bank_conflict(stride, word, rows=32, swizzle=None):
    """The worst bank conflict of a warp reading word `word` of `rows`
    consecutive slots at `stride` words a slot (a staged design's layout,
    csrc/k6_designs.cu k6_staged_kernel): the most slots on one of
    the 32 banks.  `swizzle(s, q)` gives the 16-B chunk of slot s where
    the row's chunk q lies (None: q)."""
    s = np.arange(rows)
    q, r = divmod(word, 4)
    chunk = q if swizzle is None else swizzle(s, q)
    return int(np.bincount((s * stride + 4 * chunk + r) % 32,
                           minlength=32).max())


def held_ms(fn, reps):
    """Mean device ms of fn() over `reps` calls queued behind a sleep
    kernel (the card's work alone), after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def relabeled_batch(genome_len, coverage, min_overlap, device):
    """chip_smoke.py's read set at `genome_len`, its candidate batch and
    fused_mxu3's BFS relabel, on `device`."""
    with tempfile.TemporaryDirectory(prefix="exp_k6_") as td:
        fasta = pathlib.Path(td) / "reads.fasta"
        subprocess.run(
            [sys.executable, str(bv.ROOT / "tools" / "make_testdata.py"),
             str(fasta), "--genome-len", str(genome_len), "--coverage",
             str(coverage), "--read-len", "250", "--insert", "500",
             "--seed", "42"], check=True, stdout=subprocess.DEVNULL)
        batch = bv.candidate_batch(fasta, min_overlap=min_overlap)
    return bv.prepare("fused_mxu3", *batch).to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--designs", default="all",
                    help="comma-separated names (default all; direct and "
                         "kept always run)")
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--min-overlap", type=int, default=30)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda)")
    args = ap.parse_args(argv)
    device = bv.cuda_device(args.device)
    picked = (list(DESIGNS) if args.designs == "all"
              else [d for d in args.designs.split(",") if d in DESIGNS])
    names = ["direct", "kept", *picked]
    wl = relabeled_batch(args.genome_len, args.coverage, args.min_overlap,
                         device)
    if wl.n_words > fk.W16:
        raise ValueError(f"reads of {wl.n_words} words: K6 takes at most 16")
    total = len(wl)
    slices = ([slice(s, s + SLICE) for s in range(0, total - SLICE + 1,
                                                  SLICE)]
              or [slice(0, total)])
    odd = torch.arange(total, dtype=torch.int32, device=device) % 2
    moved_o2 = wl.o2 + odd

    def call(name, sl, moved):
        o2 = moved_o2 if moved else wl.o2
        return lambda: design(name, wl.table, wl.rows1[sl], wl.rows2[sl],
                              wl.o1[sl], o2[sl], wl.n[sl],
                              n_words=wl.n_words)

    for sl in slices:
        for moved in (0, 1):
            o2 = moved_o2 if moved else wl.o2
            want = fk.verify_windows_fused_mxu_both16_plain(
                wl.table, wl.rows1[sl], wl.rows2[sl], wl.o1[sl], o2[sl],
                wl.n[sl], n_words=wl.n_words)
            for name in names:
                bad = int((call(name, sl, moved)() != want).sum())
                if bad:
                    raise RuntimeError(f"design {name} disagrees with the "
                                       f"plain version on {bad} pairs")
    times = {(name, moved): [] for name in names for moved in (0, 1)}
    for i, sl in enumerate(slices):
        for name in (names if i % 2 == 0 else names[::-1]):
            for moved in (0, 1):
                times[name, moved].append(held_ms(call(name, sl, moved),
                                                  args.reps))
    med = {k: float(np.median(v)) for k, v in times.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; {total} pairs, {len(slices)} slices of "
          f"{slices[0].stop - slices[0].start}; held ms, median over slices;"
          " every design == plain as made and moved", flush=True)
    rows = []
    for name in names:
        row = {"design": name, "held_ms": med[name, 0],
               "held_ms_moved": med[name, 1],
               "over_kept": med[name, 0] / med["kept", 0],
               "over_direct": med[name, 0] / med["direct", 0],
               "what": DESIGNS[name][1] if name in DESIGNS
               else REFERENCES[name]}
        if name in DESIGNS:
            row.update(attrs(name))
        rows.append(row)
        extra = ("" if name not in DESIGNS else
                 f"; {row['registers']} registers, {row['local_bytes']} B "
                 f"local, {row['smem_bytes']} B shared, "
                 f"{row['blocks_per_sm']} blocks an SM")
        print(f"{name:20s} {row['held_ms']:.4f} ms (moved "
              f"{row['held_ms_moved']:.4f}); x{row['over_kept']:.3f} kept, "
              f"x{row['over_direct']:.3f} direct{extra}", flush=True)
    print(json.dumps({"card": card.strip(), "pairs": total,
                      "slices": len(slices), "designs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
