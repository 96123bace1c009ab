"""Overlap-verification throughput of the single-window verify paths on one
CUDA card (the counterpart of bench.py and tools/bench_verify_paths.py).

    python -m disco_tpu_torch.bench_verify [--path P] [--genome-len N]
                                           [--device cuda]

The workload is bench.py's: one candidate batch of the overlap phase (every
(read1 window j, read2, orientation) hit of the fingerprint table, with its
suffix-prefix window) on a synthetic 400 kb / 25x / 250 bp read set,
MinOverlap 40.  Each path verifies a centred slice of 2^18 pairs; its rate
is pairs over the mean device time of a call, by CUDA events.  Prints one
JSON line per path, bench.py's payload without `vs_baseline` (the reference
assembler's rate it divides by is not measured here), plus the card's name.

The paths (PATHS), each with the table layout bench.py gives it:

    xla         overlap.verify.verify_windows (plain PyTorch)
    pallas      overlap.verify.verify_windows_pallas (K7 after a plain align)
    fused       fused_kernel.verify_windows_fused (K3)
    fused_t     fused_kernel.verify_windows_fused_t (K3, transposed table)
    fused_mxu   fused_kernel.verify_windows_fused_mxu (K4, pack_lines)
    fused_mxu2  K4 with read2 gathered from the 17-word table
    fused_mxu3  fused_kernel.verify_windows_fused_mxu_both16 (K6) after the
                BFS locality relabel over the full candidate graph; pairs
                come out in relabeled order (`Workload.perm`).  With reads
                over 256 bp, fused_kernel.verify_windows_fused_mxu_both (K5)
                over the 32-word pack_lines table, as bench.py:184-190
                selects it; K5, like the reference, takes reads of at most
                256 bp and raises there

The TPU harness's span guard (which relabels a fused_mxu run as fused when
read1's tile spans are wide) has no counterpart: the port's kernels have no
span precondition.  The benchmark measures a card: --device must name a
CUDA device.  On the CPU the paths run their plain versions through
tests/test_torch_bench_verify.py."""
import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .index.table import FingerprintTable
from .io.readstore import ReadStore
from .overlap import fused_kernel as fk
from .overlap import relation as R
from .overlap import verify
from .overlap.locality import relabel_workload

ROOT = pathlib.Path(__file__).resolve().parent.parent
GENOME_LEN = 400_000
COVERAGE = 25
READ_LEN = 250
MIN_OVERLAP = 40
SEED = 42
SLICE = 1 << 18


def make_dataset(path, genome_len: int = GENOME_LEN) -> None:
    """bench.py's read set, from tools/make_testdata.py."""
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"), str(path),
         "--genome-len", str(genome_len), "--coverage", str(COVERAGE),
         "--read-len", str(READ_LEN), "--insert", "600", "--seed",
         str(SEED)], check=True, stdout=subprocess.DEVNULL)


def candidate_batch(fasta, min_overlap: int = MIN_OVERLAP):
    """Host prep: read store, fingerprint table, candidate windows.
    Returns (store, r1, rows2, e_o1, e_o2, e_n), bench.candidate_batch's
    arrays: r1 sorted (window-scan order), rows2 rows of the stacked
    [fwd | rc] table, and the edge window (length 0 where it is invalid)."""
    store = ReadStore.from_files([str(fasta)], [], min_overlap,
                                 reference_task_order=False)
    k = min_overlap - 1
    table = FingerprintTable.build(store, k)
    qread, qj, qcode = R.window_codes(store, k)
    lo, hi = table.lookup_ranges(qcode)
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    pair_q = np.repeat(np.arange(len(qread), dtype=np.int64), counts)
    cum = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(total, dtype=np.int64) - cum[pair_q]
    tpos = lo[pair_q] + rank
    r1 = qread[pair_q].astype(np.int32)
    j = qj[pair_q]
    r2 = table.read[tpos]
    orient = table.orient[tpos]
    len1 = store.lengths[r1].astype(np.int32)
    len2 = store.lengths[r2].astype(np.int32)
    suffix_case = R._IS_SUFFIX_CASE[orient]
    use_rc = R._USE_RC[orient]
    e_valid = np.where(suffix_case, j <= len2 - k, (len1 - j) < len2)
    e_valid &= (j >= 1) & (r1 != r2)
    e_n = np.where(suffix_case, j + k, len1 - j).astype(np.int32)
    e_n = np.where(e_valid, e_n, 0)
    e_o1 = np.where(suffix_case, 0, j).astype(np.int32)
    e_o2 = np.maximum(np.where(suffix_case, len2 - e_n, 0), 0).astype(np.int32)
    rows2 = (r2 + np.where(use_rc, store.n_reads, 0)).astype(np.int32)
    return store, r1, rows2, e_o1, e_o2, e_n


def tile_spans(rows: np.ndarray):
    """Per-tile (max - min) row spans of a candidate stream, tiles of
    fk.TILE pairs: the quantity the TPU kernels' span guards bound."""
    nt = len(rows) // fk.TILE
    if nt == 0:
        return {"p50": 0, "p99": 0, "max": 0}
    t = rows[:nt * fk.TILE].reshape(nt, fk.TILE)
    spans = t.max(axis=1) - t.min(axis=1)
    return {"p50": int(np.percentile(spans, 50)),
            "p99": int(np.percentile(spans, 99)),
            "max": int(spans.max())}


def centred_slice(n_pairs: int, cap: int = SLICE) -> slice:
    """bench.py's measured slice: `cap` contiguous pairs (the r1-sorted tile
    spans kept), starting at a whole tile near the middle of the batch."""
    if n_pairs <= cap:
        return slice(0, n_pairs)
    s0 = ((n_pairs - cap) // 2 // fk.TILE) * fk.TILE
    return slice(s0, s0 + cap)


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------
def _transposed(pa):
    return np.ascontiguousarray(pa.T)


def _lines(pa):
    return fk.pack_lines(pa)[0]


def _lines_and_packed(pa):
    return fk.pack_lines(pa)[0], pa


def _lines16(pa):
    return fk.pack_lines16(pa)[0]


# name -> (table layout of the packed [fwd | rc] rows, verify function)
PATHS = {
    "xla": (np.asarray, verify.verify_windows),
    "pallas": (np.asarray, verify.verify_windows_pallas),
    "fused": (np.asarray, fk.verify_windows_fused),
    "fused_t": (_transposed, fk.verify_windows_fused_t),
    "fused_mxu": (_lines, fk.verify_windows_fused_mxu),
    "fused_mxu2": (_lines_and_packed, fk.verify_windows_fused_mxu),
    "fused_mxu3": (_lines16, fk.verify_windows_fused_mxu_both16),
}
RELABELED = ("fused_mxu3",)


def route(path: str, n_words: int):
    """(table layout, verify function) of `path` for reads of n_words
    words: fused_mxu3 with reads over 256 bp takes K5 over the 32-word
    table, as bench.py does."""
    if path == "fused_mxu3" and n_words > fk.W16:
        return _lines, fk.verify_windows_fused_mxu_both
    return PATHS[path]


@dataclass
class Workload:
    """A candidate batch laid out for one path: its table (or tables) and
    the pair arrays in the order the path verifies them.  Pair i here is
    pair perm[i] of the batch (perm is None: the batch's own order).  A
    relabeled path keeps its relabeled (2N, Wp) rows, before their layout,
    in `packed` (host numpy).  Arrays are numpy on the host, or tensors
    after `to`."""
    path: str
    table: object
    rows1: object
    rows2: object
    o1: object
    o2: object
    n: object
    n_words: int
    perm: Optional[np.ndarray] = None
    packed: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.rows1)

    def to(self, device) -> "Workload":
        def dev(x):
            if isinstance(x, tuple):
                return tuple(dev(t) for t in x)
            return verify.as_words(x, device)

        return Workload(self.path, dev(self.table),
                        *(torch.from_numpy(np.ascontiguousarray(
                            x, np.int32)).to(device)
                          for x in (self.rows1, self.rows2, self.o1,
                                    self.o2, self.n)),
                        n_words=self.n_words, perm=self.perm,
                        packed=self.packed)

    def verify(self, sl: slice = slice(None)):
        """The path's booleans for pairs `sl` of this workload."""
        fn = route(self.path, self.n_words)[1]
        return fn(self.table, self.rows1[sl], self.rows2[sl], self.o1[sl],
                  self.o2[sl], self.n[sl], n_words=self.n_words)


def prepare(path: str, store, r1, rows2, o1, o2, n) -> Workload:
    """The workload of `path` over a candidate batch (candidate_batch's
    arrays), with bench.py's table preparation; for fused_mxu3 that is the
    BFS relabel over the whole batch."""
    layout, _ = route(path, store.n_words)
    pa = np.concatenate([store.packed, store.packed_rc], axis=0)
    perm = relabeled = None
    if path in RELABELED:
        pa, r1, rows2, perm, _, o1, o2, n = relabel_workload(
            store.n_reads, pa, r1, rows2, o1, o2, n)
        relabeled = pa
    return Workload(path, layout(pa), r1, rows2, o1, o2, n,
                    n_words=store.n_words, perm=perm, packed=relabeled)


# ---------------------------------------------------------------------------
def device_ms(fn, min_seconds: float = 1.0) -> float:
    """Mean device milliseconds of fn() by CUDA events, after a warm-up
    call, over enough calls to fill about `min_seconds`."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 10
    while True:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        if ms * reps >= 1e3 * min_seconds or reps >= 10_000:
            return ms
        reps = min(10_000, max(2 * reps,
                               int(1e3 * min_seconds / max(ms, 1e-3))))


def cuda_device(name: str) -> torch.device:
    """`name` as a CUDA device; raises for another device or without a
    card (the measurements are of a card)."""
    device = torch.device(name)
    if device.type != "cuda":
        raise ValueError(f"--device {name}: the measurement is of a CUDA "
                         "card")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    return device


def measure(path: str, batch, device) -> dict:
    """bench.py's payload for one path over a candidate batch."""
    store, r1 = batch[0], batch[1]
    spans = {"full": tile_spans(np.asarray(r1))}
    t0 = time.perf_counter()
    wl = prepare(path, *batch)
    prep_s = time.perf_counter() - t0
    if path in RELABELED:
        spans["relabeled_r2_full"] = tile_spans(wl.rows2)
    sl = centred_slice(len(wl))
    spans["slice"] = tile_spans(wl.rows1[sl])
    if path in RELABELED:
        spans["relabeled_r2_slice"] = tile_spans(wl.rows2[sl])
    wl = wl.to(device)
    ws = Workload(path, wl.table, *(x[sl] for x in (
        wl.rows1, wl.rows2, wl.o1, wl.o2, wl.n)), n_words=wl.n_words)
    verified = int(ws.verify().sum())
    ms = device_ms(ws.verify)
    return {"metric": "overlaps_verified_per_s_chip",
            "value": round(len(ws) / (ms / 1e3)), "unit": "pairs/s",
            "verify_path": path, "tile_spans": spans,
            "pairs": len(ws), "verified": verified, "ms": ms,
            "prep_s": prep_s, "device": torch.cuda.get_device_name(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=[*PATHS, "all"], default="all")
    ap.add_argument("--genome-len", type=int, default=GENOME_LEN)
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda)")
    args = ap.parse_args(argv)
    device = cuda_device(args.device)
    paths = list(PATHS) if args.path == "all" else [args.path]
    with tempfile.TemporaryDirectory(prefix="bench_verify_") as td:
        fasta = pathlib.Path(td) / "bench.fasta"
        make_dataset(fasta, args.genome_len)
        batch = candidate_batch(fasta)
    for path in paths:
        print(json.dumps(measure(path, batch, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
