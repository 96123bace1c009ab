"""The designs of K1's rows route (`fused_kernel.fused_compare_dual_rows`)
that are timed against it in turns: csrc/k1_rows_designs.cu, on no path.

`chip_smoke.py` phase 10 runs every design, and the stages of the listing
designs apart, on the grid it captures from the distributed build's first
dist-mem superstep, holds each to the kept route, and times them in turns
with it.  `design` launches one on a CUDA card; there is no plain version
here: each design computes `fused_compare_dual_rows`, whose plain version
the tests and the smoke hold them to."""
import ctypes

import torch

from .. import kernels
from ..overlap import fused_kernel as fk

# name -> (id in csrc/k1_rows_designs.cu, what the design does)
DESIGNS = {
    "scalar": (0, "a compaction into a list in device memory (one atomicAdd "
                  "a block), then a check of the list on a persistent grid, "
                  "one thread a live lane reading each row word by word "
                  "with an early exit"),
    "row_chunks": (1, "scalar, each row read through the aligned 16-B chunk "
                      "that holds the word"),
    "lanes4": (2, "scalar's list, a group of 4 lanes a live lane, the "
                  "group's loads of a row contiguous, one ballot a window"),
    "lanes8": (3, "the same with 8 lanes a live lane"),
    "lanes16": (4, "the same with 16 lanes a live lane"),
    "dense": (5, "every lane in one pass, one thread a lane, no "
                 "compaction"),
    "fused_loop": (6, "the kept kernel reading each row word by word with "
                      "an early exit"),
    "fused4": (7, "the kept kernel loading each row's words four at a "
                  "time"),
}
LISTED = ("scalar", "row_chunks", "lanes4", "lanes8", "lanes16")
STAGES = {"route": 0, "compact": 1, "check": 2}

_LIB = None


def load():
    """Build (nvcc, sm_90a) and load csrc/k1_rows_designs.cu; returns the
    library."""
    global _LIB
    if _LIB is None:
        lib = kernels.load_cuda("k1_rows_designs",
                                deps=["window.cuh", "dual_rows.cuh"])
        i32, vp = ctypes.c_int, ctypes.c_void_p
        lib.disco_k1_rows_design.argtypes = ([i32, i32] + fk.ROWS_ARGTYPES
                                             + [vp] * 3)
        lib.disco_k1_rows_design.restype = ctypes.c_int
        lib.disco_k1_rows_design_count.restype = ctypes.c_int
        if lib.disco_k1_rows_design_count() != len(DESIGNS):
            raise RuntimeError("csrc/k1_rows_designs.cu and DESIGNS disagree")
        _LIB = lib
    return _LIB


def design(name, stage, table1, rows1, table2, rows2, e_o1, e_o2, e_n, c_o1,
           c_n, out=None, scratch=None):
    """`fused_compare_dual_rows`'s function through design `name`, or for a
    design of LISTED one of its STAGES alone: "compact" leaves the live list
    in `scratch`, a (live (P,), count (1,)) int32 pair, and the dead lanes'
    flags in `out`; "check" takes them.  Returns out = (edge_ok, cont_ok).
    CUDA tensors only."""
    geo = (e_o1, e_o2, e_n, c_o1, c_n)
    p, dev = fk._rows_inputs(table1, rows1, table2, rows2, geo)
    if dev.type != "cuda":
        raise ValueError("the rows route's designs run on a CUDA card")
    if stage != "route" and name not in LISTED:
        raise ValueError(f"design {name} has no stage {stage}")
    out = out if out is not None else fk._outputs(p, dev)
    if scratch is None and name in LISTED:
        scratch = (torch.empty(p, dtype=torch.int32, device=dev),
                   torch.empty(1, dtype=torch.int32, device=dev))
    lists = (0, 0) if scratch is None else (s.data_ptr() for s in scratch)
    if p:
        with torch.cuda.device(dev):
            err = load().disco_k1_rows_design(
                DESIGNS[name][0], STAGES[stage],
                *fk._rows_args(table1, rows1, table2, rows2, geo, out),
                *lists, fk._stream(dev))
        fk._raise_on(err, f"k1_rows_design {name}")
        design.launches += 1
    return out


design.launches = 0
