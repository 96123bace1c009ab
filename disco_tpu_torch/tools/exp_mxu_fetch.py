"""A sorted-row fetch through a staged tile window against the plain row
gather, on one CUDA card (the counterpart of tools/exp_mxu_fetch.py).

    python -m disco_tpu_torch.tools.exp_mxu_fetch [--device cuda]

Candidates arrive sorted by read1, so the rows of one tile of 1024 pairs
span a few rows of the packed table.  `fetch_checksum` (T3) stages a
32-row window of the table for each tile, at the tile's base row plus a
salt, and gives each pair the checksum sum(word & 0x7FFF) over the words of
its row rows[p] + salt.  The control is the same checksum over a plain row
gather.  The tool's table is padded to 128 words and 34 spare rows for the
TPU's copy alignment; here the kernel reads the (2N, Wp) packed table as it
is.

The workload is bench.py's set, its first min(P // 1024, 256) tiles of
candidates with read1 sorted.  The salt-0 call must equal the tool's numpy
checksum; the rates are rows per second over calls with salt i % 2 (CUDA
events).  --device must name a CUDA device."""
import argparse
import sys

import numpy as np
import torch

from ..bench_verify import cuda_device
from ..overlap import fused_kernel as fk
from ..overlap.verify import as_words
from .exp_fetch_variants import bench_batch, cycled_ms

TILE = fk.TILE
SUM_ROWS = 32    # staged rows a tile (the tool's K)


def checksum_numpy(packed, rows, salt=0):
    """The tool's check (exp_mxu_fetch.py:159-161): per-row sums of
    word & 0x7FFF, in int64."""
    return np.sum((packed[rows + salt] & 0x7FFF).astype(np.int64), axis=1)


def fetch_checksum_plain(table, rows, bases, salt):
    """Plain version of `fetch_checksum`: the row gather and the sums;
    `bases` does not change the result."""
    n_rows = table.shape[0]
    r = rows.long() + salt
    inside = (r >= 0) & (r < n_rows)
    words = table[r.clamp(0, max(n_rows - 1, 0))] & 0x7FFF
    return (words.sum(1) * inside).to(torch.int32)


def checksum_misses(n_rows, rows, bases, salt):
    """The row reads of `fetch_checksum` outside its windows."""
    first = bases.long() + salt
    return fk.window_misses(rows.long() + salt, first, first + SUM_ROWS - 1,
                            SUM_ROWS, n_rows)


def fetch_checksum(table, rows, bases, salt: int):
    """T3: out[p] = sum over the words w of row rows[p] + salt of
    (table[rows[p] + salt, w] & 0x7FFF), with tile t (pairs [1024 t,
    1024 t + 1024)) reading its rows from a window of 32 rows at
    bases[t] + salt, staged in shared memory.  table: (R, W) int32; rows:
    (P,) int32, best sorted; bases: (ceil(P / 1024),) int32, the tool's
    tile first rows; salt: an int (0 or 1 in the tool).  A row outside the
    table sums to 0.  Returns (P,) int32; `out_of_window` then holds the
    row reads outside the windows."""
    if table.dim() != 2:
        raise ValueError(f"table of shape {tuple(table.shape)}, not (R, W)")
    p = rows.numel()
    nt = -(-p // TILE)
    dev = fk._check((table, rows, bases), (rows,), p)
    if bases.shape != (nt,):
        raise ValueError(f"bases of shape {tuple(bases.shape)}, not ({nt},)")
    n_rows, w = table.shape
    if dev.type == "cpu":
        fetch_checksum.out_of_window = checksum_misses(n_rows, rows, bases,
                                                       salt)
        return fetch_checksum_plain(table, rows, bases, salt)
    out = torch.empty(p, dtype=torch.int32, device=dev)
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    fetch_checksum.out_of_window = misses[0]
    if p == 0:
        return out
    with torch.cuda.device(dev):
        err = fk.load_staged().disco_row_checksum_staged(
            table.data_ptr(), n_rows, w, rows.data_ptr(), p,
            bases.data_ptr(), int(salt), out.data_ptr(), misses.data_ptr(),
            fk._stream(dev))
    fk._raise_on(err, "row_checksum_staged")
    fetch_checksum.launches += 1
    return out


fetch_checksum.launches = 0
fetch_checksum.out_of_window = None


def sorted_tiles(r1, max_tiles: int = 256):
    """The tool's rows: the first min(P // 1024, max_tiles) tiles of the
    batch's read1 rows, sorted, and each tile's first row.  Returns
    (rows (nt * 1024,) int32, bases (nt,) int32)."""
    nt = min(len(r1) // TILE, max_tiles)
    rows = np.sort(np.asarray(r1[:nt * TILE], np.int32)).reshape(nt, TILE)
    return rows.reshape(-1), rows[:, 0].copy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda)")
    args = ap.parse_args(argv)
    device = cuda_device(args.device)
    store, r1, *_ = bench_batch()
    packed = np.concatenate([store.packed, store.packed_rc])
    rows_np, bases_np = sorted_tiles(r1)
    span = int((rows_np.reshape(-1, TILE) - bases_np[:, None]).max())
    table = as_words(packed, device)
    rows = torch.from_numpy(rows_np).to(device)
    bases = torch.from_numpy(bases_np).to(device)
    print(f"device {torch.cuda.get_device_name(device)}; {len(rows_np)} "
          f"rows in {len(bases_np)} tiles, widest tile span {span} rows",
          flush=True)

    got = fetch_checksum(table, rows, bases, 0).cpu().numpy()
    want = checksum_numpy(packed, rows_np)
    if not np.array_equal(got, want):
        print(f"checksums differ on {int((got != want).sum())} rows",
              flush=True)
        return 1
    print(f"checksums match; out_of_window="
          f"{int(fetch_checksum.out_of_window)}", flush=True)
    for label, fn in (("staged-fetch", fetch_checksum),
                      ("gather-fetch", fetch_checksum_plain)):
        ms = cycled_ms(fn, [(table, rows, bases, s) for s in (0, 1)])
        print(f"{label}: {len(rows_np) / (ms / 1e3):.4e} rows/s "
              f"{ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
