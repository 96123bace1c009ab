"""The device half of buildG on torch tensors: window codes -> sorted-table
lookup -> candidates -> dual window check -> the relation's rows (the
counterpart of disco_tpu/overlap/device.py).

- Window codes come straight from the packed words with a three-word
  funnel, in int64: for window j, take words j//16, +1, +2, shift out the
  2*(j%16) phase bits and keep the top 2k bits (reference: the per-substring
  std::string hashing of src/BuildGraph/src/HashTable.cpp:396-416).
- Lookup is `torch.searchsorted` over the sorted fingerprint keys, held as
  int64 with the sign bit flipped so signed order is the keys' unsigned
  order (reference: the bucket probe of HashTable.cpp:521-571).
- The one step, `device_overlap_rows`, compacts the candidates before the
  check: the bucket ranges are flattened into a (cand_cap,) list by an
  inverse searchsorted over the per-window prefix sums
  (`dense_candidates`), and only those pairs are checked.
- The check is the K2 kernel (`fused_kernel.fused_compare_dual_fetch`) when
  a packed table is given, else K1's rows route
  (`fused_kernel.fused_compare_dual_rows`), which reads both rows by index
  from packed_all on the live lanes only.
- Verified hits are compacted in window order to the relation's own
  columns, which stay on the device; the windows of each chunk are made on
  the device too (`window_starts_at`).  `DeviceOverlapEngine` runs the
  step over every window of the store (`dense_row_chunks`).

All functions take and return tensors on the caller's device; no shape or
count is read back to the host inside them."""
import numpy as np
import torch

from ..utils.logging import span
from .fused_kernel import (fused_compare_dual, fused_compare_dual_fetch,
                           fused_compare_dual_rows)
from .relation import _default_device
from .verify import as_words, make_packed_all

_M32 = 0xFFFFFFFF
_SIGN64 = -(1 << 63)


def flip_keys(keys: np.ndarray) -> np.ndarray:
    """uint64 keys -> int64 with the sign bit flipped (same order)."""
    return np.ascontiguousarray(keys, np.uint64).view(np.int64) ^ np.int64(
        _SIGN64)


def candidate_geometry(lengths, qread, qj, r2, orient, valid, *, k):
    """Window geometry of a flat (P,) candidate list
    (reference: OverlapGraph.cpp:517-595).  Returns (rows2, geo, e_valid,
    c_valid): rows2 (P,) int64, read2's row in packed_all (forward, or rc
    at +N); geo = (e_o1, e_o2, e_n, c_o1, c_n), (P,) int32 each, lengths
    zeroed on invalid pairs."""
    n_reads = lengths.shape[0]
    len1 = lengths[qread]
    len2 = lengths[r2]
    j = qj.to(torch.int32)
    suffix_case = (orient & 1) == 1      # orient 1/3: match at s2's end
    use_rc = orient >= 2                 # orient 2/3: s2 = rc(read2)

    e_valid = torch.where(suffix_case, j <= len2 - k, (len1 - j) < len2)
    e_valid &= (j >= 1) & (qread != r2) & valid
    e_n = torch.where(suffix_case, j + k, len1 - j)
    e_n = torch.where(e_valid, e_n, 0).to(torch.int32)
    e_o1 = torch.where(suffix_case, 0, j).to(torch.int32)
    e_o2 = torch.where(suffix_case, len2 - e_n, 0).clamp_min(0).to(
        torch.int32)

    c_valid = torch.where(suffix_case, j >= len2 - k, j + len2 <= len1)
    c_valid &= (qread != r2) & valid
    c_n = torch.where(c_valid, len2, 0).to(torch.int32)
    c_o1 = torch.where(suffix_case, j + k - len2, j).clamp_min(0).to(
        torch.int32)

    rows2 = r2 + torch.where(use_rc, n_reads, 0)
    return rows2, (e_o1, e_o2, e_n, c_o1, c_n), e_valid, c_valid


def candidate_checks(packed_all, lengths, qread, qj, r2, orient, valid, *,
                     k, packed_table=None):
    """Geometry + verification of a flat (P,) candidate list.  Returns
    (edge_ok, cont_ok).

    With `packed_table` (packed_all itself) the check is the K2 kernel,
    which fetches read1's rows from the table; candidates arrive sorted by
    read1 (window-scan order).  Without it, K1's rows route reads both
    rows from packed_all by index (`fused_compare_dual_rows`): the
    replicated superstep's check (dist/overlap_shard.py) and the device
    engine's with fetch=False."""
    qread = qread.to(torch.int64)
    rows2, geo, e_valid, c_valid = candidate_geometry(
        lengths, qread, qj, r2.to(torch.int64), orient, valid, k=k)
    if packed_table is not None:
        b = packed_all[rows2].T.contiguous()               # (Wp, P)
        edge_ok, cont_ok = fused_compare_dual_fetch(
            packed_table, b, qread.to(torch.int32), *geo)
    else:
        edge_ok, cont_ok = fused_compare_dual_rows(
            packed_all, qread.to(torch.int32), packed_all,
            rows2.to(torch.int32), *geo)
    return edge_ok & e_valid, cont_ok & c_valid


def candidate_checks_rows(rows1, rows2, lengths, qread, qj, r2, orient,
                          valid, *, k):
    """`candidate_checks` over a (Q, H) candidate grid and rows fetched
    beforehand instead of a resident packed_all: rows1 (Q, Wp) is read1's
    forward row, rows2 (Q, H, Wp) the candidate's forward or rc row (the
    caller resolves the orientation before fetching).  The dist-mem
    superstep's check (dist/overlap_shard.py), where the read payload is
    partitioned over the shards (reference's RMA fetch:
    src/BuildGraphMPIRMA/src/HashTable.cpp:665-708).  The geometry is
    `candidate_geometry`'s over the flattened grid; the check is K1's rows
    route, lane p pairing rows1[p // H] with row p of rows2: no block is
    expanded or transposed.  Returns (edge_ok, cont_ok), (Q, H) bool."""
    q, h = r2.shape
    wp = rows1.shape[-1]
    _, geo, e_valid, c_valid = candidate_geometry(
        lengths, qread.to(torch.int64).repeat_interleave(h),
        qj.to(torch.int32).repeat_interleave(h), r2.reshape(-1).to(torch.int64),
        orient.reshape(-1), valid.reshape(-1), k=k)
    # made each call: held across calls they would add 8 B a lane to the
    # superstep's peak device memory, which the check itself never sets
    lane = torch.arange(q * h, dtype=torch.int32, device=rows1.device)
    edge_ok, cont_ok = fused_compare_dual_rows(
        rows1, lane // h, rows2.reshape(-1, wp), lane, *geo)
    return ((edge_ok & e_valid).reshape(q, h),
            (cont_ok & c_valid).reshape(q, h))


def _dual_check(blk1, blk2, e_o1, e_o2, e_n, c_o1, c_n):
    """Edge + containment window compares over gathered (P, Wp) row
    blocks: the K1 wrapper over their columns (relation._xla_rows: the xla
    backend and the exact re-run of an overflowing chunk)."""
    return fused_compare_dual(blk1.T.contiguous(), blk2.T.contiguous(),
                              e_o1, e_o2, e_n, c_o1, c_n)


def _window_codes(packed, qread, qj, k):
    """Three-word funnel window codes in int64, sign bit flipped."""
    wlim = packed.shape[1] - 1
    wbase = qj >> 4
    phase = (qj & 15) << 1

    def word(i):
        return packed[qread, i.clamp_max(wlim)].to(torch.int64) & _M32

    w0, w1, w2 = word(wbase), word(wbase + 1), word(wbase + 2)
    hi = (w0 << 32) | w1
    # w2 >> (32 - phase) in two steps (a shift by 32 is undefined); w2 is
    # non-negative, so >> is logical.  hi << phase wraps to the uint64 bits
    win = torch.where(phase == 0, hi,
                      (hi << phase) | ((w2 >> (31 - phase)) >> 1))
    kk = min(k, 32)
    if kk < 32:
        win = (win >> (64 - 2 * kk)) & ((1 << (2 * kk)) - 1)
    return win ^ _SIGN64


def dense_candidates(packed, starts, tmeta, keys, *, k, max_len,
                     cand_cap):
    """Lookup + candidate compaction: the bucket ranges of the windows
    `starts` flattened into (cand_cap,) slots.  Returns (cwin, cread, cj,
    r2, orient, typ, cvalid, n_cand): per slot its window in the chunk,
    read1, window offset, read2, hit orientation, record type and
    validity (int64 / bool tensors), plus the chunk's candidate count."""
    q = starts.shape[0]
    qread = starts // max_len
    qj = starts % max_len
    qcode = _window_codes(packed, qread, qj, k)

    lo = torch.searchsorted(keys, qcode)
    hi = torch.searchsorted(keys, qcode, right=True)
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=lo.device),
                     torch.cumsum(hi - lo, 0)])
    n_cand = cum[q]

    # flat slot -> (window, bucket rank)
    slots = torch.arange(cand_cap, dtype=torch.int64, device=starts.device)
    cwin = torch.searchsorted(cum, slots, right=True) - 1
    cvalid = slots < n_cand
    cwin = cwin.clamp(0, q - 1)
    rank = slots - cum[cwin]
    tpos = (lo[cwin] + rank).clamp(0, tmeta.shape[0] - 1)
    meta_g = torch.where(cvalid, tmeta[tpos], 0).to(torch.int64)
    return (cwin, qread[cwin], qj[cwin], meta_g >> 3, (meta_g >> 1) & 3,
            meta_g & 1, cvalid, n_cand)


def window_starts_at(woff, s: int, q: int, chunk: int, max_len: int):
    """(chunk,) int64 window ids (read * max_len + j) of the global windows
    [s, s + chunk), made on `woff`'s device from the reads' window offsets
    (`window_offsets`, as a tensor); q is the number of windows, and ids
    past the last window repeat it (the padding of a short final chunk)."""
    idx = torch.arange(s, s + chunk, dtype=torch.int64,
                       device=woff.device).clamp_max_(q - 1)
    read = torch.searchsorted(woff, idx, right=True) - 1
    return read * max_len + (idx - woff[read])


def device_overlap_rows(packed, packed_all, lengths, starts, tmeta, keys,
                        fidx, *, k, max_len, cand_cap, out_cap, n_real,
                        packed_table=None):
    """The overlap step: lookup and candidates (`dense_candidates`), the
    dual check (`candidate_checks`), and the kept rows as the relation's
    columns.  starts: (Q,) int64 window ids (read * max_len + j); tmeta:
    (M,) int32 table metadata read << 3 | orient << 1 | typ; keys: (M,)
    flipped int64.  The verified rows of the chunk's first `n_real`
    windows (the rest pad a short chunk) are compacted in window order
    into (out_cap,) columns r1, j, r2 (int32), orient, typ (int8), cont_ok
    and edge_ok (bool).  Inside a window they come in table-slot order,
    which is the relation's order (read2's file index `fidx`, then record
    type) when the table's buckets are sorted so.

    Returns (rows, meta): rows the seven columns in that order, meta int64
    [n_hits, n_candidates, n_disorder], n_disorder counting the rows whose
    (fidx[r2], typ) lies below the previous row's of the same window.
    meta[1] > cand_cap or meta[0] > out_cap means the chunk must be re-run
    by an exact path; meta[2] > 0 that its rows need sorting."""
    cwin, cread, cj, r2, orient, typ, cvalid, n_cand = dense_candidates(
        packed, starts, tmeta, keys, k=k, max_len=max_len, cand_cap=cand_cap)
    edge_ok, cont_ok = candidate_checks(
        packed_all, lengths, cread, cj, r2, orient, cvalid, k=k,
        packed_table=packed_table)
    keep = (edge_ok | cont_ok) & (cwin < n_real)
    # row i is the slot where the running count of kept slots reaches
    # i + 1: a search over the slots, then a gather a column, so each of
    # the nine columns reads out_cap slots where a scatter would write
    # cand_cap (rows past the count read the last slot and are never read)
    kept = torch.cumsum(keep, 0)
    n_hits = kept[-1]
    slot = torch.searchsorted(
        kept, torch.arange(1, out_cap + 1, device=kept.device)).clamp_max_(
            cand_cap - 1)
    rows = tuple(col[slot].to(dtype) for col, dtype in (
        (cread, torch.int32), (cj, torch.int32), (r2, torch.int32),
        (orient, torch.int8), (typ, torch.int8), (cont_ok, torch.bool),
        (edge_ok, torch.bool)))
    wi, f, t = cwin[slot], fidx[r2[slot]], rows[4]
    live = torch.arange(1, out_cap, device=wi.device) < n_hits
    down = (f[1:] < f[:-1]) | ((f[1:] == f[:-1]) & (t[1:] < t[:-1]))
    n_disorder = (live & (wi[1:] == wi[:-1]) & down).sum()
    return rows, torch.stack([n_hits, n_cand.clamp_max(_M32), n_disorder])


def window_offsets(lengths, k: int) -> np.ndarray:
    """(n_reads + 1,) int64: the global index of each read's first window
    j in [0, len - k), and last the number of windows of the set."""
    n_win = np.asarray(lengths, np.int64) - k
    if (n_win <= 0).any():
        raise ValueError("read shorter than min overlap")
    return np.concatenate([np.zeros(1, np.int64), np.cumsum(n_win)])


def chunk_windows(woff: np.ndarray, s: int, e: int):
    """(read, j), int64, of the global windows [s, e) (s < e), from the
    reads' window offsets `woff` (`window_offsets`): O(e - s) work, whatever
    s is."""
    r0, r1 = np.searchsorted(woff, [s, e - 1], side="right") - 1
    first = woff[r0:r1 + 1]
    n = np.diff(np.clip(woff[r0:r1 + 2], s, e))
    read = np.repeat(np.arange(r0, r1 + 1, dtype=np.int64), n)
    return read, np.arange(s, e, dtype=np.int64) - np.repeat(first, n)


class DeviceOverlapEngine:
    """Host wrapper: puts the read store and the table on `device` (default:
    the CUDA card; without one it raises) and runs the rows step
    (`device_overlap_rows`) over every window of the store in chunks
    (`dense_row_chunks`).

    `fetch` selects the step's check: True runs K2, which reads read1's
    rows from packed_all; False runs K1's rows route, which reads both
    rows from packed_all by index.  `stats` counts chunks; the caller adds
    the chunks it re-ran by an exact path."""

    def __init__(self, store, table, device=None, fetch: bool = True):
        self.store = store
        self.k = table.k
        self.device = (torch.device(device) if device is not None
                       else _default_device())
        self.packed = as_words(store.packed, self.device)
        self.packed_all = make_packed_all(store.packed, store.packed_rc,
                                          self.device)
        self.lengths = torch.from_numpy(
            np.ascontiguousarray(store.lengths, np.int32)).to(self.device)
        self.keys = torch.from_numpy(flip_keys(table.keys)).to(self.device)
        if store.n_reads >= (1 << 28):
            raise ValueError(f"{store.n_reads} reads: the table's metadata "
                             "packs read ids in 28 bits")
        tmeta = ((table.read.astype(np.int32) << 3)
                 | (table.orient.astype(np.int32) << 1)
                 | table.typ.astype(np.int32))
        self.tmeta = torch.from_numpy(tmeta).to(self.device)
        self.packed_table = self.packed_all if fetch else None
        self.stats = {"chunks": 0, "fallback_chunks": 0}

    def dense_row_chunks(self, woff: np.ndarray, chunk: int, cand_cap: int,
                         keep):
        """The rows step (`device_overlap_rows`, out_cap = chunk) over every
        window of the store, each chunk's windows made on the device from
        the reads' window offsets `woff` (`window_offsets`, put on the
        device here with the reads' file indices) in a `relation.windows`
        span; the step is enqueued, and `keep(rows, meta)` takes the
        chunk's rows, inside a `relation.step` span.  A 1-deep dispatch
        pipeline: chunk i+1 is enqueued before chunk i is handed out.
        Yield ((s, e), keep's result, meta) per chunk of the global windows
        [s, e).  The offsets and file indices go to the device in this
        call, not at the first chunk: the copies wait for the host, and the
        chunk loop must not."""
        q = int(woff[-1])
        max_len = self.store.max_len
        dwoff = torch.from_numpy(np.ascontiguousarray(woff, np.int64)).to(
            self.device)
        fidx = torch.from_numpy(np.ascontiguousarray(
            self.store.file_index, np.int64)).to(self.device)

        def step(s, e, starts):
            # the rows die with this frame once `keep` has taken them: held
            # into the next chunk, they would add a chunk's rows to the peak
            rows, meta = device_overlap_rows(
                self.packed, self.packed_all, self.lengths, starts,
                self.tmeta, self.keys, fidx, k=self.k, max_len=max_len,
                cand_cap=cand_cap, out_cap=chunk, n_real=e - s,
                packed_table=self.packed_table)
            return (s, e), keep(rows, meta), meta

        def chunks():
            pending = None
            for s in range(0, q, chunk):
                e = min(s + chunk, q)
                with span("relation.windows"):
                    starts = window_starts_at(dwoff, s, q, chunk, max_len)
                with span("relation.step"):
                    done = step(s, e, starts)
                self.stats["chunks"] += 1
                if pending is not None:
                    yield pending
                pending = done
            if pending is not None:
                yield pending

        return chunks()
