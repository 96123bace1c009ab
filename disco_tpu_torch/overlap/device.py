"""The device half of buildG on torch tensors: window codes -> sorted-table
lookup -> candidates -> dual window check -> hit compaction (the
counterpart of disco_tpu/overlap/device.py).

- Window codes come straight from the packed words with a three-word
  funnel, in int64: for window j, take words j//16, +1, +2, shift out the
  2*(j%16) phase bits and keep the top 2k bits (reference: the per-substring
  std::string hashing of src/BuildGraph/src/HashTable.cpp:396-416).
- Lookup is `torch.searchsorted` over the sorted fingerprint keys, held as
  int64 with the sign bit flipped so signed order is the keys' unsigned
  order (reference: the bucket probe of HashTable.cpp:521-571).
- The dense steps (`device_overlap_rows`, the main path's, and the wire
  steps `device_overlap_dense*`) compact the candidates before the check: the bucket ranges are flattened into a
  (cand_cap,) list by an inverse searchsorted over the per-window prefix
  sums, and only those pairs are checked.
- The hit-cap grid (`device_overlap`, `_compact`, `_packed`) expands each
  window's bucket to a fixed (Q, hit_cap) grid instead, with a validity
  mask and a count of the windows whose bucket is larger than the cap; the
  compact and packed variants drop those windows' hits and compact the rest
  on the device.
- The check is the K2 kernel (`fused_kernel.fused_compare_dual_fetch`) when
  a packed table is given, else K1's rows route
  (`fused_kernel.fused_compare_dual_rows`), which reads both rows by index
  from packed_all on the live lanes only.
- Verified hits are compacted to 4-byte (`device_overlap_dense32`) or
  8-byte (`device_overlap_dense`, `device_overlap_packed`) wire rows in
  window order, or, on the main path (`device_overlap_rows`), to the
  relation's own columns, which stay on the device; the windows of that
  path's chunks are made on the device too (`window_starts_at`).

All functions take and return tensors on the caller's device; no shape or
count is read back to the host inside them."""
from typing import NamedTuple

import numpy as np
import torch

from ..utils.logging import span
from .fused_kernel import (fused_compare_dual, fused_compare_dual_fetch,
                           fused_compare_dual_rows)
from .relation import _default_device
from .verify import as_words, make_packed_all

_M32 = 0xFFFFFFFF
_SIGN64 = -(1 << 63)


class DeviceOverlapResult(NamedTuple):
    """Per (window, slot) candidate grid with verification masks."""
    r2: torch.Tensor        # (Q, H) int32 candidate read ids
    orient: torch.Tensor    # (Q, H) int32 hit orientation
    typ: torch.Tensor       # (Q, H) int32 record type
    edge_ok: torch.Tensor   # (Q, H) bool
    cont_ok: torch.Tensor   # (Q, H) bool
    overflow: torch.Tensor  # () int64 windows with more than H hits
    n_hits: torch.Tensor    # () int64 occupied candidate slots


class DeviceCompactResult(NamedTuple):
    """The verified hits of one window chunk, compacted on the device.

    Rows are in (window, table slot) order, the reference's (r1, j,
    bucket scan) relation order.  `count` may exceed `out_cap` (the rows
    past it are dropped): the caller must then re-run the chunk by an
    exact path."""
    wi: torch.Tensor        # (out_cap,) int32 window index within the chunk
    r2: torch.Tensor        # (out_cap,) int32 candidate read id
    orient: torch.Tensor    # (out_cap,) int32 hit orientation
    typ: torch.Tensor       # (out_cap,) int32 record type
    flags: torch.Tensor     # (out_cap,) int32 bit0 edge_ok, bit1 cont_ok
    count: torch.Tensor     # () int32 verified rows in the chunk
    over: torch.Tensor      # (Q,) bool the window's bucket exceeds hit_cap


def flip_keys(keys: np.ndarray) -> np.ndarray:
    """uint64 keys -> int64 with the sign bit flipped (same order)."""
    return np.ascontiguousarray(keys, np.uint64).view(np.int64) ^ np.int64(
        _SIGN64)


def _narrow32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 bits in [0, 2^32) -> int32 with those bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


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


def _checked_candidates(packed, packed_all, lengths, starts, tmeta, keys, *,
                        k, max_len, cand_cap, packed_table):
    """dense_candidates + the dual check.  Returns (cwin, cread, cj, r2,
    orient, typ, edge_ok, cont_ok, n_cand)."""
    cwin, cread, cj, r2, orient, typ, cvalid, n_cand = dense_candidates(
        packed, starts, tmeta, keys, k=k, max_len=max_len,
        cand_cap=cand_cap)
    edge_ok, cont_ok = candidate_checks(
        packed_all, lengths, cread, cj, r2, orient, cvalid, k=k,
        packed_table=packed_table)
    return cwin, cread, cj, r2, orient, typ, edge_ok, cont_ok, n_cand


class _Scatter:
    """Scatter of kept rows to their rank in a zeroed (out_cap,) vector,
    dropping ranks >= out_cap (XLA's mode="drop").  Dropped rows land in
    one extra slot that is cut off, so no count is read back to the
    host."""

    def __init__(self, keep, out_cap):
        pos = torch.cumsum(keep, 0) - 1
        self.idx = torch.where(keep & (pos < out_cap), pos, out_cap)
        self.out_cap = out_cap

    def __call__(self, vals, dtype=torch.int64):
        out = torch.zeros(self.out_cap + 1, dtype=dtype,
                          device=self.idx.device)
        out.scatter_(0, self.idx, vals.to(dtype))
        return out[:self.out_cap]


def device_overlap_dense(packed, packed_all, lengths, starts, tmeta, keys,
                         *, k, max_len, cand_cap, out_cap,
                         packed_table=None):
    """Dense-candidate overlap step with 8-byte wire rows.

    starts: (Q,) int64 window ids (read * max_len + j); tmeta: (M,) int32
    table metadata read << 3 | orient << 1 | typ; keys: (M,) flipped int64.
    Returns (data (2, out_cap) int32, meta int64 [n_hits, n_candidates]):
    row 0 is wi | orient<<21 | typ<<23 | flags<<24 (flags bit0 edge_ok,
    bit1 cont_ok), row 1 is r2.  meta[1] > cand_cap or meta[0] > out_cap
    means the chunk must be re-run by an exact path."""
    cwin, _, _, r2, orient, typ, edge_ok, cont_ok, n_cand = (
        _checked_candidates(packed, packed_all, lengths, starts, tmeta, keys,
                            k=k, max_len=max_len, cand_cap=cand_cap,
                            packed_table=packed_table))
    keep = edge_ok | cont_ok
    flags = edge_ok.to(torch.int64) | (cont_ok.to(torch.int64) << 1)
    word0 = cwin | (orient << 21) | (typ << 23) | (flags << 24)
    scat = _Scatter(keep, out_cap)
    data = torch.stack([scat(word0, torch.int32), scat(r2, torch.int32)])
    meta = torch.stack([keep.sum(), n_cand.clamp_max(_M32)])
    return data, meta


def device_overlap_dense32(packed, packed_all, lengths, starts, tmeta, keys,
                           *, k, max_len, cand_cap, out_cap, rbits,
                           packed_table=None):
    """`device_overlap_dense` with a 4-byte wire row.

    Row u32 = r2t << (dbits+4) | orient << (dbits+2) | (flags-1) << dbits
    | min(dwi, esc), where r2t = r2 << 1 | typ (rbits bits), dwi is the
    delta of the window index from the previous hit (rows are in window
    order), and dwi == esc marks an escape whose full window index ships in
    a side stream.  Requires rbits + 8 <= 32.

    Returns (word (out_cap,) int32, esc (out_cap,) int32, meta int64
    [n_hits, n_cand, n_esc])."""
    dbits = 32 - 4 - rbits
    if dbits < 4:
        raise ValueError(f"rbits = {rbits}: the 4-byte row needs rbits <= 24")
    esc = (1 << dbits) - 1
    cwin, _, _, r2, orient, typ, edge_ok, cont_ok, n_cand = (
        _checked_candidates(packed, packed_all, lengths, starts, tmeta, keys,
                            k=k, max_len=max_len, cand_cap=cand_cap,
                            packed_table=packed_table))
    keep = edge_ok | cont_ok
    flags = edge_ok.to(torch.int64) | (cont_ok.to(torch.int64) << 1)
    scat = _Scatter(keep, out_cap)
    n_hits = keep.sum()
    wis = scat(cwin)
    dwi = wis - torch.cat([wis.new_zeros(1), wis[:-1]])
    in_range = torch.arange(out_cap, device=wis.device) < n_hits
    dwi = torch.where(in_range, dwi, 0)
    is_esc = (dwi >= esc) & in_range
    r2t = (r2 << 1) | typ
    # built in int64 (r2t << (dbits+4) overflows int32), masked to the
    # 32 wire bits, then narrowed
    word = (scat(r2t << (dbits + 4)) | scat(orient << (dbits + 2))
            | scat((flags - 1) << dbits) | dwi.clamp_max(esc))
    # escape side stream: full window index per escaping hit, in order
    esc_scat = _Scatter(is_esc, out_cap)
    esc_stream = esc_scat(wis, torch.int32)
    meta = torch.stack([n_hits, n_cand.clamp_max(_M32), is_esc.sum()])
    return _narrow32(word & _M32), esc_stream, meta


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
    """Dense-candidate overlap step whose kept rows are the relation's
    columns.  The lookup, candidates and check are `device_overlap_dense`'s;
    the verified rows of the chunk's first `n_real` windows (the rest pad a
    short chunk) are compacted in window order into (out_cap,) columns r1,
    j, r2 (int32), orient, typ (int8), cont_ok and edge_ok (bool).  Inside
    a window they come in table-slot order, which is the relation's order
    (read2's file index `fidx`, then record type) when the table's buckets
    are sorted so.

    Returns (rows, meta): rows the seven columns in that order, meta int64
    [n_hits, n_candidates, n_disorder], n_disorder counting the rows whose
    (fidx[r2], typ) lies below the previous row's of the same window.
    meta[1] > cand_cap or meta[0] > out_cap means the chunk must be re-run
    by an exact path; meta[2] > 0 that its rows need sorting."""
    cwin, cread, cj, r2, orient, typ, edge_ok, cont_ok, n_cand = (
        _checked_candidates(packed, packed_all, lengths, starts, tmeta, keys,
                            k=k, max_len=max_len, cand_cap=cand_cap,
                            packed_table=packed_table))
    keep = (edge_ok | cont_ok) & (cwin < n_real)
    # row i is the slot where the running count of kept slots reaches
    # i + 1: a search over the slots, then a gather a column, so each of
    # the nine columns reads out_cap slots where `_Scatter` would write
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


def _hit_grid(packed, packed_all, lengths, starts, tmeta, keys, *, k,
              max_len, hit_cap, drop_over):
    """Lookup + the (Q, hit_cap) candidate grid + the dual check through
    K1's rows route over the flattened grid (no row block is gathered).
    Positions are int32 (tables hold under 2^31 entries).  With
    `drop_over` a window whose bucket exceeds hit_cap gets no valid slot;
    without it its first hit_cap slots stay valid.  Returns (r2, orient,
    typ, edge_ok, cont_ok, valid, over): (Q, H) int32 / bool grids and the
    (Q,) bool overflow mask."""
    q = starts.shape[0]
    qread = starts // max_len
    qj = starts % max_len
    qcode = _window_codes(packed, qread, qj, k)
    lo = torch.searchsorted(keys, qcode, out_int32=True)
    hi = torch.searchsorted(keys, qcode, right=True, out_int32=True)
    over = (hi - lo) > hit_cap
    tpos = lo[:, None] + torch.arange(hit_cap, dtype=torch.int32,
                                      device=lo.device)
    valid = tpos < hi[:, None]
    if drop_over:
        valid &= ~over[:, None]
    meta = torch.where(valid, tmeta[tpos.clamp_(0, tmeta.shape[0] - 1)], 0)
    del tpos
    r2, orient, typ = meta >> 3, (meta >> 1) & 3, meta & 1
    edge_ok, cont_ok = candidate_checks(
        packed_all, lengths, qread.to(torch.int32).repeat_interleave(hit_cap),
        qj.to(torch.int32).repeat_interleave(hit_cap), r2.reshape(-1),
        orient.reshape(-1), valid.reshape(-1), k=k)
    return (r2, orient, typ, edge_ok.reshape(q, hit_cap),
            cont_ok.reshape(q, hit_cap), valid, over)


def device_overlap(packed, packed_all, lengths, starts, tmeta, keys, *, k,
                   max_len, hit_cap):
    """The hit-cap grid step.  starts: (Q,) int64 window ids (read *
    max_len + j); tmeta, keys as for `device_overlap_dense`.  Every
    window's first hit_cap bucket entries are checked, also in a window
    whose bucket is larger: `overflow` counts those windows, for the caller
    to re-run exactly."""
    r2, orient, typ, edge_ok, cont_ok, valid, over = _hit_grid(
        packed, packed_all, lengths, starts, tmeta, keys, k=k,
        max_len=max_len, hit_cap=hit_cap, drop_over=False)
    return DeviceOverlapResult(r2, orient, typ, edge_ok, cont_ok, over.sum(),
                               valid.sum())


def device_overlap_compact(packed, packed_all, lengths, starts, tmeta, keys,
                           *, k, max_len, hit_cap, out_cap):
    """`device_overlap` with the overflowing windows' hits dropped and the
    verified hits compacted on the device into (out_cap,) rows, so that
    O(hits) words leave the device a chunk instead of the (Q, hit_cap)
    grids (the reference's hot loop,
    src/BuildGraph/src/OverlapGraph.cpp:401-478,631-674)."""
    r2, orient, typ, edge_ok, cont_ok, _, over = _hit_grid(
        packed, packed_all, lengths, starts, tmeta, keys, k=k,
        max_len=max_len, hit_cap=hit_cap, drop_over=True)
    keep = (edge_ok | cont_ok).reshape(-1)
    flags = edge_ok.to(torch.int32) | (cont_ok.to(torch.int32) << 1)
    wi = torch.arange(starts.shape[0], dtype=torch.int32,
                      device=starts.device).repeat_interleave(hit_cap)
    scat = _Scatter(keep, out_cap)
    return DeviceCompactResult(
        wi=scat(wi, torch.int32), r2=scat(r2.reshape(-1), torch.int32),
        orient=scat(orient.reshape(-1), torch.int32),
        typ=scat(typ.reshape(-1), torch.int32),
        flags=scat(flags.reshape(-1), torch.int32),
        count=keep.sum().to(torch.int32), over=over)


def device_overlap_packed(packed, packed_all, lengths, starts, tmeta, keys,
                          *, k, max_len, hit_cap, out_cap):
    """`device_overlap_compact` in two arrays: data (2, out_cap) int32, row
    0 wi | orient << 21 | typ << 23 | flags << 24 and row 1 r2 (8 B a
    hit), and meta int32 holding the uint32 words [count, the overflow
    bits of the windows, 32 a word, window i at bit i % 32 of word
    i // 32].  Q is at most 2^21 (the window index's 21 bits)."""
    q = starts.shape[0]
    if q > 1 << 21:
        raise ValueError(f"{q} windows: the packed row holds 2^21 at most")
    res = device_overlap_compact(packed, packed_all, lengths, starts, tmeta,
                                 keys, k=k, max_len=max_len,
                                 hit_cap=hit_cap, out_cap=out_cap)
    word0 = (res.wi | (res.orient << 21) | (res.typ << 23)
             | (res.flags << 24))
    data = torch.stack([word0, res.r2])
    # uint32 words built in int64 (torch on the CPU has no uint32 shift)
    bits = torch.nn.functional.pad(res.over.to(torch.int64),
                                   (0, (-q) % 32)).reshape(-1, 32)
    over_words = (bits << torch.arange(32, device=bits.device)).sum(1)
    meta = torch.cat([res.count.to(torch.int64)[None], over_words])
    return data, _narrow32(meta)


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
    the CUDA card; without one it raises) and runs the overlap steps over
    window chunks: the dense steps (`run_dense*`; over every window of the
    store, each chunk's windows made as it goes, `dense_window_chunks`, or
    made on the device, `dense_row_chunks`) and
    the hit-cap grid steps of `hit_cap` slots a window (`run`,
    `run_compact`, `run_packed` and their chunked forms).

    `fetch` selects the dense steps' check: True runs K2, which reads
    read1's rows from packed_all; False runs K1's rows route, which reads
    both rows from packed_all by index.  The grid steps always check
    through the rows route.  `stats` counts chunks; the caller adds the
    chunks it re-ran by an exact path."""

    def __init__(self, store, table, hit_cap: int = 16, device=None,
                 fetch: bool = True):
        self.store = store
        self.k = table.k
        self.hit_cap = hit_cap
        self.device = (torch.device(device) if device is not None
                       else _default_device())
        self.packed = as_words(store.packed, self.device)
        self.packed_all = make_packed_all(store.packed, store.packed_rc,
                                          self.device)
        self.lengths = torch.from_numpy(
            np.ascontiguousarray(store.lengths, np.int32)).to(self.device)
        self.keys = torch.from_numpy(flip_keys(table.keys)).to(self.device)
        if store.n_reads >= (1 << 28):
            raise ValueError(f"{store.n_reads} reads: the dense path packs "
                             "read ids in 28 bits")
        tmeta = ((table.read.astype(np.int32) << 3)
                 | (table.orient.astype(np.int32) << 1)
                 | table.typ.astype(np.int32))
        self.tmeta = torch.from_numpy(tmeta).to(self.device)
        self.packed_table = self.packed_all if fetch else None
        self.stats = {"chunks": 0, "fallback_chunks": 0}

    def window_starts(self) -> np.ndarray:
        lens = self.store.lengths.astype(np.int64)
        n_win = lens - self.k
        reads = np.repeat(np.arange(self.store.n_reads, dtype=np.int64),
                          n_win)
        offs = np.concatenate([np.arange(c) for c in n_win])
        return (reads * self.store.max_len + offs).astype(np.int64)

    def _args(self, starts):
        return (self.packed, self.packed_all, self.lengths,
                torch.from_numpy(np.ascontiguousarray(starts, np.int64)).to(
                    self.device), self.tmeta, self.keys)

    def _kw(self, cand_cap, out_cap):
        return dict(k=self.k, max_len=self.store.max_len, cand_cap=cand_cap,
                    out_cap=out_cap, packed_table=self.packed_table)

    def run_dense(self, starts, cand_cap: int, out_cap: int):
        return device_overlap_dense(*self._args(starts),
                                    **self._kw(cand_cap, out_cap))

    def run_dense32(self, starts, cand_cap: int, out_cap: int, rbits: int):
        return device_overlap_dense32(*self._args(starts), rbits=rbits,
                                      **self._kw(cand_cap, out_cap))

    def _gkw(self):
        return dict(k=self.k, max_len=self.store.max_len,
                    hit_cap=self.hit_cap)

    def run(self, starts) -> DeviceOverlapResult:
        return device_overlap(*self._args(starts), **self._gkw())

    def run_compact(self, starts, out_cap: int) -> DeviceCompactResult:
        return device_overlap_compact(*self._args(starts), out_cap=out_cap,
                                      **self._gkw())

    def run_packed(self, starts, out_cap: int):
        return device_overlap_packed(*self._args(starts), out_cap=out_cap,
                                     **self._gkw())

    def run_chunked(self, starts: np.ndarray, chunk: int = 1 << 17):
        """Yield (n_real, DeviceOverlapResult) per chunk of `chunk`
        windows, the last padded with repeats of its final window."""
        return self._chunked(lambda part: (self.run(part),), starts, chunk)

    def run_packed_chunked(self, starts: np.ndarray, chunk: int = 1 << 21,
                           out_cap: int = None):
        """Yield (n_real, data, meta) per chunk (`run_packed`)."""
        out_cap = out_cap or chunk
        return self._chunked(lambda part: self.run_packed(part, out_cap),
                             starts, chunk)

    def _chunked(self, step, starts, chunk):
        """Yield (n_real, *step(part)) per chunk of `starts`, the last
        chunk padded with repeats of its final window."""
        parts = (starts[s:s + chunk] for s in range(0, len(starts), chunk))
        return self._pipelined(lambda head, part: step(part),
                               ((len(p), p, chunk) for p in parts))

    def _pipelined(self, step, parts):
        """Yield (head, *step(head, padded part)) for each (head, part,
        chunk) of `parts`, a part shorter than `chunk` padded with repeats
        of its final window, through a 1-deep dispatch pipeline: chunk i+1
        is enqueued before chunk i is handed out.  The padding is a
        `relation.windows` span, the step a `relation.step` span: the
        starts copied to the device (for a part on the host) and the
        chunk's work enqueued."""
        pending = None
        for head, part, chunk in parts:
            if len(part) < chunk:
                with span("relation.windows"):
                    part = np.concatenate([part, np.full(
                        chunk - len(part), part[-1], part.dtype)])
            with span("relation.step"):
                res = step(head, part)
            self.stats["chunks"] += 1
            if pending is not None:
                yield pending
            pending = (head,) + tuple(res)
        if pending is not None:
            yield pending

    def dense_window_chunks(self, chunk: int = 1 << 20, cand_cap: int = None,
                            out_cap: int = None, rbits: int = None):
        """The dense steps over every window of the store, each chunk's
        windows made here from the reads' cumulative window counts
        (`chunk_windows`): no array of one entry a window over the whole
        set is built.  Yield ((read, j), *step) per chunk of `chunk`
        windows, (read, j) the chunk's real windows (int64): the 4-byte
        wire (`run_dense32`, (word, esc, meta)) with `rbits`, else the
        8-byte one (`run_dense`, (data, meta))."""
        cand_cap = cand_cap or 4 * chunk
        out_cap = out_cap or chunk
        woff = window_offsets(self.store.lengths, self.k)
        q = int(woff[-1])

        def parts():
            for s in range(0, q, chunk):
                with span("relation.windows"):
                    read, j = chunk_windows(woff, s, min(s + chunk, q))
                    starts = read * self.store.max_len + j
                yield (read, j), starts, chunk

        if rbits is None:
            def step(head, part):
                return self.run_dense(part, cand_cap, out_cap)
        else:
            def step(head, part):
                return self.run_dense32(part, cand_cap, out_cap, rbits)
        return self._pipelined(step, parts())

    def dense_row_chunks(self, woff: np.ndarray, chunk: int, cand_cap: int,
                         keep):
        """The rows step (`device_overlap_rows`, out_cap = chunk) over every
        window of the store through `_pipelined`, each chunk's windows made
        on the device from the reads' window offsets `woff`
        (`window_offsets`, put on the device here with the reads' file
        indices) in a `relation.windows` span; `keep(rows, meta)`, which
        takes the chunk's rows, runs inside the `relation.step` span.
        Yield ((s, e), keep's result, meta) per chunk of the global windows
        [s, e)."""
        q = int(woff[-1])
        dwoff = torch.from_numpy(np.ascontiguousarray(woff, np.int64)).to(
            self.device)
        fidx = torch.from_numpy(np.ascontiguousarray(
            self.store.file_index, np.int64)).to(self.device)
        kw = self._kw(cand_cap, chunk)

        def parts():
            for s in range(0, q, chunk):
                with span("relation.windows"):
                    starts = window_starts_at(dwoff, s, q, chunk,
                                              self.store.max_len)
                yield (s, min(s + chunk, q)), starts, chunk

        def step(head, starts):
            rows, meta = device_overlap_rows(
                self.packed, self.packed_all, self.lengths, starts,
                self.tmeta, self.keys, fidx, n_real=head[1] - head[0], **kw)
            return keep(rows, meta), meta

        return self._pipelined(step, parts())

    def run_dense32_chunked(self, starts: np.ndarray, chunk: int = 1 << 20,
                            cand_cap: int = None, out_cap: int = None,
                            rbits: int = None):
        """Yield (n_real, word, esc, meta) per chunk (4-byte wire)."""
        cand_cap = cand_cap or 4 * chunk
        out_cap = out_cap or chunk
        if rbits is None:
            rbits = max(int(self.store.n_reads).bit_length() + 1, 8)
        return self._chunked(
            lambda part: self.run_dense32(part, cand_cap, out_cap, rbits),
            starts, chunk)

    def run_dense_chunked(self, starts: np.ndarray, chunk: int = 1 << 20,
                          cand_cap: int = None, out_cap: int = None):
        """Yield (n_real, data, meta) per chunk (8-byte wire)."""
        cand_cap = cand_cap or 4 * chunk
        out_cap = out_cap or chunk
        return self._chunked(
            lambda part: self.run_dense(part, cand_cap, out_cap),
            starts, chunk)
