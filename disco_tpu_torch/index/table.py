"""Sorted canonical fingerprint table over read end-(L-1)-mers.

The counterpart of disco_tpu/index/table.py, built by one of two routes
that give the same arrays, dtypes and order (tests/test_torch_table.py
holds both to each other and to the original's):

- the numpy route (`FingerprintTable.build(store, k)`): the end k-mers'
  base codes unpacked column by column, packed into keys, ordered by
  `np.lexsort` on (key, file index, type).  The plain version: the native
  two-pass protocol, the xla backend and the tools build with it.
- the torch route (`build(store, k, device=...)`), on the device of the
  run's relation: the four end keys are the window codes of the overlap
  step's three-word funnel (`overlap/device.py::_window_codes`) at the
  read's two ends in its forward and rc words, and the order is two
  stable sorts, first by (file index << 1 | type) and then by key, which
  leave ties in the order of the concatenation, as `np.lexsort` does.
  The columns come to the host once, at the end.

Replacement for the reference's chained prefix/suffix hash table
(reference: src/BuildGraph/src/HashTable.cpp:341-571). Design differences:

- The reference buckets records by a canonical hash min(h(s), h(rc(s))) and
  re-verifies string equality during the bucket scan; bucket iteration order
  is read-file order. We instead store, per read end, entries under BOTH the
  k-mer code and its reverse-complement code, in one array SORTED by
  (key, read, end-type). A query is then a pure `searchsorted` — vectorizable
  on device — and the hits for a key, ordered by (read, type), reproduce the
  reference's bucket scan order exactly (file order == read-ID order; a
  read's prefix record precedes its suffix record,
  reference: src/BuildGraph/src/HashTable.cpp:450-512).
- Keys are the first min(k, 32) bases packed 2-bit into a uint64. For
  k > 32 the key is a truncation; downstream verification always compares
  the full overlap window including the k-mer, so results stay exact.
- The reference's if/else in the bucket scan emits a single orientation per
  record (reference: src/BuildGraph/src/HashTable.cpp:535-566); for
  palindromic end-mers (kmer == its own rc) we therefore drop the rc-keyed
  entry so only the forward orientation is reported.

Hit orientation encoding (identical to the reference's):
  0 = query == prefix of read2 (forward)
  1 = query == suffix of read2 (forward)
  2 = query == prefix of rc(read2)   [rc of read2's suffix]
  3 = query == suffix of rc(read2)   [rc of read2's prefix]
"""
from dataclasses import dataclass

import numpy as np
import torch

from ..io.readstore import ReadStore
from ..overlap.verify import as_words
from ..utils.logging import count, span

_SIGN64 = -(1 << 63)
_LAST = (1 << 63) - 1
# (orient << 1) | typ of the four parts, in concatenation order: prefix,
# suffix, prefix rc (orient 3), suffix rc (orient 2)
_PART_META = (0, 3, 6, 5)


def _pack_key(codes: np.ndarray) -> np.ndarray:
    """(N, k) uint8 codes -> uint64 keys over the first min(k,32) bases."""
    k = min(codes.shape[1], 32)
    key = np.zeros(codes.shape[0], np.uint64)
    for t in range(k):
        key = (key << np.uint64(2)) | codes[:, t].astype(np.uint64)
    return key


def end_kmer_codes(store: ReadStore, k: int):
    """Return (prefix_codes, suffix_codes, prefix_rc_codes, suffix_rc_codes)
    as (N, k) uint8 matrices of base codes."""
    n = store.n_reads
    pref = np.zeros((n, k), np.uint8)
    suf = np.zeros((n, k), np.uint8)
    # unpack from packed words (vectorized)
    words = store.packed  # (N, W+1) uint32
    positions = np.arange(k)
    for t in positions:
        w = words[:, t // 16]
        pref[:, t] = (w >> np.uint32(30 - 2 * (t % 16))) & np.uint32(3)
    lens = store.lengths.astype(np.int64)
    for t in positions:
        pos = lens - k + t
        w = words[np.arange(n), pos // 16]
        sh = (30 - 2 * (pos % 16)).astype(np.uint32)
        suf[:, t] = (w >> sh) & np.uint32(3)
    pref_rc = (3 - pref)[:, ::-1]
    suf_rc = (3 - suf)[:, ::-1]
    return pref, suf, pref_rc, suf_rc


@dataclass
class FingerprintTable:
    k: int
    keys: np.ndarray     # (M,) uint64, sorted
    read: np.ndarray     # (M,) int32, 0-based read index
    orient: np.ndarray   # (M,) int8 hit orientation 0..3
    typ: np.ndarray      # (M,) int8, 0=prefix record, 1=suffix record

    @classmethod
    def build(cls, store: ReadStore, k: int,
              device=None) -> "FingerprintTable":
        """The table of `store`'s read ends at k.  device=None: the numpy
        route; a torch device: the torch route on it (`_device_columns`).
        Both give the same arrays."""
        if k > store.lengths.min():
            raise ValueError("k longer than shortest read")
        if device is not None:
            return cls(k, *_device_columns(store, k, torch.device(device)))
        pref, suf, pref_rc, suf_rc = end_kmer_codes(store, k)
        n = store.n_reads
        rid = np.arange(n, dtype=np.int32)

        key_p, key_s = _pack_key(pref), _pack_key(suf)
        key_pr, key_sr = _pack_key(pref_rc), _pack_key(suf_rc)
        # palindrome dedup on the FULL kmer (not the truncated key)
        pal_p = (pref == pref_rc).all(axis=1)
        pal_s = (suf == suf_rc).all(axis=1)

        keys = [key_p, key_s, key_pr[~pal_p], key_sr[~pal_s]]
        reads = [rid, rid, rid[~pal_p], rid[~pal_s]]
        orients = [np.full(n, 0, np.int8), np.full(n, 1, np.int8),
                   np.full((~pal_p).sum(), 3, np.int8),
                   np.full((~pal_s).sum(), 2, np.int8)]
        typs = [np.zeros(n, np.int8), np.ones(n, np.int8),
                np.zeros((~pal_p).sum(), np.int8),
                np.ones((~pal_s).sum(), np.int8)]

        keys = np.concatenate(keys)
        reads = np.concatenate(reads)
        orients = np.concatenate(orients)
        typs = np.concatenate(typs)

        # Within a key, hits must come back in the reference's hash-bucket
        # scan order = hash-data insertion order = FILE order (the reference
        # re-reads the files in file order to fill the table,
        # reference: src/BuildGraph/src/HashTable.cpp:97-114), with a read's
        # prefix record before its suffix record. File order is file_index
        # order, which differs from read-ID order when the parser's task
        # permutation applies (see ReadStore.from_files).
        fidx_of = store.file_index
        order = np.lexsort((typs, fidx_of[reads], keys))
        return cls(k=k, keys=keys[order], read=reads[order],
                   orient=orients[order], typ=typs[order])

    def lookup_ranges(self, query_keys: np.ndarray):
        """[lo, hi) of each query key's entries, int64: numpy's searchsorted
        arrays, computed by torch.searchsorted on all host cores over the
        keys with their sign bit flipped (signed order = unsigned order)."""
        keys, q = (torch.from_numpy(np.ascontiguousarray(x, np.uint64).view(
            np.int64) ^ np.int64(-(1 << 63))) for x in (self.keys, query_keys))
        return (torch.searchsorted(keys, q).numpy(),
                torch.searchsorted(keys, q, right=True).numpy())


def _device_columns(store: ReadStore, k: int, device: torch.device):
    """(keys, read, orient, typ) of `FingerprintTable.build` made on
    `device`: the numpy route's arrays, dtypes and order.  Besides the
    sorts, its ops are those the overlap step runs anyway (elementwise
    int64, where, cat, gathers, a bool sum): the card loads an op's kernels
    into host memory at their first use, and they stay there."""
    n = store.n_reads
    with span("index.keys"):
        # overlap.device imports overlap.relation, which imports this module
        from ..overlap.device import _window_codes
        packed = as_words(store.packed, device)
        packed_rc = as_words(store.packed_rc, device)
        rid = torch.arange(n, dtype=torch.int64, device=device)
        head = torch.zeros_like(rid)
        tail = torch.from_numpy(store.lengths.astype(np.int64)).to(device) - k
        minor = torch.from_numpy(store.file_index).to(device) << 1

        def codes(words, start, width):
            return _window_codes(words, rid, start, width)

        # int64 with the sign bit flipped: signed order = unsigned order
        key_p, key_s = codes(packed, head, k), codes(packed, tail, k)
        key_pr, key_sr = codes(packed_rc, tail, k), codes(packed_rc, head, k)
        # palindromes on the FULL k-mer: the key holds its first 32 bases,
        # the bases past them are compared 32 at a time
        pal_p, pal_s = key_p == key_pr, key_s == key_sr
        for c in range(32, k, 32):
            w = min(32, k - c)
            pal_p &= codes(packed, head + c, w) == codes(packed_rc, tail + c, w)
            pal_s &= codes(packed, tail + c, w) == codes(packed_rc, head + c, w)
        # the numpy route's concatenation, prefix, suffix, prefix rc, suffix
        # rc, with a palindrome's rc entry kept in place under the last key
        # and the last minor key: the sorts put it after every entry, and
        # the first m entries are the table
        m = 4 * n - int(pal_p.sum() + pal_s.sum())
        keys = torch.cat([key_p, key_s, torch.where(pal_p, _LAST, key_pr),
                          torch.where(pal_s, _LAST, key_sr)])
        # minor key: file index << 1 | typ
        minor = torch.cat([minor, minor | 1, torch.where(pal_p, _LAST, minor),
                           torch.where(pal_s, _LAST, minor | 1)])
        # an entry: read << 3 | orient << 1 | typ
        meta = torch.cat([(rid << 3) | part for part in _PART_META])
    with span("index.order"):
        # within a key, file order (file_index), a read's prefix record
        # before its suffix record: np.lexsort((typs, fidx_of[reads],
        # keys)) as a stable sort by the minor key, then by the key
        _, o1 = torch.sort(minor, stable=True)
        keys, o2 = torch.sort(keys[o1], stable=True)
        meta = meta[o1[o2[:m]]].to(torch.int32)
    with span("index.pull"):
        keys = (keys[:m] ^ _SIGN64).cpu().numpy().view(np.uint64)
        meta = meta.cpu().numpy()
        cols = (keys, meta >> 3, ((meta >> 1) & 3).astype(np.int8),
                (meta & 1).astype(np.int8))
    count("index.entries", m)
    if device.type == "cuda":
        count("index.card_builds")
    return cols
