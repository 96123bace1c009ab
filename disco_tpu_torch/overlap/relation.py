"""Full overlap/containment relation computation (the counterpart of
disco_tpu/overlap/relation.py).

For every read r1 and window j in [0, len1-k) (the reference's substring loop,
reference: src/BuildGraph/src/OverlapGraph.cpp:401,638), look up the window's
(k=minOverlap-1)-mer in the fingerprint table and verify each hit:

- containment check (reference: OverlapGraph.cpp:517-554): read2 lies entirely
  within read1 — windows of length len2;
- edge check (reference: OverlapGraph.cpp:567-595): suffix-prefix overlap that
  extends to the reads' ends — only j >= 1 qualifies
  (reference: OverlapGraph.cpp:638 starts the edge loop at j=1).

The relation is ORDER-COMPLETE: hits per (r1, j) are sorted by
(read2, record-type), which equals the reference's hash-bucket scan order
(file order), so the sequential replay in `buildg` reproduces the
reference's outputs bit-for-bit.

Backends: "native" (the C++/OpenMP host kernel), "device" (the torch
pipeline of overlap/device.py on a CUDA card, or on the CPU through the
kernels' plain versions), and "xla" (the exact host expansion of
disco_tpu's XLA path, checked through the K1 wrapper; also the device
backend's fallback for chunks that overflow their caps).
"""
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..utils.logging import count, span
from . import verify as _verify

BACKEND_ENV = "DISCO_TPU_TORCH_BACKEND"

# Orientation tables, indexed by hit orientation 0..3
# (reference: src/BuildGraph/src/OverlapGraph.cpp:428-433,660-666)
_IS_SUFFIX_CASE = np.array([0, 1, 0, 1], np.bool_)  # orient 1/3: match at s2 end
_USE_RC = np.array([0, 0, 1, 1], np.bool_)       # orient 2/3: s2 = rc(read2)

_COLUMNS = {"r1": np.int32, "j": np.int32, "r2": np.int32,
            "orient": np.int8, "typ": np.int8, "cont_ok": np.bool_,
            "edge_ok": np.bool_}


@dataclass
class OverlapRelation:
    """Struct-of-arrays of verified hits, sorted by (r1, j, r2, typ).

    r1, r2 : int32, 0-based read indices
    j      : int32 window start in read1 (reference's substring position)
    orient : int8 hit orientation (0..3, table semantics)
    typ    : int8 table record type (0 prefix, 1 suffix) — tie-break order
    cont_ok: bool — read2 contained in read1 at this hit
    edge_ok: bool — proper suffix-prefix overlap at this hit (j>=1 enforced)
    stats  : counters of the backend that made it (device: chunks and
             fallback_chunks)
    """
    r1: np.ndarray
    j: np.ndarray
    r2: np.ndarray
    orient: np.ndarray
    typ: np.ndarray
    cont_ok: np.ndarray
    edge_ok: np.ndarray
    k: int
    stats: dict = field(default_factory=dict)

    def __len__(self):
        return len(self.r1)


def window_codes(store: ReadStore, k: int):
    """Return (qread, qj, qcode): one query per (read, window j in [0,len-k)).
    Codes are the first min(k,32) bases of each window, packed uint64
    (`window_codes_at`)."""
    n = store.n_reads
    lens = store.lengths.astype(np.int64)
    n_win = lens - k  # windows j in [0, len-k)
    if (n_win <= 0).any():
        raise ValueError("read shorter than min overlap")
    qread = np.repeat(np.arange(n, dtype=np.int32), n_win)
    cum = np.cumsum(n_win)
    offs = np.arange(int(cum[-1]), dtype=np.int64) - np.repeat(
        cum - n_win, n_win)
    qj = offs.astype(np.int32)
    return qread, qj, window_codes_at(store, qread, qj, k)


def window_codes_at(store: ReadStore, qread, qj, k: int) -> np.ndarray:
    """The uint64 codes of the given windows (read qread, start qj): the
    first min(k,32) bases, computed with a three-word funnel over the
    packed words (the same formula as the device pipeline,
    overlap/device.py)."""
    kk = min(k, 32)
    words = store.packed
    wlim = words.shape[1] - 1
    wbase = qj // 16
    phase = (2 * (qj % 16)).astype(np.uint64)
    w0 = words[qread, np.minimum(wbase, wlim)].astype(np.uint64)
    w1 = words[qread, np.minimum(wbase + 1, wlim)].astype(np.uint64)
    w2 = words[qread, np.minimum(wbase + 2, wlim)].astype(np.uint64)
    hi = (w0 << np.uint64(32)) | w1
    win = np.where(phase == 0, hi,
                   (hi << phase) | ((w2 >> (np.uint64(31) - phase))
                                    >> np.uint64(1)))
    return win >> np.uint64(64 - 2 * kk)


def default_backend() -> str:
    """"device" when a CUDA card is present, else "native" (the C++/OpenMP
    host kernel).  DISCO_TPU_TORCH_BACKEND=native|device|xla overrides."""
    env = os.environ.get(BACKEND_ENV)
    if env:
        return env
    return "device" if torch.cuda.is_available() else "native"


def _default_device() -> torch.device:
    """The CUDA card.  Without one this raises: the host runs the plain
    versions only when the caller passes device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is "
                           "false; pass device=\"cpu\" to run the kernels' "
                           "plain versions on the host")
    return torch.device("cuda")


def compute_relation(store: ReadStore, table: FingerprintTable,
                     chunk: int = 1 << 22, backend: str = None,
                     device=None) -> OverlapRelation:
    """Verified overlap/containment relation over all read windows.

    backend="device": `_device_relation` on `device` (default: the CUDA
    card; without one it raises).  Default when a card is present; below 2^20
    windows the auto-selected device backend gives way to the native one.

    backend="native": the C++/OpenMP kernel (native/src/overlap.cpp).

    backend="xla": exact host expansion of every candidate pair, checked in
    chunks of `chunk` candidates through the K1 wrapper on `device`."""
    if backend is None:
        backend = default_backend()
        if backend == "device":
            n_win = int(store.lengths.sum()) - store.n_reads * table.k
            if n_win < (1 << 20):
                backend = "native"
    if backend == "native":
        from .. import native
        out = native.overlap_relation(
            store.packed, store.packed_rc, store.lengths, table.keys,
            table.read, table.orient, table.typ, table.k)
        return OverlapRelation(
            r1=out["r1"], j=out["j"], r2=out["r2"], orient=out["orient"],
            typ=out["typ"], cont_ok=out["cont_ok"], edge_ok=out["edge_ok"],
            k=table.k)
    if backend == "device":
        return _device_relation(store, table, device=device)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    k = table.k
    qread, qj, qcode = window_codes(store, k)
    rows = _xla_rows(store, table, qread, qj, qcode, chunk, device=device)
    return _sorted_relation(store, rows, k)


def _xla_rows(store: ReadStore, table: FingerprintTable, qread, qj, qcode,
              chunk: int = 1 << 22, *, device=None, packed_all=None):
    """Expand every candidate pair of the given windows on the host and
    check them through the K1 wrapper on `device` (the CUDA kernel on a
    card, its plain version on the CPU); returns the kept-row dict
    (unsorted).  Shared by the xla backend and the device backend's
    fallback, which passes its resident `packed_all`."""
    from .device import _dual_check
    k = table.k
    device = torch.device(device) if device is not None else (
        packed_all.device if packed_all is not None else _default_device())
    lo, hi = table.lookup_ranges(qcode)
    counts = (hi - lo).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])

    n = store.n_reads
    if packed_all is None:
        packed_all = _verify.make_packed_all(store.packed, store.packed_rc,
                                             device)

    kept = {name: [] for name in _COLUMNS}

    # chunk boundaries in candidate space aligned to window groups
    q_starts = [0]
    while q_starts[-1] < len(qread):
        nxt = int(np.searchsorted(cum, cum[q_starts[-1]] + chunk,
                                  side="left"))
        nxt = max(nxt, q_starts[-1] + 1)
        q_starts.append(min(nxt, len(qread)))

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    for qs, qe in zip(q_starts[:-1], q_starts[1:]):
        cnt = counts[qs:qe]
        tot = int(cnt.sum())
        if tot == 0:
            continue
        pair_q = np.repeat(np.arange(qs, qe, dtype=np.int64), cnt)
        rank = np.arange(tot, dtype=np.int64) - np.repeat(
            (cum[qs:qe] - cum[qs]), cnt)
        tpos = lo[pair_q] + rank

        r1 = qread[pair_q]
        j = qj[pair_q]
        r2 = table.read[tpos]
        orient = table.orient[tpos]
        typ = table.typ[tpos]

        len1 = store.lengths[r1].astype(np.int32)
        len2 = store.lengths[r2].astype(np.int32)
        suffix_case = _IS_SUFFIX_CASE[orient]
        use_rc = _USE_RC[orient]

        # edge (reference: OverlapGraph.cpp:567-595)
        e_valid = np.where(suffix_case, j <= len2 - k, (len1 - j) < len2)
        e_valid &= (j >= 1) & (r1 != r2)
        e_n = np.where(suffix_case, j + k, len1 - j)
        e_o1 = np.where(suffix_case, 0, j)
        e_o2 = np.where(suffix_case, len2 - e_n, 0)
        e_n = np.where(e_valid, e_n, 0)

        # containment (reference: OverlapGraph.cpp:517-554)
        c_valid = np.where(suffix_case, j >= len2 - k, j + len2 <= len1)
        c_valid &= r1 != r2
        c_n = np.where(c_valid, len2, 0)
        c_o1 = np.where(suffix_case, j + k - len2, j)

        rows2 = r2.astype(np.int64) + np.where(use_rc, n, 0)
        blk1 = packed_all[dev(r1).long()]
        blk2 = packed_all[torch.from_numpy(rows2).to(device)]
        edge_ok, cont_ok = _dual_check(
            blk1, blk2, dev(e_o1), dev(e_o2), dev(e_n), dev(c_o1), dev(c_n))
        edge_ok = edge_ok.cpu().numpy() & e_valid
        cont_ok = cont_ok.cpu().numpy() & c_valid
        keep = edge_ok | cont_ok
        for name, col in (("r1", r1), ("j", j), ("r2", r2),
                          ("orient", orient), ("typ", typ),
                          ("cont_ok", cont_ok), ("edge_ok", edge_ok)):
            kept[name].append(col[keep].astype(_COLUMNS[name], copy=False))

    return {name: (np.concatenate(kept[name]) if kept[name]
                   else np.zeros(0, dtype))
            for name, dtype in _COLUMNS.items()}


def _sorted_relation(store: ReadStore, rows: dict, k: int,
                     stats: dict = None) -> OverlapRelation:
    """Sort kept rows into the reference's relation order: hits per (r1, j)
    ordered like the bucket scan — by the candidate's FILE index (insertion
    order), prefix record first."""
    fidx2 = store.file_index[rows["r2"]]
    order = np.lexsort((rows["typ"], fidx2, rows["j"], rows["r1"]))
    return OverlapRelation(
        r1=rows["r1"][order], j=rows["j"][order], r2=rows["r2"][order],
        orient=rows["orient"][order], typ=rows["typ"][order],
        cont_ok=rows["cont_ok"][order], edge_ok=rows["edge_ok"][order], k=k,
        stats=dict(stats or {}))


def relation_order(w, fidx2, typ) -> np.ndarray:
    """The permutation that puts rows in the relation's order: by window,
    then read2's FILE index, then record type, ties kept in their given
    order.  `w` is any window index that grows with (r1, j), such as the
    global window index; the permutation is then np.lexsort((typ, fidx2,
    j, r1))'s.  One stable sort of one int64 key (w, fidx2, typ), or none
    when the rows are in order already, as a re-run chunk's rows are."""
    w = np.asarray(w, np.int64)
    fidx2 = np.asarray(fidx2, np.int64)
    if len(w) == 0:
        return np.zeros(0, np.int64)
    fbits = max(int(fidx2.max()).bit_length(), 1)
    if int(w.max()) >= 1 << (62 - fbits):
        raise ValueError(f"window index {int(w.max())} and {fbits}-bit file "
                         "indices do not fit one int64 key")
    key = (w << (fbits + 1)) | (fidx2 << 1) | np.asarray(typ, np.int64)
    if (key[1:] >= key[:-1]).all():
        return np.arange(len(key))
    return np.argsort(key, kind="stable")


class _RowSegments:
    """The relation's rows kept on the device until the end: each column in
    segments of `cap` rows, which the chunk steps fill in chunk order at a
    count held on the device, so that no step waits for the count of the
    chunk before it.  A chunk over its caps adds no rows.  The host follows
    each segment's count as it learns the chunks' counts (`settle`), and
    opens a new segment before a step whose rows might not fit."""

    def __init__(self, cap: int, out_cap: int, cand_cap: int, device):
        assert cap >= 2 * out_cap, (cap, out_cap)
        self.cap, self.out_cap, self.cand_cap = cap, out_cap, cand_cap
        self.cols, self.fill, self.known = [], [], []
        self.unsettled = 0   # steps put into the last segment, not settled
        self.dst = torch.arange(out_cap, dtype=torch.int64, device=device)

    def put(self, rows, meta) -> int:
        """Enqueue the copy of a chunk's (out_cap,) columns to the last
        segment's count, and the count's rise; returns the segment."""
        if (not self.cols or self.known[-1]
                + (self.unsettled + 1) * self.out_cap > self.cap):
            self.cols.append(tuple(torch.empty(self.cap, dtype=r.dtype,
                                               device=r.device)
                                   for r in rows))
            self.fill.append(torch.zeros((), dtype=torch.int64,
                                         device=self.dst.device))
            self.known.append(0)
            self.unsettled = 0
        i = len(self.cols) - 1
        self.unsettled += 1
        dst = self.fill[i] + self.dst
        for col, r in zip(self.cols[i], rows):
            col.index_copy_(0, dst, r)
        within = (meta[0] <= self.out_cap) & (meta[1] <= self.cand_cap)
        self.fill[i] += torch.where(within, meta[0], 0)
        return i

    def settle(self, i: int, n: int) -> int:
        """A chunk of segment i kept n rows: returns their first row."""
        off = self.known[i]
        self.known[i] += n
        if i == len(self.cols) - 1:
            self.unsettled -= 1
        return off

    def pull(self, runs, out: dict) -> None:
        """Copy each run (segment, first row, rows, row in `out`) of every
        column straight into its slice of the host arrays `out`, then free
        the segments."""
        for i, off, n, a in runs:
            for name, col in zip(_COLUMNS, self.cols[i]):
                torch.from_numpy(out[name][a:a + n]).copy_(col[off:off + n])
        self.cols.clear()
        self.fill.clear()


def _device_relation(store: ReadStore, table: FingerprintTable,
                     chunk: int = None, cand_factor: float = 4, *,
                     device=None, fetch: bool = True) -> OverlapRelation:
    """The device overlap phase: the full window scan runs through the
    dense-candidate pipeline (overlap/device.py) in chunks of `chunk`
    windows (default 2^20 on a CUDA card, 2^14 elsewhere).  Chunks whose
    candidate or hit count exceeds the static caps (cand_factor * chunk,
    chunk) are re-run exactly by `_xla_rows`, at once and in their place;
    their number is `stats["fallback_chunks"]` of the result.  A
    cand_factor below 1 forces such re-runs on inputs of fewer candidates
    than windows.  Output is identical to the native backend: same rows,
    same (r1, j, bucket-scan) order.

    The chunk loop stays on the device: each chunk's windows are made there
    from the reads' window offsets, its kept rows are written as the
    relation's columns (`device_overlap_rows`) and appended to segments
    kept there (`_RowSegments`), and the host reads back three counts a
    chunk: rows, candidates, and rows out of the relation's order.  Each
    column is pulled once at the end, a copy a segment.  The host makes a
    chunk's windows and codes (`chunk_windows`, `window_codes_at`) only to
    re-run it, and sorts a chunk's rows (`relation_order`) only when it is
    re-run or the device found them out of order, as it does when the
    table's buckets are not in (file index, type) order; that number is
    `stats["reordered_chunks"]`.  No host array holds an entry a window of
    the whole set; what grows is the kept rows, 15 B each, on the device
    and then on the host.

    `fetch` picks the check: K2 (True) or K1's rows route.  Displaces the
    reference's hot loop (src/BuildGraph/src/OverlapGraph.cpp:631-674).

    Its spans (utils/logging.py): `relation.upload` (the engine built, the
    window offsets and file indices put on the device), the engine's
    `relation.windows` (the window ops enqueued) and `relation.step` (the
    step and the rows' copy to their segment enqueued) a chunk, then
    `relation.wait` (the chunk's counts, which wait for its kernels);
    `relation.fallback` (a re-run), `relation.decode` (the window index and
    file index of a re-run or out-of-order chunk's rows) and
    `relation.order` (their sort); at the end `relation.pull` (the columns
    copied to the host) and `relation.join` (the re-run chunks' rows put in
    place).  Its counters: `relation.candidates` (the chunks' candidates),
    `relation.slots` (cand_cap a chunk: the slots the check ran on),
    `relation.rows` (the rows kept on the device) and `relation.reordered`
    (the chunks sorted on the host because the device found them out of
    order)."""
    from .device import DeviceOverlapEngine, chunk_windows, window_offsets

    device = torch.device(device) if device is not None else _default_device()
    if chunk is None:
        # on the CPU the checks run as their plain versions, whose
        # temporaries grow with cand_cap x Wp: keep chunks small there
        chunk = 1 << 20 if device.type == "cuda" else 1 << 14
    cand_cap = int(cand_factor * chunk)
    k = table.k
    fidx = store.file_index
    with span("relation.upload"):
        segs = _RowSegments(16 * chunk, chunk, cand_cap, device)
        eng = DeviceOverlapEngine(store, table, device=device, fetch=fetch)
        woff = window_offsets(store.lengths, k)
        chunks = eng.dense_row_chunks(woff, chunk, cand_cap, segs.put)

    def ordered(rows: dict) -> dict:
        """The rows of one chunk, in relation order."""
        with span("relation.decode"):
            w = woff[rows["r1"]] + rows["j"]
            f = fidx[rows["r2"]]
        with span("relation.order"):
            order = relation_order(w, f, rows["typ"])
            return {name: col[order] for name, col in rows.items()}

    # per chunk in order: ("card", segment, first row, rows, out of order)
    # or ("host", its rows in relation order)
    parts = []
    for (s, e), seg, meta in chunks:
        with span("relation.wait"):
            meta = meta.cpu().numpy()        # [n_hits, n_cand, n_disorder]
        count("relation.candidates", int(meta[1]))
        count("relation.slots", cand_cap)
        if int(meta[1]) <= cand_cap and int(meta[0]) <= chunk:
            n = int(meta[0])
            parts.append(("card", seg, segs.settle(seg, n), n,
                          int(meta[2]) > 0))
            continue
        # static-cap overflow: exact re-run of the whole chunk, windows and
        # codes made for it alone
        segs.settle(seg, 0)
        with span("relation.fallback"):
            eng.stats["fallback_chunks"] += 1
            read, jj = chunk_windows(woff, s, e)
            fb = _xla_rows(store, table, read, jj,
                           window_codes_at(store, read, jj, k),
                           packed_all=eng.packed_all)
        parts.append(("host", ordered(fb)))

    with span("relation.pull"):
        runs, host, flagged, a = [], [], [], 0
        for part in parts:
            if part[0] == "host":
                host.append((a, part[1]))
                a += len(part[1]["r1"])
                continue
            _, seg, off, n, disorder = part
            if disorder:
                flagged.append((a, a + n))
            if n and runs and runs[-1][0] == seg and (
                    runs[-1][1] + runs[-1][2] == off
                    and runs[-1][3] + runs[-1][2] == a):
                runs[-1][2] += n          # contiguous on both sides
            elif n:
                runs.append([seg, off, n, a])
            a += n
        rows = {name: np.empty(a, dtype) for name, dtype in _COLUMNS.items()}
        segs.pull(runs, rows)
    for lo, hi in flagged:
        for name, col in ordered({name: col[lo:hi]
                                  for name, col in rows.items()}).items():
            rows[name][lo:hi] = col
    with span("relation.join"):
        for lo, part in host:
            for name, col in part.items():
                rows[name][lo:lo + len(col)] = col
        count("relation.rows", a - sum(len(p["r1"]) for _, p in host))
        count("relation.reordered", len(flagged))
        stats = dict(eng.stats, reordered_chunks=len(flagged))
        del eng, chunks, segs, parts, host   # the device's arrays freed here
    return OverlapRelation(**rows, k=k, stats=stats)
