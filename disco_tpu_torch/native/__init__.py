"""ctypes bindings for the C++ host code of buildG and fullsimplify.

The sources are native/src/{readqc,overlap,replay,refsort,parsimplify,
mcmf,backindex}.cpp, byte-identical copies of the JAX package's, compiled
into the port's own build directory (see disco_tpu_torch/kernels.py).
Bound are read QC and packing, the record scanner (whole file, lengths
only, and in windows), the native overlap relation (all three protocols),
the traversal replay, and simplify's host code: libstdc++'s std::sort
permutation, parsimplify, the min-cost flow solver and the read-to-edge
back index.  Semantics are those of disco_tpu/native/__init__.py.

The port's own host code, native/port/*.cpp, has no twin in the JAX
package: native/port/replay.cpp is the traversal the port runs
(`replay_walk`, `ReplayWalk.text`); native/src/replay.cpp's
`graph_replay` stays bound as its parity oracle."""
import ctypes
import os
import threading

import numpy as np

from ..kernels import load_native, load_port_native

_LOCK = threading.Lock()
_LIBS = {}

_p64 = ctypes.POINTER(ctypes.c_int64)
_p32 = ctypes.POINTER(ctypes.c_int32)
_p16 = ctypes.POINTER(ctypes.c_int16)
_pi8 = ctypes.POINTER(ctypes.c_int8)
_pu8 = ctypes.POINTER(ctypes.c_uint8)
_pu32 = ctypes.POINTER(ctypes.c_uint32)
_pu64 = ctypes.POINTER(ctypes.c_uint64)
_i64 = ctypes.c_int64
_vp = ctypes.c_void_p

# name -> (g++ options, {function: (argtypes, restype)})
_SPECS = {
    "readqc": (("-O3", ("-fopenmp",)), {
        "qc_test_reads": ([ctypes.c_char_p, _p64, _i64, _i64, _pu8], None),
        "pack_reads_ordered": ([ctypes.c_char_p, _p64, _p64, _i64, _i64,
                                _pu32, _pu32], _i64),
        "seq_scan_count": ([ctypes.c_char_p, _i64], _i64),
        "seq_scan_open": ([ctypes.c_char_p, _p64, _p64], _vp),
        "seq_scan_extract": ([_vp, ctypes.c_char_p, _i64, _p64, _i64], _i64),
        "seq_scan_fill": ([ctypes.c_char_p, _i64, ctypes.c_char_p, _i64,
                           _p64, _i64], _i64),
        "seq_scan_offsets_close": ([_vp, _p64], None),
        "seq_scan_record_pos": ([_vp, _p64], None),
        "seq_scan_extract_window": ([_vp, _i64, _i64, ctypes.c_char_p, _i64,
                                     _p64, _i64], _i64),
        "seq_scan_close": ([_vp], None),
    }),
    "overlap": (("-O3", ("-fopenmp",)), {
        "overlap_relation_collect_mode": ([_pu32, _pu32, _p32, _i64, _i64,
                                           _pu64, _p32, _pi8, _pi8, _i64,
                                           _i64, _p64, _i64, _pu8], _vp),
        "overlap_relation_export": ([_vp, _p32, _p32, _p32, _pi8, _pi8,
                                     _pu8, _pu8], None),
        "overlap_relation_export_grouped": ([_vp, _i64, _p64, _p16, _p32,
                                             _pi8], None),
    }),
    "replay": (("-O2", ("-fopenmp",)), {
        "graph_replay": ([_i64, _i64, _i64, _p64, _p16, _p32, _pi8, _p32,
                          _p64, _pu8, _i64, _p64,
                          ctypes.POINTER(_vp), _p64,
                          ctypes.POINTER(_vp), _p64], _vp),
        "replay_free": ([_vp], None),
        "edge_group_count": ([_p32, _p32, _pu8, _pu8, _i64], _i64),
        "edge_group_fill": ([_p32, _p32, _p32, _pi8, _pu8, _pu8, _i64,
                             _i64, _p16, _p32, _pi8, _p64], None),
    }),
    "refsort": (("-O2", ()), {
        "stdsort_by_key_u64": ([_pu64, _p64, _i64], None),
        "stdsort_by_key_i64": ([_p64, _p64, _i64], None),
        "stdsort_by_key_i64_desc": ([_p64, _p64, _i64], None),
    }),
    "parsimplify": (("-O2", ()), {
        "parsimplify_run": ([ctypes.c_char_p, ctypes.c_char_p, _i64], _i64),
    }),
    "mcmf": (("-O3", ()), {
        "mcmf_solve": ([_i64, _i64, _p64, _p64, _p64, _p64, _p64, _p64],
                       _i64),
    }),
    "backindex": (("-O2", ()), {
        "backindex_new": ([_i64], _vp),
        "backindex_free": ([_vp], None),
        "backindex_add_bulk": ([_vp, _p32, _pi8, _i64, _i64, _i64], None),
        "backindex_remove_bulk": ([_vp, _p32, _pi8, _i64, _i64, _i64],
                                  None),
        "backindex_query": ([_vp, _i64, ctypes.c_int32, _p64, _p64], _i64),
        "backindex_count": ([_vp, _i64], _i64),
        "backindex_has": ([_vp, _i64], ctypes.c_int32),
        "backindex_head_ptr": ([_vp], _p32),
        "backindex_query_cap": ([_vp, _i64, ctypes.c_int32, _p64, _p64,
                                 _i64], _i64),
    }),
}

# the port's own sources, native/port/<name>.cpp
_PORT_SPECS = {
    "replay": (("-O3", ("-fopenmp",)), {
        "replay_walk": ([_i64, _i64, _i64, _p64, _p16, _p32, _pi8, _p32,
                         _pu8, _i64, _p64], _vp),
        "replay_format": ([_vp, _p64, _p32], _i64),
        "replay_output": ([_vp, ctypes.POINTER(_vp), ctypes.POINTER(_vp),
                           _p64, ctypes.POINTER(_p64), _p64], None),
        "replay_free": ([_vp], None),
    }),
}


def _load(key, name: str, specs, loader) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            (opt, extra), fns = specs[name]
            lib = loader(name, opt=opt, extra=extra)
            for fn, (argtypes, restype) in fns.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[key] = lib
    return lib


def _lib(name: str) -> ctypes.CDLL:
    return _load(name, name, _SPECS, load_native)


def _port_lib(name: str) -> ctypes.CDLL:
    return _load(("port", name), name, _PORT_SPECS, load_port_native)


def build_all() -> None:
    """Compile and load every host library of the port."""
    for name in _SPECS:
        _lib(name)


def _ptr(a, ptype):
    return a.ctypes.data_as(ptype)


def _as_char_p(x):
    if isinstance(x, bytes):
        return x
    return x.ctypes.data_as(ctypes.c_char_p)


# ---------------------------------------------------------------------------
# libstdc++ std::sort permutation (see src/refsort.cpp)
# ---------------------------------------------------------------------------
def stdsort_permutation(keys, descending: bool = False) -> np.ndarray:
    """Permutation produced by libstdc++ std::sort with a key-only `<`
    comparator, including its exact (unstable) treatment of ties. perm[i] is
    the original index of the element at sorted position i."""
    keys = np.ascontiguousarray(keys)
    n = len(keys)
    out = np.empty(n, np.int64)
    if n == 0:
        return out
    if n <= 16:
        # libstdc++ introsort runs a plain insertion sort on ranges up to
        # _S_threshold=16, which is stable, so the permutation is a stable
        # argsort (and the common small lists skip the ctypes round trip)
        if descending:
            k2 = keys.astype(np.int64, copy=False)
            return np.lexsort((np.arange(n), -k2))
        return np.argsort(keys, kind="stable")
    lib = _lib("refsort")
    if keys.dtype == np.uint64 and not descending:
        lib.stdsort_by_key_u64(_ptr(keys, _pu64), _ptr(out, _p64), n)
        return out
    keys = keys.astype(np.int64, copy=False)
    fn = (lib.stdsort_by_key_i64_desc if descending
          else lib.stdsort_by_key_i64)
    fn(_ptr(keys, _p64), _ptr(out, _p64), n)
    return out


# ---------------------------------------------------------------------------
# buildG traversal replay (see src/replay.cpp)
# ---------------------------------------------------------------------------
def graph_replay(n: int, k: int, wpgs: int, starts, ej, er2, eo, lens, fidx,
                 all_marked, start_read: int = 1):
    """Run the sequential buildG traversal replay from `start_read`
    (native/src/replay.cpp: the parity oracle of `replay_walk`).
    Returns (par_blob, start_blob, chunk_ends): the _parGraph.txt content,
    the _startRead.txt content (one line per chunk), and the parGraph byte
    offset after each chunk flush (the valid kill/restart points)."""
    lib = _lib("replay")
    starts = np.ascontiguousarray(starts, np.int64)
    ej = np.ascontiguousarray(ej, np.int16)
    er2 = np.ascontiguousarray(er2, np.int32)
    eo = np.ascontiguousarray(eo, np.int8)
    lens = np.ascontiguousarray(lens, np.int32)
    fidx = np.ascontiguousarray(fidx, np.int64)
    all_marked = np.ascontiguousarray(all_marked, np.uint8)
    size = ctypes.c_int64(0)
    sptr = ctypes.c_void_p()
    ssize = ctypes.c_int64(0)
    cptr = ctypes.c_void_p()
    nch = ctypes.c_int64(0)
    ptr = lib.graph_replay(
        n, k, wpgs, _ptr(starts, _p64), _ptr(ej, _p16), _ptr(er2, _p32),
        _ptr(eo, _pi8), _ptr(lens, _p32), _ptr(fidx, _p64),
        _ptr(all_marked, _pu8), start_read, ctypes.byref(size),
        ctypes.byref(sptr), ctypes.byref(ssize), ctypes.byref(cptr),
        ctypes.byref(nch))
    try:
        par = ctypes.string_at(ptr, size.value)
        start_blob = ctypes.string_at(sptr, ssize.value)
        chunk_ends = np.ctypeslib.as_array(
            ctypes.cast(cptr, _p64), shape=(nch.value,)).copy()
        return par, start_blob, chunk_ends
    finally:
        lib.replay_free(ptr)
        lib.replay_free(sptr)
        lib.replay_free(cptr)


class ReplayWalk:
    """A finished walk of the port's traversal (native/port/replay.cpp):
    `inserts` (calls to insert_all_edges), `edges` (edge pairs made) and
    `lines` (parGraph lines) count its work; `text` prints its lines."""

    def __init__(self, lib, handle, n, counts):
        self._lib, self._h, self._n = lib, handle, n
        self.inserts, self.edges, self.lines = (int(c) for c in counts)

    def text(self, fidx, lens):
        """(par_blob, start_blob, chunk_ends), as `graph_replay` returns
        them; frees the walk."""
        if self._h is None:
            raise RuntimeError("the walk's text was taken")
        fidx = np.ascontiguousarray(fidx, np.int64)
        lens = np.ascontiguousarray(lens, np.int32)
        if len(fidx) < self._n or len(lens) < self._n:
            raise ValueError("ReplayWalk.text: fidx and lens need n reads")
        lib, h = self._lib, self._h
        try:
            size = lib.replay_format(h, _ptr(fidx, _p64), _ptr(lens, _p32))
            tptr, sptr, cptr = _vp(), _vp(), _p64()
            ssize, nch = ctypes.c_int64(0), ctypes.c_int64(0)
            lib.replay_output(h, ctypes.byref(tptr), ctypes.byref(sptr),
                              ctypes.byref(ssize), ctypes.byref(cptr),
                              ctypes.byref(nch))
            par = ctypes.string_at(tptr, size)
            start_blob = ctypes.string_at(sptr, ssize.value)
            chunk_ends = np.ctypeslib.as_array(
                cptr, shape=(nch.value,)).copy()
            return par, start_blob, chunk_ends
        finally:
            self._h = None
            lib.replay_free(h)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.replay_free(self._h)
            self._h = None


def replay_walk(n: int, k: int, wpgs: int, starts, ej, er2, eo, lens,
                all_marked, start_read: int = 1) -> ReplayWalk:
    """The port's traversal: `graph_replay`'s walk, from `start_read`,
    marking `all_marked` ((n+1,) uint8, C-contiguous) in place.  Returns
    the walk; its `text` makes graph_replay's outputs."""
    if not (isinstance(all_marked, np.ndarray) and all_marked.dtype == np.uint8
            and all_marked.flags.c_contiguous):
        raise TypeError("all_marked must be a C-contiguous uint8 array")
    starts = np.ascontiguousarray(starts, np.int64)
    ej = np.ascontiguousarray(ej, np.int16)
    er2 = np.ascontiguousarray(er2, np.int32)
    eo = np.ascontiguousarray(eo, np.int8)
    lens = np.ascontiguousarray(lens, np.int32)
    if (len(starts) != n + 1 or len(all_marked) != n + 1 or len(lens) < n
            or not len(ej) == len(er2) == len(eo) == starts[n]):
        raise ValueError("replay_walk: the groups do not fit n reads")
    lib = _port_lib("replay")
    counts = np.zeros(3, np.int64)
    h = lib.replay_walk(n, k, wpgs, _ptr(starts, _p64), _ptr(ej, _p16),
                        _ptr(er2, _p32), _ptr(eo, _pi8), _ptr(lens, _p32),
                        _ptr(all_marked, _pu8), start_read,
                        _ptr(counts, _p64))
    return ReplayWalk(lib, h, n, counts)


def edge_hit_groups(r1, j, r2, orient, edge_ok, contained, n: int):
    """Filter the relation to edge rows with both endpoints uncontained and
    compact (j, r2+1, orient) preserving order, plus per-read group bounds
    `starts` (group of 1-based read r = [starts[r-1], starts[r]))."""
    lib = _lib("replay")
    r1 = np.ascontiguousarray(r1, np.int32)
    j = np.ascontiguousarray(j, np.int32)
    r2 = np.ascontiguousarray(r2, np.int32)
    orient = np.ascontiguousarray(orient, np.int8)
    edge_ok = np.ascontiguousarray(edge_ok, np.uint8)
    contained = np.ascontiguousarray(contained, np.uint8)
    nrows = len(r1)
    total = lib.edge_group_count(_ptr(r1, _p32), _ptr(r2, _p32),
                                 _ptr(edge_ok, _pu8), _ptr(contained, _pu8),
                                 nrows)
    out_j = np.empty(total, np.int16)
    out_r2 = np.empty(total, np.int32)
    out_eo = np.empty(total, np.int8)
    starts = np.empty(n + 1, np.int64)
    lib.edge_group_fill(
        _ptr(r1, _p32), _ptr(j, _p32), _ptr(r2, _p32), _ptr(orient, _pi8),
        _ptr(edge_ok, _pu8), _ptr(contained, _pu8), nrows, n,
        _ptr(out_j, _p16), _ptr(out_r2, _p32), _ptr(out_eo, _pi8),
        _ptr(starts, _p64))
    return starts, out_j, out_r2, out_eo


# ---------------------------------------------------------------------------
# Read QC + 2-bit packing + record scan (see src/readqc.cpp)
# ---------------------------------------------------------------------------
def qc_test_reads(blob: bytes, offsets: np.ndarray,
                  min_overlap: int) -> np.ndarray:
    """Vectorized Dataset::testRead over reads concatenated in `blob` with
    n+1 boundary `offsets`. Returns a (n,) bool keep-mask."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    out = np.empty(n, np.uint8)
    _lib("readqc").qc_test_reads(_as_char_p(blob), _ptr(offsets, _p64), n,
                                 min_overlap, _ptr(out, _pu8))
    return out.astype(bool)


def pack_reads(blob: bytes, offsets: np.ndarray, n_words: int,
               order: "np.ndarray | None" = None):
    """2-bit pack reads (forward + reverse complement) into
    (n, n_words+1) uint32 rows with one zero pad word each; row i packs
    record order[i] (identity when order is None).
    Raises ValueError on a non-ACGT base."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    if order is None:
        n = len(offsets) - 1
        order_p = ctypes.cast(None, _p64)
    else:
        order = np.ascontiguousarray(order, np.int64)
        n = len(order)
        order_p = _ptr(order, _p64)
    packed = np.empty((n, n_words + 1), np.uint32)
    packed_rc = np.empty((n, n_words + 1), np.uint32)
    bad = _lib("readqc").pack_reads_ordered(
        _as_char_p(blob), _ptr(offsets, _p64), order_p, n, n_words,
        _ptr(packed, _pu32), _ptr(packed_rc, _pu32))
    if bad >= 0:
        raise ValueError(f"non-ACGT base in read {bad + 1}")
    return packed, packed_rc


def seq_scan_path(path: str):
    """Streaming scan of an UNCOMPRESSED FASTA/FASTQ file into
    (seq_blob uint8, (n+1,) offsets), the sequence blob allocated at its
    exact size; None if the file cannot be scanned this way (caller falls
    back to `seq_scan`)."""
    lib = _lib("readqc")
    n = ctypes.c_int64(0)
    tot = ctypes.c_int64(0)
    h = lib.seq_scan_open(os.fsencode(path), ctypes.byref(n),
                          ctypes.byref(tot))
    if not h:
        return None
    offsets = np.zeros(n.value + 1, np.int64)
    buf = np.empty(max(tot.value, 1), np.uint8)
    w = lib.seq_scan_extract(h, _as_char_p(buf), tot.value,
                             _ptr(offsets, _p64), n.value)
    if w != tot.value:  # -1 = capacity guard tripped in C++ (file changed)
        raise RuntimeError(
            f"{path}: file changed between scan passes ({w} != {tot.value})")
    return buf, offsets


def seq_scan_lengths(path: str):
    """Lengths-only streaming scan of an uncompressed FASTA/FASTQ file:
    the (n+1,) sequence-length boundary offsets, no sequence bytes
    materialized (simplify's DataSet loads read lengths only, reference:
    src/SimplifyGraph/src/DataSet.cpp).  None if not scannable."""
    lib = _lib("readqc")
    n = ctypes.c_int64(0)
    tot = ctypes.c_int64(0)
    h = lib.seq_scan_open(os.fsencode(path), ctypes.byref(n),
                          ctypes.byref(tot))
    if not h:
        return None
    offsets = np.zeros(n.value + 1, np.int64)
    lib.seq_scan_offsets_close(h, _ptr(offsets, _p64))
    return offsets


def iter_record_windows(path: str, window_bytes: int = 64 << 20):
    """Windows (seq_blob uint8, (m+1,) offsets, rec_lo) of about
    `window_bytes` of file each, covering every record of an uncompressed
    FASTA/FASTQ file in order without holding the whole blob (the
    reference's contig streamer reads record by record,
    OverlapGraph.cpp:2148-2243).  Returns a generator, or None if the file
    cannot be scanned this way (the caller falls back)."""
    lib = _lib("readqc")
    n = ctypes.c_int64(0)
    tot = ctypes.c_int64(0)
    h = lib.seq_scan_open(os.fsencode(path), ctypes.byref(n),
                          ctypes.byref(tot))
    if not h:
        return None
    n = n.value
    rec_pos = np.empty(max(n, 1), np.int64)
    lib.seq_scan_record_pos(h, _ptr(rec_pos, _p64))
    fsize = os.path.getsize(path)

    def gen():
        try:
            lo = 0
            while lo < n:
                hi = lo
                start = rec_pos[lo]
                # grow the window by file bytes (sequence <= file bytes)
                while hi < n and (rec_pos[hi] - start) < window_bytes:
                    hi += 1
                file_hi = fsize if hi >= n else int(rec_pos[hi])
                file_lo = int(rec_pos[lo])
                cap = file_hi - file_lo
                buf = np.empty(max(cap, 1), np.uint8)
                offs = np.zeros(hi - lo + 1, np.int64)
                w = lib.seq_scan_extract_window(
                    h, file_lo, file_hi, _as_char_p(buf), cap,
                    _ptr(offs, _p64), hi - lo)
                if w < 0:
                    raise RuntimeError(
                        f"{path}: window extract overflow at records "
                        f"[{lo},{hi})")
                yield buf[:w], offs, lo
                lo = hi
        finally:
            lib.seq_scan_close(h)
    return gen()


def seq_scan(raw):
    """Parse a FASTA/FASTQ byte buffer (bytes or uint8 ndarray) into
    (seq_blob, offsets): upper-cased concatenated record sequences
    (uint8 array) + (n+1,) boundaries.
    Raises ValueError on an unknown leading byte."""
    lib = _lib("readqc")
    size = len(raw)
    n = lib.seq_scan_count(_as_char_p(raw), size)
    if n < 0:
        raise ValueError("Unknown input file format")
    offsets = np.zeros(n + 1, np.int64)
    buf = np.empty(max(size, 1), np.uint8)
    total = lib.seq_scan_fill(_as_char_p(raw), size, _as_char_p(buf),
                              len(buf), _ptr(offsets, _p64), n)
    if total < 0:
        raise RuntimeError("seq_scan: fill pass exceeded counted capacity")
    return buf[:total], offsets


# ---------------------------------------------------------------------------
# Overlap relation (see src/overlap.cpp)
# ---------------------------------------------------------------------------
def _table_args(packed, packed_rc, lengths, keys, tread, torient, ttyp):
    return (np.ascontiguousarray(packed, np.uint32),
            np.ascontiguousarray(packed_rc, np.uint32),
            np.ascontiguousarray(lengths, np.int32),
            np.ascontiguousarray(keys, np.uint64),
            np.ascontiguousarray(tread, np.int32),
            np.ascontiguousarray(torient, np.int8),
            np.ascontiguousarray(ttyp, np.int8))


def _collect(packed, packed_rc, lengths, keys, tread, torient, ttyp, k,
             mode, contained):
    lib = _lib("overlap")
    packed, packed_rc, lengths, keys, tread, torient, ttyp = _table_args(
        packed, packed_rc, lengths, keys, tread, torient, ttyp)
    n, row_words = packed.shape
    cptr = (_ptr(np.ascontiguousarray(contained, np.uint8), _pu8)
            if mode == 2 else ctypes.cast(None, _pu8))
    total = ctypes.c_int64(0)
    handle = lib.overlap_relation_collect_mode(
        _ptr(packed, _pu32), _ptr(packed_rc, _pu32), _ptr(lengths, _p32), n,
        row_words, _ptr(keys, _pu64), _ptr(tread, _p32),
        _ptr(torient, _pi8), _ptr(ttyp, _pi8), len(keys), k,
        ctypes.byref(total), mode, cptr)
    return lib, handle, total.value


def _export(lib, handle, total):
    out = {
        "r1": np.empty(total, np.int32), "j": np.empty(total, np.int32),
        "r2": np.empty(total, np.int32), "orient": np.empty(total, np.int8),
        "typ": np.empty(total, np.int8), "cont_ok": np.empty(total, np.uint8),
        "edge_ok": np.empty(total, np.uint8)}
    lib.overlap_relation_export(
        handle, _ptr(out["r1"], _p32), _ptr(out["j"], _p32),
        _ptr(out["r2"], _p32), _ptr(out["orient"], _pi8),
        _ptr(out["typ"], _pi8), _ptr(out["cont_ok"], _pu8),
        _ptr(out["edge_ok"], _pu8))
    out["cont_ok"] = out["cont_ok"].astype(bool)
    out["edge_ok"] = out["edge_ok"].astype(bool)
    return out


def overlap_relation(packed: np.ndarray, packed_rc: np.ndarray,
                     lengths: np.ndarray, keys: np.ndarray,
                     tread: np.ndarray, torient: np.ndarray,
                     ttyp: np.ndarray, k: int):
    """Full verified overlap/containment relation over all (read, window)
    queries against the sorted fingerprint table, emitted in
    (r1, j, bucket-scan) order. Returns dict of column arrays (see
    overlap.cpp for semantics)."""
    # mode 0 of collect_mode is the single-pass full relation
    return _export(*_collect(packed, packed_rc, lengths, keys, tread,
                             torient, ttyp, k, 0, None))


def overlap_relation_mode(packed: np.ndarray, packed_rc: np.ndarray,
                          lengths: np.ndarray, keys: np.ndarray,
                          tread: np.ndarray, torient: np.ndarray,
                          ttyp: np.ndarray, k: int, mode: int,
                          contained: "np.ndarray | None" = None):
    """Streaming-mode relation passes: mode=1 containment-only; mode=2
    edge-only over uncontained reads (`contained` = (n,) 0-based byte
    mask).  Returns the same column dict as overlap_relation."""
    return _export(*_collect(packed, packed_rc, lengths, keys, tread,
                             torient, ttyp, k, mode, contained))


def overlap_relation_mode2_grouped(packed: np.ndarray,
                                   packed_rc: np.ndarray,
                                   lengths: np.ndarray, keys: np.ndarray,
                                   tread: np.ndarray, torient: np.ndarray,
                                   ttyp: np.ndarray, k: int,
                                   contained: np.ndarray):
    """Edge-only (mode=2) relation pass with the slim grouped export:
    returns (starts int64 (n+1), j int16, r2 int32 1-based, orient int8) —
    exactly the traversal replay's inputs."""
    lib, handle, total = _collect(packed, packed_rc, lengths, keys, tread,
                                  torient, ttyp, k, 2, contained)
    n = len(lengths)
    starts = np.empty(n + 1, np.int64)
    out_j = np.empty(total, np.int16)
    out_r2 = np.empty(total, np.int32)
    out_eo = np.empty(total, np.int8)
    lib.overlap_relation_export_grouped(
        handle, n, _ptr(starts, _p64), _ptr(out_j, _p16),
        _ptr(out_r2, _p32), _ptr(out_eo, _pi8))
    return starts, out_j, out_r2, out_eo


# ---------------------------------------------------------------------------
# parsimplify, min-cost flow, read -> edge back index
# (see src/{parsimplify,mcmf,backindex}.cpp)
# ---------------------------------------------------------------------------
def parsimplify_run(edge_file: str, out_file: str, min_ovl: int) -> None:
    """Native parsimplify: edge_file -> out_file (bit-identical to the
    Python oracle simplify.pargraph.parsimplify)."""
    rc = _lib("parsimplify").parsimplify_run(
        edge_file.encode(), out_file.encode(), min_ovl)
    if rc != 0:
        raise OSError(f"parsimplify_run failed on {edge_file}")


def mcmf_solve(v_nodes: int, tail, head, lb, ub, cost) -> np.ndarray:
    """Solve min-cost flow with per-arc lower bounds (ub<0 = infinite).
    Returns the per-arc flow vector; raises on infeasibility."""
    arrs = [np.ascontiguousarray(a, np.int64)
            for a in (tail, head, lb, ub, cost)]
    n_arcs = len(arrs[0])
    out = np.empty(n_arcs, np.int64)
    rc = _lib("mcmf").mcmf_solve(v_nodes, n_arcs,
                                 *(_ptr(a, _p64) for a in arrs),
                                 _ptr(out, _p64))
    if rc != 0:
        raise RuntimeError("infeasible flow problem")
    return out


class NativeBackIndex:
    """ctypes wrapper over the backindex.cpp arena; see EdgeLocArena in
    simplify/dataset.py for the public semantics."""
    __slots__ = ("lib", "h", "head", "_qa", "_qi", "_qa_p", "_qi_p",
                 "_query")

    def __init__(self, n_reads: int):
        self.lib = _lib("backindex")
        self.h = self.lib.backindex_new(n_reads)
        # zero-copy has-entries view (the C head vector is fixed-size)
        self.head = np.ctypeslib.as_array(
            self.lib.backindex_head_ptr(self.h), shape=(n_reads + 1,))
        # reused query buffers (grown on demand) with their ctypes pointers
        # made once: data_as on every call dominated the per-read query
        self._qa = np.empty(64, np.int64)
        self._qi = np.empty(64, np.int64)
        self._qa_p = _ptr(self._qa, _p64)
        self._qi_p = _ptr(self._qi, _p64)
        self._query = self.lib.backindex_query_cap

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.backindex_free(self.h)
            self.h = None

    def add_bulk(self, rids: np.ndarray, ori_bits: np.ndarray, addr: int,
                 idx0: int = 0):
        rids = np.ascontiguousarray(rids, np.int32)
        ori_bits = np.ascontiguousarray(ori_bits, np.int8)
        self.lib.backindex_add_bulk(self.h, _ptr(rids, _p32),
                                    _ptr(ori_bits, _pi8), len(rids), addr,
                                    idx0)

    def remove_bulk(self, rids: np.ndarray, ori_bits: np.ndarray, addr: int,
                    idx0: int = 0):
        rids = np.ascontiguousarray(rids, np.int32)
        ori_bits = np.ascontiguousarray(ori_bits, np.int8)
        self.lib.backindex_remove_bulk(self.h, _ptr(rids, _p32),
                                       _ptr(ori_bits, _pi8), len(rids), addr,
                                       idx0)

    def query(self, rid: int, orient_bit: int):
        """Single-call query into reused buffers; returns (addr_list,
        idx_list) as Python lists, or (None, None) for no entries."""
        w = self._query(self.h, rid, orient_bit, self._qa_p, self._qi_p,
                        len(self._qa))
        if w < 0:
            n = -w
            self._qa = np.empty(2 * n, np.int64)
            self._qi = np.empty(2 * n, np.int64)
            self._qa_p = _ptr(self._qa, _p64)
            self._qi_p = _ptr(self._qi, _p64)
            w = self._query(self.h, rid, orient_bit, self._qa_p,
                            self._qi_p, len(self._qa))
        if w == 0:
            return None, None
        return self._qa[:w].tolist(), self._qi[:w].tolist()

    def has(self, rid: int) -> bool:
        return bool(self.lib.backindex_has(self.h, rid))
