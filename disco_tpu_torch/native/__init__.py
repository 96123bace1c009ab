"""ctypes bindings for the C++ host code on the buildG path.

The sources are native/src/{readqc,overlap,replay}.cpp, byte-identical
copies of the JAX package's, compiled into the port's own build directory
(see disco_tpu_torch/kernels.py).  Only what the buildG slice calls is bound:
read QC and packing, the record scanner, the native overlap relation (all
three protocols), and the traversal replay.  Semantics are those of disco_tpu/native/__init__.py."""
import ctypes
import os
import threading

import numpy as np

from ..kernels import load_native

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
}


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            (opt, extra), fns = _SPECS[name]
            lib = load_native(name, opt=opt, extra=extra)
            for fn, (argtypes, restype) in fns.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
    return lib


def build_all() -> None:
    """Compile and load every host library of the slice."""
    for name in _SPECS:
        _lib(name)


def _ptr(a, ptype):
    return a.ctypes.data_as(ptype)


def _as_char_p(x):
    if isinstance(x, bytes):
        return x
    return x.ctypes.data_as(ctypes.c_char_p)


# ---------------------------------------------------------------------------
# buildG traversal replay (see src/replay.cpp)
# ---------------------------------------------------------------------------
def graph_replay(n: int, k: int, wpgs: int, starts, ej, er2, eo, lens, fidx,
                 all_marked, start_read: int = 1):
    """Run the sequential buildG traversal replay from `start_read`.
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
