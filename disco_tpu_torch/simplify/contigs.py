"""Contig/scaffold emission by streaming read files
(reference: src/SimplifyGraph/src/OverlapGraph.cpp):
- streamContigs        :2295-2369
- loadStringFromReadsFile :2148-2243 (plain files: raw record strings,
  no uppercasing / N-replacement — those happen only in the gz path)
- populate_read        :2252-2287
- Edge::loadReadString :Edge.cpp:536-581
- printEdge (3-arg)    :1785-1824
- printEdgeCoverage    :1833-1848

Contig strings are built into 'N'-initialised bytearrays; scaffold gaps
remain 'N' (reference: Edge.cpp:548-549).
"""
from typing import Dict, List, Optional, Tuple

import numpy as np

from .core import Edge
from .dataset import iter_fasta_seqs
from .engine import FullGraph
from .params import REF_THRESH


def _rc(s: str) -> str:
    return s.translate(_RC_TABLE)[::-1]


_RC_TABLE = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")
_RC_BYTES = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


def _load_read_string(graph: FullGraph, e: Edge, s: str, index: int) -> None:
    """reference: Edge::loadReadString (Edge.cpp:536-581)."""
    if not e.is_smaller() or e.edge_length() < graph.p.min_contig_length:
        return
    if e.string is None:
        e.string = bytearray(b"N" * e.edge_length())
    b = s.encode()
    if index == -1:
        ln = e.first_offset()
        e.string[0:ln] = b[0:ln]
    elif index == -2:
        e.string[e.offset:e.offset + len(b)] = b
    else:
        if index < e.inner.n - 1:
            ln = e.inner[index + 1][2]
            start = e.inner.offset_sum(0, index + 1)
        else:
            ln = e.last_offset()
            start = e.inner.offset_sum(0, e.inner.n)
        if ln < len(b):
            e.string[start:start + ln] = b[:ln]
        else:
            e.string[start:start + len(b)] = b


def _populate_read(graph: FullGraph, rid: int, s: str) -> None:
    """reference: populate_read (OverlapGraph.cpp:2252-2287)."""
    s_rev = _rc(s)
    lst = graph.g.get(rid)
    if lst:
        for e in lst:
            if e.is_smaller():
                if (e.orient >> 1) & 1:
                    _load_read_string(graph, e, s, -1)
                else:
                    _load_read_string(graph, e, s_rev, -1)
            else:
                t = e.twin
                if t.orient & 1:
                    _load_read_string(graph, t, s, -2)
                else:
                    _load_read_string(graph, t, s_rev, -2)
    for (e, idx) in graph.d.fwd_edges(rid):
        _load_read_string(graph, e, s, idx)
    for (e, idx) in graph.d.bwd_edges(rid):
        _load_read_string(graph, e, s_rev, idx)


def load_sequences(graph: FullGraph, single_files: List[str],
                   pair_files: List[str],
                   inter_pair_files: List[str]) -> None:
    """Stream all read files in the reference's order: separated pairs,
    interleaved pairs, singles (streamContigs :2300-2310).

    Unlike the reference's read-major walk (populate_read per read with
    edge-location lookups and per-placement offset prefix sums,
    OverlapGraph.cpp:2252-2287), the fill is planned EDGE-major first —
    one pass over the edges' inner lists yields every (read, region)
    placement with an O(1) running prefix — and the single read-file
    stream then applies the plan.  Placement regions within an edge
    string are disjoint (each spans exactly the gap to the next link, and
    scaffold gaps stay 'N'), so fill order cannot matter and the result
    is byte-identical to the read-major walk; `_populate_read` above is
    kept as the direct transcription for reference."""
    min_len = graph.p.min_contig_length
    # the placement plan is kept in compact typed arrays, not a dict of
    # per-read tuple lists: at metagenome scale the plan covers most reads
    # and the Python-object form was the largest allocation of the contig
    # streamer (~400 MB for ~13 MB of payload at 10 Mb)
    from array import array
    p_rid = array("q")
    p_eidx = array("i")
    p_flags = array("b")   # bit0: rc; bits 1-2: mode
    p_start = array("i")
    p_cap = array("i")
    edges_tab: list = []
    np_parts: list = []  # vectorized inner-placement rows, per edge

    def add(rid, eidx, rc, mode, start, cap):
        p_rid.append(rid)
        p_eidx.append(eidx)
        p_flags.append((1 if rc else 0) | (mode << 1))
        p_start.append(start)
        p_cap.append(cap)

    for node_lst in graph.g.d.values():
        for e in node_lst:
            if not e.is_smaller() or e.edge_length() < min_len:
                continue
            eidx = len(edges_tab)
            edges_tab.append(e)
            # mode 0: source-read prefix (index -1); mode 1: dest read at
            # e.offset (index -2); mode 2: inner read at its link offset
            add(e.src, eidx, not ((e.orient >> 1) & 1), 0, 0,
                e.first_offset())
            add(e.dst, eidx, not (e.orient & 1), 1, e.offset, 0)
            n = e.inner.n
            if n:
                # vectorized inner-placement rows straight from the
                # columnar rope (a transient tuple list here held
                # ~120 B/inner read at metagenome scale)
                cols = e.inner.columns()
                pref = np.cumsum(cols.off, dtype=np.int64)
                cap = np.empty(n, np.int32)
                cap[:n - 1] = cols.off[1:]
                cap[n - 1] = e.offset - e.inner_sum
                flags = (((cols.ori & 1) != 1).astype(np.int8)
                         | np.int8(2 << 1))
                np_parts.append((cols.rid.astype(np.int64),
                                 np.full(n, eidx, np.int32), flags,
                                 pref.astype(np.int32), cap))

    parts_rid = [np.frombuffer(p_rid, np.int64)]
    parts_eidx = [np.frombuffer(p_eidx, np.int32)]
    parts_flags = [np.frombuffer(p_flags, np.int8)]
    parts_start = [np.frombuffer(p_start, np.int32)]
    parts_cap = [np.frombuffer(p_cap, np.int32)]
    for t in np_parts:
        parts_rid.append(t[0])
        parts_eidx.append(t[1])
        parts_flags.append(t[2])
        parts_start.append(t[3])
        parts_cap.append(t[4])
    rid_a = np.concatenate(parts_rid)
    order = np.argsort(rid_a, kind="stable")
    rid_s = rid_a[order]
    eidx_s = np.concatenate(parts_eidx)[order]
    flags_s = np.concatenate(parts_flags)[order]
    start_s = np.concatenate(parts_start)[order]
    cap_s = np.concatenate(parts_cap)[order]
    del (p_rid, p_eidx, p_flags, p_start, p_cap, rid_a, order, np_parts,
         parts_rid, parts_eidx, parts_flags, parts_start, parts_cap)

    def plan_range(rid):
        lo = int(np.searchsorted(rid_s, rid, side="left"))
        hi = int(np.searchsorted(rid_s, rid, side="right"))
        return lo, hi

    def feed(rid, b, lo, hi):
        brc = None
        for i in range(lo, hi):
            e = edges_tab[eidx_s[i]]
            f = int(flags_s[i])
            rc = f & 1
            mode = f >> 1
            start = int(start_s[i])
            cap = int(cap_s[i])
            if e.string is None:
                e.string = bytearray(b"N" * e.edge_length())
            if rc:
                if brc is None:
                    brc = b.translate(_RC_BYTES)[::-1]
                src = brc
            else:
                src = b
            if mode == 0:
                e.string[0:cap] = src[0:cap]
            elif mode == 1:
                e.string[start:start + len(src)] = src
            elif cap < len(src):
                e.string[start:start + cap] = src[:cap]
            else:
                e.string[start:start + len(src)] = src

    # reads stream as bytes straight from the native record scanner (same
    # uppercasing as the reference's contig streamer, OverlapGraph.cpp:2165)
    from .. import native
    from ..io import fasta as iofasta

    rid = 1
    for group in (pair_files, inter_pair_files, single_files):
        for path in group:
            # windowed native streaming: at metagenome scale the
            # whole-file sequence blob (~the reads file size) dominated
            # the emission phase's RSS; windows keep one ~64 MB slice
            # resident (the reference streams record by record,
            # OverlapGraph.cpp:2148-2243)
            win = (native.iter_record_windows(path)
                   if not path.endswith(".gz") else None)
            if win is not None:
                for blob, offs, _lo in win:
                    mv = memoryview(blob)
                    bounds = offs.tolist()
                    for i in range(len(bounds) - 1):
                        lo, hi = plan_range(rid)
                        if lo < hi:
                            feed(rid, bytes(mv[bounds[i]:bounds[i + 1]]),
                                 lo, hi)
                        rid += 1
                continue
            blob, offs = iofasta.scan_records(path)
            mv = memoryview(blob)
            bounds = offs.tolist()
            for i in range(len(bounds) - 1):
                lo, hi = plan_range(rid)
                if lo < hi:
                    feed(rid, bytes(mv[bounds[i]:bounds[i + 1]]), lo, hi)
                rid += 1


def _fmt_float(v: float) -> str:
    """C++ ostream default float formatting (6 significant digits)."""
    return f"{v:.6g}"


def _print_edge_with_reads(graph: FullGraph, e: Edge, edge_f, used_f,
                           name_id: int) -> None:
    """reference: printEdge 3-arg (:1785-1824)."""
    d = graph.d
    offset_sum = e.inner_sum if e.inner.n else 0
    last_off = (e.inner[e.inner.n - 1][2] if e.inner.n else e.offset)
    edge_f.write(f"contig_{name_id:010d}\t{e.src}\t{e.dst}\t")
    used_f.write(f"{e.src}\n")
    d.used[e.src] = True
    used_f.write(f"{e.dst}\n")
    d.used[e.dst] = True
    edge_f.write(f"{e.orient},{e.offset - offset_sum},"
                 f"{offset_sum + (e.dst_len - last_off)},0,0\t")
    for (rid, ori, off) in e.inner:
        edge_f.write(f"({rid},{ori},{off})")
        used_f.write(f"{rid}\n")
        d.used[rid] = True
    edge_f.write("\n")


def _print_edge_coverage(graph: FullGraph, e: Edge, cov_f,
                         name_id: int) -> None:
    vals = graph.coverage_values(e)
    cov_f.write(f"contig_{name_id:010d},")
    # chunked text emission: a genome-scale scaffold's tolist() would
    # box tens of millions of ints (~28 B each) at once
    for s in range(0, len(vals), 1 << 20):
        chunk = vals[s:s + (1 << 20)]
        cov_f.write(",".join(map(str, chunk.tolist())))
        cov_f.write(",")
    if len(vals) == 0:
        cov_f.write(",")
    cov_f.write("\n")


def stream_contigs(graph: FullGraph, single_files: List[str],
                   pair_files: List[str], inter_pair_files: List[str],
                   contig_file: str, edge_file: str, cov_file: str,
                   used_file: str, name_prefix: str,
                   printed: int) -> int:
    """reference: streamContigs (:2295-2369).  Returns the updated printed
    counter."""
    load_sequences(graph, single_files, pair_files, inter_pair_files)
    edges = graph.get_edges()
    p = graph.p
    with open(contig_file, "w") as ctg, open(edge_file, "w") as ef, \
            open(cov_file, "w") as cf, open(used_file, "w") as uf:
        for e in edges:
            if (e.edge_length() >= p.min_contig_length
                    and e.inner.n >= p.min_reads_to_print):
                s = (bytes(e.string).decode()
                     if e.string is not None else "")
                printed += 1
                _print_edge_with_reads(graph, e, ef, uf, printed)
                _print_edge_coverage(graph, e, cf, printed)
                cov = graph._cov_depth(e)
                ctg.write(f">{name_prefix}_{printed:010d}"
                          f" Coverage: {_fmt_float(cov)}"
                          f" Length: {len(s)}\n")
                start = 0
                while True:
                    ctg.write(s[start:start + 100] + "\n")
                    start += 100
                    if start >= len(s):
                        break
    return printed


def _sort_by_len(strs: List[str]) -> List[str]:
    """std::sort with Utils::compare (length ascending, unstable ties —
    reference: Utils.h:182-186)."""
    from ..native import stdsort_permutation
    if not strs:
        return strs
    keys = np.fromiter((len(s) for s in strs), np.int64, len(strs))
    perm = stdsort_permutation(keys)
    return [strs[i] for i in perm]


def stream_contigs_thresh(graph: FullGraph, single_files: List[str],
                          pair_files: List[str],
                          inter_pair_files: List[str], contig_file: str,
                          edge_file: str, cov_file: str, used_file: str,
                          name_prefix: str, printed: int,
                          sim_path: Optional[str] = None) -> int:
    """Benchmark-specific N50 post-processing path
    (reference: streamContigsThresh, OverlapGraph.cpp:2377-2635): split
    contigs listed in <simPath>/test/<thresh>.txt, join groups from
    <thresh>_join.txt, then greedily concatenate smallest contigs until the
    N50 target is met.  Only reached for the hard-coded dataset sizes in
    REF_THRESH (Utils.cpp:671-679); 'J' placeholders become 'N' on output."""
    size = graph.d.size()
    thresh = REF_THRESH.get(size, REF_THRESH.get(size // 1_000_000))
    load_sequences(graph, single_files, pair_files, inter_pair_files)
    edges = graph.get_edges()
    p = graph.p
    contig_strs: List[str] = []
    cov_vals: List[float] = []
    total_len = 0
    with open(edge_file, "w") as ef, open(cov_file, "w") as cf, \
            open(used_file, "w") as uf:
        for e in edges:
            if (e.edge_length() >= p.min_contig_length
                    and e.inner.n >= p.min_reads_to_print):
                s = (bytes(e.string).decode()
                     if e.string is not None else "")
                printed += 1
                _print_edge_with_reads(graph, e, ef, uf, printed)
                _print_edge_coverage(graph, e, cf, printed)
                # reference: vector<UINT64> covVals (:2422) truncates the
                # float cov depth; updateBaseByBaseCoverageStat runs AFTER
                # printEdgeCoverage so the header uses the same value
                cov_vals.append(int(graph._cov_depth(e)))
                contig_strs.append(s)
                total_len += len(s)

    # split mis-assembled contigs per fingerprint table
    mis: List[str] = []
    if sim_path:
        try:
            f = open(f"{sim_path}/test/{thresh}.txt")
        except OSError:
            f = None
        if f:
            with f:
                for line in f:
                    tok = line.strip().split(",")
                    for i, s in enumerate(contig_strs):
                        if tok[0] in s:
                            if tok[1] != "0":
                                last = int(tok[-1])
                                if last <= len(s):
                                    start = 0
                                    for t in tok[1:]:
                                        seg = int(t) - start
                                        mis.append(s[start:start + seg])
                                        start = int(t)
                                    mis.append(s[start:])
                            del contig_strs[i]
                            break
            contig_strs.extend(mis)

    contig_strs = _sort_by_len(contig_strs)
    cumulative = 0
    idx = len(contig_strs) - 1
    final: List[str] = []
    while idx >= 0:
        if len(contig_strs[idx]) < thresh:
            break
        cumulative += len(contig_strs[idx])
        final.append(contig_strs[idx])
        idx -= 1
    n50_len = len(final[-1]) if final else thresh

    if cumulative >= total_len * 0.5:
        del contig_strs[idx + 1:]
        final.extend(contig_strs)
    else:
        del contig_strs[idx + 1:]
        join_lines: List[str] = []
        if sim_path:
            try:
                with open(f"{sim_path}/test/{thresh}_join.txt") as jf:
                    join_lines = [ln.rstrip("\n") for ln in jf]
            except OSError:
                pass
        sub_strs: List[str] = []
        li = 0
        while cumulative < total_len * 0.5 and contig_strs:
            if li >= len(join_lines):
                break
            tok = join_lines[li].split(",")
            li += 1
            idxs: List[int] = []
            oris: List[bool] = []
            for t in tok:
                ori = True
                fstr = t
                if t and t[0] == "(":
                    ori = False
                    fstr = t[1:-1]
                for j, s in enumerate(contig_strs):
                    if fstr in s:
                        idxs.append(j)
                        oris.append(ori)
                        break
            tot_sub = 0
            sub = ""
            if len(idxs) == len(tok):
                for j, ori in zip(idxs, oris):
                    sub += contig_strs[j] if ori else _rc(contig_strs[j])
                    tot_sub += len(contig_strs[j])
                for j in sorted(idxs, reverse=True):
                    del contig_strs[j]
            if tot_sub > 0:
                sub_strs.append(sub)
                if tot_sub > thresh:
                    cumulative += tot_sub
        contig_strs.extend(sub_strs)
        sub_strs = []
        contig_strs = _sort_by_len(contig_strs)
        while cumulative < total_len * 0.5 and contig_strs:
            tot_sub = 0
            sub = ""
            join_ctr = 0
            while tot_sub <= n50_len and contig_strs:
                s = contig_strs.pop()
                tot_sub += len(s)
                sub += s
                join_ctr += 1
            sub_strs.append(sub)
            if join_ctr > 1:
                cumulative += tot_sub
        final.extend(sub_strs)
        final.extend(contig_strs)

    final.sort(key=len, reverse=True)
    with open(contig_file, "w") as ctg:
        for ci, s in enumerate(final):
            cov = cov_vals[ci] if ci < len(cov_vals) else 0
            ctg.write(f">{name_prefix}_{ci + 1:010d}"
                      f" Coverage: {cov}"
                      f" Length: {len(s)}\n")
            s = s.replace("J", "N")
            start = 0
            while True:
                ctg.write(s[start:start + 100] + "\n")
                start += 100
                if start >= len(s):
                    break
    return printed
