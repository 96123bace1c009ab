"""fullsimplify's view of the read set.

Read IDs here are RAW FILE POSITIONS: the reference's DataSet assigns one ID
per input record with no QC (reference: DataSet.cpp:15-119), matching the
fileIndex convention of the buildG edge files (OUTPUT.md:8).

Replicated quirks (load-bearing for parity):
- storeContainedReadInformation attaches each finished group of contained
  reads to the NEXT group's containing read, and drops the final group
  (reference: DataSet.cpp:316-335 — the `else` branch passes the new line's
  containingReadID with the previous group's lists).
- getReadCoverage counts a contained read at base `indx` when
  overlapStart > indx (sic) and indx < overlapStart+len
  (reference: DataSet.cpp:365-381).
- getMatePair returns 0 when the mate is a contained read.
"""
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .core import Edge, _Cols as _RopeCols


@dataclass
class DataSetInfo:
    number: int
    is_paired: bool
    is_interleaved: bool
    r1_start: int
    r1_end: int
    r2_start: int = 0
    r2_end: int = 0
    avg_inner_distance: float = 0.0
    avg_inner_distance_sd: float = 0.0
    r1_file: str = ""
    r2_file: str = ""


def count_fasta_records(path: str) -> List[int]:
    """Record lengths in file order (FASTA or FASTQ; reference parses with
    getline '>'-delimited concatenation, DataSet.cpp:88-102).  Uses the
    native record scanner (same length semantics: stripped sequence bytes);
    the Python reader below is the fallback/oracle."""
    try:
        from .. import native
        from ..io import fasta as iofasta
        if not path.endswith(".gz"):
            # lengths-only streaming scan: no sequence bytes materialized
            offs = native.seq_scan_lengths(path)
            if offs is not None:
                return np.diff(offs).tolist()
        _blob, offs = native.seq_scan(iofasta.read_bytes(path))
        return np.diff(offs).tolist()
    except Exception:
        pass
    lengths: List[int] = []
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":
            cur = None
            for line in f:
                if line.startswith(">"):
                    if cur is not None:
                        lengths.append(cur)
                    cur = 0
                else:
                    cur += len(line.strip())
            if cur is not None:
                lengths.append(cur)
        elif first == "@":
            while True:
                h = f.readline()
                if not h:
                    break
                s = f.readline().strip()
                f.readline()
                f.readline()
                lengths.append(len(s))
        else:
            raise ValueError(f"Unknown read file format: {path}")
    return lengths


def iter_fasta_seqs(path: str):
    """Yield raw record sequences in file order (uppercased like the
    reference's contig streamer, OverlapGraph.cpp:2165)."""
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":
            cur: Optional[List[str]] = None
            for line in f:
                if line.startswith(">"):
                    if cur is not None:
                        yield "".join(cur).upper()
                    cur = []
                else:
                    cur.append(line.strip())
            if cur is not None:
                yield "".join(cur).upper()
        else:
            while True:
                h = f.readline()
                if not h:
                    break
                s = f.readline().strip()
                f.readline()
                f.readline()
                yield s.upper()


def iter_fasta_records(path: str):
    """Yield (raw_header_line, sequence) in file order.  The header keeps its
    '>'/'@' marker: the reference's unused-read writer prepends ANOTHER '>'
    to the raw line (reference: DataSet.cpp:464,541 — output headers are
    '>>name' for FASTA input), which we reproduce by giving callers the raw
    line."""
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":
            header = None
            cur: List[str] = []
            for line in f:
                if line.startswith(">"):
                    if header is not None:
                        yield header, "".join(cur)
                    header = line.rstrip("\n")
                    cur = []
                else:
                    cur.append(line.strip())
            if header is not None:
                yield header, "".join(cur)
        else:
            while True:
                h = f.readline()
                if not h:
                    break
                s = f.readline().strip()
                f.readline()
                f.readline()
                yield h.rstrip("\n"), s


class EdgeLocArena:
    """Read -> edge back-index over the native slot arena
    (native/backindex.cpp; reference: Read::edgeP[]/edgeOriIndex[],
    src/SimplifyGraph/src/Read.h:31-33).

    Registrations are BULK per edge (one ctypes call per
    updateReadsLocations) into per-read chains that preserve APPEND
    order (the reference's vector push_back order is parity-relevant);
    entries carry the edge's allocation serial, resolved back to the
    Edge object through `by_addr`.  ~20 B/entry native vs ~150 B for
    boxed-int flat lists — the top live allocation of the simplify phase
    at metagenome scale (docs/MEMORY_PLAN.md)."""
    __slots__ = ("nat", "by_addr")

    def __init__(self, n_reads: int):
        from .. import native
        self.nat = native.NativeBackIndex(n_reads)
        self.by_addr = {}

    def __getitem__(self, rid: int) -> bool:
        """Truthiness shim for `locs[rid]` has-any-entries checks
        (zero-copy view of the native head array)."""
        return self.nat.head[rid] >= 0

    def add(self, rid: int, edge, key: int) -> None:
        self.by_addr[edge.addr] = edge
        self.nat.add_bulk(np.asarray([rid], np.int32),
                          np.asarray([key & 1], np.int8), edge.addr,
                          idx0=key >> 1)

    def remove(self, rid: int, edge, key: int) -> None:
        self.nat.remove_bulk(np.asarray([rid], np.int32),
                             np.asarray([key & 1], np.int8), edge.addr,
                             idx0=key >> 1)

    def add_edge_bulk(self, edge, rids, ori_bits) -> None:
        self.by_addr[edge.addr] = edge
        self.nat.add_bulk(rids, ori_bits, edge.addr)

    def remove_edge_bulk(self, edge, rids, ori_bits) -> None:
        self.nat.remove_bulk(rids, ori_bits, edge.addr)
        self.by_addr.pop(edge.addr, None)

    def _rope_parts(self, rope):
        """Yield (rids int32, ori_bits int8) per leaf, left to right —
        registration never forces a top-level columns() cache (merged
        scaffold ropes would otherwise pin an O(n * merge-depth) chain of
        columnar caches through their subtree references)."""
        for p in rope._leaves():
            if isinstance(p, _RopeCols):
                yield (p.rid, (1 - (p.ori & 1)).astype(np.int8))
            else:
                n = len(p)
                rids = np.empty(n, np.int32)
                bits = np.empty(n, np.int8)
                for i, (rid, ori, _off) in enumerate(p):
                    rids[i] = rid
                    bits[i] = 0 if (ori & 1) == 1 else 1
                yield (rids, bits)

    def register_rope(self, edge, rope) -> None:
        self.by_addr[edge.addr] = edge
        idx0 = 0
        for rids, bits in self._rope_parts(rope):
            self.nat.add_bulk(rids, bits, edge.addr, idx0=idx0)
            idx0 += len(rids)

    def unregister_rope(self, edge, rope) -> None:
        idx0 = 0
        for rids, bits in self._rope_parts(rope):
            self.nat.remove_bulk(rids, bits, edge.addr, idx0=idx0)
            idx0 += len(rids)
        self.by_addr.pop(edge.addr, None)

    def entries(self, rid: int, orient_bit: int) -> List[Tuple]:
        if self.nat.head[rid] < 0:
            return []
        addr, idx = self.nat.query(rid, orient_bit)
        if addr is None:
            return []
        by = self.by_addr
        out = []
        for a, i in zip(addr, idx):
            e = by.get(a)
            if e is not None:
                out.append((e, i))
        return out


class SimplifyDataset:
    """Read table + mate-pair arithmetic + read->edge back-index."""

    def __init__(self, single_files: List[str], pair_files: List[str],
                 inter_pair_files: List[str]):
        self.lengths: List[int] = [0]  # 1-based
        self.datasets: List[DataSetInfo] = []
        self.single_files = list(single_files)
        self.pair_files = list(pair_files)
        self.inter_pair_files = list(inter_pair_files)
        n = 0
        # separated pairs come first (reference: DataSet.cpp:129-147)
        it = iter(pair_files)
        for f1 in it:
            f2 = next(it)
            info = DataSetInfo(len(self.datasets), True, False, n + 1, 0)
            self.lengths.extend(count_fasta_records(f1))
            info.r1_end = len(self.lengths) - 1
            info.r2_start = len(self.lengths)
            self.lengths.extend(count_fasta_records(f2))
            info.r2_end = len(self.lengths) - 1
            info.r1_file, info.r2_file = f1, f2
            n = len(self.lengths) - 1
            self.datasets.append(info)
        for f1 in inter_pair_files:
            info = DataSetInfo(len(self.datasets), True, True, n + 1, 0)
            self.lengths.extend(count_fasta_records(f1))
            info.r1_end = len(self.lengths) - 1
            info.r1_file = f1
            n = len(self.lengths) - 1
            self.datasets.append(info)
        for f1 in single_files:
            info = DataSetInfo(len(self.datasets), False, False, n + 1, 0)
            self.lengths.extend(count_fasta_records(f1))
            info.r1_end = len(self.lengths) - 1
            info.r1_file = f1
            n = len(self.lengths) - 1
            self.datasets.append(info)

        nn = self.size()
        # columnar per-read state (numpy, not Python lists: at metagenome
        # scale the list-of-int/bool forms alone were hundreds of MB)
        self.lengths = np.asarray(self.lengths, np.int64)
        self.contained_flag = np.zeros(nn + 1, bool)
        # per-read list of (containedReadID, ovlStart, orient)
        self.con_reads: List[Optional[List[Tuple[int, int, int]]]] = \
            [None] * (nn + 1)
        self.used = np.zeros(nn + 1, bool)
        # read -> edge registrations (reference: Read::setEdge/delEdge)
        self.edge_locs = EdgeLocArena(nn)

    def size(self) -> int:
        return len(self.lengths) - 1

    def read_len(self, rid: int) -> int:
        return int(self.lengths[rid])

    def read_len_array(self) -> np.ndarray:
        return self.lengths

    # -- contained reads ----------------------------------------------------
    def store_contained_read_info(self, files: List[str]) -> int:
        ctr = 0
        for path in files:
            this_containing = 0
            ids: List[int] = []
            oris: List[int] = []
            starts: List[int] = []
            with open(path) as f:
                for line in f:
                    toks = line.rstrip("\n").split("\t")
                    if len(toks) < 3:
                        continue
                    contained = int(toks[0])
                    containing = int(toks[1])
                    info = toks[2].split(",")
                    ori = int(info[0])
                    ovl_start = int(info[8])
                    if not self.contained_flag[contained]:
                        self.contained_flag[contained] = True
                        ctr += 1
                    if this_containing == containing:
                        ids.append(contained)
                        oris.append(ori)
                        starts.append(ovl_start)
                    else:
                        # reference bug replicated: previous group's lists
                        # attached to the NEW containing read; final group
                        # dropped (DataSet.cpp:316-335)
                        if ids:
                            self._set_con_reads(containing, ids, starts, oris)
                        this_containing = containing
                        ids = [contained]
                        oris = [ori]
                        starts = [ovl_start]
        return ctr

    def _set_con_reads(self, rid: int, ids, starts, oris) -> None:
        lst = self.con_reads[rid]
        if lst is None:
            lst = []
            self.con_reads[rid] = lst
        lst.extend(zip(ids, starts, oris))

    def contained_count(self, rid: int) -> int:
        lst = self.con_reads[rid]
        return len(lst) if lst else 0

    def recursive_contained_count(self, rid: int) -> int:
        lst = self.con_reads[rid]
        if not lst:
            return 0
        total = len(lst)
        for (cid, _s, _o) in lst:
            total += self.recursive_contained_count(cid)
        return total

    def read_coverage(self, rid: int, indx: int) -> int:
        """reference: DataSet::getReadCoverage (DataSet.cpp:365-381)."""
        cov = 1
        lst = self.con_reads[rid]
        if not self.contained_flag[rid] and lst:
            for (cid, start, _o) in lst:
                if start > indx and indx < start + self.lengths[cid]:
                    cov += 1
        return cov

    # -- mates --------------------------------------------------------------
    def mate_pair(self, r1: int) -> int:
        """reference: DataSet::getMatePair (DataSet.cpp:385-423).

        Scoping quirk replicated: the interleaved branch and the r2-side
        branch assign the OUTER r2ID before the contained check and then
        `break`, so a CONTAINED mate is still returned by the function's
        final `return r2ID`; only the separated r1-side branch declares a
        shadowing local (DataSet.cpp:407) and therefore yields 0 for a
        contained mate."""
        r2_out = 0
        for d in self.datasets:
            if not d.is_paired:
                continue
            if d.r1_start <= r1 <= d.r1_end:
                if d.is_interleaved:
                    if (r1 - d.r1_start) % 2:
                        r2_out = r1 - 1
                    else:
                        r2_out = r1 + 1
                    if r2_out != 0 and not self.contained_flag[r2_out]:
                        return r2_out
                    break  # contained mate still returned below
                else:
                    r2_local = (r1 - d.r1_start) + d.r2_start
                    if not self.contained_flag[r2_local]:
                        return r2_local
                    break  # shadowed local: outer stays 0
            elif d.r2_start != 0 and d.r2_start <= r1 <= d.r2_end:
                r2_out = (r1 - d.r2_start) + d.r1_start
                if not self.contained_flag[r2_out]:
                    return r2_out
                break  # contained mate still returned below
        return r2_out

    def mate_array(self) -> "np.ndarray":
        """Vectorized `mate_pair` over all read IDs (cached; valid because
        contained_flag is static after load).  Branch semantics match
        mate_pair exactly: interleaved and r2-side mates are returned even
        when contained (the reference's shadowed-local quirk), the
        separated r1-side yields 0 for a contained mate."""
        if getattr(self, "_mate_array", None) is not None:
            return self._mate_array
        n = self.size()
        mate = np.zeros(n + 1, np.int64)
        cf = np.zeros(n + 1, bool)
        cf[1:] = [bool(x) for x in self.contained_flag[1:n + 1]]
        for ds in self.datasets:
            if not ds.is_paired:
                continue
            if ds.is_interleaved:
                r = np.arange(ds.r1_start, ds.r1_end + 1)
                odd = (r - ds.r1_start) % 2 == 1
                mate[r] = np.where(odd, r - 1, r + 1)
            else:
                r = np.arange(ds.r1_start, ds.r1_end + 1)
                cand = r - ds.r1_start + ds.r2_start
                mate[r] = np.where(cf[cand], 0, cand)
                r2 = np.arange(ds.r2_start, ds.r2_end + 1)
                mate[r2] = r2 - ds.r2_start + ds.r1_start
        self._mate_array = mate
        return mate

    def mate_pair_list(self, rid: int) -> List[int]:
        """reference: DataSet::getMatePairList (DataSet.cpp:425-440)."""
        out = []
        m = self.mate_pair(rid)
        if m:
            out.append(m)
        lst = self.con_reads[rid]
        if lst:
            for (cid, _s, _o) in lst:
                cm = self.mate_pair(cid)
                if cm:
                    out.append(cm)
        return out

    def dataset_number(self, rid: int) -> int:
        for d in self.datasets:
            if (d.r1_start <= rid <= d.r1_end
                    or (d.r2_start and d.r2_start <= rid <= d.r2_end)):
                return d.number
        raise ValueError(f"read {rid} not in any dataset")

    # -- read -> edge back-index (reference: Read::setEdge/delEdge) ---------
    # Arena-backed (EdgeLocArena): per-entry state lives in numpy slot
    # arrays + one Python pointer slot — ~20 B/entry instead of the ~150 B
    # of boxed ints and per-read list objects, which were the top live
    # allocation of the whole simplify phase (docs/MEMORY_PLAN.md).
    def set_edge(self, rid: int, edge: Edge, idx: int, orient_bit: int):
        self.edge_locs.add(rid, edge, idx << 1 | orient_bit)

    def del_edge(self, rid: int, edge: Edge, idx: int, orient_bit: int):
        self.edge_locs.remove(rid, edge, idx << 1 | orient_bit)

    def clear_edge_info(self) -> None:
        self.edge_locs = EdgeLocArena(self.size())

    def fwd_edges(self, rid: int) -> List[Tuple[Edge, int]]:
        return self.edge_locs.entries(rid, 0)

    def bwd_edges(self, rid: int) -> List[Tuple[Edge, int]]:
        return self.edge_locs.entries(rid, 1)

    # -- used reads ---------------------------------------------------------
    def load_used_reads(self, path: str) -> int:
        ctr = 0
        try:
            f = open(path)
        except OSError:
            return 0
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rid = int(line)
                if not self.used[rid]:
                    self.used[rid] = True
                    ctr += 1
                    ctr += self.recursive_contained_count(rid)
        return ctr
