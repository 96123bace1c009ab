"""The plain reference of what buildG writes, and the comparison that
decides `correct`.  NumPy only; it imports nothing of the program and takes
nothing the program made: it reads the reads' FASTA (the same file the
program reads) and where each read came from (`gen.Truth`).

It holds for the read sets of the configurations here: error-free reads of
one length L drawn from random genomes, where no two genome positions share
a MinOverlap-mer, so two reads overlap exactly when their intervals on one
genome do.  Positions may share a (MinOverlap - 1)-mer, the planted repeats
of `gen.plant_repeats`: these give candidates whose overlap fails on the
next base, which buildG checks and rejects and which change nothing below.
Then buildG (reference assembler: OverlapGraph.cpp) writes:

- containedReads: every read whose interval another read of smaller read
  ID has (the same bases, or their reverse complement), contained in the
  smallest-ID read of that interval: one line each,
  `contained<TAB>container<TAB>o,L,0,0,L,0,L,L,0,L` by file index, `o` 3
  when both reads are on one strand, else 2;
- parGraph: the transitively reduced overlap graph of the other reads: an
  edge between reads of neighbouring intervals of one genome whose starts
  lie at most L - MinOverlap apart, `src<TAB>dst<TAB>orient,ovl,0,0,L,
  L-ovl,L-1,L,0,ovl-1,NA,flag` with src the smaller read ID, ovl = L minus
  the starts' distance, orient the overlap's orientation seen from src.

Read IDs follow the reference's parser (`read_ids`): records in blocks of
READ_TASK_BLOCK + 1, the first 65 full blocks in reverse (one thread's
deferred OpenMP tasks), the others in place, the remainder last.  Every
edge's orientation, and every line the program wrote, is also checked on
the reads' bases (`overlap_holds`)."""
import glob
from collections import Counter

import numpy as np

READ_TASK_BLOCK = 10000
# edge orientation of a hit orientation (reference: OverlapGraph.cpp:660-666)
EDGE_ORIENT = (3, 0, 2, 1)
HIT_OF_EDGE = np.argsort(EDGE_ORIENT)   # its inverse: an edge's hit
_RC = bytes.maketrans(b"ACGT", b"TGCA")


class Reads:
    """A FASTA of one-line records of one length: each read's bases
    (`fwd`) and their reverse complement (`rc`), as bytes."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        if len(lines) % 2 or not all(h.startswith(b">")
                                     for h in lines[::2]):
            raise ValueError(f"{path}: not two-line FASTA records")
        self.fwd = lines[1::2]
        self.length = len(self.fwd[0])
        if any(len(s) != self.length for s in self.fwd):
            raise ValueError(f"{path}: reads of more than one length")
        if b"".join(self.fwd).translate(None, b"ACGT"):
            raise ValueError(f"{path}: a base other than A, C, G, T")
        self.rc = [s.translate(_RC)[::-1] for s in self.fwd]

    def __len__(self):
        return len(self.fwd)


def read_ids(n_records: int) -> np.ndarray:
    """(N,) int64: the 1-based read ID of each record, in file order."""
    bs = READ_TASK_BLOCK + 1
    n_blocks = -(-n_records // bs)
    nfull = n_records // bs
    ndefer = min(nfull, 65)
    perm = (list(range(ndefer, nfull)) + list(range(ndefer - 1, -1, -1))
            + ([nfull] if nfull < n_blocks else []))
    rec_order = np.concatenate(
        [np.arange(b * bs, min((b + 1) * bs, n_records)) for b in perm])
    ids = np.empty(n_records, np.int64)
    ids[rec_order] = np.arange(1, n_records + 1)
    return ids


def overlap_holds(reads: Reads, a, b, hit, ovl) -> np.ndarray:
    """(E,) bool: whether read a overlaps read b by `ovl` bases in hit
    orientation `hit` (0: a's suffix is b's prefix; 1: a's prefix is b's
    suffix; 2, 3: the same with b reverse-complemented)."""
    fwd, rc, length = reads.fwd, reads.rc, reads.length
    out = []
    for x, y, h, o in zip(np.asarray(a).tolist(), np.asarray(b).tolist(),
                          np.asarray(hit).tolist(), np.asarray(ovl).tolist()):
        if not 1 <= o <= length:
            out.append(False)
            continue
        sy = rc[y] if h >= 2 else fwd[y]
        if h % 2 == 0:
            out.append(fwd[x][length - o:] == sy[:o])
        else:
            out.append(fwd[x][:o] == sy[length - o:])
    return np.asarray(out, bool)


def expected_graph(reads: Reads, truth, ids, min_overlap: int,
                   rc_contained=True):
    """The graph buildG writes for these reads.  Returns (contained,
    edges): contained lines as a sorted list of strings; edges as an
    (E, 4) int64 array of (src file index, dst file index, orient, ovl),
    sorted.  rc_contained=False breaks one guarantee (a read whose reverse
    complement another read is, is contained): the control."""
    n, length = len(reads), reads.length
    g, start = truth.genome.astype(np.int64), truth.start.astype(np.int64)
    strand = truth.strand.astype(np.int64)
    if len(g) != n or (g < 0).any() or truth.error_rate:
        raise ValueError("the reference takes error-free reads of genomes")
    fidx = np.arange(1, n + 1)
    group_strand = np.zeros(n, np.int64) if rc_contained else strand
    order = np.lexsort((ids, group_strand, start, g))
    gs, ss, ts = g[order], start[order], group_strand[order]
    new = np.ones(n, bool)
    new[1:] = (gs[1:] != gs[:-1]) | (ss[1:] != ss[:-1]) | (ts[1:] != ts[:-1])
    keeper_pos = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    keeper = order[keeper_pos]                   # smallest ID of its group
    dup = ~new
    b, a = order[dup], keeper[dup]
    same = strand[b] == strand[a]
    contained = sorted(
        f"{fidx[x]}\t{fidx[y]}\t{3 if s else 2},{length},0,0,{length},0,"
        f"{length},{length},0,{length}"
        for x, y, s in zip(b.tolist(), a.tolist(), same.tolist()))
    ok = overlap_holds(reads, a, b, np.where(same, 0, 2),
                       np.full(len(a), length))
    if not ok.all():
        raise ValueError("reads of one interval differ: the truth is wrong")

    # intervals of kept reads in genome order; an edge joins every kept
    # read of an interval to every kept read of the next one in reach
    kept = order[new]
    key_g, key_s = g[kept], start[kept]
    iv_new = np.ones(len(kept), bool)
    iv_new[1:] = (key_g[1:] != key_g[:-1]) | (key_s[1:] != key_s[:-1])
    iv = np.cumsum(iv_new) - 1                   # interval of each kept read
    iv_g, iv_s = key_g[iv_new], key_s[iv_new]
    reach = length - min_overlap
    link = (iv_g[1:] == iv_g[:-1]) & (iv_s[1:] - iv_s[:-1] <= reach)
    first = np.flatnonzero(iv_new)
    count = np.diff(np.append(first, len(kept)))
    li = np.flatnonzero(link)
    per = count[li] * count[li + 1]
    at = np.repeat(li, per)
    p = np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
    src = kept[first[at] + p // count[at + 1]]
    dst = kept[first[at + 1] + p % count[at + 1]]
    swap = ids[src] > ids[dst]
    src, dst = np.where(swap, dst, src), np.where(swap, src, dst)
    ovl = length - np.abs(start[src] - start[dst])
    hit = np.full(len(src), -1)
    for h in range(4):                 # the first orientation that holds
        left = np.flatnonzero(hit < 0)
        ok = overlap_holds(reads, src[left], dst[left],
                           np.full(len(left), h), ovl[left])
        hit[left[ok]] = h
    if (hit < 0).any():
        raise ValueError("neighbouring intervals do not overlap: the truth "
                         "is wrong")
    orient = np.asarray(EDGE_ORIENT)[hit]
    edges = np.stack([fidx[src], fidx[dst], orient, ovl], 1)
    return contained, edges[np.lexsort(edges.T[::-1])]


def parse_par_graph(paths) -> np.ndarray:
    """(E, 14) int64 fields of parGraph lines (NA read as -1)."""
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    blob = b"".join(blobs).replace(b"NA", b"-1")
    for sep in (b"\t", b",", b"\n"):
        blob = blob.replace(sep, b" ")
    fields = np.array(blob.split(), dtype=np.int64)
    if len(fields) % 14:
        raise ValueError("parGraph lines of other than 14 fields")
    return fields.reshape(-1, 14)


def judge_graph(prefix: str, reads: Reads, truth, ids, min_overlap: int,
                want=None) -> dict:
    """The numbers compared for the graph a run wrote under `prefix`
    (<prefix>_*_parGraph.txt, <prefix>_*_containedReads.txt), each to be
    0: contained lines missing or extra, edges missing, edges extra (true
    overlaps the graph must not hold), edge lines wrong (malformed, or an
    overlap the reads do not have, or two lines of one pair that
    disagree).  `want` is expected_graph's output, made when not given."""
    n, length = len(reads), reads.length
    contained, edges = want or expected_graph(reads, truth, ids, min_overlap)
    par = sorted(glob.glob(prefix + "_*_parGraph.txt"))
    crd = sorted(glob.glob(prefix + "_*_containedReads.txt"))
    if not par or not crd:
        return {"graph_files_missing": 1}
    got_c = []
    for p in crd:
        with open(p) as f:
            got_c.extend(line.rstrip("\n") for line in f if line.strip())
    want_c, have_c = Counter(contained), Counter(got_c)
    contained_diff = sum(((want_c - have_c) + (have_c - want_c)).values())

    try:
        f = parse_par_graph(par)
    except ValueError:
        return {"graph_unreadable": 1}
    src_f, dst_f, orient, ovl = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
    in_range = (src_f >= 1) & (src_f <= n) & (dst_f >= 1) & (dst_f <= n) \
        & (orient >= 0) & (orient <= 3)
    src = np.clip(src_f - 1, 0, n - 1)
    dst = np.clip(dst_f - 1, 0, n - 1)
    # the fields the writer derives from ovl and the two lengths
    derived = np.stack([np.zeros_like(ovl), np.zeros_like(ovl),
                        np.full_like(ovl, length), length - ovl,
                        np.full_like(ovl, length - 1),
                        np.full_like(ovl, length), np.zeros_like(ovl),
                        ovl - 1, np.full_like(ovl, -1)], 1)
    well_formed = in_range & (f[:, 4:13] == derived).all(1) \
        & np.isin(f[:, 13], (0, 1, 2)) & (ids[src] < ids[dst])
    hit = HIT_OF_EDGE[np.clip(orient, 0, 3)]
    holds = overlap_holds(reads, src, dst, hit, ovl)
    wrong_line = ~(well_formed & holds)
    tuples = np.unique(f[:, :4], axis=0)
    pairs = np.unique(f[:, :2], axis=0)
    wrong = int(wrong_line.sum()) + (len(tuples) - len(pairs))

    def rows(x):
        return {tuple(r) for r in x.tolist()}
    got_e, want_e = rows(tuples), rows(edges)
    return {"contained_diff": contained_diff,
            "edges_missing": len(want_e - got_e),
            "edges_extra": len(got_e - want_e),
            "edge_lines_wrong": wrong}


def write_graph(prefix: str, contained, edges, length: int) -> None:
    """Write `expected_graph`'s output as buildG's two files under
    `prefix` (the control put in the program's place)."""
    with open(prefix + "_0_containedReads.txt", "w") as f:
        f.writelines(line + "\n" for line in contained)
    with open(prefix + "_0_parGraph.txt", "w") as f:
        for s, d, o, v in edges.tolist():
            f.write(f"{s}\t{d}\t{o},{v},0,0,{length},{length - v},"
                    f"{length - 1},{length},0,{v - 1},NA,0\n")


def judge_assembly(contig_files, scaffold_files, genomes, full) -> tuple:
    """The numbers compared for an assembly, each to be at most its limit,
    and what else the placing gives, not compared.  `full` are the genomes
    that the reads cover in full (the configuration's `assembly`).

    - pieces_off_genome: contigs and scaffold pieces (between runs of N)
      that lie in no genome or its reverse complement, plus one for an
      assembly with no contig or no scaffold;
    - contig_gap_bp: the most bases of one `full` genome that no contig
      covers;
    - scaffold_gap_bp: the most bases of one `full` genome that its best
      scaffold, the one that covers most of it, leaves out."""
    from .genome import covered, place
    contigs = place(genomes, contig_files, False)
    scaffolds = place(genomes, scaffold_files, True)
    off = sum(p is None for seq in contigs + scaffolds for p in seq) \
        + (not contigs) + (not scaffolds)

    def on(seqs, g):
        return [[(p[1], p[2]) for p in seq if p is not None and p[0] == g]
                for seq in seqs]
    contig_gap = scaffold_gap = 0
    for g in full:
        size = len(genomes[g])
        contig_gap = max(contig_gap, size - covered(
            [iv for seq in on(contigs, g) for iv in seq]))
        scaffold_gap = max(scaffold_gap, size - max(
            (covered(seq) for seq in on(scaffolds, g)), default=0))
    info = {"contigs": len(contigs), "scaffolds": len(scaffolds),
            "scaffold_pieces": sum(len(seq) for seq in scaffolds)}
    return {"pieces_off_genome": int(off), "contig_gap_bp": contig_gap,
            "scaffold_gap_bp": scaffold_gap}, info
