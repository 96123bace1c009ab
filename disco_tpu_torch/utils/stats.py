"""Assembly statistics — `assemblyStats.py` executable equivalent.

`denovo` mode (reference: assemblyStats.py:202-294): per-contig length
census with N80/N50/N20 (length at which the cumulative sum, contigs sorted
descending, first EXCEEDS the fraction of total — reference
:153-201), the absolute-sum NxM ladder (50M..1000M bases, reference
:136-150), writing `<base>.stat.txt` and, with a length cutoff,
`<base>.filtered.fasta`.

`mapped` mode (reference: assemblyStats.py:296-470): consumes contigs whose
FASTA descriptions carry the 10-field convertBWA annotation
(ContigName,ContigLength,MappedStartPositionInContig,ReferenceID,
MappedStartPositionInReference,MappedLength,Insertion,Deletion,Mismatch,
EditDistance), filters by mapping quality 1 - edit/mapped and length, and
reports the same table plus reference coverage% from a per-base hit mask
(numpy bool array standing in for the reference's bitarray).
"""
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..simplify.dataset import iter_fasta_seqs

# reference: assemblyStats.py:275-281
_NX_LADDER = (50_000_000, 100_000_000, 200_000_000, 300_000_000,
              500_000_000, 800_000_000, 1_000_000_000)


@dataclass
class AssemblyStats:
    n_contigs: int = 0
    total_len: int = 0
    max_len: int = 0
    min_len: int = 0
    mean_len: float = 0.0
    n80: int = 0
    n50: int = 0
    n20: int = 0
    n50_index: int = 0
    gc_frac: float = 0.0
    nx_ladder: List[int] = field(default_factory=lambda: [0] * 7)
    coverage_pct: Optional[float] = None


def _nx(frac: float, lengths_desc: List[int], total: int) -> int:
    """reference: assemblyStats.py:153-177 — first length where the
    running sum strictly exceeds total*frac."""
    target = total * frac
    acc = 0
    for ln in lengths_desc:
        acc += ln
        if acc > target:
            return ln
    return 0


def _nx_abs(teo: int, lengths_desc: List[int]) -> int:
    """reference: assemblyStats.py:136-150 (get_N_Length, N value only)."""
    acc = 0
    for ln in lengths_desc:
        acc += ln
        if teo < acc:
            return ln
    return 0


def _nn50(n50: int, lengths_desc: List[int]) -> int:
    """reference: assemblyStats.py:179-187 — 0-based index of the first
    contig whose length equals N50 (default 1)."""
    for i, ln in enumerate(lengths_desc):
        if ln == n50:
            return i
    return 1


def _finish(lengths: List[int], total: int, gc: int) -> AssemblyStats:
    st = AssemblyStats()
    if not lengths:
        return st
    lengths = sorted(lengths, reverse=True)
    st.n_contigs = len(lengths)
    st.total_len = total
    st.max_len = lengths[0]
    st.min_len = lengths[-1]
    st.mean_len = total / len(lengths)
    st.n80 = _nx(0.8, lengths, total)
    st.n50 = _nx(0.5, lengths, total)
    st.n20 = _nx(0.2, lengths, total)
    st.n50_index = _nn50(st.n50, lengths)
    st.nx_ladder = [_nx_abs(teo, lengths) for teo in _NX_LADDER]
    st.gc_frac = gc / total if total else 0.0
    return st


def assembly_stats(fasta: str, min_len: int = 0) -> AssemblyStats:
    lengths: List[int] = []
    gc = 0
    total = 0
    for seq in iter_fasta_seqs(fasta):
        if len(seq) < min_len:
            continue
        lengths.append(len(seq))
        total += len(seq)
        gc += sum(map(seq.count, "GCgc"))
    return _finish(lengths, total, gc)


def format_stats(st: AssemblyStats) -> str:
    lines = [
        f"contigs:      {st.n_contigs}",
        f"total length: {st.total_len}",
        f"max length:   {st.max_len}",
        f"min length:   {st.min_len}",
        f"mean length:  {st.mean_len:.1f}",
        f"N80:          {st.n80}",
        f"N50:          {st.n50}",
        f"N20:          {st.n20}",
        f"N50 index:    {st.n50_index}",
        f"GC%:          {100.0 * st.gc_frac:.2f}",
    ]
    if st.coverage_pct is not None:
        lines.append(f"coverage%:    {st.coverage_pct:.2f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Executable-parity file outputs
# ---------------------------------------------------------------------------

def _out_paths(input_filename: str) -> Tuple[str, str]:
    """reference: assemblyStats.py:207-217 — outputs land next to the input."""
    d = os.path.dirname(input_filename)
    base = os.path.splitext(os.path.basename(input_filename))[0]
    stat = os.path.join(d, base + ".stat.txt") if d else base + ".stat.txt"
    filt = (os.path.join(d, base + ".filtered.fasta") if d
            else base + ".filtered.fasta")
    return stat, filt


def _iter_fasta_records(path: str):
    """Yield (description, seq) pairs."""
    desc = None
    chunks: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if desc is not None:
                    yield desc, "".join(chunks)
                desc = line[1:]
                chunks = []
            elif desc is not None:
                chunks.append(line)
    if desc is not None:
        yield desc, "".join(chunks)


def _write_fasta_record(f, desc: str, seq: str, width: int = 60) -> None:
    # 60-column wrap, matching BioPython's SeqIO.write used by the reference
    f.write(f">{desc}\n")
    for i in range(0, len(seq), width):
        f.write(seq[i:i + width] + "\n")


def denovo_stat_file(input_filename: str, min_len: int = 0) -> str:
    """`assembly_stat denovo -i <fasta> [-m N]`
    (reference: assemblyStats.py:202-294). Returns the stat file path."""
    stat_path, filt_path = _out_paths(input_filename)
    lengths: List[int] = []
    total = 0
    filt = open(filt_path, "w") if min_len != 0 else None
    try:
        for desc, seq in _iter_fasta_records(input_filename):
            if len(seq) >= min_len:
                total += len(seq)
                lengths.append(len(seq))
                if filt:
                    _write_fasta_record(filt, desc, seq)
    finally:
        if filt:
            filt.close()
    st = _finish(lengths, total, 0)
    with open(stat_path, "w") as out:
        out.write("n\tn:N50\tmin\tN80\tN50\tN20\tN50M\tN100M\tN200M\tN300M"
                  "\tN500M\tN800M\tN1000M\tmax\tsum\tfilename\n")
        out.write("\t".join(str(v) for v in (
            st.n_contigs, st.n50_index, st.min_len, st.n80, st.n50, st.n20,
            *st.nx_ladder, st.max_len, st.total_len)) +
            f"\t{input_filename}\n")
    return stat_path


def _parse_bwa_description(desc: str):
    """Parse the 10-field convertBWA annotation
    (reference: assemblyStats.py:417-434)."""
    fields = desc.split(",")
    if len(fields) != 10:
        raise ValueError(
            "Check contig fasta file.ID should have 10 elements!")
    mapped_length = max(1, int(fields[5].split("=")[1]))
    edit_distance = int(fields[9].split("=")[1])
    reference_id = fields[3].split("=")[1]
    mapped_start_ref = int(fields[4].split("=")[1])
    return reference_id, mapped_start_ref, mapped_length, edit_distance


def mapped_stat_file(input_filename: str, ref_filename: str,
                     min_len: int = 0, map_quality: float = 0.0) -> str:
    """`assembly_stat mapped -i <fasta> -r <ref> [-m N] [-q Q]`
    (reference: assemblyStats.py:296-470). Returns the stat file path."""
    stat_path, filt_path = _out_paths(input_filename)
    ref_ids: List[str] = []
    masks: List[np.ndarray] = []
    for desc, seq in _iter_fasta_records(ref_filename):
        ref_ids.append(desc.split()[0] if desc else "")
        masks.append(np.zeros(len(seq), bool))
    ref_index = {rid: i for i, rid in enumerate(ref_ids)}

    lengths: List[int] = []
    total = 0
    write_filtered = (map_quality != 0.0) or (min_len != 0)
    filt = open(filt_path, "w") if write_filtered else None
    try:
        for desc, seq in _iter_fasta_records(input_filename):
            rid, start, mlen, edit = _parse_bwa_description(desc)
            if map_quality != 0.0 and (1 - edit / mlen) < map_quality:
                continue
            if min_len != 0 and len(seq) < min_len:
                continue
            total += len(seq)
            lengths.append(len(seq))
            i = ref_index[rid]
            masks[i][start - 1:start - 1 + mlen] = True
            if filt:
                _write_fasta_record(filt, desc, seq)
    finally:
        if filt:
            filt.close()
    st = _finish(lengths, total, 0)
    total_ref = sum(len(m) for m in masks)
    covered = sum(int(m.sum()) for m in masks)
    cov_pct = 100.0 * covered / total_ref if total_ref else 0.0
    with open(stat_path, "w") as out:
        out.write("n\tn:N50\tmin\tN80\tN50\tN20\tmax\tsum\tcoverage(%)"
                  "\tfilename\n")
        out.write("\t".join(str(v) for v in (
            st.n_contigs, st.n50_index, st.min_len, st.n80, st.n50, st.n20,
            st.max_len, st.total_len)) +
            f"\t{cov_pct:.2f}\t{input_filename}\n")
    return stat_path
