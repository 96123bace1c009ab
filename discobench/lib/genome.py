"""The genome check of an assembly: a frozen copy of
disco_tpu_torch/tools/assemble_scale.py's `genome_check`, `locate` and
`_covered`, taking several genomes (a mock community) as strings, with its
own FASTA reader in place of the program's (so that nothing here imports
the program), and placing every piece on its genome, so that what each
genome's contigs and scaffolds cover can be judged.  The genomes come from
the generator's Truth, so assemble_scale's `draw_genome` has no copy
here."""
import re


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def locate(genome: str, rc_genome: str, seq: str):
    """(start, length) of `seq` on the forward strand of `genome`, found
    in it or in its reverse complement `rc_genome`; None when in
    neither."""
    p = genome.find(seq)
    if p < 0:
        q = rc_genome.find(seq)
        if q < 0:
            return None
        p = len(genome) - q - len(seq)
    return p, len(seq)


def covered(intervals) -> int:
    """Bases in the union of (start, length) intervals."""
    total, end = 0, -1
    for s, n in sorted(intervals):
        if s + n > end:
            total += s + n - max(s, end)
            end = s + n
    return total


def iter_fasta_seqs(path: str):
    """The sequences of a FASTA file, each joined over its lines."""
    cur = None
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur is not None:
                    yield "".join(cur)
                cur = []
            elif cur is not None:
                cur.append(line.strip())
    if cur is not None:
        yield "".join(cur)


def place(genomes, files, split: bool):
    """Every sequence of `files`, its pieces (between runs of N when
    `split`) placed on `genomes` (joined by an N, which no piece holds):
    a list, a sequence each, of [(genome, start, length) or None for a
    piece found in no genome or its reverse complement]."""
    joined = "N".join(genomes)
    rc_joined = revcomp(joined)
    offsets, at = [], 0
    for g in genomes:
        offsets.append(at)
        at += len(g) + 1
    out = []
    for path in files:
        for seq in iter_fasta_seqs(str(path)):
            pieces = []
            for piece in (re.split("N+", seq) if split else [seq]):
                if not piece:
                    continue
                hit = locate(joined, rc_joined, piece)
                if hit is None:
                    pieces.append(None)
                    continue
                g = max(i for i, o in enumerate(offsets) if o <= hit[0])
                pieces.append((g, hit[0] - offsets[g], hit[1]))
            out.append(pieces)
    return out
