"""The read-set generator of the benchmark: a frozen copy of the repo's
tools/make_testdata.py (seeded random genomes, 250 bp interleaved pairs,
insert 500 +- 25, --error-rate), turned into a function that also returns
where each read came from, and extended by three things:

- staggered mock levels (`levels`, `strains_per_level`): each level's share
  of the read pairs, the same for every strain of the level, as in the
  ATCC MSA-1003 staggered mix (18%, 1.8%, 0.18%, 0.02% of the reads), in
  place of make_testdata's geometric mock;
- an explicit count of reads (`reads`) in place of a coverage;
- short repeats planted in every genome (`repeats`, `plant_repeats`), so
  that the overlap check has candidates to reject.

With none of them, `write_reads` writes the same bytes as
tools/make_testdata.py with the same arguments
(discobench/tests/test_discobench_gen.py holds it so).  Imports numpy
only."""
from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

DEFAULTS = {"genome_len": 200_000, "coverage": 25.0, "read_len": 250,
            "insert": 500, "insert_sd": 25, "seed": 42, "error_rate": 0.0,
            "levels": None, "strains_per_level": 1, "reads": None,
            "repeats": None}


@dataclass
class Truth:
    """Where each record of the written file came from, in file order:
    genome index, the 0-based start of the read's interval on the genome's
    forward strand, and its strand (+1 forward, -1 reverse complement).
    `genomes` are the genome strings."""
    genome: np.ndarray
    start: np.ndarray
    strand: np.ndarray
    genomes: list
    read_len: int
    error_rate: float


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def plant_repeats(codes: np.ndarray, rng, families: int, copies: int,
                  length: int) -> np.ndarray:
    """Plant `families` repeats into the genome `codes` ((G,) base codes
    0-3, changed in place): each a random `length`-mer written at `copies`
    places, in a random orientation, each copy between flanking bases that
    no other copy of its family has (before it and after it, read in the
    repeat's own orientation).  So copies share exactly `length` bases:
    with `length` = MinOverlap - 1 every read whose end lies on a copy is
    a candidate of the reads over the other copies, and none of these
    candidates overlaps by MinOverlap bases.  Returns the copies' starts
    (families x copies), the flanks included."""
    if not 2 <= copies <= 4:
        raise ValueError("a family has 2 to 4 copies: four bases can flank "
                         "them")
    unit = length + 2
    n = families * copies
    n_slots = len(codes) // unit
    if n > n_slots // 2:
        raise ValueError("more repeat copies than the genome holds")
    # copies never touch: one to a slot of `unit` bases, slots apart
    slots = rng.choice(n_slots // 2, size=n, replace=False) * 2
    at = slots.reshape(families, copies) * unit
    for f in range(families):
        core = rng.integers(0, 4, size=length)
        before = rng.permutation(4)[:copies]
        after = rng.permutation(4)[:copies]
        flip = rng.integers(0, 2, size=copies)
        for c in range(copies):
            u = np.concatenate([[before[c]], core, [after[c]]])
            codes[at[f, c]:at[f, c] + unit] = 3 - u[::-1] if flip[c] else u
    return at


def write_reads(out: str, seed: int, **params) -> Truth:
    """Write the read set of `params` (keys of DEFAULTS, `seed` apart) to
    `out`; returns its Truth.  `repeats` is {"families", "copies",
    "length"} a genome, planted from a stream of its own, so that the
    reads' places do not depend on it."""
    unknown = set(params) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown read-set parameters {sorted(unknown)}")
    a = dict(DEFAULTS, **params, seed=seed)
    rng = np.random.default_rng(a["seed"])
    rep_rng = np.random.default_rng([a["seed"], 1])
    levels = a["levels"]
    n_genomes = len(levels) * a["strains_per_level"] if levels else 1
    genomes = []
    for _ in range(n_genomes):
        codes = rng.integers(0, 4, size=a["genome_len"])
        if a["repeats"]:
            plant_repeats(codes, rep_rng, **a["repeats"])
        genomes.append(BASES[codes].tobytes().decode())

    if levels:
        weights = np.repeat(np.asarray(levels, float), a["strains_per_level"])
        if abs(weights.sum() - 1.0) > 1e-9:
            raise ValueError("levels times strains_per_level must sum to 1")
    else:
        weights = np.ones(1)
    if a["reads"] is not None:
        n_pairs_total = a["reads"] // 2
    else:
        n_pairs_total = int(n_genomes * a["genome_len"] * a["coverage"]
                            / (2 * a["read_len"]))
    gidx = []
    starts_l = []
    inserts_l = []
    for g, w in enumerate(weights):
        n_pairs = (int(round(n_pairs_total * w)) if levels
                   else max(1, int(n_pairs_total * w)))
        ins = np.clip(
            rng.normal(a["insert"], a["insert_sd"], size=n_pairs).astype(int),
            a["read_len"] + 10, None)
        st = rng.integers(0, a["genome_len"] - ins.max() - 1, size=n_pairs)
        gidx.append(np.full(n_pairs, g))
        starts_l.append(st)
        inserts_l.append(ins)
    gidx = np.concatenate(gidx)
    starts = np.concatenate(starts_l)
    inserts = np.concatenate(inserts_l)
    if n_genomes > 1:
        perm = rng.permutation(len(gidx))
        gidx, starts, inserts = gidx[perm], starts[perm], inserts[perm]

    error_rate, read_len = a["error_rate"], a["read_len"]

    def add_errors(read):
        if error_rate <= 0:
            return read
        arr = np.frombuffer(read.encode(), dtype=np.uint8).copy()
        hits = np.nonzero(rng.random(len(arr)) < error_rate)[0]
        if len(hits):
            codes = np.zeros(256, np.uint8)
            codes[BASES] = np.arange(4)
            newc = (codes[arr[hits]] + rng.integers(1, 4, len(hits))) % 4
            arr[hits] = BASES[newc]
        return arr.tobytes().decode()

    parts = []
    rid = 0
    for g, s, ins in zip(gidx.tolist(), starts.tolist(), inserts.tolist()):
        frag = genomes[g][s:s + ins]
        r1 = add_errors(frag[:read_len])
        r2 = add_errors(revcomp(frag[-read_len:]))
        rid += 1
        parts.append(f">r{rid}/1 g={g} pos={s}\n{r1}\n")
        rid += 1
        parts.append(f">r{rid}/2 g={g} pos={s}\n{r2}\n")
    with open(out, "w") as f:
        f.write("".join(parts))

    s2 = starts + inserts - read_len
    return Truth(np.repeat(gidx.astype(np.int64), 2),
                 np.stack([starts, s2], 1).reshape(-1).astype(np.int64),
                 np.tile(np.array([1, -1], np.int8), len(gidx)), genomes,
                 read_len, error_rate)
