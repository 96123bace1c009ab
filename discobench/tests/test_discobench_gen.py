"""The generator's frozen copy against tools/make_testdata.py."""
import subprocess
import sys

import numpy as np
import pytest

from _tiny import ROOT
from discobench.lib.gen import write_reads


@pytest.mark.parametrize("args, params", [
    (["--genome-len", "30000", "--coverage", "8", "--seed", "7"],
     dict(genome_len=30000, coverage=8.0)),
    (["--genome-len", "20000", "--coverage", "5", "--seed", "2147483711",
      "--read-len", "120", "--insert", "300"],
     dict(genome_len=20000, coverage=5.0, read_len=120, insert=300)),
])
def test_same_bytes_as_make_testdata(tmp_path, args, params):
    want = tmp_path / "want.fasta"
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_testdata.py"),
                    str(want), *args], check=True, capture_output=True)
    got = tmp_path / "got.fasta"
    seed = int(args[args.index("--seed") + 1])
    write_reads(str(got), seed, **params)
    assert got.read_bytes() == want.read_bytes()


def test_truth_locates_every_read(tmp_path):
    path = tmp_path / "r.fasta"
    t = write_reads(str(path), 5, genome_len=20000, levels=[0.3, 0.2],
                    strains_per_level=2, reads=4000)
    seqs = path.read_text().split("\n")[1::2]
    assert len(seqs) == len(t.start) == 4000
    comp = str.maketrans("ACGT", "TGCA")
    for s, g, st, sd in zip(seqs, t.genome, t.start, t.strand):
        piece = t.genomes[g][st:st + t.read_len]
        assert s == (piece if sd > 0 else piece.translate(comp)[::-1])


def test_staggered_levels_share_the_reads(tmp_path):
    t = write_reads(str(tmp_path / "r.fasta"), 3, genome_len=150000,
                    levels=[0.18, 0.018, 0.0018, 0.0002],
                    strains_per_level=5, reads=100000)
    per = np.bincount(t.genome, minlength=20)
    assert per.sum() == 100000
    assert list(per) == [18000] * 5 + [1800] * 5 + [180] * 5 + [20] * 5
    with pytest.raises(ValueError):
        write_reads(str(tmp_path / "x.fasta"), 3, levels=[0.5, 0.4])


def test_repeats_share_29_bases_and_no_30(tmp_path):
    """Each family's copies share exactly 29 bases, on either strand."""
    from collections import Counter

    from discobench.lib.gen import revcomp
    t = write_reads(str(tmp_path / "r.fasta"), 2**31 + 9, genome_len=40_000,
                    coverage=1.0,
                    repeats={"families": 12, "copies": 4, "length": 29})
    g = t.genomes[0]
    both = (g, revcomp(g))
    for k, shared in ((29, 2 * 12), (30, 0)):
        c = Counter(s[i:i + k] for s in both for i in range(len(s) - k + 1))
        assert sum(v > 1 for v in c.values()) == shared
        assert all(v == 4 for v in c.values() if v > 1)
