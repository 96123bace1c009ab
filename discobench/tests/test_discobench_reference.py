"""The plain reference against the program's native buildG on tiny read
sets, the control's failure, and the dual-check work against the
program's candidates."""
import numpy as np
import pytest
import torch

from _tiny import SEED
from discobench.lib import reference as R
from discobench.lib.bounds import dual_check_work
from discobench.lib.gen import write_reads

SETS = {
    "isolate": dict(genome_len=120_000, coverage=30.0),
    "repeats": dict(genome_len=120_000, coverage=30.0,
                    repeats={"families": 40, "copies": 4, "length": 29}),
    "mock": dict(genome_len=20_000, levels=[0.18, 0.018, 0.0018, 0.0002],
                 strains_per_level=5, reads=24_000),
}


def buildg(tmp_path, name):
    from disco_tpu_torch import cli
    fasta = tmp_path / "reads.fasta"
    truth = write_reads(str(fasta), SEED, **SETS[name])
    prefix = str(tmp_path / "g")
    assert cli.main(["buildg", "-pe", str(fasta), "-f", prefix, "-m-ovl",
                     "30", "-backend", "native"]) == 0
    reads = R.Reads(str(fasta))
    return prefix, reads, truth, R.read_ids(len(reads))


@pytest.mark.parametrize("name", sorted(SETS))
def test_reference_equals_buildg(tmp_path, name):
    prefix, reads, truth, ids = buildg(tmp_path, name)
    numbers = R.judge_graph(prefix, reads, truth, ids, 30)
    assert numbers == {"contained_diff": 0, "edges_missing": 0,
                       "edges_extra": 0, "edge_lines_wrong": 0}


@pytest.mark.parametrize("name", sorted(SETS))
def test_control_is_not_correct(tmp_path, name):
    """The control: the reference in the program's place with one
    guarantee broken (reads that are each other's reverse complement not
    contained)."""
    _, reads, truth, ids = buildg(tmp_path, name)
    control = R.expected_graph(reads, truth, ids, 30, rc_contained=False)
    R.write_graph(str(tmp_path / "ctl"), *control, reads.length)
    numbers = R.judge_graph(str(tmp_path / "ctl"), reads, truth, ids, 30)
    assert numbers["contained_diff"] > 0 and numbers["edges_extra"] > 0


def test_judge_sees_an_altered_line(tmp_path):
    prefix, reads, truth, ids = buildg(tmp_path, "isolate")
    path = prefix + "_0_parGraph.txt"
    lines = open(path).read().split("\n")
    f = lines[5].split("\t")
    f[2] = f[2].replace(f[2].split(",")[1], str(int(f[2].split(",")[1]) - 1),
                        1)
    lines[5] = "\t".join(f)
    open(path, "w").write("\n".join(lines))
    numbers = R.judge_graph(prefix, reads, truth, ids, 30)
    assert numbers["edge_lines_wrong"] >= 1 and numbers["edges_extra"] == 1


def test_read_ids_follow_the_parser():
    """Against the program's read-ID order (ReadStore.from_files)."""
    ids = R.read_ids(10001 * 3 + 7)
    assert ids[0] == 2 * 10001 + 1          # block 2 first, then 1, 0
    assert ids[2 * 10001] == 1
    assert ids[-1] == 10001 * 3 + 7
    assert sorted(ids) == list(range(1, 10001 * 3 + 8))


def test_dual_check_work_counts_the_programs_candidates(tmp_path):
    from disco_tpu_torch.index.table import FingerprintTable
    from disco_tpu_torch.io.readstore import ReadStore
    from disco_tpu_torch.overlap.relation import window_codes
    fasta = tmp_path / "r.fasta"
    write_reads(str(fasta), 9, genome_len=30_000, coverage=20.0)
    store = ReadStore.from_files([str(fasta)], [], 30,
                                 reference_task_order=False)
    table = FingerprintTable.build(store, 29)
    _, _, qcode = window_codes(store, 29)
    lo, hi = table.lookup_ranges(qcode)
    reads = R.Reads(str(fasta))
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    codes = torch.from_numpy(lut[np.frombuffer(b"".join(reads.fwd),
                                               np.uint8)].reshape(
        len(reads), reads.length))
    work = dual_check_work(codes, 29, block=1000)
    assert work["candidates"] == int((hi - lo).sum())
    assert 0 < work["compared_words"] <= 16 * 2 * work["candidates"]
    assert work["bound_s"] > 0


def test_judge_assembly_places_pieces_on_strains(tmp_path):
    rng = np.random.default_rng(4)
    g = ["".join("ACGT"[i] for i in rng.integers(0, 4, 5000))
         for _ in range(3)]
    from discobench.lib.genome import revcomp

    def fasta(name, seqs):
        path = tmp_path / name
        path.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
        return [str(path)]
    contigs = [g[0][:3000], g[0][2900:], revcomp(g[1][100:4000]), g[2][:50]]
    scaffolds = [g[0][:2500] + "NNNN" + g[0][2600:], revcomp(g[1][100:4000])]
    numbers, info = R.judge_assembly(fasta("c.fa", contigs),
                                     fasta("s.fa", scaffolds), g, [0, 1])
    assert numbers == {"pieces_off_genome": 0, "contig_gap_bp": 1100,
                       "scaffold_gap_bp": 1100}
    assert info == {"contigs": 4, "scaffolds": 2, "scaffold_pieces": 3}
    numbers, _ = R.judge_assembly(fasta("c.fa", contigs[1:] + ["ACGT" * 20]),
                                  fasta("s.fa", scaffolds[:1]), g, [0, 1])
    assert numbers == {"pieces_off_genome": 1, "contig_gap_bp": 2900,
                       "scaffold_gap_bp": 5000}
