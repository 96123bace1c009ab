"""disco_tpu_torch.utils.stats (assemblyStats.py's denovo and mapped modes)
against disco_tpu.utils.stats: the same files, byte for byte, and the
hand-derived values of tests/test_stats.py (the reference is Python 2 +
BioPython and cannot run here: strict > for the Nx thresholds, the 0-based
n:N50 index, the absolute NxM ladder, stat.txt's column layout)."""
import dataclasses
import shutil

from conftest import GOLDEN
from disco_tpu.utils import stats as jstats
from disco_tpu_torch.utils import stats as tstats


def _write_fasta(path, recs):
    with open(path, "w") as f:
        for desc, seq in recs:
            f.write(f">{desc}\n{seq}\n")


def _both(monkeypatch, tmp_path, fn, fasta, *args, **kw):
    """Run `fn` of each package on its own copy of `fasta`, named
    ctg.fasta in the working directory (stat.txt records the path as
    given); every file the two write must be identical.  Returns the port's
    stat.txt lines."""
    outs = {}
    for name, mod in (("port", tstats), ("jax", jstats)):
        d = tmp_path / name
        d.mkdir(parents=True)
        shutil.copy(fasta, d / "ctg.fasta")
        monkeypatch.chdir(d)
        assert getattr(mod, fn)("ctg.fasta", *args, **kw) == "ctg.stat.txt"
        outs[name] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert outs["port"] == outs["jax"]
    return (tmp_path / "port" / "ctg.stat.txt").read_text().splitlines()


def test_denovo_stat_file(tmp_path, monkeypatch):
    # lengths 100, 200, 300, 400 -> total 1000, sorted desc [400,300,200,100]
    fa = tmp_path / "in.fasta"
    _write_fasta(fa, [(f"c{i}", "AC" * (n // 2))
                      for i, n in enumerate((100, 300, 400, 200))])
    lines = _both(monkeypatch, tmp_path, "denovo_stat_file", fa)
    assert lines[0].split("\t") == [
        "n", "n:N50", "min", "N80", "N50", "N20", "N50M", "N100M", "N200M",
        "N300M", "N500M", "N800M", "N1000M", "max", "sum", "filename"]
    vals = lines[1].split("\t")
    # N50: cum 400 <= 500, +300=700 > 500 -> 300, first index 1;
    # N80: cum 700 <= 800, +200=900 > 800 -> 200; N20: 400 > 200 -> 400
    assert vals[:6] == ["4", "1", "100", "200", "300", "400"]
    assert vals[6:13] == ["0"] * 7  # absolute ladder unreachable
    assert vals[13:15] == ["400", "1000"]
    assert vals[15] == "ctg.fasta"


def test_denovo_filtered_fasta(tmp_path, monkeypatch):
    fa = tmp_path / "in.fasta"
    _write_fasta(fa, [("keep me", "A" * 70), ("drop", "A" * 10)])
    vals = _both(monkeypatch, tmp_path, "denovo_stat_file", fa,
                 min_len=50)[1].split("\t")
    filt = (tmp_path / "port" / "ctg.filtered.fasta").read_text()
    # only the long record, wrapped at 60 columns like SeqIO.write
    assert filt == ">keep me\n" + "A" * 60 + "\n" + "A" * 10 + "\n"
    assert vals[0] == "1" and vals[14] == "70"


def test_mapped_stat_file(tmp_path, monkeypatch):
    ref = tmp_path / "ref.fasta"
    _write_fasta(ref, [("chr1", "G" * 1000)])
    desc = ("ContigName=c1,ContigLength=500,MappedStartPositionInContig=1,"
            "ReferenceID=chr1,MappedStartPositionInReference=101,"
            "MappedLength=400,Insertion=0,Deletion=0,Mismatch=20,"
            "EditDistance=20")
    desc2 = ("ContigName=c2,ContigLength=300,MappedStartPositionInContig=1,"
             "ReferenceID=chr1,MappedStartPositionInReference=301,"
             "MappedLength=100,Insertion=0,Deletion=0,Mismatch=90,"
             "EditDistance=90")
    fa = tmp_path / "in.fasta"
    _write_fasta(fa, [(desc, "A" * 500), (desc2, "A" * 300)])
    # no filters: both counted; coverage = union [100,500)+[300,400) = 400
    vals = _both(monkeypatch, tmp_path / "all", "mapped_stat_file", fa,
                 str(ref))[1].split("\t")
    assert vals[0] == "2" and vals[7] == "800"
    assert vals[8] == "40.00"
    # quality filter 0.5 drops c2 (1 - 90/100 = 0.1 < 0.5)
    vals = _both(monkeypatch, tmp_path / "q", "mapped_stat_file", fa, str(ref),
                 map_quality=0.5)[1].split("\t")
    assert vals[0] == "1" and vals[7] == "500"
    assert vals[8] == "40.00"  # mask still covers [100,500)
    filt = (tmp_path / "q" / "port" / "ctg.filtered.fasta").read_text()
    assert "c2" not in filt and filt.startswith(">ContigName=c1")


def test_assembly_stats_summary():
    """The summary `stats` prints without a mode, on mini's scaffolds."""
    fa = str(GOLDEN / "mini" / "simplify" / "mini_scaffoldsFinal_1.fasta")
    st = tstats.assembly_stats(fa)
    assert dataclasses.asdict(st) == dataclasses.asdict(
        jstats.assembly_stats(fa))
    assert st.n_contigs > 0 and st.n50 > 0 and st.total_len > 0
    assert tstats.format_stats(st) == jstats.format_stats(
        jstats.assembly_stats(fa))
