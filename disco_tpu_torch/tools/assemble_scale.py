"""Time to contigs at the size its users run, by hand: `assemble` of the
port's command line, reads to scaffolds, on one read set of
tools/make_testdata.py (250 bp pairs, 500 bp insert, seed 99), by default
the JAX package's verified set (100 Mb genome, 25x: 10,000,000 reads), with
the three shipped cfgs (tests/golden/thresh146, MinOverlap4BuildGraph 30).

    python -m disco_tpu_torch.tools.assemble_scale [--genome-len N]
        [--coverage C] [--error-rate E] [--runs device,native[,rma]]
        [--reads PATH] [--keep DIR] [--against DIR]

Each run is `assemble` in a fresh process (`bench_e2e.run_child`), in the
order given: `device` (`-backend device`), `native` (`-backend native`),
`rma` (`-n 4 -rma`).  Prints one JSON line: the card (its name, and its
name and power limit as nvidia-smi prints them), the seconds the reads took
to make, and by run its wall and what its child reported (buildG's and
fullsimplify's walls, every `clock` stage and fullsimplify's by iteration,
peak RSS and the RSS when fullsimplify started, launches, peak device
memory, the relation's stats), and whether every file under graph/ and
assembly/ and both *FinalCombined.fasta equal the first run's
(`same_as_first`, by name).  For error-free reads (`--error-rate 0`) it
adds the genome check (`genome_check`): the genome drawn again from the
seed, every contig and every scaffold piece between runs of N an exact
substring of it or of its reverse complement, with the sequences' count,
N50 and longest, and the share of the genome the longest scaffold covers.
It exits 1 when a check fails.

`--reads PATH` takes the reads there, made there first if missing; each
child runs from the reads' directory and names the file as it is named
there, so `_ReadIDMap.txt` holds its name alone.  `--keep DIR` runs in
DIR and keeps each run's tree (DIR/<run>/asm) and the SHA-256 of its
every file (DIR/<run>.sha256.json); `--against DIR` compares each run
with the runs kept in DIR, byte for byte where their files are there and
by the digests where only the manifest is (a run of another call).  The
device and rma runs need a CUDA card: without one the tool exits non-zero
before it makes any data."""
import argparse
import filecmp
import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from .bench_e2e import ROOT, run_child

RUNS = {"device": ["-backend", "device"], "native": ["-backend", "native"],
        "rma": ["-n", "4", "-rma"]}
SEED, READ_LEN, INSERT = 99, 250, 500
CFG_DIR = ROOT / "tests" / "golden" / "thresh146"
CFGS = ("-p", str(CFG_DIR / "cfg.cfg"), "-p2", str(CFG_DIR / "cfg_2.cfg"),
        "-p3", str(CFG_DIR / "cfg_3.cfg"))
NAME = "asm"                   # each run's -o, in its own directory
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def draw_genome(genome_len: int, seed: int) -> np.ndarray:
    """The genome tools/make_testdata.py draws first from its seed (its
    one genome, `BASES[rng.integers(0, 4, size=genome_len)]`), as base
    codes 0..3 (A, C, G, T)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=genome_len).astype(np.uint8)


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


def _covered(intervals) -> int:
    """Bases in the union of (start, length) intervals."""
    total, end = 0, -1
    for s, n in sorted(intervals):
        if s + n > end:
            total += s + n - max(s, end)
            end = s + n
    return total


def genome_check(codes: np.ndarray, contig_files, scaffold_files) -> dict:
    """Every contig of `contig_files` and every piece between runs of N of
    the scaffolds of `scaffold_files` must lie exactly in the genome
    `codes` or its reverse complement.  Returns, for contigs and
    scaffolds, the sequences' count, N50 and longest (utils.stats), the
    pieces checked and those that failed (the first few by record
    number), and the share of the genome the longest scaffold's pieces
    cover; `ok` when there are pieces of both and none failed."""
    from ..simplify.dataset import iter_fasta_seqs
    from ..utils.stats import _finish

    genome = BASES[codes].tobytes().decode()
    rc_genome = revcomp(genome)
    out = {"genome_len": len(genome)}
    for kind, files, split in (("contigs", contig_files, False),
                               ("scaffolds", scaffold_files, True)):
        lengths, pieces, failed, longest = [], 0, [], (0, [])
        for path in files:
            for rec, seq in enumerate(iter_fasta_seqs(str(path))):
                lengths.append(len(seq))
                hits = []
                for piece in (re.split("N+", seq) if split else [seq]):
                    if not piece:
                        continue
                    pieces += 1
                    hit = locate(genome, rc_genome, piece)
                    if hit is None:
                        failed.append(f"{pathlib.Path(path).name}:{rec}")
                    else:
                        hits.append(hit)
                if len(seq) > longest[0]:
                    longest = (len(seq), hits)
        st = _finish(lengths, sum(lengths), 0)
        out[kind] = {"files": len(files), "sequences": st.n_contigs,
                     "n50": st.n50, "longest": st.max_len,
                     "total": st.total_len, "pieces": pieces,
                     "failed": len(failed), "first_failed": failed[:5]}
        if split:
            out[kind]["longest_covers"] = (_covered(longest[1])
                                           / max(len(genome), 1))
    out["ok"] = all(out[k]["pieces"] > 0 and out[k]["failed"] == 0
                    for k in ("contigs", "scaffolds"))
    return out


def tree_files(run_dir: pathlib.Path) -> dict:
    """The files a run's `assemble` wrote, by name relative to its
    directory: everything under graph/ and assembly/, and the two
    *FinalCombined.fasta beside them."""
    files = {}
    for sub in ("graph", "assembly"):
        for p in sorted((run_dir / sub).rglob("*")):
            if p.is_file():
                files[str(p.relative_to(run_dir))] = p
    for p in sorted(run_dir.glob("*FinalCombined.fasta")):
        files[p.name] = p
    return files


def sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def same_files(got: dict, want: dict, want_digests: dict = None) -> dict:
    """By name over both runs' files: whether the bytes are the same (a
    file only one run wrote is not); with `want_digests`, `want` may lack
    a file whose SHA-256 the digests hold."""
    digests = want_digests or {}
    same = {}
    for name in sorted(set(got) | set(want) | set(digests)):
        if name not in got:
            same[name] = False
        elif name in want:
            same[name] = filecmp.cmp(got[name], want[name], shallow=False)
        else:
            same[name] = digests.get(name) == sha256(got[name])
    return same


def card_line():
    """The card's name and power limit as nvidia-smi prints them, or None
    without it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def make_reads(fasta: pathlib.Path, args) -> float:
    """The reads of tools/make_testdata.py (run as a program) into `fasta`;
    returns the seconds it took."""
    fasta.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"), str(fasta),
         "--genome-len", str(args.genome_len), "--coverage",
         str(args.coverage), "--read-len", str(READ_LEN), "--insert",
         str(INSERT), "--seed", str(SEED), "--error-rate",
         str(args.error_rate)], check=True, stdout=subprocess.DEVNULL)
    return time.perf_counter() - t0


def kept_runs(against: pathlib.Path) -> dict:
    """The runs kept in `against` (`--keep`): by name, their files there
    and their digests."""
    return {m.name[:-len(".sha256.json")]: (
                tree_files(against / m.name[:-len(".sha256.json")] / NAME),
                json.loads(m.read_text()))
            for m in sorted(against.glob("*.sha256.json"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-len", type=int, default=100_000_000)
    ap.add_argument("--coverage", type=float, default=25.0)
    ap.add_argument("--error-rate", type=float, default=0.0)
    ap.add_argument("--runs", default="device,native")
    ap.add_argument("--reads", type=pathlib.Path,
                    help="the reads (made there first if missing)")
    ap.add_argument("--keep", type=pathlib.Path,
                    help="run in this directory and keep every run's tree "
                         "and its files' digests")
    ap.add_argument("--against", type=pathlib.Path,
                    help="compare every run with the runs kept here")
    args = ap.parse_args(argv)
    runs = args.runs.split(",")
    if any(r not in RUNS for r in runs) or len(set(runs)) != len(runs):
        sys.exit(f"assemble_scale: runs are {', '.join(RUNS)}, each once")
    card = None
    if set(runs) != {"native"}:
        import torch
        if not torch.cuda.is_available():
            sys.exit("assemble_scale: the device and rma runs need a CUDA "
                     "card (torch.cuda.is_available() is false)")
        card = torch.cuda.get_device_name(0)
    if args.keep and args.against and (args.keep.resolve()
                                       == args.against.resolve()):
        sys.exit("assemble_scale: --keep and --against name one directory")
    kept = kept_runs(args.against) if args.against else {}

    with tempfile.TemporaryDirectory() as td:
        # the children run from the reads' directory: every path absolute
        work = (args.keep or pathlib.Path(td)).resolve()
        work.mkdir(parents=True, exist_ok=True)
        fasta = (args.reads or work / "reads.fasta").resolve()
        data_s = None if fasta.exists() else make_reads(fasta, args)
        out = {"bench": "assemble_scale", "genome_len": args.genome_len,
               "coverage": args.coverage, "error_rate": args.error_rate,
               "seed": SEED, "read_len": READ_LEN, "insert": INSERT,
               "cfgs": CFGS[1::2], "card": card, "card_line": card_line(),
               "data_s": data_s, "reads_bytes": fasta.stat().st_size,
               "runs": {}}
        first, ok = None, True
        for name in runs:
            run_dir = work / name
            shutil.rmtree(run_dir, ignore_errors=True)
            run_dir.mkdir(parents=True)
            wall, child = run_child(
                str(fasta.parent), str(run_dir / NAME),
                ["-inP", fasta.name, *CFGS, *RUNS[name]], command="assemble")
            files = tree_files(run_dir / NAME)
            same = None if first is None else same_files(files, first)
            against = {k: same_files(files, kf, digests)
                       for k, (kf, digests) in kept.items()}
            for s in [same or {}, *against.values()]:
                ok &= all(s.values())
            ok &= child["rc"] == 0
            out["runs"][name] = {
                "wall_s": wall, "files": len(files),
                "bytes": sum(p.stat().st_size for p in files.values()),
                "same_as_first": same, "against": against or None, **child}
            # what a run gave, as it ends, in case a later one fails
            print(json.dumps({name: out["runs"][name]}), file=sys.stderr,
                  flush=True)
            if args.keep:
                (work / f"{name}.sha256.json").write_text(json.dumps(
                    {n: sha256(p) for n, p in files.items()}))
            if first is None:
                first, first_dir = files, run_dir / NAME
            elif not args.keep:            # the disk the next run needs
                shutil.rmtree(run_dir)
        out["genome_check"] = None
        if args.error_rate == 0:
            t0 = time.perf_counter()
            assembly = first_dir / "assembly"
            check = genome_check(
                draw_genome(args.genome_len, SEED),
                sorted(assembly.glob(f"{NAME}_contigsFinal_*.fasta")),
                sorted(assembly.glob(f"{NAME}_scaffoldsFinal_*.fasta")))
            out["genome_check"] = dict(check, seconds=time.perf_counter()
                                       - t0)
            ok &= check["ok"]
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
