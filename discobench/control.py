"""The control of a cell's `correct`: the plain reference put in the
program's place with one guarantee of the configuration broken (a read
whose reverse complement another read of smaller read ID is, is not
contained: containment checked on one strand), written as buildG's files
and judged by the same comparison as the program's.  At the cell's own
size, one JSON line a seed; a sound control reads 0 on every number, this
one must not.

    python3 discobench/control.py --workload <name> --seeds 11,12,13

Needs no card: the reference and the comparison are NumPy."""
import argparse
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from discobench import harness
    from discobench.lib import reference as R
    from discobench.lib.gen import write_reads

    cell = harness.load_cell(args.workload, ROOT)
    config = cell["config"]
    min_overlap = config["MinOverlap4BuildGraph"]
    failed_all = True
    for seed in map(int, args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="discobench-ctl-") as td:
            fasta = pathlib.Path(td) / "reads.fasta"
            truth = write_reads(str(fasta), seed, **config["reads"])
            t0 = time.perf_counter()
            reads = R.Reads(str(fasta))
            ids = R.read_ids(len(reads))
            want = R.expected_graph(reads, truth, ids, min_overlap)
            control = R.expected_graph(reads, truth, ids, min_overlap,
                                       rc_contained=False)
            R.write_graph(td + "/ctl", *control, reads.length)
            numbers = R.judge_graph(td + "/ctl", reads, truth, ids,
                                    min_overlap, want)
            failed_all &= any(numbers.values())
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": numbers,
                              "contained": len(want[0]),
                              "edges": len(want[1]),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
