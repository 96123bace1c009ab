"""discobench: one run of one cell of BENCHMARK.json on the card.

    python3 discobench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line on standard output (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1) and, as the last
lines of standard error, each number compared with its limit.  Exits non-0
and prints no result without as many CUDA cards as the cell asks for, or
when the window loaded JAX or the JAX package."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / ".discobench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed places inside the checkout; the
    # program's own libraries build into disco_tpu_torch/_build
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("DISCO_TPU_TORCH_TRACE", "DISCO_TPU_TORCH_BACKEND"):
        os.environ.pop(var, None)
    sys.path.insert(0, str(ROOT))
    from discobench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("discobench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"discobench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START, ROOT)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
