"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
compared with the plain reference are the last lines of standard error.
A run on a machine without the card, or with fewer cards than the cell
asks for, or one that finds JAX or the JAX package loaded, prints no
result and exits with another code than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    manifest = harness.load_json(harness.MANIFEST)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"the cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_START,
                          manifest=manifest)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
