"""Read the numbers that decide ``correct`` over many seeds, with the
control and the faults, to set and to check their limits.

    python3 portbench/survey.py --workload <cell> --seeds <n> --base <seed>
        [--seconds <s>] [--control] [--faults]

Each seed runs the cell once, in one process, as ``run.py`` does (a short
window); ``--control`` adds the reference computed one precision lower
in the program's place; ``--faults`` runs three seeds again under each
fault that the cell's workload file lists (``lib/faults.py``). One JSON
line a reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    from portbench import harness
    from portbench.lib import faults
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--base", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    def quiet(*a, **kw):
        pass

    def show(kind, seed, out, t0):
        print(json.dumps({"kind": kind, "seed": seed,
                          "correct": out["correct"],
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()},
                          "control": {k: v["value"] for k, v in
                                      out.get("control", {}).items()},
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "detail": out.get("detail"),
                          "seconds": time.perf_counter() - t0}), flush=True)
    for i in range(args.seeds):
        seed, t0 = args.base + i, time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False,
                          log=quiet, control=args.control)
        show("sound", seed, out, t0)
    if args.faults:
        for name in harness.load_json(harness.HERE / "workloads"
                                      / f"{args.workload}.json")["faults"]:
            for i in range(3):
                seed, t0 = args.base + 100 + i, time.perf_counter()
                out = harness.run(args.workload, seed, args.seconds, False,
                                  log=quiet, breaker=faults.FAULTS[name]())
                show(name, seed, out, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
