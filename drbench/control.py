"""The control of the benchmark's correctness check: for each seed, one
run of the cell as the benchmark makes it, then the reference put in the
program's place at the traffic's lower ``control_precision``, judged by
the same numbers after as many calls.  The benchmark's own runs never
run it.

    python3 drbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

Prints one JSON line a seed (the program's numbers, the control's, and
whether each came out correct), then a summary line: the largest of the
program's readings and the smallest of the control's, for each number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from drbench import harness
    low, high = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter() if low else T_START
        r = harness.run(args.workload, seed, args.seconds, False, t,
                        control=True)
        prog = {k: v["value"] for k, v in r["checks"].items()}
        ctrl = {k: v["value"] for k, v in r["control_checks"].items()}
        for k, v in prog.items():
            low[k] = max(low.get(k, v), v)
        for k, v in ctrl.items():
            high[k] = min(high.get(k, v), v)
        print(json.dumps({
            "seed": seed, "calls": r["attempted"], "program": prog,
            "program_correct": r["correct"], "control": ctrl,
            "control_correct": all(v["value"] <= v["limit"]
                                   for v in r["control_checks"].values())}),
            flush=True)
    print(json.dumps({"workload": args.workload, "program_max": low,
                      "control_min": high}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
