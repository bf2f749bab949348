"""Run one cell of the benchmark of ``dr_tpu_torch`` and print its result.

    python3 drbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with the cell's cards.  The
last line of standard output is the result object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; ``breakdown`` with
``--trace 1``; ``checks`` last); the compared numbers, each beside its
limit, are the last lines of standard error.  No card, too few cards, a
forbidden import (``jax``, ``jaxlib``, ``flax``, ``dr_tpu``) or a
checkout without the port: a message on standard error, no result, a
non-zero exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "drbench" / ".cache"


def main(argv=None, *, device=None, config_override=None):
    """The command; ``device`` and ``config_override`` (a CPU device and
    a smaller configuration) are for the benchmark's own tests, which
    drive a whole run without a card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches at fixed paths inside the checkout (the port's nvcc builds
    # go to dr_tpu_torch/_build/, inside it too)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from drbench import harness
    try:
        import torch
        torch.set_num_threads(4)
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START, device=device,
                             config_override=config_override)
    except (harness.NoDevice, ImportError) as e:
        print(f"drbench: {e}", file=sys.stderr)
        return 2
    # the last step before the result: nothing loaded since may escape
    bad = harness.forbidden_modules()
    if bad:
        print(f"drbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
