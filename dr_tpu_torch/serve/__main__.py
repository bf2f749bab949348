"""``python -m dr_tpu_torch.serve`` — run the serving daemon foreground
(counterpart of ``dr_tpu/serve/__main__.py``).

Prints ONE JSON ready line (``{"serving": <socket>, "pid": ...}``) once
the claim is held and the socket is listening, then serves until a
client ``shutdown`` op or SIGTERM/SIGINT; a start failure (double
daemon, failed claim — on a box without a card, a daemon not asked for
the CPU) prints a classified error line and exits 1.

``--cpu`` claims one CPU rank; without it the daemon claims every CUDA
device and never serves on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dr_tpu_torch.serve",
        description="dr_tpu_torch serving daemon (one resident device "
                    "claim)")
    ap.add_argument("--socket", default=None,
                    help="Unix-domain socket path "
                         "(default: $DR_GPU_SERVE_SOCKET or the "
                         "per-uid temp path)")
    ap.add_argument("--cpu", action="store_true",
                    help="claim one CPU rank instead of the CUDA devices")
    ap.add_argument("--state-dir", default=None,
                    help="crash-safe resident-state journal directory "
                         "(default: $DR_GPU_SERVE_STATE_DIR, unset = "
                         "resident state is process-memory only)")
    args = ap.parse_args(argv)
    from ..utils import resilience
    from .daemon import Server
    srv = Server(args.socket, cpu=args.cpu, state_dir=args.state_dir)
    try:
        srv.start()
    except Exception as e:
        ce = resilience.classified(e)
        print(json.dumps({"serving": None,
                          "error": {"cls": type(ce).__name__,
                                    "message": str(ce)}}), flush=True)
        return 1
    print(json.dumps({"serving": srv.path, "pid": os.getpid()}),
          flush=True)

    def _term(signum, frame):  # pragma: no cover - signal path
        # SIGTERM is the GRACEFUL stop: drain — stop admitting, finish
        # in-flight batches — then exit.  On a helper thread: drain
        # blocks up to the drain timeout, and a signal handler must not.
        import threading

        def _drain():
            try:
                srv.drain()
            except resilience.ResilienceError:
                srv.stop()  # faulted drain: hard stop still exits

        threading.Thread(target=_drain, name="serve-sigterm-drain",
                         daemon=True).start()

    def _int(signum, frame):  # pragma: no cover - signal path
        srv.stop()  # SIGINT (^C): immediate stop

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _int)
    srv.wait()
    srv.stop()
    print(json.dumps({"served": srv.stats()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
