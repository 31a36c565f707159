"""fig20's async ÷ barrier learner steps (``chip_smoke.fig20_async_learner``,
phase 22's gate) in one process of a checkout: once before any phase, then
after that checkout's ``chip_smoke.py`` phases 1 to N - 1 (its ``main()``
stopped at phase N's heading, the backward kernels' build joined) several
times, each beside a census of the process (``chip_smoke.host_census`` of
this repository: Python and OS threads, child processes, objects the
garbage collector tracks).  It tells whether the phases before phase 22
change what fig20 sees.

  python scripts/fig20_after_phases.py [--checkout DIR] [--stop-at N]
      [--repeats R]

Run one process a checkout (parent and change unpacked by ``git archive``)
and compare them in one call on the card: each prints
``FIG20 <checkout> <when> ratio <x>`` (or the gate's message) and its
census.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Stop(Exception):
    """Raised at phase ``--stop-at``'s heading to leave ``main()``."""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, default=ROOT)
    parser.add_argument("--stop-at", type=int, default=6)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    tree = args.checkout.resolve()
    os.chdir(tree)
    sys.path[:0] = [str(tree / "src"), str(tree)]
    census = load(ROOT / "chip_smoke.py", "chip_smoke_census").host_census
    smoke = load(tree / "chip_smoke.py", "chip_smoke")
    import torch

    def fig20(when):
        print(f"FIG20 {tree.name} {when} census {json.dumps(census())}",
              flush=True)
        try:
            ratio = smoke.fig20_async_learner(torch)["async_over_barrier"]
        except smoke.SmokeFailure as err:
            ratio = str(err)
        print(f"FIG20 {tree.name} {when} ratio {ratio}", flush=True)

    log = smoke.log

    def stop_at_phase(message):
        log(message)
        if message.startswith(f"phase {args.stop_at}:"):
            for thread in threading.enumerate():
                if thread.name == "nvcc-backward":
                    thread.join()
            for i in range(args.repeats):
                fig20(f"after_phases_1_{args.stop_at - 1}_{i}")
            raise Stop

    t0 = time.monotonic()
    fig20("fresh")
    smoke.log = stop_at_phase
    try:
        smoke.main()
    except Stop:
        pass
    print(f"FIG20 {tree.name} done in {time.monotonic() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
