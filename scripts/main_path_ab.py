"""Phases 24 and 25 of ``chip_smoke.py`` (the model zoo's serving path and
training) on two checkouts of the repository, on one card, in the order
A, B, B, A, each run in a process of its own; then their tokens/s and
step times side by side.

  python scripts/main_path_ab.py --a DIR --b DIR [--out FILE]

``--a`` and ``--b`` are the roots of two checkouts (for example the parent
commit and the change, each unpacked with ``git archive``).  Each run
imports that checkout's ``chip_smoke.py``, builds its kernels and calls
its ``zoo_serving`` and ``training``: their own checks hold, so a run
fails as the phase would.  The records go to ``--out`` (JSON) and the
table to standard output, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention, flash_attention, ssd_scan, vtrace
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels = [{"name": w.name, "wrapper": w, "source": m.SOURCE,
            "replaces": m.REPLACES}
           for m, w in ((decode_attention, decode_attention.decode_attention),
                        (vtrace, vtrace.vtrace),
                        (flash_attention, flash_attention.flash_attention),
                        (ssd_scan, ssd_scan.ssd_scan))]
build.build([k["name"] for k in kernels])
t0 = time.monotonic()
serving = chip_smoke.zoo_serving(torch, kernels)
t24 = time.monotonic() - t0
t0 = time.monotonic()
trained = chip_smoke.training(torch, kernels)
t25 = time.monotonic() - t0
z = trained["zamba2"]
out = {"phase24_s": t24, "phase25_s": t25, "serving": [
    {k: row[k] for k in ("config", "dtype", "cache_dtype",
                         "prefill_tokens_per_s", "decode_tokens_per_s",
                         "step_ms_p50", "step_ms_p95")}
    for row in serving["configs"]],
    "zamba2": {"tokens_per_s": z["tokens_per_s"],
               "step_ms_p50": z["step_ms_p50"],
               "step_ms_p95": z["step_ms_p95"],
               "first_step_ms": z["step_ms"][0],
               "device_ms": z["profile"]["device_ms"],
               "peak_gib": z["peak_gib"]}}
print("AB_RESULT " + json.dumps(out))
"""


def run(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, str(root)],
                          cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"run in {root} exited {proc.returncode}")
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("AB_RESULT ")][-1]
    return json.loads(line[len("AB_RESULT "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--a", required=True, type=Path)
    p.add_argument("--b", required=True, type=Path)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    order = [("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)]
    runs = []
    for label, root in order:
        runs.append({"label": label, "root": str(root), **run(root.resolve())})
        print(f"{label} done: phase 24 {runs[-1]['phase24_s']:.1f} s, "
              f"phase 25 {runs[-1]['phase25_s']:.1f} s", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs},
                                       indent=1))

    def both(label, get):
        return [get(r) for r in runs if r["label"] == label]

    print(f"card: {card}; order A, B, B, A; each cell 'first, second' run")
    rows = [("zamba2 train tokens/s", lambda r: r["zamba2"]["tokens_per_s"]),
            ("zamba2 train step p50 ms", lambda r: r["zamba2"]["step_ms_p50"]),
            ("zamba2 train step p95 ms", lambda r: r["zamba2"]["step_ms_p95"]),
            ("zamba2 train first step ms",
             lambda r: r["zamba2"]["first_step_ms"]),
            ("zamba2 train device ms a step",
             lambda r: r["zamba2"]["device_ms"])]
    for i, row in enumerate(runs[0]["serving"]):
        name = f"{row['config']} {row['dtype']}/{row['cache_dtype']}"
        for key in ("prefill_tokens_per_s", "decode_tokens_per_s",
                    "step_ms_p50", "step_ms_p95"):
            rows.append((f"{name} {key}",
                         lambda r, i=i, key=key: r["serving"][i][key]))
    for name, get in rows:
        a, b = both("A", get), both("B", get)
        print(f"{name}: A {a[0]:.3f}, {a[1]:.3f} (mean "
              f"{statistics.mean(a):.3f}); B {b[0]:.3f}, {b[1]:.3f} (mean "
              f"{statistics.mean(b):.3f}); B/A {statistics.mean(b) / statistics.mean(a):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
