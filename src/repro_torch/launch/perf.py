"""Perf hillclimbing driver: run tagged dry-run variants of a combo and log
hypothesis -> change -> before/after roofline terms to JSONL.

Each variant is one ``repro_torch.launch.dryrun.run_combo`` trace on a fake
256- or 512-rank mesh (the plain route; predictions against the NVIDIA
H100 datasheet figures of ``repro_torch.launch.mesh``, not measurements).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --pair qwen3-1.7b:train_4k \
      --variant remat=dots --tag H1-dots
"""
import argparse
import json
import os
import sys
import time

import torch

from repro_torch.launch.dryrun import run_combo

DTYPES = {"bf16": torch.bfloat16, "f8": torch.float8_e4m3fn,
          "f32": torch.float32}


def parse_variant(tokens):
    kw = {}
    rules = {}
    for tok in tokens or []:
        k, v = tok.split("=", 1)
        if k == "remat":
            kw["remat"] = v
        elif k == "microbatches":
            kw["microbatches"] = int(v)
        elif k == "cache_dtype":
            kw["cache_dtype"] = DTYPES[v]
        elif k == "cache_layout":
            kw["cache_layout"] = v
        elif k == "moe_group":
            kw["moe_group"] = int(v)
        elif k == "moe_cf":
            kw["moe_cf"] = float(v)
        elif k == "objective":
            kw["objective"] = v
        elif k.startswith("rule."):
            rules[k[5:]] = None if v in ("none", "None") else v
        else:
            raise ValueError(tok)
    if rules:
        kw["rules_overrides"] = rules
    return kw


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pair", required=True, help="arch:shape")
    p.add_argument("--mesh", default="single")
    p.add_argument("--variant", nargs="*", default=[])
    p.add_argument("--tag", required=True)
    p.add_argument("--out", default="results/perf_iterations.jsonl")
    args = p.parse_args(argv)

    arch, shape = args.pair.split(":")
    kw = parse_variant(args.variant)
    t0 = time.time()
    rec = run_combo(arch, shape, args.mesh, tag=args.tag, **kw)
    rec["variant_args"] = args.variant
    rec["wall_s"] = round(time.time() - t0, 1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    if rec["status"] == "ok":
        r = rec["roofline"]
        m = rec["memory"]
        print(f"[{args.tag}] {arch} x {shape}: dom={r['dominant']}"
              f" c={r['compute_s']:.4f} m={r['memory_s']:.4f}"
              f" n={r['collective_s']:.4f} useful={r['useful_flops_ratio']:.2f}"
              f" live={m['approx_live_bytes']/2**30:.1f}GB fits={m['fits_hbm']}")
    else:
        print(f"[{args.tag}] {rec['status']}: {rec.get('error','')[:200]}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
