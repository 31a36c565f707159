"""Decode attention's time on the card at every split count, beside the
split plan's choice: the numbers ``kernels/decode_attention.py``'s
``TARGET_BLOCKS`` are read from.

  python scripts/decode_plan_sweep.py [--out FILE]

For each shape and dtype pair (the zoo's serving shapes at 8 slots over
384 keys, Whisper's cross-attention over 1500 frames, the long cache and
the policy's shape), the kernel runs with the cache cut into 1 to 12
ranges (up to 8 merge in a cluster, more in a second launch), each call
held to the plain version, and is timed by CUDA events over a CUDA graph's
replay (``chip_smoke.time_ms``).  Prints one line a shape with the card's
name and power limit, and writes the records to ``--out`` (JSON).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPLITS = (1, 2, 3, 4, 5, 6, 8, 12)
# (label, b, h, kv, s, d, q dtype, cache dtype)
SHAPES = [("internvl2_26b", 8, 48, 8, 384, 128, "bfloat16", "bfloat16"),
          ("qwen3_1_7b", 8, 16, 8, 384, 128, "float32", "float32"),
          ("qwen3_1_7b_bf16_cache", 8, 16, 8, 384, 128, "float32",
           "bfloat16"),
          ("granite_moe", 8, 24, 8, 384, 64, "float32", "float32"),
          ("zamba2_1_2b", 8, 32, 32, 384, 64, "float32", "float32"),
          ("whisper_base", 8, 8, 8, 384, 64, "float32", "float32"),
          ("whisper_cross", 8, 8, 8, 1500, 64, "float32", "float32"),
          ("long_cache", 64, 4, 2, 2048, 64, "float32", "float32"),
          ("policy", 16, 4, 2, 8, 64, "float32", "float32")]


def sweep(torch, chip_smoke, decode_module, ref, label, b, h, kv, s, d,
          dtype, kv_dtype):
    """{splits: device ms} for one shape, and the plan's splits."""
    rng = chip_smoke.np.random.RandomState(chip_smoke.SEED + 1)
    q, k, v, lens = chip_smoke.decode_inputs(b, h, kv, s, d, [s] * b,
                                             torch.float32, rng)
    q = q.to(getattr(torch, dtype))
    k, v = k.to(getattr(torch, kv_dtype)), v.to(getattr(torch, kv_dtype))
    fn = decode_module.decode_attention._kernel()
    expected = ref.decode_attention_ref(q, k, v, lens).float()
    tol = chip_smoke.TOL[dtype]
    times = {}
    for splits in SPLITS:
        per_split = -(-s // splits)
        if (splits - 1) * per_split >= s:
            continue  # fewer ranges than asked for would cover s
        out = torch.empty_like(q)
        part = torch.empty(splits * b * h * (d + 2), device="cuda")

        def call():
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lens.data_ptr(), out.data_ptr(), part.data_ptr(), b, h,
                      s, kv, d, decode_module._DTYPES[q.dtype],
                      decode_module._DTYPES[k.dtype], splits, per_split,
                      d ** -0.5, torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"{label}: launch at {splits} splits "
                                   f"returned {code}")
        call()
        torch.cuda.synchronize()
        err = (out.float() - expected).abs().max().item()
        if err > tol:
            raise RuntimeError(f"{label} at {splits} splits: max_abs_err "
                               f"{err} > {tol}")
        times[splits] = chip_smoke.time_ms(call)
    plan = decode_module.plan_splits(b, kv, s, d, q.dtype, k.dtype)
    return {"label": label, "shape": [b, h, kv, s, d, dtype, kv_dtype],
            "plan": list(plan), "ms": times,
            "best_splits": min(times, key=times.get)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as decode_module
    if not torch.cuda.is_available():
        print("decode_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    build.build(["decode_attention"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    records = []
    for shape in SHAPES:
        record = sweep(torch, chip_smoke, decode_module, ref, *shape)
        records.append(record)
        cells = ", ".join(f"{n}: {ms * 1e3:.3f}" for n, ms in
                          record["ms"].items())
        print(f"{record['label']}: plan {record['plan'][0]} splits; "
              f"us by splits {{{cells}}}; best {record['best_splits']}",
              flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "records": records},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
