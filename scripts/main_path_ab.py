"""Parts of ``chip_smoke.py`` on two checkouts of the repository, on one
card, in the order A, B, B, A, each run in a process of its own; then
their numbers side by side.

  python scripts/main_path_ab.py --a DIR --b DIR
                                 [--what main|decode|flash_forward|ssd|backward]
                                 [--out FILE]

``--a`` and ``--b`` are the roots of two checkouts (for example the parent
commit and the change, each unpacked with ``git archive``).  Each run
imports that checkout's ``chip_smoke.py`` and builds its kernels; the
functions' own checks hold, so a run fails as the phase would.  What runs:

- ``main`` (the default): phases 24 and 25, ``zoo_serving`` and
  ``training`` (the model zoo's serving path and training): tokens/s and
  step times;
- ``decode``: phase 5's decode attention rows, ``time_decode_serving``
  (the zoo's serving shapes), the long cache (b 64, s 2048) and the
  policy's serving shape (b 16, s 8), each against the plain version:
  device ms (a CUDA graph's replay), eager ms and CUDA launches a call;
- ``flash_forward``: phase 5's flash attention forward rows,
  ``time_flash``, ``time_flash_policy`` and ``time_flash_zoo`` (each call
  against the plain version): device ms (a CUDA graph's replay) and eager
  ms at the main paths' shapes;
- ``ssd``: the SSD scan's forward at Zamba2-1.2B's scoring shape (phase
  5) and at its training shape keeping its scratch for the backward (phase
  13's forward), and ``time_ssd_bwd`` at the training shape, each held to
  the plain version: device ms (a CUDA graph's replay), eager ms, and each
  launch's device ms (torch.profiler; rows named by the checkout's own
  kernels, so they appear in the records but not side by side);
- ``backward``: phase 13's timed backward shapes, ``time_flash_bwd`` at
  Zamba2's training shape (f32, d 64) and qwen3-1.7b's (d 128, f32 and
  bf16), ``time_ssd_bwd`` at Zamba2's, and the flash backward over every
  key at Whisper's encoder shape (f32, d 64; timed here by one function for
  both checkouts): device ms and eager ms.

The records go to ``--out`` (JSON) and the table to standard output, with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

PRELUDE = r"""
import json, re, sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention, flash_attention, ref, ssd_scan, vtrace
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
"""

RUNS = {"main": PRELUDE + r"""
kernels = [{"name": w.name, "wrapper": w, "source": m.SOURCE,
            "replaces": m.REPLACES}
           for m, w in ((decode_attention, decode_attention.decode_attention),
                        (vtrace, vtrace.vtrace),
                        (flash_attention, flash_attention.flash_attention),
                        (ssd_scan, ssd_scan.ssd_scan))]
# the backward kernels, in a checkout that has them
kernels += [{"name": w.name, "wrapper": w, "source": m.BWD_SOURCE,
             "replaces": m.REPLACES}
            for m, attr in ((flash_attention, "flash_attention_bwd"),
                            (ssd_scan, "ssd_scan_bwd"))
            for w in [getattr(m, attr, None)] if w is not None]
build.build([k["name"] for k in kernels])
t0 = time.monotonic()
serving = chip_smoke.zoo_serving(torch, kernels)
t24 = time.monotonic() - t0
t0 = time.monotonic()
trained = chip_smoke.training(torch, kernels)
t25 = time.monotonic() - t0
z = trained["zamba2"]
rows = {"zamba2 train tokens/s": z["tokens_per_s"],
        "zamba2 train step p50 ms": z["step_ms_p50"],
        "zamba2 train step p95 ms": z["step_ms_p95"],
        "zamba2 train first step ms": z["step_ms"][0],
        "zamba2 train device ms a step": z["profile"]["device_ms"],
        "zamba2 train peak GiB": z["peak_gib"]}
for row in serving["configs"]:
    name = f"{row['config']} {row['dtype']}/{row['cache_dtype']}"
    for key in ("prefill_tokens_per_s", "decode_tokens_per_s",
                "step_ms_p50", "step_ms_p95"):
        rows[f"{name} {key}"] = row[key]
print("AB_RESULT " + json.dumps({"seconds": {"phase 24": t24,
                                             "phase 25": t25},
                                 "rows": rows}))
""", "decode": PRELUDE + r"""
build.build(["decode_attention"])
decode = decode_attention.decode_attention
plan = decode_attention.plan_splits
t0 = time.monotonic()
timed = {row["label"]: row for row in chip_smoke.time_decode_serving(
    decode, ref, torch, plan)}
timed["long_cache"] = chip_smoke.time_decode_attention(decode, ref, torch,
                                                       plan, 64, 2048, 2048)
timed["policy"] = chip_smoke.time_decode_attention(decode, ref, torch, plan,
                                                   16, 8, 8)
rows = {}
for name, row in timed.items():
    rows[f"{name} ms"] = row["ms"]
    rows[f"{name} eager ms"] = row["eager_ms"]
    rows[f"{name} launches a call"] = row["cuda_launches_per_call"]
print("AB_RESULT " + json.dumps({"seconds": {"decode rows":
                                             time.monotonic() - t0},
                                 "rows": rows}))
""", "flash_forward": PRELUDE + r"""
build.build(["flash_attention"])
flash = flash_attention.flash_attention
t0 = time.monotonic()
timed = {"zamba2_scoring": chip_smoke.time_flash(
             flash, ref, torch, configs.get_arch(chip_smoke.ZAMBA)),
         "policy_learner": chip_smoke.time_flash_policy(flash, ref, torch)}
for row in chip_smoke.time_flash_zoo(flash, ref, torch):
    timed[row["path"]] = row
rows = {}
for name, row in timed.items():
    rows[f"{name} ms"] = row["ms"]
    rows[f"{name} eager ms"] = row["eager_ms"]
    for key in ("contiguous_ms", "cold_l2_ms", "library_ms"):
        if key in row:
            rows[f"{name} {key.replace('_ms', '')} ms"] = row[key]
print("AB_RESULT " + json.dumps({"seconds": {"flash rows":
                                             time.monotonic() - t0},
                                 "rows": rows}))
""", "ssd": PRELUDE + r"""
build.build(["ssd_scan", "ssd_scan_bwd"])
ssd, ssd_bwd = ssd_scan.ssd_scan, ssd_scan.ssd_scan_bwd
zamba = configs.get_arch(chip_smoke.ZAMBA)
ssm = zamba.ssm
h, p, n, chunk = (ssm.num_heads(zamba.d_model), ssm.head_dim, ssm.d_state,
                  ssm.chunk_size)
t0 = time.monotonic()
rows = {}
for label, (b, s), keep in (
        ("forward scoring", (chip_smoke.ZAMBA_BATCH, chip_smoke.ZAMBA_SEQ),
         False),
        ("forward training keep", chip_smoke.TRAIN_ZAMBA_SHAPE, True)):
    inputs = chip_smoke.ssd_inputs(
        b, s, h, p, n, chip_smoke.np.random.RandomState(chip_smoke.SEED + 8),
        model_like=True)

    def fwd():
        return ssd(*inputs, chunk, None, keep=keep)
    y, final = fwd()[:2]
    y_ref, final_ref = ref.ssd_scan_ref(*inputs, chunk)
    err = max(((a - e).abs().max() / (e.abs().max() + 1.0)).item()
              for a, e in ((y, y_ref), (final, final_ref)))
    assert err <= chip_smoke.SSD_PATH_TOL, (label, err)
    del y, final, y_ref, final_ref
    rows[f"{label} ms"] = chip_smoke.time_ms(fwd, warmup=3, launches=20,
                                             graph=True)
    rows[f"{label} eager ms"] = chip_smoke.time_ms(fwd, warmup=3,
                                                   launches=20, graph=False)
    for i, (name, ms) in enumerate(chip_smoke.profiled_kernels(torch, fwd)
                                   or []):
        kernel = re.search(r"ssd_\w+?_kernel", name)
        rows[f"{label} launch {i} {kernel.group(0) if kernel else name} ms"] \
            = ms
bwd = chip_smoke.time_ssd_bwd(torch, ref, ssd, ssd_bwd, zamba)
rows["backward training ms"] = bwd["ms"]
rows["backward training eager ms"] = bwd["eager_ms"]
for name, ms in bwd["device_ms_by_kernel"].items():
    rows[f"backward training launch {name} ms"] = ms
print("AB_RESULT " + json.dumps({"seconds": {"ssd rows":
                                             time.monotonic() - t0},
                                 "rows": rows}))
""", "backward": PRELUDE + r"""
build.build(["flash_attention", "flash_attention_bwd", "ssd_scan",
             "ssd_scan_bwd"])
flash = flash_attention.flash_attention
flash_bwd = flash_attention.flash_attention_bwd
zamba = configs.get_arch(chip_smoke.ZAMBA)
dense = configs.get_arch(chip_smoke.TRAIN_DENSE)
b, s = chip_smoke.TRAIN_ZAMBA_SHAPE
db, ds = chip_smoke.TRAIN_DENSE_SHAPE
t0 = time.monotonic()
timed = {"flash zamba2_train float32": chip_smoke.time_flash_bwd(
    torch, ref, flash, flash_bwd, "zamba2_train", b, zamba.num_heads,
    zamba.num_kv_heads, s, zamba.head_dim, "float32", zamba.sliding_window)}
for name in ("float32", "bfloat16"):
    timed[f"flash qwen3_1_7b {name}"] = chip_smoke.time_flash_bwd(
        torch, ref, flash, flash_bwd, "qwen3_1_7b", db, dense.num_heads,
        dense.num_kv_heads, ds, dense.head_dim, name, dense.sliding_window)
timed["ssd zamba2_train float32"] = chip_smoke.time_ssd_bwd(
    torch, ref, ssd_scan.ssd_scan, ssd_scan.ssd_scan_bwd, zamba)


def every_key(b, h, kv, s, d):
    # attention over every key, timed by the same code in both checkouts;
    # the grads held to the plain backward at GRAD_TOL and a repeat
    rng = chip_smoke.np.random.RandomState(chip_smoke.SEED + 32)
    q, k, v = chip_smoke.flash_inputs(b, h, kv, s, s, d, torch.float32, rng)
    g = torch.as_tensor(rng.randn(b, h, s, d).astype("float32")).cuda()
    out, lse = flash(q, k, v, False, None, with_lse=True)
    grads = flash_bwd(q, k, v, out, lse, g, False, None)
    again = flash_bwd(q, k, v, out, lse, g, False, None)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=False)
    scaled = max(chip_smoke.grad_scaled_err(a, e)
                 for a, e in zip(grads, plain))
    assert all(torch.equal(a, r) for a, r in zip(grads, again))
    assert scaled <= chip_smoke.GRAD_TOL, scaled

    def bwd():
        return flash_bwd(q, k, v, out, lse, g, False, None)
    return {"ms": chip_smoke.time_ms(bwd, warmup=3, launches=20, graph=True),
            "eager_ms": chip_smoke.time_ms(bwd, warmup=3, launches=20,
                                           graph=False)}


for label, b_, h, kv, sq, sk, d, causal, _ in chip_smoke.FLASH_ZOO:
    if label == "whisper_encoder":
        timed[f"flash {label} float32"] = every_key(b_, h, kv, sq, d)
rows = {}
for name, row in timed.items():
    rows[f"{name} ms"] = row["ms"]
    rows[f"{name} eager ms"] = row["eager_ms"]
print("AB_RESULT " + json.dumps({"seconds": {"backward rows":
                                             time.monotonic() - t0},
                                 "rows": rows}))
"""}


def run(root: Path, what: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUNS[what], str(root)],
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
    p.add_argument("--what", choices=sorted(RUNS), default="main")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    order = [("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)]
    runs = []
    for label, root in order:
        runs.append({"label": label, "root": str(root),
                     **run(root.resolve(), args.what)})
        print(f"{label} done: " + ", ".join(
            f"{part} {seconds:.1f} s"
            for part, seconds in runs[-1]["seconds"].items()), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "what": args.what,
                                        "runs": runs}, indent=1))
    print(f"card: {card}; {args.what}; order A, B, B, A; each cell 'first, "
          f"second' run")
    for name in runs[0]["rows"]:
        if any(name not in r["rows"] for r in runs):
            continue  # a row one checkout does not time
        a = [r["rows"][name] for r in runs if r["label"] == "A"]
        b = [r["rows"][name] for r in runs if r["label"] == "B"]
        if any(v is None for v in a + b):
            continue  # a launch the profiler did not record
        print(f"{name}: A {a[0]:.6g}, {a[1]:.6g} (mean "
              f"{statistics.mean(a):.6g}); B {b[0]:.6g}, {b[1]:.6g} (mean "
              f"{statistics.mean(b):.6g}); B/A "
              f"{statistics.mean(b) / statistics.mean(a):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
