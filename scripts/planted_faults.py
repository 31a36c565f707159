"""Control readings for ``chip_smoke.py`` phase 23's parity rules: the model
zoo's first batch scored through flash kernels that carry a planted fault,
each read against the plain route by the rules phase 23 applies.

A rule that a wrong kernel also passes checks nothing.  The faults:

- ``wrong_kv_head``: query head i reads KV head (i // group + 1) mod kv;
- ``last_key_tile_dropped``: a query tile that walks two or more key
  tiles skips its last one (under the causal mask, the diagonal tile);
- ``own_key_masked``: the causal mask hides key i from query i too.

Each faulted kernel is built from a copy of ``csrc/flash_attention.cu``
edited as text, into ``src/repro_torch/kernels/_build/probe/`` (which git
ignores), as ``scripts/tensor_core_probe.py`` builds its variants: the
package's sources are never touched.  The committed kernel is read first,
as the control.  For each config and kernel: the largest |d last_logits|
over the largest plain |logit| beside the rule
(``chip_smoke.ZOO_LOGIT_REL_TOL``), the greedy actions that differ, for MoE
the tokens that some layer routes to another expert beside
``chip_smoke.MOE_REROUTED_MAX``, and whether ``chip_smoke.compare_scoring``
passes.  Configs are phase 23's, at full width and depth, from its seed.

    PYTHONPATH=src python scripts/planted_faults.py [--configs NAME ...]
        [--json PATH]

Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke  # noqa: E402  (phase 23's inputs, routes and rules)
import tensor_core_probe as tcp  # noqa: E402  (variant build and binding)
from repro_torch.kernels import build  # noqa: E402

# fault: (text of the committed kernel, its replacement)
FAULTS = {
    "wrong_kv_head": ("kv_head = head / (h / kv);",
                      "kv_head = (head / (h / kv) + 1) % kv;"),
    "last_key_tile_dropped": (
        "n_tiles = (k_end - k_begin + BN - 1) / BN;",
        "n_tiles = max(1, (k_end - k_begin + BN - 1) / BN - 1);"),
    "own_key_masked": ("causal && (j > i ||", "causal && (j >= i ||"),
}


def fault_sources(name):
    """{file name: text}: the flash kernel's source with fault ``name``."""
    old, new = FAULTS[name]
    text = (build.CSRC / "flash_attention.cu").read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"fault {name}: flash_attention.cu holds {old!r} "
                           f"{text.count(old)} times, not once")
    return {"flash_attention.cu": text.replace(old, new)}


def readings(torch, name, dtype_name, kernels):
    """The first batch of config ``name`` on the plain route, then on each
    of ``kernels`` ({fault: flash wrapper}), read by phase 23's rules."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    cfg = configs.get_arch(name)
    dtype = getattr(torch, dtype_name)
    generator = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    params = transformer.init(generator, cfg, device="cuda", dtype=dtype)
    text = (chip_smoke.WHISPER_TEXT if cfg.arch_type == "audio"
            else chip_smoke.ZOO_SEQ - cfg.vision_tokens)
    batch = chip_smoke.zoo_batches(torch, cfg, dtype, chip_smoke.ZOO_BATCH,
                                   text, 1)[0]
    step = make_prefill_step(cfg)
    (plain, feats), plain_choices = chip_smoke.router_choices(
        lambda: chip_smoke.plain_scoring(torch, step, params, batch))
    rule = chip_smoke.ZOO_LOGIT_REL_TOL[dtype_name]
    largest = plain["last_logits"][:, :cfg.vocab_size].abs().max().item()
    rows = []
    for fault, kernel in kernels.items():
        with mock.patch.object(ops, "_flash", kernel):
            out, choices = chip_smoke.router_choices(
                lambda: step(params, batch))
        err = (out["last_logits"].float()
               - plain["last_logits"].float()).abs().max().item()
        row = {"config": name, "dtype": dtype_name, "fault": fault,
               "rel_err": err / largest, "rule": rule,
               "actions_differing": int((out["actions"]
                                         != plain["actions"]).sum()),
               "positions": out["actions"].numel()}
        rerouted = None
        if cfg.arch_type == "moe":
            routing, rerouted = chip_smoke.differing_choices(
                torch, cfg, choices, plain_choices, out["actions"].shape)
            row.update(routing, rerouted_tokens=int(rerouted.sum()),
                       rerouted_max=chip_smoke.MOE_REROUTED_MAX)
        try:
            chip_smoke.compare_scoring(torch, cfg, params, out, plain, feats,
                                       rule, f"{name} {fault}", rerouted)
            row["passes"] = True
        except chip_smoke.SmokeFailure as failure:
            row.update(passes=False, failure=str(failure))
        chip_smoke.log(f"  {json.dumps(row)}")
        rows.append(row)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--configs", nargs="+",
                        default=[name for name, _, _ in chip_smoke.ZOO])
    parser.add_argument("--json", type=Path, help="write the results here")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("planted_faults: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"card: {card}; torch {torch.__version__} cuda "
                   f"{torch.version.cuda}")
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     flash_attention)
    build.build(["flash_attention"])
    built = tcp.build_all({f"flash_attention-{fault}": fault_sources(fault)
                           for fault in FAULTS})
    kernels = {"none": flash_attention}
    kernels.update({fault: tcp.variant_wrapper(
        FlashAttention, built[f"flash_attention-{fault}"])
        for fault in FAULTS})
    dtypes = {name: dtype for name, dtype, _ in chip_smoke.ZOO}
    rows = []
    for name in args.configs:
        rows += readings(torch, name, dtypes[name], kernels)
        gc.collect()
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "rows": rows},
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
