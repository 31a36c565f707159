"""Multi-pod dry run: trace every (arch x input-shape x mesh) combo on one rank
of a fake 256- or 512-rank mesh.

Proves the distribution config is coherent without hardware: initialises a
fake process group (``torch.testing._internal.distributed.fake_pg``) of the
production mesh's size (16x16 single-pod / 2x16x16 multi-pod), distributes
the params, the ZeRO-1 optimizer state, the batch and the cache as
``DTensor``s over fake tensors by the port's shardings, and runs the
train/prefill/serve step once under the logical-axis rules.  Nothing is
allocated and nothing is launched: every tensor is a ``FakeTensor`` on the
CPU, so the model runs the PLAIN route (``kernels/ref.py``), not the card's
kernels, and the record says so (``"route": "plain"``).  A
:class:`repro_torch.launch.hlo_analysis.LocalCounter` counts rank 0's local
program (FLOPs, bytes, collectives, peak live bytes), and the roofline
terms divide them by the NVIDIA H100 datasheet figures of
``repro_torch.launch.mesh``: every figure here is a prediction, not a
measurement of the card.  Records go to a JSONL file.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import sharding as shlib
from repro_torch import tree
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, get_shape
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_CHIP, IB_BW,
                                     PEAK_FLOPS_BF16, make_production_mesh)
from repro_torch.launch.param_sharding import tree_shardings
from repro_torch.launch.specs import (decode_specs, fake_mode, input_specs,
                                      params_specs)
from repro_torch.launch.steps import (TrainState, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.optim import adam

SKIPS = {
    # (arch, shape): reason — recorded, not silently dropped.
    ("whisper-base", "long_500k"):
        "enc-dec full attention; no sub-quadratic variant in family (DESIGN.md)",
}

# Per-combo production configs that bound each rank's live bytes (the
# predicted peak is held to the card's HBM_PER_CHIP).
COMBO_OVERRIDES = {
    # 7B-class decode with 128 x 32k contexts: f8 KV cache + unrolled layers
    ("codeqwen1.5-7b", "decode_32k"): dict(cache_dtype="f8",
                                           cache_layout="list"),
    ("deepseek-7b", "decode_32k"): dict(cache_dtype="f8",
                                        cache_layout="list"),
    ("internvl2-26b", "decode_32k"): dict(cache_dtype="f8",
                                          cache_layout="list"),
    # MoE with tiny experts: 16 microbatches to bound activation live-set
    ("granite-moe-3b-a800m", "train_4k"): dict(microbatches=16),
}
# dense/moe/vlm archs run long_500k with the sliding-window variant.
SLIDING_WINDOW_FOR_LONG = 8192

# mesh kind -> (shape, axis names), as make_production_mesh builds them
MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


def batch_shardings(rules, specs):
    def spec_for(path, x):
        nd = len(x.shape)
        if nd == 0:
            return rules.named_sharding((), ())
        logical = ["batch"] + [None] * (nd - 1)
        return rules.named_sharding(tuple(logical), tuple(x.shape))
    return tree.map_with_path(spec_for, specs)


def cache_shardings(rules, cache_specs):
    """Decode caches: (layers, batch, length, kv_heads, head_dim) KV tensors,
    (layers, batch, heads, state, head_dim) SSM states, conv states."""
    def spec_for(path, x):
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path
                 if not isinstance(p, tree.SequenceKey)]
        leaf = str(names[-1]) if names else ""
        nd = len(x.shape)

        def align(core):
            """Right-align the core logical axes; pad front with 'layers'."""
            if nd <= len(core):
                return core[-nd:]
            return ["layers"] * (nd - len(core)) + core

        if leaf in ("k", "v") or leaf.startswith("cross"):
            log = align(["batch", "kv_seq", "kv_heads", "head_dim"])
        elif leaf == "state":
            log = align(["batch", "ssm_heads", "ssm_state", None])
        elif leaf == "conv":
            log = align(["batch", None, "ff"])
        else:
            log = [None] * nd
        return rules.named_sharding(tuple(log), tuple(x.shape))
    return tree.map_with_path(spec_for, cache_specs)


def model_flops_analytic(cfg, shape):
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), N = active params."""
    n = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch     # decode: one token per sequence


# ------------------------------------------------------------ distributing
def _local_shape(shape, mesh, placements):
    """Rank 0's shard of a tensor of global ``shape`` (the rules shard only
    dims that every mesh axis on them divides)."""
    out = list(shape)
    for mesh_dim, p in enumerate(placements):
        if p.is_shard():
            size = mesh.size(mesh_dim)
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide mesh dim {mesh_dim} ({size})")
            out[p.dim] //= size
    return out


def _contiguous_stride(shape):
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def distribute(specs, shardings, mesh):
    """A ``DTensor`` over a fake local shard for every fake leaf of
    ``specs``, placed by the matching leaf of ``shardings``."""
    from torch.distributed.tensor import DTensor

    def one(x, placements):
        shape = tuple(x.shape)
        with fake_mode():
            local = torch.empty(_local_shape(shape, mesh, placements),
                                dtype=x.dtype, device="cpu")
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    return tree.map(one, specs, shardings)


# ------------------------------------------------------- DTensor's rules
# What the dry run sets in DTensor's sharding rules while a combo traces
# (a record's ``dtensor_rules``), where a torch lacks the rule or its own
# rule cannot take what the step gives:
#
# * ``scatter_(dim, index, src)`` with self, index and src sharded alike on
#   another dim is local to each rank (the decode step writes its cache
#   slots so);
# * ``argmax``/``argmin`` over a sharded dim take DTensor's reduction rule
#   (gather the dim, then reduce), not its own handler, which fails on a
#   batch of one row (long_500k's decode);
# * ``flip`` keeps a shard of every dim it does not flip (the backward of
#   the SSM's ``cumsum``): one rule on every torch, which not every torch
#   has;
# * ``view`` and ``_unsafe_view`` keep DTensor's own strategy, and reshard
#   their input as ``reshape`` does only where that strategy refuses (it
#   cannot flatten a sharded dim into a dim before it on every torch, and
#   ``matmul`` flattens a sharded batch so).
#
# Any other op without a rule fails the combo, and the record's error
# names it.


def _strict_first(strict, relaxed):
    """A view's strategy: DTensor's own, which keeps every shard it can;
    where that refuses to reshard, the one that reshards as ``reshape``."""
    def strategy(*args, **kwargs):
        try:
            return strict(*args, **kwargs)
        except RuntimeError:
            return relaxed(*args, **kwargs)
    return strategy


@contextlib.contextmanager
def dtensor_rules():
    """Set the rules above in DTensor's tables while the block runs; yield
    their names, and put every table back as it was after the block."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._ops._view_ops import (
        RuntimeSchemaInfo, register_op_strategy_map)
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten
    dispatcher = DTensor._op_dispatcher
    prop = dispatcher.sharding_propagator
    tables = [getattr(dispatcher, "_custom_op_handlers", {})] + [
        t for name, t in vars(prop).items()
        if name.startswith("op_") and isinstance(t, dict)]
    saved = [dict(t) for t in tables]
    names = ["sharded aten.scatter_.src"]

    def scatter_rule(self, dim, index, src):
        dim = dim % len(self.shape)
        out = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
        for d in range(len(self.shape)):
            if d != dim:
                out.append(([Shard(d)], [Shard(d), None, Shard(d), Shard(d)]))
        return out

    def flip_rule(self, dims):
        flipped = {d % len(self.shape) for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None])
            for d in range(len(self.shape)) if d not in flipped]

    try:
        register_sharding(aten.scatter_.src)(scatter_rule)
        for op in (aten.argmax.default, aten.argmin.default):
            if tables[0].pop(op, None) is not None:
                names.append(f"reduction {op}")
        for table in tables:
            table.pop(aten.flip.default, None)
        register_sharding(aten.flip.default)(flip_rule)
        # the flipped dims are part of the rule's cache key
        prop.op_to_schema_info[aten.flip.default] = RuntimeSchemaInfo(1)
        names.append("sharded aten.flip.default")
        for op in (aten.view.default, aten._unsafe_view.default):
            strict = prop.op_strategy_funcs[op]
            register_op_strategy_map(op, torch.Tensor.view,
                                     schema_info=RuntimeSchemaInfo(1),
                                     strict_view=False)
            prop.op_strategy_funcs[op] = _strict_first(
                strict, prop.op_strategy_funcs[op])
            names.append(f"relaxed view {op}")
        prop.propagate_op_sharding.cache_clear()
        yield names
    finally:
        for table, entries in zip(tables, saved):
            table.clear()
            table.update(entries)
        prop.propagate_op_sharding.cache_clear()


# ------------------------------------------------------------------ steps
def build_step_and_args(cfg, shape, rules, objective="bc", remat="full",
                        microbatches=8, cache_dtype=torch.bfloat16,
                        cache_layout="stacked", param_dtype=torch.bfloat16):
    """The step function and its ``DTensor`` arguments on ``rules.mesh``."""
    mesh = rules.mesh
    pspecs = params_specs(cfg, param_dtype)
    psh = tree_shardings(pspecs, rules)
    repl = rules.named_sharding((), ())

    if shape.kind == "train":
        opt = adam(1e-4, clip=1.0)
        step_fn = make_train_step(cfg, opt, objective=objective, remat=remat,
                                  microbatches=microbatches)
        with fake_mode():
            opt_specs = opt.init(pspecs)
            step0 = torch.zeros((), dtype=torch.int32)
        opt_sh = tree_shardings(opt_specs, rules, zero=True)   # ZeRO-1
        params = distribute(pspecs, psh, mesh)
        state = TrainState(
            params, distribute(opt_specs, opt_sh, mesh),
            distribute(step0, repl, mesh),
            distribute(pspecs, psh, mesh) if objective == "dqn" else None)
        batch = input_specs(cfg, shape)
        batch = distribute(batch, batch_shardings(rules, batch), mesh)
        return step_fn, (state, batch)

    params = distribute(pspecs, psh, mesh)
    if shape.kind == "prefill":
        step_fn = make_prefill_step(cfg)
        batch = input_specs(cfg, shape)
        batch = distribute(batch, batch_shardings(rules, batch), mesh)
        return step_fn, (params, batch)

    # decode, on the JAX package's default decode path ("jnp")
    step_fn = make_serve_step(cfg, backend="grouped")
    d = decode_specs(cfg, shape, cache_dtype=cache_dtype, layout=cache_layout)
    cache = distribute(d["cache"], cache_shardings(rules, d["cache"]), mesh)
    token = distribute(d["token"], rules.named_sharding(
        ("batch", None), tuple(d["token"].shape)), mesh)
    pos = distribute(d["pos"], repl, mesh)
    return step_fn, (params, cache, token, pos)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0), destroyed on exit: no rank but this one exists, and collectives
    return at once."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _make_mesh(mesh_kind):
    if mesh_kind in ("single", "multi"):
        return make_production_mesh(multi_pod=(mesh_kind == "multi"))
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = mesh_kind
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _trace(step_fn, args, rules):
    """Run ``step_fn(*args)`` once on fake DTensors under ``rules`` and a
    fresh counter; returns the counter."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = hlo_analysis.LocalCounter()
    with counter, shlib.use_rules(rules), implicit_replication():
        counter.track(args)
        step_fn(*args)
    return counter


def run_combo(arch_name, shape_name, mesh_kind, objective="bc", remat="full",
              rules_overrides=None, tag="baseline", microbatches=8,
              cache_dtype=torch.bfloat16, cache_layout="stacked",
              moe_group=None, moe_cf=None, cfg=None, shape=None,
              param_dtype=torch.bfloat16):
    """Trace one combo and return its record.  ``mesh_kind`` is
    ``"single"``, ``"multi"`` or ``(shape, axis names)`` of another fake
    mesh; ``cfg`` and ``shape`` replace the named arch's config and input
    shape (the names stay the record's); ``param_dtype`` is the params'
    (bfloat16, as the JAX package's dry run)."""
    cfg = cfg or get_arch(arch_name)
    if cfg.moe is not None and (moe_group or moe_cf):
        moe_updates = {}
        if moe_group:
            moe_updates["group_size"] = moe_group
        if moe_cf:
            moe_updates["capacity_factor"] = moe_cf
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_updates))
    shape = shape or get_shape(shape_name)
    rec = {"arch": arch_name, "shape": shape_name,
           "mesh": mesh_kind if isinstance(mesh_kind, str) else
           "x".join(map(str, mesh_kind[0])),
           "objective": objective if shape.kind == "train" else shape.kind,
           "tag": tag, "route": "plain"}
    ov = COMBO_OVERRIDES.get((arch_name, shape_name))
    if ov:
        rec["combo_overrides"] = {k: str(v) for k, v in ov.items()}
        if "cache_dtype" in ov:
            cache_dtype = torch.float8_e4m3fn if ov["cache_dtype"] == "f8" \
                else cache_dtype
        cache_layout = ov.get("cache_layout", cache_layout)
        microbatches = ov.get("microbatches", microbatches)
    if (arch_name, shape_name) in SKIPS:
        rec["status"] = "skipped"
        rec["reason"] = SKIPS[(arch_name, shape_name)]
        return rec
    if shape_name == "long_500k":
        if cfg.arch_type in ("dense", "moe", "vlm"):
            cfg = dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_FOR_LONG)
            rec["variant"] = f"sliding_window={SLIDING_WINDOW_FOR_LONG}"

    mesh_shape, mesh_names = (MESHES[mesh_kind] if isinstance(mesh_kind, str)
                              else mesh_kind)
    n_chips = math.prod(mesh_shape)
    model_size = dict(zip(mesh_names, mesh_shape)).get("model", 1)
    overrides = dict(rules_overrides or {})
    if shape.kind == "decode" and cfg.num_kv_heads % model_size != 0:
        # KV heads don't divide the model axis: shard the cache's head_dim
        # instead (scores become sharded partial sums over head_dim — the
        # all-reduce follows; the cache update stays local).
        overrides.setdefault("kv_seq", None)
        overrides.setdefault("head_dim", "model")
        rec["kv_layout"] = "headdim-sharded"
    if cfg.num_heads and cfg.num_heads % model_size != 0:
        # heads don't divide the model axis: sequence-parallel attention
        # (otherwise attention compute replicates onto every rank).
        # Un-chunked seq-par scores are (rows/dev, h, sq/model, sk) f32 —
        # only enable when that buffer stays well under HBM (train is
        # microbatched; prefill only at <=1 row per device).
        data_shards = n_chips // model_size
        rows_per_dev = max(shape.global_batch // data_shards, 1)
        mb = microbatches if shape.kind == "train" else 1
        score_gb = (rows_per_dev / mb) * cfg.num_heads * \
            (shape.seq_len / model_size) * shape.seq_len * 4 / 2 ** 30
        if shape.kind in ("train", "prefill") and score_gb <= 8.0:
            overrides.setdefault("q_seq", "model")
            rec["attn_layout"] = "seq-parallel"

    t0 = time.time()
    try:
        with fake_process_group(n_chips), dtensor_rules() as added:
            rec["dtensor_rules"] = added
            mesh = _make_mesh(mesh_kind)
            rules = shlib.ShardingRules(mesh, overrides)
            with shlib.use_rules(rules):
                step_fn, args = build_step_and_args(
                    cfg, shape, rules, objective=objective, remat=remat,
                    microbatches=microbatches, cache_dtype=cache_dtype,
                    cache_layout=cache_layout, param_dtype=param_dtype)
            counter = _trace(step_fn, args, rules)
            del args
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        return rec

    rec["status"] = "ok"
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["chips"] = n_chips
    rec["params"] = cfg.num_params()
    rec["active_params"] = cfg.num_active_params()
    live = counter.peak_bytes
    rec["memory"] = {"approx_live_bytes": live,
                     "fits_hbm": bool(live <= HBM_PER_CHIP)}

    an = counter.analysis
    rec["hlo"] = an.as_dict()
    rec["hlo"]["dot_flops"] = an.dot_flops
    rec["hlo"]["conv_flops"] = an.conv_flops
    rec["hlo"]["ops"] = counter.ops

    # --- roofline terms (per rank; the counts are one rank's program) ---
    model_flops = model_flops_analytic(cfg, shape)
    compute_s = an.flops / PEAK_FLOPS_BF16
    memory_s = an.hbm_bytes / HBM_BW
    collective_s = an.collective_bytes / IB_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    rec["roofline"] = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_total": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "useful_flops_ratio": (model_flops / n_chips) / an.flops if an.flops else 0.0,
    }
    return rec


def _child(arch, shape, mesh_kind, args):
    """One combo of a several-combo run in a process of its own, appending
    its record to ``args.out`` (a trace is one thread, so the combos run
    side by side).  Returns the started process."""
    import subprocess

    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh_kind, "--objective",
         args.objective, "--remat", args.remat, "--tag", args.tag,
         "--microbatches", str(args.microbatches), "--out", args.out],
        env=env)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    p.add_argument("--objective", default="bc", choices=["bc", "dqn"])
    p.add_argument("--remat", default="full", choices=["full", "none", "dots"])
    p.add_argument("--tag", default="baseline")
    p.add_argument("--microbatches", type=int, default=8)
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="results/dryrun.jsonl")
    args = p.parse_args(argv)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    combos = [(arch, shape, mesh_kind) for arch in archs for shape in shapes
              for mesh_kind in meshes]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if len(combos) > 1:
        # one process a combo, half as many at once as the host has cores
        # (a trace is one thread); records land in the order combos end
        jobs = max(1, (os.cpu_count() or 2) // 2)
        pending, running, n_fail = list(combos), [], 0
        while pending or running:
            while pending and len(running) < jobs:
                running.append(_child(*pending.pop(0), args))
            time.sleep(0.5)
            still = []
            for proc in running:
                if proc.poll() is None:
                    still.append(proc)
                else:
                    n_fail += proc.returncode != 0
            running = still
        return 1 if n_fail else 0
    arch, shape, mesh_kind = combos[0]
    t0 = time.time()
    rec = run_combo(arch, shape, mesh_kind, objective=args.objective,
                    remat=args.remat, tag=args.tag,
                    microbatches=args.microbatches)
    rec["wall_s"] = round(time.time() - t0, 1)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    status = rec["status"]
    if status == "error":
        print(f"[FAIL] {arch} x {shape} x {mesh_kind}: {rec['error']}",
              file=sys.stderr)
        return 1
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" dom={r['dominant']} c={r['compute_s']:.4f}s"
                 f" m={r['memory_s']:.4f}s n={r['collective_s']:.4f}s")
    print(f"[{status}] {arch} x {shape} x {mesh_kind} ({rec['wall_s']}s)"
          f"{extra}")
    if status == "ok":
        print("  memory:", rec["memory"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
