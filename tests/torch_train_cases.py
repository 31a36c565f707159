"""Shared cases of the training slice's CPU tests (``test_torch_train.py``
and ``test_torch_train_steps.py``): the six families' reduced configs in
both packages, numpy batches, the JAX package's params in the port's
layout, leaf comparisons, and the two packages' train steps run side by
side."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jax_configs
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.optim import adam as jax_adam
from repro.optim import sgd as jax_sgd
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.optim import adam, sgd
from repro_torch.optim.optimizers import AdamState, SgdState

LEAF_TOL = 1e-5        # of each leaf's largest magnitude
CE_TOL = 1e-5          # relative, on a CE of ~3-50
LR = 1e-3              # Adam
SGD_LR = 0.01
# the six families; the hybrid with a tail block (3 layers, a group of 2)
FAMILIES = {"dense": "qwen3-1.7b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-780m", "hybrid": "zamba2-1.2b",
            "vlm": "internvl2-26b", "audio": "whisper-base"}
HYBRID_TAIL = dict(num_layers=3, hybrid_attn_every=2)
BATCH, SEQ = 2, 32


def configs_of(family):
    arch = FAMILIES[family]
    cfg = configs.reduced(configs.get_arch(arch))
    jcfg = jax_configs.reduced(jax_configs.get_arch(arch))
    if family == "hybrid":
        cfg = dataclasses.replace(cfg, **HYBRID_TAIL)
        jcfg = dataclasses.replace(jcfg, **HYBRID_TAIL)
    return cfg, jcfg


def make_batch(cfg, b=BATCH, s=SEQ, seed=1):
    """tokens, labels, rewards and discounts (and vision or frames, 0.1 x
    normal) from numpy."""
    rng = np.random.RandomState(seed)
    batch = {
        "tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "rewards": rng.rand(b, s).astype(np.float32),
        "discounts": (0.9 * (rng.rand(b, s) > 0.1)).astype(np.float32),
    }
    if cfg.arch_type == "vlm":
        batch["vision"] = (0.1 * rng.randn(b, cfg.vision_tokens,
                                           cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = (0.1 * rng.randn(b, cfg.encoder_seq,
                                           cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def jax_params(family):
    _, jcfg = configs_of(family)
    return jax.jit(jax_tf.init, static_argnums=1)(jax.random.key(0), jcfg)


def port_params(family):
    cfg, _ = configs_of(family)
    return transformer.params_from_jax(
        cfg, jax.tree.map(np.asarray, jax_params(family)), device="cpu")


def close_leaf(actual, expected, tol=LEAF_TOL, what=""):
    """Largest |actual - expected| within ``tol`` of |expected|'s largest."""
    actual = actual.detach().numpy() if isinstance(
        actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, what
    if not expected.size:
        return
    scale = max(float(np.max(np.abs(expected))), 1e-30)
    err = float(np.max(np.abs(actual - expected)))
    assert err <= tol * scale, (what, err, scale)


def close_tree(port_tree, jax_tree, cfg, tol=LEAF_TOL, what=""):
    """A tree of the port's layout against one of the JAX package's, leaf
    for leaf in JAX order."""
    ours = jax.tree_util.tree_leaves_with_path(
        transformer.params_to_jax(cfg, port_tree))
    theirs = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        close_leaf(a, b, tol, f"{what}{jax.tree_util.keystr(path)}")


def state_from_jax(cfg, jstate):
    """The JAX package's train state (Adam or SGD, any objective) in the
    port's layout."""
    def port(node):
        return None if node is None else transformer.params_from_jax(
            cfg, jax.tree.map(np.asarray, node), device="cpu")

    def tensor(x):
        return torch.tensor(np.asarray(x))
    opt = jstate.opt_state
    if hasattr(opt, "mu"):
        opt = AdamState(tensor(opt.step), port(opt.mu), port(opt.nu))
    else:
        opt = SgdState(tensor(opt.step), port(opt.momentum))
    return steps.TrainState(port(jstate.params), opt, tensor(jstate.step),
                            port(jstate.target_params))


def run_both(family, objective, steps_to_run, *, optimizer="adam",
             microbatches=1, target_period=100, b=BATCH, remat="none"):
    """The JAX package's train step and the port's from the same state
    over the same batches, the port's twice: each step from the JAX
    package's state after the step before (so each comparison is of one
    step), and free-running.  Yields (step, cfg, JAX state, JAX metrics,
    (port state, metrics) stepped, (port state, metrics) free-running)
    after each step."""
    cfg, jcfg = configs_of(family)
    params = jax_params(family)
    jopt, opt = ((jax_adam(LR), adam(LR)) if optimizer == "adam"
                 else (jax_sgd(SGD_LR), sgd(SGD_LR)))
    jstate = jax_steps.TrainState(
        params, jopt.init(params), jnp.zeros((), jnp.int32),
        params if objective == "dqn" else None)
    free = state_from_jax(cfg, jstate)
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, jopt, objective=objective, remat="none",
        target_period=target_period, microbatches=microbatches))
    step = steps.make_train_step(cfg, opt, objective=objective, remat=remat,
                                 target_period=target_period,
                                 microbatches=microbatches)
    for i in range(steps_to_run):
        batch = make_batch(cfg, b=b, seed=10 + i)
        stepped = step(state_from_jax(cfg, jstate), batch)
        jstate, jmetrics = jstep(jstate, batch)
        free, free_metrics = step(free, batch)
        yield i + 1, cfg, jstate, jmetrics, stepped, (free, free_metrics)


def check_step(cfg, jstate, jmetrics, state, metrics, what, *,
               free_running=False, sgd_grads=True):
    """Metrics within CE_TOL; the step counters equal; and leaf for leaf
    within LEAF_TOL: the optimizer's state from one step (Adam's moments
    after one step from the same state are the step's grads: mu = 0.1 g,
    nu = 0.001 g^2; SGD's momentum, at 0, is the grads) and, under SGD,
    the params.  Under Adam the params are not compared: its first steps
    turn summation-order noise in a grad near its eps (1e-8) into weight
    differences of up to ~lr / 50, so SGD, whose update is linear in the
    grads, holds them.  ``free_running``: the port ran every step from its
    own state, so only metrics and params are held (its grads follow
    params that have drifted by f32 noise).  ``sgd_grads=False`` leaves
    SGD's grads out (see ``test_torch_train_steps.py``)."""
    assert sorted(metrics) == sorted(jmetrics), what
    for k, v in jmetrics.items():
        assert abs(float(metrics[k]) - float(v)) <= CE_TOL * max(
            abs(float(v)), 1e-3), (what, k, float(metrics[k]), float(v))
    assert int(state.step) == int(jstate.step)
    assert int(state.opt_state.step) == int(jstate.opt_state.step)
    opt, jopt = state.opt_state, jstate.opt_state
    if hasattr(jopt, "mu"):
        assert not free_running
        close_tree(opt.mu, jopt.mu, cfg, what=f"{what} mu")
        close_tree(opt.nu, jopt.nu, cfg, what=f"{what} nu")
        return
    if sgd_grads and not free_running:
        close_tree(opt.momentum, jopt.momentum, cfg, what=f"{what} grads")
    close_tree(state.params, jstate.params, cfg, what=f"{what} params")


def check_run(cfg, jstate, jmetrics, stepped, free, what):
    """One step of ``run_both`` held: the stepped run in full (SGD's grads
    after step 1 only; ``test_torch_train_steps.py`` says why), and under
    SGD the free-running one too."""
    check_step(cfg, jstate, jmetrics, *stepped, what,
               sgd_grads=int(jstate.step) == 1)
    if isinstance(stepped[0].opt_state, SgdState):
        check_step(cfg, jstate, jmetrics, *free, f"{what} free-running",
                   free_running=True)
