"""Large-model training in repro_torch against the JAX package:
``layers.cross_entropy`` and ``chunked_cross_entropy`` (values and grads),
``remat`` "none", "full" and "dots" on every family, ``init_train_state``'s
layout, the DQN objective's step on dense and MoE, microbatches,
``launch.train.make_corpus_sampler`` and ``main``.  The BC objective's
step on every family is in ``test_torch_train_steps.py``, which also says
how the steps are compared.

Weights come from the JAX ``transformer.init`` through the port's
``transformer.params_from_jax``; batches from numpy.  Tolerances are
stated beside each check: by default 1e-5 of each leaf's largest
magnitude (``torch_train_cases.close_leaf``)."""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import steps as jax_steps
from repro.launch import train as jax_train
from repro.models import layers as jax_layers
from repro.optim import adam as jax_adam
from repro_torch import tree
from repro_torch.launch import steps, train
from repro_torch.models import layers, transformer
from repro_torch.optim import adam, sgd
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import (CE_TOL, FAMILIES, LR, check_run, check_step,
                               close_leaf, close_tree, configs_of, make_batch,
                               port_params, run_both)


# ------------------------------------------------------------ cross-entropy
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(masked):
    """Value and grad in the logits, with and without a mask."""
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(3, 7, 40)).astype(np.float32)
    labels = rng.randint(0, 40, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) > 0.4).astype(np.float32) if masked else None

    def jloss(lg):
        return jax_layers.cross_entropy(
            lg, labels, None if mask is None else jnp.asarray(mask))
    jvalue, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    value = layers.cross_entropy(
        x, torch.tensor(labels), None if mask is None else torch.tensor(mask))
    value.backward()
    value = value.detach()
    assert value.dtype == torch.float32
    assert abs(float(value) - float(jvalue)) <= CE_TOL * abs(float(jvalue))
    close_leaf(x.grad, jgrad)


@pytest.mark.parametrize("s,chunk,masked,valid_vocab", [
    (12, 4, False, None),      # three whole chunks
    (14, 4, False, None),      # a remainder chunk of 2
    (14, 4, True, None),       # a mask over a remainder
    (12, 5, True, 27),         # valid_vocab: entries 27..31 are padding
    (6, 16, False, 27),        # a chunk longer than the sequence
])
def test_chunked_cross_entropy_matches(s, chunk, masked, valid_vocab):
    """Value, and grads in x and the table, against the JAX package's; and
    the value equal to the plain CE over the full logits (the JAX
    package's ``test_chunked_ce_matches_plain_ce``)."""
    rng = np.random.RandomState(s + chunk)
    b, d, v = 2, 16, 32
    x = rng.randn(b, s, d).astype(np.float32)
    table = rng.randn(v, d).astype(np.float32)
    labels = rng.randint(0, valid_vocab or v, (b, s)).astype(np.int32)
    mask = (rng.rand(b, s) > 0.3).astype(np.float32) if masked else None

    def jloss(x, table):
        return jax_layers.chunked_cross_entropy(
            x, table, labels, chunk=chunk,
            mask=None if mask is None else jnp.asarray(mask),
            valid_vocab=valid_vocab)
    jvalue, (jgx, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))

    tx = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    value = layers.chunked_cross_entropy(
        tx, tt, torch.tensor(labels), chunk=chunk,
        mask=None if mask is None else torch.tensor(mask),
        valid_vocab=valid_vocab)
    value.backward()
    value = value.detach()
    assert abs(float(value) - float(jvalue)) <= CE_TOL * abs(float(jvalue))
    close_leaf(tx.grad, jgx, what="x")
    close_leaf(tt.grad, jgt, what="table")
    if valid_vocab is None:
        with torch.no_grad():
            plain = layers.cross_entropy(
                layers.unembed(tt, tx), torch.tensor(labels),
                None if mask is None else torch.tensor(mask))
        assert abs(float(plain) - float(value)) <= CE_TOL * abs(float(plain))


def test_chunked_cross_entropy_keeps_no_chunk_logits_for_the_backward():
    """Under grad mode no (b, chunk, V) tensor is saved for the backward:
    each chunk's logits are recomputed (torch.utils.checkpoint)."""
    rng = np.random.RandomState(0)
    b, s, d, v = 2, 12, 8, 64
    x = torch.tensor(rng.randn(b, s, d).astype(np.float32),
                     requires_grad=True)
    table = torch.tensor(rng.randn(v, d).astype(np.float32),
                         requires_grad=True)
    labels = torch.tensor(rng.randint(0, v, (b, s)))
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = layers.chunked_cross_entropy(x, table, labels, chunk=4)
    assert shapes and not any(len(sh) == 3 and sh[-1] == v for sh in shapes)
    loss.backward()
    assert x.grad is not None and table.grad is not None


# ------------------------------------------------------------------ remat
def _features_and_grads(cfg, params, batch, remat):
    leaves, treedef = tree.flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    feats, aux = transformer.forward_features(
        tree.unflatten(treedef, live), cfg, batch, remat=remat)
    weights = torch.tensor(np.random.RandomState(7).randn(
        *feats.shape).astype(np.float32))
    loss = torch.sum(feats * weights) + sum(aux.values(), torch.zeros(()))
    # lm_head takes no part in the features
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    aux = {k: float(v.detach()) for k, v in aux.items()}
    return feats.detach(), aux, grads


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_modes_give_equal_features_and_grads(family):
    """"full" and "dots" recompute the same blocks: features, MoE losses
    and every grad leaf equal "none"'s to 1e-6 of the leaf's largest
    magnitude (the same ops on the same inputs: in practice bit-equal)."""
    cfg, _ = configs_of(family)
    params, batch = port_params(family), make_batch(cfg)
    feats, aux, grads = _features_and_grads(cfg, params, batch, "none")
    for remat in ("full", "dots"):
        f, a, g = _features_and_grads(cfg, params, batch, remat)
        close_leaf(f, feats.numpy(), 1e-6, remat)
        assert a == pytest.approx(aux, rel=1e-6, abs=0)
        for x, y in zip(g, grads):
            assert (x is None) == (y is None)
            if y is not None:
                close_leaf(x, y.numpy(), 1e-6, remat)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_remat_dots_keeps_between_none_and_full(family):
    """Bytes kept for the backward after a forward: "none" > "dots" >
    "full".  ``saved_tensors_hooks`` counts what autograd saves outside
    the checkpoints (inside one, the checkpoint's own hooks take the
    saves); "dots" also keeps the products its policy saves, counted as
    the policy marks them (``transformer._save_dots``, wrapped)."""
    cfg, _ = configs_of(family)
    params, batch = port_params(family), make_batch(cfg)
    leaves, treedef = tree.flatten(params)
    kept = {}
    policy = transformer._save_dots

    for remat in ("none", "full", "dots"):
        counted = [0]

        def pack(t):
            counted[0] += t.numel() * t.element_size()
            return t

        def counting(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if (decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
                    and not ctx.is_recompute):
                a, b = args[0], args[1]
                counted[0] += (a[..., 0].numel() * b.shape[-1]
                               * a.element_size())
            return decision

        live = [p.detach().requires_grad_() for p in leaves]
        transformer._save_dots = counting
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                feats, _ = transformer.forward_features(
                    tree.unflatten(treedef, live), cfg, batch, remat=remat)
        finally:
            transformer._save_dots = policy
        kept[remat] = counted[0]
        feats.sum().backward()
    assert kept["none"] > kept["dots"] > kept["full"], kept


def test_remat_is_off_without_grad_and_rejects_unknown_modes():
    cfg, _ = configs_of("dense")
    params, batch = port_params("dense"), make_batch(cfg)
    with torch.no_grad():
        a, _ = transformer.forward_features(params, cfg, batch, remat="full")
        b, _ = transformer.forward_features(params, cfg, batch, remat="none")
    assert torch.equal(a, b) and a.grad_fn is None
    with pytest.raises(ValueError):
        transformer.forward_features(params, cfg, batch, remat="some")


# ------------------------------------------------------- init_train_state
def _paths(tree_):
    return {jax.tree_util.keystr(p): (tuple(np.shape(x)),
                                      np.dtype(getattr(x, "dtype")))
            for p, x in jax.tree_util.tree_leaves_with_path(tree_)}


@pytest.mark.parametrize("objective", ["bc", "dqn"])
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_init_train_state_layout_matches(family, objective):
    """Leaf names, shapes and dtypes of params, Adam's state, the step and
    the target (``None`` for "bc", a copy for "dqn") against the JAX
    package's ``init_train_state``."""
    cfg, jcfg = configs_of(family)
    opt = jax_adam(LR)
    jstate = jax.eval_shape(lambda: jax_steps.init_train_state(
        jax.random.key(0), jcfg, opt, objective=objective))
    state = steps.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   adam(LR), device="cpu",
                                   objective=objective)
    ours = train.state_to_jax(cfg, state)
    assert type(ours.opt_state).__name__ == type(jstate.opt_state).__name__
    assert _paths(ours) == _paths(jstate)
    assert state.step.dtype == torch.int32 and state.step.device.type == "cpu"
    if objective == "bc":
        assert state.target_params is None and jstate.target_params is None
    else:
        for p, t in zip(tree.leaves(state.params),
                        tree.leaves(state.target_params)):
            assert torch.equal(p, t) and p.data_ptr() != t.data_ptr()


# ------------------------------------------------------------ DQN step
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_dqn_train_step_matches(family, optimizer):
    """``target_period`` 2: the target is copied from the params before the
    update at steps 0 and 2, so after 3 steps it holds those of step 2."""
    for n, cfg, jstate, jm, stepped, free in run_both(
            family, "dqn", 3, optimizer=optimizer, target_period=2):
        if n in (1, 3):
            check_run(cfg, jstate, jm, stepped, free, f"{family} dqn {n}")
            close_tree(stepped[0].target_params, jstate.target_params, cfg,
                       what=f"target {n}")
        if n == 3:
            assert not np.allclose(
                np.asarray(jstate.target_params["final_norm"]["scale"]),
                np.asarray(jstate.params["final_norm"]["scale"]))


# ------------------------------------------------------------ microbatches
def test_microbatched_grads_match_full_batch():
    """The JAX package's ``test_microbatched_grads_match_full_batch`` on the
    port: with SGD(1.0) the update is linear in the grads (Adam's
    normalisation would amplify a grad near 0 into an O(lr) difference),
    so 4 microbatches and 1 agree to f32 accumulation noise."""
    cfg, _ = configs_of("dense")
    batch = make_batch(cfg, b=4)
    out = {}
    for m in (1, 4):
        state = steps.init_train_state(torch.Generator().manual_seed(0), cfg,
                                       sgd(1.0), device="cpu")
        step = steps.make_train_step(cfg, sgd(1.0), remat="none",
                                     microbatches=m)
        out[m] = (state, *step(state, batch))
    (s0, s1, m1), (_, s4, m4) = out[1], out[4]
    diffs = [float(torch.max(torch.abs(a - b)))
             for a, b in zip(tree.leaves(s1.params), tree.leaves(s4.params))]
    assert max(diffs) < 2e-4
    assert abs(float(m1["ce"]) - float(m4["ce"])) < 1e-3
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(s0.params), tree.leaves(
            steps.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   sgd(1.0), device="cpu").params))), \
        "the step wrote the state it was given"


def test_microbatches_match_the_reference():
    """4 microbatches in the port against 4 in the JAX package on the VLM,
    so the vision leaf is split with the tokens: metrics (their mean) and
    the accumulated grads (Adam's moments after one step from the same
    state) at steps 1 and 3."""
    for n, cfg, jstate, jm, stepped, _ in run_both(
            "vlm", "bc", 3, microbatches=4, b=4):
        if n in (1, 3):
            check_step(cfg, jstate, jm, *stepped, f"microbatches {n}")


# --------------------------------------------------------------- train.py
def test_corpus_sampler_matches_the_reference_exactly():
    ours = train.make_corpus_sampler(97, 24, 3, seed=5)
    theirs = jax_train.make_corpus_sampler(97, 24, 3, seed=5)
    for _ in range(2):
        a, b = ours(), theirs()
        assert sorted(a) == sorted(b)
        for k in b:
            expected = np.asarray(b[k])
            assert isinstance(a[k], np.ndarray)
            assert a[k].dtype == expected.dtype
            np.testing.assert_array_equal(a[k], expected)


def test_main_trains_and_checkpoints_the_reference_layout(tmp_path, capsys):
    """``main`` on a reduced qwen3-1.7b on the CPU for 20 steps: the CE
    falls (exit 0), and the checkpoint at step 20 holds the JAX package's
    train state, leaf for leaf in count and shape."""
    assert train.main(["--arch", "qwen3-1.7b", "--device", "cpu",
                       "--steps", "20", "--checkpoint-dir",
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step   20  ce" in out and "(improved)" in out
    cfg = jax_configs.reduced(jax_configs.get_arch("qwen3-1.7b"))
    opt = jax_adam(jax_train.cosine_schedule(3e-4, 20, warmup_steps=10),
                   clip=1.0)
    template = jax.eval_shape(lambda: jax_steps.init_train_state(
        jax.random.key(0), cfg, opt))
    expected = [tuple(x.shape) for x in jax.tree.leaves(template)]
    with np.load(tmp_path / "checkpoint_20.npz") as data:
        saved = [tuple(data[f"leaf_{i}"].shape) for i in range(
            sum(1 for k in data.files if k.startswith("leaf_")))]
    assert saved == expected


def test_main_dqn_reports_its_td_where_the_reference_has_no_ce(capsys):
    """``--objective dqn``: the JAX package's ``main`` reads
    ``metrics["ce"]`` after the first step, and its DQN objective returns
    no "ce" (only "loss" and "td"), so that ``main`` would raise KeyError;
    the port's ``main`` reports the TD loss instead."""
    cfg, jcfg = configs_of("dense")
    opt = jax_adam(LR)
    state = jax_steps.init_train_state(jax.random.key(0), jcfg, opt,
                                       objective="dqn")
    _, metrics = jax.jit(jax_steps.make_train_step(
        jcfg, opt, objective="dqn", remat="none"))(state, {
            k: jnp.asarray(v) for k, v in make_batch(cfg, s=8).items()})
    assert sorted(metrics) == ["loss", "td"]
    assert train.main(["--arch", "qwen3-1.7b", "--objective", "dqn",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--device", "cpu"]) in (0, 1)
    assert "done: td" in capsys.readouterr().out


def test_tree_walks_leave_no_reference_cycles():
    """``tree.flatten``, ``unflatten`` and ``map`` free their leaves by
    reference count: a walk that closed over its list of leaves kept every
    leaf (on the card, each of Adam's param-sized temporaries) alive until
    the cyclic collector ran."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        state = {"a": [torch.zeros(3), torch.ones(2)], "b": (torch.ones(1),)}
        out = tree.map(lambda x, y: x + y, state, state)
        refs = [weakref.ref(x) for x in tree.leaves(out)]
        leaves, treedef = tree.flatten(out)
        again = tree.unflatten(treedef, leaves)
        del out, leaves, again
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()
