"""repro_torch.optim and repro_torch.tree against the JAX package: the same
numpy params and gradients go through ``repro.optim`` and the port, and
updates, params and optimizer state agree after 1 and 10 steps.

Tolerance: atol 1e-6, rtol 1e-5 on f32 values of order 1 — the two
frameworks round pow, sqrt and the global norm's sum in their own order,
within a few ulps per step."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro_torch import optim, tree

ATOL, RTOL = 1e-6, 1e-5


def _params(seed=0):
    """A nested tree: dict keys out of sorted order, a list of layer dicts,
    a nested dict and a bare leaf."""
    rng = np.random.RandomState(seed)
    return {
        "torso": [{"w": rng.randn(6, 4).astype(np.float32),
                   "b": rng.randn(4).astype(np.float32)},
                  {"w": rng.randn(4, 3).astype(np.float32),
                   "b": rng.randn(3).astype(np.float32)}],
        "head": {"scale": rng.randn(3).astype(np.float32)},
        "bias": rng.randn(2, 2).astype(np.float32),
    }


def _grads(step, scale):
    return tree.map(lambda x: (x * scale).astype(np.float32),
                    _params(seed=100 + step))


def _to_torch(t):
    return tree.map(lambda x: torch.as_tensor(np.asarray(x)), t)


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _assert_tree_close(port, ref):
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


def test_tree_flattens_in_jax_order():
    params = _params()
    port_leaves = tree.leaves(params)
    ref_leaves = jax.tree.leaves(params)
    assert [x.shape for x in port_leaves] == [x.shape for x in ref_leaves]
    for a, b in zip(port_leaves, ref_leaves):
        assert a is b
    state = jax_optim.adam(1e-3).init(_to_jax(params))
    port_state = optim.adam(1e-3).init(_to_torch(params))
    assert [np.asarray(x).shape for x in tree.leaves(port_state)] == \
        [x.shape for x in jax.tree.leaves(state)]
    rebuilt = tree.unflatten(tree.flatten(params)[1], port_leaves)
    assert list(rebuilt) == sorted(params)       # dicts come back sorted
    assert tree.leaves(None) == [] and tree.leaves(()) == []



_PairA = collections.namedtuple("_PairA", "x y")
_PairB = collections.namedtuple("_PairB", "x y")

# (first tree, second tree): jax.tree.map raises ValueError on the first
# eight and maps the rest (a leaf of the first tree takes the second's
# whole subtree there, None included).
TREE_PAIRS = {
    "dict_keys": ({"a": 1, "b": 2}, {"a": 1, "c": 3}),
    "extra_key": ({"a": 1}, {"a": 1, "b": 2}),
    "tuple_vs_list": ((1, 2), [1, 2]),
    "namedtuple_types": (_PairA(1, 2), _PairB(1, 2)),
    "namedtuple_vs_tuple": (_PairA(1, 2), (1, 2)),
    "none_vs_leaf": ({"a": None, "b": 1}, {"a": 1, "b": 1}),
    "none_vs_empty_tuple": (None, ()),
    "list_length": ([1, 2], [1, 2, 3]),
    "same": ({"b": [1, (2, None)], "a": _PairA(3, 4)},
             {"b": [5, (6, None)], "a": _PairA(7, 8)}),
    "leaf_vs_none": ({"a": 1, "b": 1}, {"a": None, "b": 2}),
    "leaf_vs_subtree": ([1, 2], [(3, 4), 5]),
}


@pytest.mark.parametrize("first,second", TREE_PAIRS.values(),
                         ids=TREE_PAIRS.keys())
def test_tree_map_raises_where_jax_tree_map_raises(first, second):
    """tree.map compares structures as jax.tree.map does: dict keys,
    container types, NamedTuple types and where a None sits; it raises
    ValueError exactly where jax.tree.map does, and otherwise builds the
    same tree."""
    try:
        expected = jax.tree.map(lambda *xs: xs, first, second)
    except ValueError:
        expected = ValueError
    if expected is ValueError:
        with pytest.raises(ValueError):
            tree.map(lambda *xs: xs, first, second)
    else:
        got = tree.map(lambda *xs: xs, first, second)
        assert got == expected
        assert type(got) is type(expected)


def test_tree_stack_raises_on_mismatched_structures():
    """The replay batcher's stack: a batch of items whose dict keys
    differ raises, where it used to stack by leaf position."""
    with pytest.raises(ValueError):
        tree.stack([{"a": 1, "b": 2}, {"a": 1, "c": 3}])
    with pytest.raises(ValueError):
        tree.stack([(1, 2), [1, 2]])
    stacked = tree.stack([{"a": 1, "b": (2, 3)}, {"a": 4, "b": (5, 6)}])
    np.testing.assert_array_equal(stacked["b"][1], [3, 6])

def _run(port_opt, ref_opt, steps, grad_scale):
    params = _params()
    p_port, p_ref = _to_torch(params), _to_jax(params)
    s_port, s_ref = port_opt.init(p_port), ref_opt.init(p_ref)
    for step in range(steps):
        grads = _grads(step, grad_scale)
        with torch.no_grad():
            u_port, s_port = port_opt.update(_to_torch(grads), s_port, p_port)
            p_port = optim.apply_updates(p_port, u_port)
        u_ref, s_ref = ref_opt.update(_to_jax(grads), s_ref, p_ref)
        p_ref = jax_optim.apply_updates(p_ref, u_ref)
        _assert_tree_close(u_port, u_ref)
    _assert_tree_close(p_port, p_ref)
    _assert_tree_close(s_port, s_ref)
    return s_port


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("clip,grad_scale", [(None, 1.0), (40.0, 1.0),
                                             (1.0, 5.0)])
def test_adam_matches_reference(steps, clip, grad_scale):
    """Adam with and without the global-norm clip (``(1.0, 5.0)`` clips
    every step), with bias correction from the int32 step."""
    state = _run(optim.adam(6e-4, clip=clip), jax_optim.adam(6e-4, clip=clip),
                 steps, grad_scale)
    assert state.step.dtype == torch.int32 and int(state.step) == steps


@pytest.mark.parametrize("steps", [1, 10])
def test_adamw_with_schedule_matches_reference(steps):
    sched = optim.cosine_schedule(1e-2, total_steps=12, warmup_steps=3)
    ref_sched = jax_optim.cosine_schedule(1e-2, total_steps=12,
                                          warmup_steps=3)
    _run(optim.adam(sched, weight_decay=0.1, clip=2.0),
         jax_optim.adam(ref_sched, weight_decay=0.1, clip=2.0), steps, 1.0)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("momentum,clip", [(0.0, None), (0.9, 3.0)])
def test_sgd_matches_reference(steps, momentum, clip):
    _run(optim.sgd(0.05, momentum=momentum, clip=clip),
         jax_optim.sgd(0.05, momentum=momentum, clip=clip), steps, 1.0)


@pytest.mark.parametrize("steps", [1, 10])
def test_chain_clip_matches_reference(steps):
    warm = optim.linear_warmup(0.1, 4)
    ref_warm = jax_optim.linear_warmup(0.1, 4)
    _run(optim.chain_clip(optim.sgd(warm, momentum=0.5), 1.5),
         jax_optim.chain_clip(jax_optim.sgd(ref_warm, momentum=0.5), 1.5),
         steps, 2.0)


@pytest.mark.parametrize("make", [
    lambda o: o.linear_warmup(3e-3, 7),
    lambda o: o.linear_warmup(3e-3, 0),
    lambda o: o.cosine_schedule(1e-3, 20),
    lambda o: o.cosine_schedule(1e-3, 20, warmup_steps=5, final_frac=0.0),
])
def test_schedules_match_reference(make):
    port, ref = make(optim), make(jax_optim)
    for step in range(0, 30):
        got = port(torch.tensor(step, dtype=torch.int32))
        want = ref(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


def test_global_norm_and_target_updates_match_reference():
    a, b = _params(1), _params(2)
    np.testing.assert_allclose(
        optim.global_norm(_to_torch(a)).numpy(),
        np.asarray(jax_optim.global_norm(_to_jax(a))), rtol=RTOL)
    for step in (0, 3, 4, 8):
        _assert_tree_close(
            optim.periodic_update(_to_torch(a), _to_torch(b),
                                  torch.tensor(step), 4),
            jax_optim.periodic_update(_to_jax(a), _to_jax(b),
                                      jnp.asarray(step), 4))
    _assert_tree_close(
        optim.incremental_update(_to_torch(a), _to_torch(b), 0.05),
        jax_optim.incremental_update(_to_jax(a), _to_jax(b), 0.05))
