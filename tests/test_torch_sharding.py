"""The launch layer's sharding in repro_torch against the JAX package:
``ShardingRules.mesh_axes`` and ``zero_spec`` on duck-typed meshes over
drawn logical axes and dims, ``tree_pspecs`` leaf by leaf for every arch
(reduced and full size) on the 4x2 and both production meshes, the
fake-tensor input specs of every arch x shape (both cache layouts) against
``jax.eval_shape``'s, the placements of a two-axis spec, and ``shard`` on
plain tensors and DTensors (values kept, on 8 local ranks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jax_configs
from repro import sharding as jax_sharding
from repro.launch import param_sharding as jax_ps
from repro.launch import specs as jax_specs
from repro.models import transformer as jax_tf
from repro_torch import configs, sharding, tree
from repro_torch.launch import param_sharding, specs

MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


class _FakeMesh:
    """Duck-typed mesh, as ``tests/test_sharding.py`` builds one: the rules
    read only ``axis_names`` and ``devices.shape``."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _rules(mesh):
    shape, names = MESHES[mesh]
    return (sharding.ShardingRules(_FakeMesh(shape, names)),
            jax_sharding.ShardingRules(_FakeMesh(shape, names)))


LOGICAL = st.sampled_from([None] + sorted(jax_sharding.BASE_RULES))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@settings(max_examples=150, deadline=None)
@given(data=st.data())
def test_mesh_axes_and_zero_spec_equal_the_references(mesh, data):
    port, ref = _rules(mesh)
    rank = data.draw(st.integers(0, 5))
    logical = tuple(data.draw(st.lists(LOGICAL, min_size=rank,
                                       max_size=rank)))
    dims = tuple(data.draw(st.lists(
        st.sampled_from([1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 64, 256, 512,
                         92553]),
        min_size=rank, max_size=rank)))
    spec = port.mesh_axes(logical, dims)
    expected = ref.mesh_axes(logical, dims)
    assert tuple(spec) == tuple(expected)
    assert tuple(port.mesh_axes(logical)) == tuple(ref.mesh_axes(logical))
    assert tuple(port.zero_spec(spec, dims)) == \
        tuple(ref.zero_spec(expected, dims))


def test_rules_read_a_device_mesh_and_the_duck_typed_mesh_alike():
    """A torch ``DeviceMesh`` gives its names and sizes through
    ``mesh_dim_names`` and ``mesh.shape``; a duck-typed one through
    ``axis_names`` and ``devices.shape``."""
    class _DeviceMeshLike:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    a = sharding.ShardingRules(_DeviceMeshLike())
    b = sharding.ShardingRules(_FakeMesh(*MESHES["multi"]))
    assert a._axis_sizes == b._axis_sizes == {"pod": 2, "data": 16,
                                              "model": 16}
    spec = a.mesh_axes(("batch", "vocab"), (256, 151936))
    assert spec == sharding.P(("pod", "data"), "model")
    assert spec == (("pod", "data"), "model")


def _ref_specs_by_name(params, rules):
    pspecs = jax_ps.tree_pspecs(params, rules)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_leaves(
                pspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
        out[jax_ps._key_names(path)] = (tuple(leaf.shape), tuple(spec))
    return out


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_tree_pspecs_equal_the_references_leaf_by_leaf(arch, size):
    """Every param leaf of the port (no layer axis: a stack is a list of
    per-layer dicts) resolves to the JAX package's spec of the stacked leaf
    without its leading ``layers`` entries, which are replicated, on the
    4x2 and both production meshes."""
    cfg, jcfg = configs.get_arch(arch), jax_configs.get_arch(arch)
    if size == "reduced":
        cfg, jcfg = configs.reduced(cfg), jax_configs.reduced(jcfg)
    jparams = jax.eval_shape(
        lambda: jax_tf.init(jax.random.key(0), jcfg, jnp.bfloat16))
    params = specs.params_specs(cfg, torch.bfloat16)
    for mesh in MESHES:
        port, ref = _rules(mesh)
        expected = _ref_specs_by_name(jparams, ref)
        seen = []

        def check(path, leaf, spec):
            names = param_sharding._key_names(path)
            stacked = sum(isinstance(p, tree.SequenceKey) for p in path)
            shape, ref_spec = expected[names]
            assert tuple(leaf.shape) == shape[stacked:], (names, mesh)
            assert ref_spec[:stacked] == (None,) * min(stacked,
                                                       len(ref_spec))
            assert isinstance(spec, sharding.PartitionSpec)
            assert tuple(spec) == ref_spec[stacked:], (names, mesh)
            seen.append(names)

        tree.map_with_path(check, params,
                           param_sharding.tree_pspecs(params, port))
        assert set(seen) == set(expected)


def test_param_logical_axes_by_name():
    """The JAX package's cases (``tests/test_sharding.py``) on the port's
    paths, whose stacks carry no layer axis."""
    D, S = tree.DictKey, tree.SequenceKey
    assert param_sharding.param_logical_axes(
        (D("blocks"), S(3), D("attn"), D("wq")), (128, 8, 32)) == (
        "d_model", "heads", "head_dim")
    assert param_sharding.param_logical_axes(
        (D("embed"), D("table")), (1024, 128)) == ("vocab", "embed_d")
    assert param_sharding.param_logical_axes(
        (D("blocks"), S(0), D("moe"), D("experts"), D("w_gate")),
        (8, 128, 64)) == ("experts", "d_model", "expert_ff")
    assert param_sharding.param_logical_axes(
        (D("mu"), D("blocks"), S(1), D("mlp"), D("w_down")),
        (64, 128)) == ("ff", "d_model")


def _leaves_with_names(flat):
    return [(tuple(str(getattr(p, "key", getattr(p, "name",
                                                  getattr(p, "idx", None))))
                   for p in path),
             tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for path, x in flat]


def _cases():
    for arch in sorted(configs.ARCHS):
        for shape in sorted(configs.INPUT_SHAPES):
            yield arch, shape


@pytest.mark.parametrize("arch,shape", list(_cases()))
def test_input_specs_match_the_references(arch, shape):
    """``input_specs`` of every arch x shape: the same tree, leaf names,
    shapes and dtypes as the JAX package's ``jax.eval_shape`` stand-ins,
    and a decode cache in both layouts and in float8 too; nothing is
    allocated (fake tensors)."""
    cfg, jcfg = configs.get_arch(arch), jax_configs.get_arch(arch)
    s, js = configs.get_shape(shape), jax_configs.get_shape(shape)
    variants = [({}, {})]
    if s.kind == "decode":
        variants = [
            (dict(layout=layout, cache_dtype=dt),
             dict(layout=layout, cache_dtype=jdt))
            for layout in ("stacked", "list")
            for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                            (torch.float8_e4m3fn, jnp.float8_e4m3fn))]
    for kw, jkw in variants:
        got = specs.input_specs(cfg, s, **kw)
        want = jax_specs.input_specs(jcfg, js, **jkw)
        flat = tree.flatten_with_path(got)[0]
        assert all(isinstance(x, torch._subclasses.FakeTensor)
                   for _, x in flat)
        jflat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert _leaves_with_names(flat) == [
            (names, shape_, str(np.dtype(dtype)))
            for names, shape_, dtype in (
                (tuple(str(getattr(p, "key", getattr(p, "name",
                                                     getattr(p, "idx", None))))
                       for p in path), tuple(x.shape), x.dtype)
                for path, x in jflat)], (arch, shape, kw)


@pytest.fixture
def fake_group():
    """A fake process group of 512 ranks for this test alone: destroyed
    after, so no later test in the worker sees it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def test_two_axis_spec_placements_give_the_references_local_shapes(
        fake_group):
    """``zero_spec``'s ``("data", "pod")``, which is not mesh order, maps to
    placements whose local shard has the shape of the JAX package's shard
    of the same spec; so does the mesh-ordered ``("pod", "data")``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = init_device_mesh("cpu", (2, 16, 16),
                            mesh_dim_names=("pod", "data", "model"))
    rules = sharding.ShardingRules(mesh)
    sizes = {"pod": 2, "data": 16, "model": 16}
    shape = (2048, 96, 128)
    for spec in (sharding.P(("data", "pod"), None, "model"),
                 sharding.P(("pod", "data"), "model", None),
                 rules.zero_spec(rules.mesh_axes((None, "heads", None),
                                                 shape), shape)):
        local, _ = compute_local_shape_and_global_offset(
            shape, mesh, rules.placements(spec))
        want = [d // int(np.prod([sizes[a] for a in
                                  ((e,) if isinstance(e, str) else e or ())]))
                for d, e in zip(shape, tuple(spec) + (None,) * 3)]
        assert list(local) == want, spec
    assert rules.zero_spec(rules.mesh_axes((None, "heads", None), shape),
                           shape) == (("data", "pod"), "model", None)


def test_shard_is_a_no_op_outside_a_context_and_on_plain_tensors():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert sharding.shard(x, "batch", "seq", "d_model") is x
    rules = sharding.ShardingRules(_FakeMesh(*MESHES["4x2"]))
    with sharding.use_rules(rules):
        assert sharding.current_rules() is rules
        assert sharding.shard(x, "batch", "seq", "d_model") is x
        assert not sharding.distributed(x)
    assert sharding.current_rules() is None


def test_shard_keeps_a_dtensors_values_on_a_4x2_mesh():
    """On 8 simulated ranks with real local shards (``LocalTensorMode``
    over a fake group), ``shard`` redistributes to the resolved placements
    and the global values stay the same."""
    import torch.distributed as dist
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with LocalTensorMode(8):
            mesh = init_device_mesh("cpu", (4, 2),
                                    mesh_dim_names=("data", "model"))
            full = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(
                8, 6, 4)
            x = distribute_tensor(full, mesh, [Shard(0), Replicate()])
            with sharding.use_rules(sharding.ShardingRules(mesh)):
                assert sharding.distributed(x)
                y = sharding.shard(x, "batch", None, "heads")
                assert tuple(y.placements) == (Shard(0), Shard(2))
                z = sharding.shard(y, "batch", "kv_seq", "d_model")
                assert tuple(z.placements) == (Shard(0), Replicate())
                assert sharding.shard(z, "batch", None, None) is z
            assert torch.equal(y.full_tensor(), full)
            assert torch.equal(z.full_tensor(), full)
    finally:
        dist.destroy_process_group()


def test_shard_constrains_the_gradient_to_the_same_placements():
    """As JAX transposes a sharding constraint into the same constraint on
    the cotangent, the gradient that ``shard`` passes back has the
    placements it resolved, and the values of the plain computation."""
    import torch.distributed as dist
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    full = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    weight = torch.linspace(-1.0, 1.0, 4)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with LocalTensorMode(8):
            mesh = init_device_mesh("cpu", (4, 2),
                                    mesh_dim_names=("data", "model"))
            x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
            x.requires_grad_()
            w = distribute_tensor(weight, mesh, [Replicate(), Replicate()])
            with sharding.use_rules(sharding.ShardingRules(mesh)):
                y = sharding.shard(x, "batch", None, "heads")
                (y * w).sum().backward()
            assert tuple(y.placements) == (Shard(0), Shard(2))
            assert tuple(x.grad.placements) == (Shard(0), Shard(2))
            grad = x.grad.full_tensor()
        assert torch.equal(grad, weight.expand(8, 6, 4))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("table_dim", [0, 1, None])
def test_embed_on_a_sharded_table_matches_the_plain_lookup(table_dim):
    """On 8 simulated ranks, ``layers.embed`` on a table sharded on vocab
    (the rules' layout), on d_model, or replicated, with the tokens
    sharded on the batch: the rows and the table's gradient equal the
    plain lookup's, and a vocab-sharded table is never gathered (one
    all-reduce of the rows, no all-gather)."""
    import torch.distributed as dist
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models import layers

    rng = np.random.RandomState(0)
    table = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    tokens = torch.from_numpy(rng.randint(0, 16, size=(8, 3)))
    weight = torch.from_numpy(rng.normal(size=(8, 3, 4)).astype(np.float32))
    plain = table.clone().requires_grad_()
    want = layers.embed({"table": plain}, tokens)
    (want * weight).sum().backward()

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with LocalTensorMode(8):
            mesh = init_device_mesh("cpu", (4, 2),
                                    mesh_dim_names=("data", "model"))
            placement = Replicate() if table_dim is None else Shard(table_dim)
            t = distribute_tensor(table, mesh, [Replicate(), placement])
            t.requires_grad_()
            x = distribute_tensor(tokens, mesh, [Shard(0), Replicate()])
            w = distribute_tensor(weight, mesh, [Shard(0), Replicate()])
            with sharding.use_rules(sharding.ShardingRules(mesh)), \
                    CommDebugMode() as comms:
                rows = layers.embed({"table": t}, x)
                out = sharding.shard(rows, "batch", None, None)
                (out * w).sum().backward()
            assert rows.placements[0] == Shard(0)
            assert rows.placements[1] == {0: Partial(), 1: Shard(2),
                                          None: Replicate()}[table_dim]
            assert tuple(t.grad.placements) == (Partial(), placement)
            assert torch.equal(out.full_tensor(), want.detach())
            assert torch.allclose(t.grad.full_tensor(), plain.grad,
                                  rtol=0, atol=1e-6)
        counts = {str(k): v for k, v in comms.get_comm_counts().items()}
        if table_dim == 0:
            assert not [k for k in counts if "all_gather" in k], counts
            assert sum(v for k, v in counts.items() if "all_reduce" in k) == 1
    finally:
        dist.destroy_process_group()


def test_dry_run_rules_keep_flip_sharded_and_come_out_after():
    """Inside ``dryrun.dtensor_rules()`` a flip keeps the shard of a dim it
    does not flip, with the plain flip's values; after the block every
    table of DTensor's rules is as it was."""
    import torch.distributed as dist
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import dryrun

    def tables():
        prop = DTensor._op_dispatcher.sharding_propagator
        out = {name: dict(t) for name, t in vars(prop).items()
               if name.startswith("op_") and isinstance(t, dict)}
        out["handlers"] = dict(DTensor._op_dispatcher._custom_op_handlers)
        return out

    before = tables()
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with LocalTensorMode(8):
            mesh = init_device_mesh("cpu", (4, 2),
                                    mesh_dim_names=("data", "model"))
            x = distribute_tensor(full, mesh, [Shard(0), Replicate()])
            with dryrun.dtensor_rules() as names:
                assert tables() != before
                y = torch.flip(x, [1])
            assert "sharded aten.flip.default" in names
            assert tuple(y.placements) == (Shard(0), Replicate())
            assert torch.equal(y.full_tensor(), torch.flip(full, [1]))
    finally:
        dist.destroy_process_group()
    assert tables() == before
