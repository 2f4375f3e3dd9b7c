"""repro_torch.sharding: ``resolve`` held to the reference's
``repro.sharding.rules.resolve`` on the fake meshes of
``tests/test_sharding.py`` (hypothesis over axes and shapes), the cache,
parameter and batch helpers held to the reference's on the same trees,
and the ambient mesh's ``constrain``."""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.distributed.tensor import Replicate, Shard

from repro.sharding import rules as R
from repro_torch.launch import mesh as M
from repro_torch.sharding import ctx
from repro_torch.sharding import rules as TR


class FakeMesh:
    """Stands in for jax.sharding.Mesh (resolve only reads names/shape)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESH1 = FakeMesh((16, 16), ("data", "model"))
MESH2 = FakeMesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"pod1": MESH1, "pod2": MESH2}
AXES = ["batch", "heads", "embed", "mlp", "kv_seq", "vocab", "seq",
        "kv_heads", "experts", "layers", "head_dim", None]
DIMS = [1, 2, 8, 13, 40, 64, 128, 256, 4096]


def _same(axes, dims, mesh, rules):
    want = tuple(R.resolve(axes, dims, mesh, rules))
    assert TR.partition_spec(axes, dims, mesh, rules) == want
    placements = TR.resolve(axes, dims, mesh, rules)
    assert len(placements) == len(mesh.axis_names)
    assert all(isinstance(p, (Shard, Replicate)) for p in placements)
    assert TR.spec_of(placements, mesh) == want


@settings(max_examples=150, deadline=None)
@given(dims=st.lists(st.sampled_from(DIMS), min_size=1, max_size=5),
       names=st.lists(st.sampled_from(AXES), min_size=1, max_size=5),
       mesh=st.sampled_from(sorted(MESHES)),
       rules=st.sampled_from(["param", "act"]))
def test_resolve_equals_the_reference(dims, names, mesh, rules):
    n = min(len(dims), len(names))
    _same(tuple(names[:n]), tuple(dims[:n]), MESHES[mesh],
          {"param": R.PARAM_RULES, "act": R.ACT_RULES}[rules])


@pytest.mark.parametrize("axes,shape,mesh,rules,want", [
    (("batch", "heads", None, "kv_seq"), (256, 64, 512, 4096), MESH1,
     "act", ("data", "model")),
    (("batch", "heads", None, "kv_seq"), (256, 40, 512, 4096), MESH1,
     "act", ("data", None, None, "model")),
    (("batch", None), (256, 8), MESH2, "act", (("pod", "data"),)),
    (("batch",), (1,), MESH2, "act", ()),
    (("embed", "mlp"), (4096, 16384), MESH1, "param", ("data", "model")),
    (("mlp", "mlp"), (16384, 16384), MESH1, "param", ("model",)),
])
def test_the_reference_cases(axes, shape, mesh, rules, want):
    rules = TR.PARAM_RULES if rules == "param" else TR.ACT_RULES
    assert TR.partition_spec(axes, shape, mesh, rules) == want
    _same(axes, shape, mesh, rules)


def test_the_rule_tables_are_the_reference_s():
    assert TR.PARAM_RULES == R.PARAM_RULES
    assert TR.ACT_RULES == R.ACT_RULES
    assert TR.CACHE_AXES == R.CACHE_AXES
    assert TR.SMALL_PARAM_BYTES == R.SMALL_PARAM_BYTES


def test_a_production_layout_resolves_as_the_fake_mesh():
    for multi, fake in ((False, MESH1), (True, MESH2)):
        layout = M.make_production_mesh(multi_pod=multi)
        assert layout.axis_names == fake.axis_names
        assert layout.shape == fake.devices.shape
        axes, shape = ("batch", "heads", "mlp"), (256, 64, 4096)
        assert TR.resolve(axes, shape, layout, TR.ACT_RULES) \
            == TR.resolve(axes, shape, fake, TR.ACT_RULES)


@pytest.fixture
def specs_from_reference(monkeypatch):
    """The reference's helpers with ``NamedSharding`` returning its spec
    (a ``NamedSharding`` needs real devices; the specs are what is held)."""
    monkeypatch.setattr(R, "NamedSharding", lambda mesh, spec: tuple(spec))
    return R


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _sds(shape, dtype=np.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["pod1", "pod2"])
def test_helpers_equal_the_reference(specs_from_reference, mesh):
    ref = specs_from_reference
    axes = {"wq": ("embed", "heads", "head_dim"), "norm": ("embed",),
            "mlp": {"up": ("embed", "mlp"), "down": ("mlp", "embed")}}
    shapes = {"wq": (5120, 64, 128), "norm": (5120,),
              "mlp": {"up": (5120, 25600), "down": (25600, 5120)}}
    t_tree = jax.tree.map(lambda s: _meta(s), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    j_tree = jax.tree.map(lambda s: _sds(s), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    spec = lambda tree: jax.tree.map(
        lambda p: TR.spec_of(p, mesh), tree,
        is_leaf=lambda x: isinstance(x, tuple) and (
            not x or isinstance(x[0], (Shard, Replicate))))
    want = ref.param_sharding(axes, j_tree, mesh)
    assert spec(TR.param_sharding(axes, t_tree, mesh)) == want

    batch_t = {"tokens": _meta((256, 4096), torch.int32),
               "mask": _meta((1, 4096))}
    batch_j = {"tokens": _sds((256, 4096), np.int32),
               "mask": _sds((1, 4096))}
    assert spec(TR.batch_sharding(batch_t, mesh)) \
        == ref.batch_sharding(batch_j, mesh)

    cache = {"k": (8, 128, 32768, 8, 128), "ssm": (8, 128, 8192, 16),
             "odd": (8, 128, 3)}
    cache_t = {"off0": {k: _meta(v) for k, v in cache.items()}}
    cache_j = {"off0": {k: _sds(v) for k, v in cache.items()}}
    assert spec(TR.cache_sharding(cache_t, mesh)) \
        == ref.cache_sharding(cache_j, mesh)
    assert TR.spec_of(TR.replicated(mesh), mesh) == ()


def test_local_shape_divides_the_sharded_dims():
    layout = M.make_production_mesh(multi_pod=True)
    placements = (Shard(1), Shard(1), Shard(2))
    assert TR.local_shape((46, 77312, 77312), placements, layout) \
        == (46, 2416, 4832)
    with pytest.raises(ValueError, match="does not split"):
        TR.local_shape((46, 100, 77312), placements, layout)


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.arange(6.0)
    assert ctx.current_mesh() is None
    assert ctx.constrain(x, ("batch",)) is x
    with ctx.use_mesh(MESH1):
        assert ctx.current_mesh() is MESH1
        assert ctx.constrain(x, ("batch",)) is x    # not a DTensor
    assert ctx.current_mesh() is None


def test_constrain_redistributes_a_dtensor_under_a_mesh():
    """A world of one over gloo, a (1, 1) mesh: a replicated DTensor is
    redistributed to the resolved placements (a shard over a dim of one
    rank), and the values are the same."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    M.init_single_process_group("gloo")
    try:
        mesh = M.make_host_mesh()
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        x = torch.arange(24.0).view(4, 6)
        d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        with ctx.use_mesh(mesh):
            got = ctx.constrain(d, ("batch", "mlp"))
        # a dim of one rank divides nothing (the product must exceed 1)
        assert tuple(got.placements) == TR.resolve(("batch", "mlp"),
                                                   (4, 6), mesh,
                                                   TR.ACT_RULES)
        assert torch.equal(got.full_tensor(), x)
        w = M.world2d(mesh)
        assert w.shape == (1, 1) and w.coord == (0, 0)
    finally:
        dist.destroy_process_group()
