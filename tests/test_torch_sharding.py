"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, entry by entry.

Twins of ``tests/test_sharding.py::TestRules``, a seeded property over
random shapes, axes and mesh sizes, and for all ten archs on the (1, 1),
(16, 16) and (2, 16, 16) rules: the parameter, optimizer-state, batch and
cache specs leaf by leaf, built directly from ``ShardingRules`` as the
reference's test builds them (no devices needed). Also the port's
``abstract_params`` and ``cache_spec`` against the reference's, the DTensor
placements, the logical constraint (a no-op on plain tensors, a
redistribution of a DTensor), a (2, 1) mesh over two simulated ranks and
the production meshes, which still raise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as RefP  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import abstract_params as ref_abstract_params  # noqa: E402
from repro.models import cache_axes as ref_cache_axes  # noqa: E402
from repro.models import cache_spec as ref_cache_spec  # noqa: E402
from repro.models import model_spec as ref_model_spec  # noqa: E402
from repro.models.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.optim.adamw import AdamWState as RefAdamWState  # noqa: E402
from repro.runtime.step_builder import input_specs as ref_input_specs  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.logical import constrain, logical_sharding_scope  # noqa: E402
from repro_torch.distributed.sharding import P, PartitionSpec, ShardingRules  # noqa: E402
from repro_torch.launch.dryrun import DRYRUN_MESH  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_mesh,
    make_production_mesh,
    mesh_name,
    simulated_ranks,
    single_device_mesh,
)
from repro_torch.models import abstract_params, cache_axes, cache_spec, model_spec  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.runtime.step_builder import build_step, input_specs  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - hypothesis is optional
    given = None


def rules_16x16(module=sharding):
    return module.ShardingRules(
        mesh_axes=("data", "model"),
        mesh_shape={"data": 16, "model": 16},
        rules={
            "batch": ("pod", "data"),
            "heads": ("model",),
            "kv_heads": ("model",),
            "embed": ("data",),
            "vocab": ("model",),
            "seq": ("model",),
        },
    )


def both(shape, axes):
    """The port's spec and the reference's for the same request."""
    return rules_16x16().spec_for(shape, axes), rules_16x16(ref_sharding).spec_for(shape, axes)


def same(port, ref):
    return isinstance(port, PartitionSpec) and tuple(port) == tuple(ref)


class TestRules:
    def test_divisible_dims_shard(self):
        port, ref = both((256, 4096), ("batch", "seq"))
        assert port == P("data", "model") and same(port, ref) and ref == RefP("data", "model")

    def test_indivisible_dims_replicate(self):
        # 8 kv heads cannot shard over model=16 -> None
        port, ref = both((256, 4096, 8, 128), ("batch", "seq", "kv_heads", None))
        assert port == P("data", "model", None, None) and same(port, ref)

    def test_missing_mesh_axis_skipped(self):
        # "pod" not in the mesh: batch falls through to "data"
        port, ref = both((32,), ("batch",))
        assert port == P("data") and same(port, ref)

    def test_axis_used_once(self):
        port, ref = both((4096, 4096), ("seq", "heads"))  # both want "model"
        assert port == P("model", None) and same(port, ref)

    def test_none_axes(self):
        port, ref = both((5, 7), (None, None))
        assert port == P(None, None) and same(port, ref)


LOGICAL = sorted(sharding.DEFAULT_RULES) + [None, "unknown"]

if given is not None:

    @settings(max_examples=300, deadline=None, derandomize=True, database=None)
    @given(
        dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 96, 128, 4096]),
                      min_size=1, max_size=5),
        logical=st.lists(st.sampled_from(LOGICAL), min_size=5, max_size=5),
        pod=st.sampled_from([1, 2, 4]),
        data=st.sampled_from([1, 2, 4, 8, 16]),
        model=st.sampled_from([1, 2, 4, 8, 16]),
    )
    def test_spec_for_matches_the_reference(dims, logical, pod, data, model):
        axes = tuple(logical[: len(dims)])
        shape = {"pod": pod, "data": data, "model": model}
        port = ShardingRules(tuple(shape), shape, dict(sharding.DEFAULT_RULES))
        ref = ref_sharding.ShardingRules(tuple(shape), shape, dict(ref_sharding.DEFAULT_RULES))
        assert same(port.spec_for(dims, axes), ref.spec_for(dims, axes))


def test_default_rules_equal_the_reference():
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES


MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _rules(module, mesh):
    sizes, axes = MESHES[mesh]
    return module.ShardingRules(axes, dict(zip(axes, sizes)), dict(module.DEFAULT_RULES))


def _flat(tree, prefix=()):
    """Leaves by path: dicts by key, NamedTuples by field."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], prefix + (k,)).items()}
    if isinstance(tree, (AdamWState, RefAdamWState)):
        return {p: v for f in tree._fields for p, v in _flat(getattr(tree, f), prefix + (f,)).items()}
    return {prefix: tree}


def _assert_specs_equal(port_tree, ref_tree):
    port, ref = _flat(port_tree), _flat(ref_tree)
    assert sorted(port) == sorted(ref)
    for path in ref:
        assert same(port[path], ref[path]), (path, port[path], ref[path])


def test_archs_equal_the_reference():
    assert ARCHS == REF_ARCHS


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_equal_the_reference(arch, mesh):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    rules, rrules = _rules(sharding, mesh), _rules(ref_sharding, mesh)
    spec_tree, rspec_tree = model_spec(cfg), ref_model_spec(rcfg)
    _assert_specs_equal(sharding.param_specs(rules, spec_tree), ref_sharding.param_specs(rrules, rspec_tree))
    _assert_specs_equal(sharding.opt_state_specs(rules, spec_tree, None),
                        ref_sharding.opt_state_specs(rrules, rspec_tree, None))
    for shape, rshape in zip(SHAPES, REF_SHAPES):
        ins, rins = input_specs(cfg, shape), ref_input_specs(rcfg, rshape)
        if "batch" in rins:
            _assert_specs_equal(sharding.batch_specs(rules, ins["batch"]),
                                ref_sharding.batch_specs(rrules, rins["batch"]))
            _assert_specs_equal(sharding.batch_specs(rules, ins["batch"], "seq"),
                                ref_sharding.batch_specs(rrules, rins["batch"], "seq"))
        if "cache" in rins:
            _assert_specs_equal(sharding.tree_specs_from_axes(rules, ins["cache"], cache_axes(cfg)),
                                ref_sharding.tree_specs_from_axes(rrules, rins["cache"], ref_cache_axes(rcfg)))


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "") if isinstance(dtype, torch.dtype) else np.dtype(dtype).name


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_cache_spec_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    port = _flat(abstract_params(model_spec(cfg), cfg.param_dtype))
    ref = _flat(ref_abstract_params(ref_model_spec(rcfg), rcfg.param_dtype))
    assert sorted(port) == sorted(ref)
    for path, leaf in port.items():
        assert leaf.device.type == "meta"  # nothing allocated
        assert (tuple(leaf.shape), _dtype_name(leaf.dtype)) == (tuple(ref[path].shape),
                                                                _dtype_name(ref[path].dtype)), path
    assert _flat(cache_axes(cfg)) == _flat(ref_cache_axes(rcfg))
    if cfg.has_decode:
        port_cache, ref_cache = _flat(cache_spec(cfg, 4, 64)), _flat(ref_cache_spec(rcfg, 4, 64))
        assert sorted(port_cache) == sorted(ref_cache)
        for path, (shape, dtype) in port_cache.items():
            assert (tuple(shape), _dtype_name(dtype)) == (tuple(ref_cache[path].shape),
                                                          _dtype_name(ref_cache[path].dtype)), path


def test_placements_per_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        axis_names = ("pod", "data", "model")

    specs = {"w": P(("pod", "data"), None, "model"), "b": P(None), "opt": AdamWState(0, {"m": P("model")}, {})}
    got = sharding.shardings_from_specs(Mesh3(), {"w": specs["w"], "b": specs["b"]})
    assert got == {"w": (Shard(0), Shard(0), Shard(2)), "b": (Replicate(), Replicate(), Replicate())}
    opt = sharding.shardings_from_specs(Mesh3(), AdamWState(P(), {"m": P("model")}, {}))
    assert opt.mu == {"m": (Replicate(), Replicate(), Shard(0))} and opt.count == (Replicate(),) * 3


def test_make_rules_reads_the_mesh():
    rules = sharding.make_rules(DRYRUN_MESH, {"embed": ()})
    assert rules.mesh_axes == ("data", "model") and rules.mesh_shape == {"data": 1, "model": 1}
    assert rules.rules["embed"] == () and rules.rules["heads"] == ("model",)
    assert mesh_name(DRYRUN_MESH) == "1x1:data,model"


def test_constrain_is_a_no_op_on_one_device_and_raises_when_it_would_shard():
    x = torch.zeros(4, 8)
    assert constrain(x, ("batch", None)) is x  # no scope
    one = sharding.make_rules(DRYRUN_MESH)
    seen = []

    def spec_fn(shape, axes):
        seen.append((shape, axes))
        return one.spec_for(shape, axes)

    with logical_sharding_scope(spec_fn):
        assert constrain(x, ("batch", "seq")) is x
        assert constrain(x, ("batch",)) is x  # rank differs: left alone, as in the reference
    assert seen == [((4, 8), ("batch", "seq"))]
    plain = torch.zeros(32, 8)
    with logical_sharding_scope(rules_16x16().spec_for):
        assert constrain(plain, ("batch", None)) is plain  # a plain tensor has no placements to change
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with simulated_ranks(2):
        mesh = make_mesh((2, 1), ("data", "model"), "cpu")
        x = distribute_tensor(torch.arange(32.0).reshape(8, 4), mesh.device_mesh, (Replicate(), Replicate()))
        rules = sharding.make_rules(mesh)
        with logical_sharding_scope(rules.spec_for):
            y = constrain(x, ("batch", None))  # a DTensor is redistributed to the spec's placements
            assert y.placements == (Shard(0), Replicate())
            assert torch.equal(y.full_tensor().reconcile(), torch.arange(32.0).reshape(8, 4))
            assert constrain(y, ("batch", None)) is y  # already so placed
            assert constrain(x, (None, None)) is x  # a spec that shards nothing


def test_meshes_past_one_device_raise():
    # the production meshes are Queue A 10b.2's
    with pytest.raises(NotImplementedError, match="10b.2"):
        make_production_mesh()
    with pytest.raises(NotImplementedError, match="10b.2"):
        make_production_mesh(multi_pod=True)
    # a mesh of two devices needs a process group of two ...
    with pytest.raises(RuntimeError, match="world size 2"):
        make_mesh((2, 1), ("data", "model"), "cpu")
    # ... and over one, the train step builds on it; the other kinds are 10b.2's
    cfg = get_config("qwen3-0.6b")
    with simulated_ranks(2):
        two = make_mesh((2, 1), ("data", "model"), "cpu")
        assert two.device_mesh.shape == (2, 1) and two.device_mesh.mesh_dim_names == ("data", "model")
        bundle = build_step(cfg, SHAPES[0], two)
        assert bundle.kind == "train" and len(bundle.in_shardings) == 3
        with pytest.raises(NotImplementedError, match="10b.2"):
            build_step(cfg, ShapeConfig("d", 16, 2, "decode"), two)
    cpu = single_device_mesh("cpu")
    assert cpu.device == torch.device("cpu") and cpu.shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            single_device_mesh()  # the card unless the CPU is asked for
    cfg = get_config("qwen3-0.6b")
    wide = type(DRYRUN_MESH)(("data", "model"), (16, 16))
    with pytest.raises(NotImplementedError, match="10b.2"):
        build_step(cfg, SHAPES[0], wide).lower()  # the dry run on a mesh of more than one device
