"""The port's sharding rules (repro_torch.sharding, repro_torch.compat)
against the JAX package's: the same rules, flag for flag, and the same
spec for every shape on the meshes (4, 4), (16, 16) and (2, 16, 16)."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import NamedSharding  # noqa: E402

from _hyp import given, settings, st  # noqa: E402
from repro.compat import abstract_mesh as jax_abstract_mesh  # noqa: E402
from repro.sharding import rules as R  # noqa: E402
from repro_torch.compat import AbstractMesh, abstract_mesh  # noqa: E402
from repro_torch.sharding import rules as T  # noqa: E402

MESHES = [((4, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# (reference rules, port rules): every flag of both constructors
RULES = [
    (R.default_rules(), T.default_rules()),
    (R.default_rules(True), T.default_rules(True)),
    (R.serving_rules(), T.serving_rules()),
    (R.serving_rules(True), T.serving_rules(True)),
    (R.serving_rules(shard_cache_seq=False),
     T.serving_rules(shard_cache_seq=False)),
    (R.serving_rules(True, False), T.serving_rules(True, False)),
]
LOGICAL = ["batch", "heads", "kv_heads", "mlp", "embed", "vocab", "experts",
           "q_lora", "kv_lora", "head_dim", "seq", "layers", "embed_repl",
           "conv", "state", None]


def test_rules_equal_reference_flag_for_flag():
    for ref, port in RULES:
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for name in LOGICAL[:-1]:
            assert port.axis_prefs(name) == ref.axis_prefs(name)


@settings(max_examples=60, deadline=None)
@given(mesh_i=st.integers(0, len(MESHES) - 1),
       rules_i=st.integers(0, len(RULES) - 1),
       dims=st.lists(st.sampled_from([1, 2, 3, 8, 10, 16, 32, 56, 128, 256,
                                      512]), min_size=1, max_size=5),
       names=st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=5))
def test_spec_for_shape_equals_reference(mesh_i, rules_i, dims, names):
    """The port's spec is the reference's PartitionSpec entry for entry,
    it is valid (no mesh axis used twice, every sharded dim divisible by
    its axes' product), and its block is NamedSharding.shard_shape's."""
    n = min(len(dims), len(names))
    dims, names = dims[:n], names[:n]
    sizes, axes = MESHES[mesh_i]
    ref_rules, port_rules = RULES[rules_i]
    jmesh = jax_abstract_mesh(sizes, axes)
    mesh = abstract_mesh(sizes, axes)
    ref = R.spec_for_shape(jmesh, names, dims, ref_rules)
    spec = T.spec_for_shape(mesh, names, dims, port_rules)
    assert spec == tuple(ref)
    used = []
    for dim, entry in zip(dims, spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        used += list(group)
        assert dim % math.prod(mesh.shape[a] for a in group) == 0
    assert len(used) == len(set(used))
    assert T.shard_shape(mesh, spec, dims) == tuple(
        NamedSharding(jmesh, ref).shard_shape(tuple(dims)))


@pytest.mark.parametrize("sizes,axes", MESHES)
def test_serving_rules_no_data_on_cache_seq_conflict(sizes, axes):
    """The reference's test on the port: the serving rules shard the
    cache's sequence over `model`, the default rules do not."""
    mesh, jmesh = abstract_mesh(sizes, axes), jax_abstract_mesh(sizes, axes)
    logical = ("layers", "batch", "kv_heads", "seq", "head_dim")
    shape = (4, 8, 1, 4096, 128)
    spec = T.spec_for_shape(mesh, logical, shape, T.serving_rules())
    assert spec[3] == "model", "serving rules must shard cache seq on model"
    spec_d = T.spec_for_shape(mesh, logical, shape, T.default_rules())
    assert spec_d[3] is None
    assert spec == tuple(R.spec_for_shape(jmesh, logical, shape,
                                          R.serving_rules()))
    assert spec_d == tuple(R.spec_for_shape(jmesh, logical, shape,
                                            R.default_rules()))


def test_tree_specs_equal_reference():
    import jax
    logical = {"a": ("batch", "embed"), "b": {"c": ("vocab", "embed"),
                                              "d": ("embed_repl",)}}
    shapes = {"a": (256, 4096), "b": {"c": (151936, 4096), "d": (4096,)}}
    for sizes, axes in MESHES:
        ref = R.tree_specs(jax_abstract_mesh(sizes, axes), logical, shapes)
        port = T.tree_specs(abstract_mesh(sizes, axes), logical, shapes)
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        got = {"/".join(k.key for k in p): tuple(ns.spec) for p, ns in flat}
        assert got == {"a": port["a"], "b/c": port["b"]["c"],
                       "b/d": port["b"]["d"]}


def test_normalize_and_shard_shape():
    assert T.normalize([("data",), (), ("pod", "data"), None, "model"]) == (
        "data", None, ("pod", "data"), None, "model")
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert T.shard_shape(mesh, (("pod", "data"),), (64, 7)) == (2, 7)
    with pytest.raises(ValueError, match="does not divide"):
        T.shard_shape(mesh, ("model",), (8,))
    with pytest.raises(ValueError, match="more entries"):
        T.shard_shape(mesh, ("model", None), (16,))


def test_abstract_mesh():
    mesh = abstract_mesh((16, 16), ("data", "model"))
    assert isinstance(mesh, AbstractMesh)
    assert mesh.shape == dict(jax_abstract_mesh((16, 16),
                                                ("data", "model")).shape)
    assert mesh.axis_names == ("data", "model") and mesh.size == 256
    assert mesh.axis_size("model") == 16
    with pytest.raises(ValueError, match="exchanges no data"):
        mesh.all_to_all(torch.zeros(16, 2), "model")
    one = abstract_mesh((1, 1), ("data", "model"))
    t = torch.arange(6.0).reshape(3, 2)
    assert one.all_to_all(t, "model") is t
    with pytest.raises(ValueError, match="against axes"):
        abstract_mesh((1,), ("data", "model"))
