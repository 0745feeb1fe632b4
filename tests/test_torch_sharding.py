"""The port's logical-axis sharding rules (``repro_torch/distributed/
sharding.py``) against the reference's: each case of
``tests/test_sharding.py``, then a parity matrix. For every leaf of the
step arguments (weights, optimizer state, caches, batch) of all 13
configs x 3 shapes x both production meshes, the port's ``pspec_for`` must
equal the reference's (exact equality of the specs; the reference's mesh
is ``tests/test_sharding.py``'s ``fake_mesh``: the one CPU device
repeated), and the logical axes of every weight, optimizer-state and cache
leaf must equal the reference's, leaf for leaf once the reference's
stacked segments are unstacked."""
import collections

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

import repro.configs as rc  # noqa: E402
import repro.distributed.sharding as rsh  # noqa: E402
import repro.models.api as ref_api  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
import repro_torch.distributed.sharding as sh  # noqa: E402
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,  # noqa: E402
                                     make_tp_mesh)
from repro_torch.models.api import make_step_bundle  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def fake_mesh(shape=(4, 2), axes=("data", "model")):
    devs = np.array(jax.devices() * (int(np.prod(shape))
                                     // len(jax.devices()) + 1))
    return JaxMesh(devs[:int(np.prod(shape))].reshape(shape), axes)


def mesh(shape=(4, 2), axes=("data", "model")):
    """A mesh by its axes alone (no devices), as the dry-run reads one."""
    return sh.Mesh(tuple(axes), tuple(shape))


def test_pspec_basic():
    spec = sh.pspec_for(("batch", "seq", None), mesh(), sh.TRAIN_RULES,
                        (8, 16, 32))
    assert spec == ("data",)


def test_pspec_drops_non_divisible():
    # heads=3 not divisible by model=2 => replicated
    spec = sh.pspec_for(("batch", None, "heads", None), mesh(),
                        sh.TRAIN_RULES, (8, 16, 3, 64))
    assert spec == ("data",)
    spec2 = sh.pspec_for(("batch", None, "heads", None), mesh(),
                         sh.TRAIN_RULES, (8, 16, 4, 64))
    assert spec2 == ("data", None, "model")


def test_pspec_axis_dedup():
    """kv cache (batch, kv_seq, kv_heads): kv_seq takes 'model' first, so
    kv_heads must be dropped (a mesh axis can appear only once)."""
    spec = sh.pspec_for(("batch", "kv_seq", "kv_heads", None), mesh(),
                        sh.ShardingRules(kv_seq="model", kv_heads="model"),
                        (8, 64, 2, 32))
    assert spec == ("data", "model")


def test_pod_axis_dropped_on_single_pod():
    assert sh.pspec_for(("batch",), mesh(), sh.TRAIN_RULES, (8,)) == (
        "data",)
    mesh3 = mesh((2, 2, 2), ("pod", "data", "model"))
    assert sh.pspec_for(("batch",), mesh3, sh.TRAIN_RULES, (8,)) == (
        ("pod", "data"),)


def test_decode_rules_replicate_batch():
    rules = sh.rules_for_shape("decode", 128)
    assert rules.batch is None
    assert rules.kv_seq == ("data", "model")
    assert sh.rules_for_shape("train").batch == ("pod", "data")
    assert sh.rules_for_shape("prefill") == sh.PREFILL_RULES
    with pytest.raises(ValueError):
        sh.rules_for_shape("serve")


def test_shard_noop_outside_ctx():
    x = torch.ones(4, 4)
    assert sh.shard(x, ("batch", None)) is x


def test_shard_applies_in_ctx():
    """On a one-device mesh the annotation keeps the tensor; the context
    restores the previous mesh and rules on exit."""
    with sh.sharding_ctx(sh.single_device_mesh(), sh.TRAIN_RULES):
        x = torch.ones(4, 4)
        y = sh.shard(x, ("batch", None))
        assert y is x and y.shape == x.shape
        assert sh.current_rules() is sh.TRAIN_RULES
    assert sh.current_mesh() is None and sh.current_rules() is None


def test_shard_over_a_mesh_waits_for_tensor_parallelism():
    """On a larger mesh ``shard()`` returns meta and real tensors alike:
    the reference's constraint changes no value, and placing a tensor's
    pieces is ``spmd.place``'s (training on a mesh, ported). The serving
    TP mesh and the training mesh give CPU shards, and without the cards
    ask for them or for an explicit device list."""
    with sh.sharding_ctx(mesh(), sh.TRAIN_RULES):
        m = torch.empty(8, 4, device="meta")
        assert sh.shard(m, ("batch", None)) is m
        x = torch.ones(8, 4)
        assert sh.shard(x, ("batch", None)) is x
        ns = sh.named_sharding(("batch", "heads"), (8, 4))
        assert ns == sh.NamedSharding(mesh(), ("data", "model"))
    assert sh.named_sharding(("batch",), (8,)) is None
    assert make_tp_mesh(2, "cpu").devices == (torch.device("cpu"),) * 2
    cpu = make_mesh((4, 2), ("data", "model"), "cpu")
    assert cpu.devices == (torch.device("cpu"),) * 8
    assert cpu.shape == mesh().shape and mesh().devices is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="explicit list of 2"):
            make_tp_mesh(2)
        with pytest.raises(RuntimeError, match="explicit list of 8"):
            make_mesh((4, 2), ("data", "model"))


def test_batch_axes():
    assert sh.batch_axes(mesh(), sh.TRAIN_RULES) == "data"
    assert sh.batch_axes(None) is None


def test_tree_shardings_and_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    tree = {"w": (("fsdp", "mlp"), (32, 48)), "n": ((None,), (7,))}
    got = sh.tree_shardings(tree, single, sh.TRAIN_RULES)
    assert got == {"w": sh.NamedSharding(single, ("data", "model")),
                   "n": sh.NamedSharding(single, ())}
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "data"))


# -- parity with the reference over every leaf ------------------------------

def _ref_leaves(tree):
    return jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], tuple)
        and all(isinstance(i, int) for i in x[1])
        and (x[0] is None or isinstance(x[0], tuple)))


def _unstacked(tree, repeats, stacked=False):
    """The reference's (axes, shape) leaves with each leaf of a segment
    that repeats (a leading None axis of the repeat count) counted once
    per layer without that axis."""
    if sh.is_axes_leaf(tree):
        axes, shape = tree
        if stacked:
            assert axes[0] is None
            return [(tuple(axes[1:]), tuple(shape[1:]))] * shape[0]
        return [(tuple(axes), tuple(shape))]
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in repeats:
                for seg, rep in zip(v, repeats[k], strict=True):
                    out += _unstacked(seg, repeats, rep > 1)
            else:
                out += _unstacked(v, repeats, stacked)
    else:
        for v in tree:
            out += _unstacked(v, repeats, stacked)
    return out


def _counts(leaves):
    return collections.Counter((tuple(a) if a is not None else None,
                                tuple(s)) for a, s in leaves)


@pytest.mark.parametrize("arch", tc.ARCH_IDS)
def test_pspec_and_axes_parity_with_reference(arch):
    cfg, ref_cfg = tc.get_config(arch), rc.get_config(arch)
    ref_lm = RefLM(ref_cfg)
    repeats = {"segments": [s.repeat for s in ref_lm.program],
               "encoder": [s.repeat for s in ref_lm.enc_program]}
    checked = 0
    for shape_name in SHAPES:
        shape, ref_shape = tc.SHAPES[shape_name], rc.SHAPES[shape_name]
        for multi in (False, True):
            m = make_production_mesh(multi_pod=multi)
            ref_m = fake_mesh(tuple(m.axis_sizes), m.axis_names)
            rules = sh.rules_for_shape(shape.kind, shape.global_batch)
            ref_rules = rsh.rules_for_shape(shape.kind, shape.global_batch)
            with sh.sharding_ctx(m, rules):
                b = make_step_bundle(cfg, shape)
            with rsh.sharding_ctx(ref_m, ref_rules):
                rb = ref_api.make_step_bundle(ref_cfg, ref_shape)
            assert b.static_meta == rb.static_meta
            # every leaf of the step's arguments: the same spec
            for axes, shp in tree_leaves(b.args_axes, is_leaf=sh.is_axes_leaf):
                want = rsh.pspec_for(axes or (), ref_m, ref_rules, shp)
                assert sh.pspec_for(axes or (), m, rules, shp) == \
                    tuple(want), (arch, shape_name, multi, axes, shp)
                checked += 1
            if multi:
                continue
            # the same logical axes, leaf for leaf
            for i, (port_grp, ref_grp) in enumerate(
                    zip(b.args_axes[:-1], rb.args_axes[:-1])):
                if i == 1:             # decode caches: a list of segments
                    ref_grp = {"segments": ref_grp}
                assert _counts(tree_leaves(port_grp,
                                           is_leaf=sh.is_axes_leaf)) == \
                    _counts(_unstacked(ref_grp, repeats)), (shape_name, i)
            assert _counts(tree_leaves(b.args_axes[-1],
                                       is_leaf=sh.is_axes_leaf)) == \
                _counts(_ref_leaves(rb.args_axes[-1]))
    assert checked > 0
