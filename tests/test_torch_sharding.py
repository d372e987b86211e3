"""The port's distribution layer against the reference's.

In process: the logical-axis rules (``build_rules``: mapping and
warnings) of every arch × shape × mesh, and the parameter, cache and
batch specs of every leaf of every arch at full size, held to the
reference's. The reference's rules and specs read only ``mesh.shape``,
so a stand-in with a ``shape`` dict takes the place of a JAX mesh (no
multi-device JAX), and the port's read the same stand-in. The port's
trees hold the layer axis unstacked, so a port leaf's spec must equal
the reference's spec of the stacked leaf with its stacked leading
entries dropped.

On four gloo CPU ranks (one spawn for the file, bodies in
``tests/_torch_sharding_ranks.py``): the reduced qwen3-moe-30b-a3b train
step on a (2, 2) ("data", "model") mesh (DP × TP × EP + FSDP state)
equals the single-process step (loss rel 1e-4, parameters max |Δ| <
5e-4: ``tests/test_distribution.py``'s tolerances); the dense prefill
and a decode step under the rules equal the unsharded ones (1e-5,
float32); expert-parallel ``moe_ffn`` equals the local dispatch, with
its gradient.
"""

from __future__ import annotations

import functools
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_sharding_ranks as ranks
from repro.configs import registry as rreg
from repro.models import model as RM
from repro.sharding import params as rsp
from repro_torch.configs import registry as preg
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun as PD
from repro_torch.launch import mesh as pmesh
from repro_torch.models import model as PM
from repro_torch.sharding import params as psp
from repro_torch.sharding import rules as prules
from repro_torch.tree import tree_leaves

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}


class _Mesh:
    """Stand-in mesh: the rules read ``shape`` alone."""

    def __init__(self, shape):
        self.shape = dict(shape)


@functools.lru_cache(maxsize=None)
def _ref_dryrun():
    """The reference's dry-run module, imported with the environment
    kept: it sets ``XLA_FLAGS`` (512 host devices) at import, which
    must not reach this process's JAX."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def _rules(arch, shape, mesh):
    rd = _ref_dryrun()
    m = _Mesh(MESHES[mesh])
    ref = rd.build_rules(rreg.get_config(arch), rd.SHAPES[shape], m)
    port = PD.build_rules(preg.get_config(arch), SHAPES[shape], m)
    return ref, port


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", preg.ARCH_IDS)
def test_build_rules_equal_reference(arch, mesh):
    for shape in SHAPES:
        ref, port = _rules(arch, shape, mesh)
        assert port.mapping == ref.mapping, (arch, shape, mesh)
        assert port.warnings == ref.warnings, (arch, shape, mesh)
        for logical in [("batch", "seq", "embed"),
                        ("batch", "heads", "seq", "head_dim"),
                        ("batch", "seq", "vocab"),
                        ("batch", "kv_heads", "kv_seq", "head_dim")]:
            assert tuple(port.spec(*logical)) == tuple(ref.spec(*logical))


# -- specs --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = rreg.get_config(arch)
    params = jax.eval_shape(lambda k: RM.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    cache = None
    if not cfg.is_encoder:
        cache = jax.eval_shape(lambda: RM.init_cache(cfg, 128, 1024))
    return params, cache


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    cfg = preg.get_config(arch)
    params = PD._meta_params(cfg)
    cache = None
    if not cfg.is_encoder:
        cache = PM.init_cache(cfg, 128, 1024, device="meta")
    return params, cache


def _ref_by_path(spec_tree):
    from jax.sharding import PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {rsp._path_str(p): tuple(s) for p, s in flat}


def _port_by_path(spec_tree, path=()):
    if isinstance(spec_tree, prules.P):
        yield path, tuple(spec_tree)
    elif isinstance(spec_tree, dict):
        for k, v in spec_tree.items():
            yield from _port_by_path(v, path + (k,))
    elif isinstance(spec_tree, (list, tuple)):
        for i, v in enumerate(spec_tree):
            yield from _port_by_path(v, path + (i,))


def _assert_specs_match(port_specs, ref_specs):
    ref = _ref_by_path(ref_specs)
    seen = set()
    n = 0
    for path, spec in _port_by_path(port_specs):
        key = "/".join(str(p) for p in path if not isinstance(p, int))
        n_lead = sum(isinstance(p, int) for p in path)
        assert key in ref, (path, sorted(ref))
        assert spec == ref[key][n_lead:], (path, spec, ref[key])
        seen.add(key)
        n += 1
    assert seen == set(ref), set(ref) ^ seen
    return n


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", preg.ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh, fsdp):
    ref_rules, port_rules = _rules(arch, "train_4k", mesh)
    rp, _ = _ref_shapes(arch)
    pp, _ = _port_shapes(arch)
    n = _assert_specs_match(psp.param_specs(pp, port_rules, fsdp=fsdp),
                            rsp.param_specs(rp, ref_rules, fsdp=fsdp))
    assert n == len(tree_leaves(pp))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", ["16x16", "2x2x2"])
@pytest.mark.parametrize("arch", [a for a in preg.ARCH_IDS
                                  if not preg.get_config(a).is_encoder])
def test_cache_specs_equal_reference(arch, mesh, shape):
    ref_rules, port_rules = _rules(arch, shape, mesh)
    _, rc = _ref_shapes(arch)
    _, pc = _port_shapes(arch)
    _assert_specs_match(psp.cache_specs(pc, port_rules),
                        rsp.cache_specs(rc, ref_rules))


@pytest.mark.parametrize("arch", preg.ARCH_IDS)
def test_batch_specs_equal_reference(arch):
    rd = _ref_dryrun()
    for shape in SHAPES:
        for mesh in MESHES:
            ref_rules, port_rules = _rules(arch, shape, mesh)
            rb = rd.input_specs(rreg.get_config(arch), rd.SHAPES[shape])
            pb = PD.input_specs(preg.get_config(arch), SHAPES[shape])
            assert {k: tuple(v.shape) for k, v in pb.items()} == {
                k: tuple(v.shape) for k, v in rb.items()}
            _assert_specs_match(psp.batch_specs(pb, port_rules),
                                rsp.batch_specs(rb, ref_rules))


def test_spec_for_path_rule_tables_are_the_references():
    assert psp._PARAM_RULES == rsp._PARAM_RULES
    assert psp._CACHE_RULES == rsp._CACHE_RULES


def test_axis_rules_current_and_logical_spec():
    from repro.sharding import rules as rrules
    m = _Mesh(MESHES["2x2"])
    port = prules.make_rules(m)
    ref = rrules.make_rules(m)
    assert port.mapping == ref.mapping
    assert prules.current_rules() is None
    assert tuple(prules.logical_spec("batch", "vocab")) == (None, None)
    with prules.axis_rules(port):
        assert prules.current_rules() is port
        assert tuple(prules.logical_spec("batch", "seq", "vocab")) == (
            "data", None, "model")
        # a mesh axis used once: the later duplicate replicates
        assert tuple(port.spec("heads", "vocab")) == ("model", None)
        x = torch.ones(3)
        assert prules.constrain(x, "batch") is x       # plain: no-op
    assert prules.current_rules() is None


# -- meshes and placements (a gloo world of one, torn down after) ---------------

@pytest.fixture
def world_of_one():
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


def test_meshes_and_placements_on_a_world_of_one(world_of_one):
    from torch.distributed.tensor import Replicate, Shard
    mesh = pmesh.make_small_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert pmesh.dp_axes_for(mesh) == ("data",)
    assert prules.placements(prules.P("data", None, "model"), mesh) == (
        Shard(0), Shard(2))
    assert prules.placements(prules.P(None, None), mesh) == (
        Replicate(), Replicate())
    with pytest.raises(ValueError, match="used twice"):
        prules.placements(prules.P("model", "model"), mesh)
    with pytest.raises(ValueError, match="no axis"):
        prules.placements(prules.P("pipe"), mesh)
    with pytest.raises(ValueError, match="world of 1"):
        pmesh.make_small_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="world of 1"):
        pmesh.make_production_mesh(device="cpu")
    three = pmesh.parse_mesh("1x1x1", device="cpu")
    assert three.mesh_dim_names == ("pod", "data", "model")
    assert pmesh.dp_axes_for(three) == ("pod", "data")
    assert pmesh.parse_mesh(None) is None
    rules = prules.make_rules(three, dp_axes=("pod", "data"))
    # batch → (pod, data) lives on one flattened dim
    assert rules.dmesh.mesh_dim_names == ("pod+data", "model")
    assert rules.dmesh is rules.dmesh
    assert rules.placements("batch", None, "vocab") == (Shard(0), Shard(2))
    with pytest.raises(ValueError, match="major to minor"):
        prules.placements(prules.P(("data", "pod")), three)


def test_distribute_and_gather_round_trip(world_of_one):
    mesh = pmesh.make_small_mesh(device="cpu")
    rules = prules.make_rules(mesh)
    rng = np.random.default_rng(0)
    tree = {"embed": torch.from_numpy(rng.standard_normal((8, 4))),
            "blocks": [{"attn": {"wq": torch.from_numpy(
                rng.standard_normal((4, 6)))}}],
            "step": torch.tensor(3)}
    specs = psp.param_specs(tree, rules, fsdp=True, fsdp_min_size=4)
    assert tuple(specs["embed"]) == ("data", "model")
    d = psp.distribute(tree, specs, rules)
    assert not hasattr(d["step"], "placements")       # scalars stay plain
    for a, b in zip(tree_leaves(tree), tree_leaves(d)):
        assert torch.equal(a, b.full_tensor() if b.ndim else b)


# -- four gloo ranks ------------------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return ranks.spawn(ranks.numerics, tmp_path_factory.mktemp("sharding"))


@pytest.mark.timeout(200)
def test_moe_train_step_on_2x2_matches_single_process(four_ranks):
    out = four_ranks["moe_train_step"]
    assert out["rules"]["experts"] == "model" and out["rules"]["batch"] == (
        "data")
    assert out["loss_single"] == pytest.approx(out["loss_dist"], rel=1e-4)
    assert out["max_param_diff"] < 5e-4, out


@pytest.mark.timeout(200)
def test_dense_prefill_and_decode_under_rules_match_unsharded(four_ranks):
    out = four_ranks["dense_prefill_decode"]
    assert "Shard" in out["prefill_placements"]
    for k in ("prefill_err", "cache_prefill_err", "decode_err",
              "cache_decode_err"):
        assert out[k] < 1e-5, (k, out)


@pytest.mark.timeout(200)
def test_expert_parallel_moe_ffn_matches_local_with_gradient(four_ranks):
    out = four_ranks["moe_expert_parallel"]
    for k in ("y", "dx", "dup", "dgate", "ddown", "drouter"):
        assert out[k] <= 1e-5 * max(1.0, out["scale_" + k]), (k, out)
