"""The port's sharding rules, collective accounting and roofline against
the JAX package's, on the CPU with no process group: the specs are
computed on stand-in meshes of the form each package reads (16x16, as
``tests/test_config_sharding.py``, and the port's 32x8), and must equal
JAX's tuple for tuple, leaf by leaf, for every assigned architecture.
Numbers compare exactly, or within 1e-12 relative where float sums
differ in order."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.analysis.hlo_parse import parse_collectives  # noqa: E402
from repro.analysis import roofline as jrl  # noqa: E402
from repro.config import ALL_SHAPES as JSHAPES  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.configs import ASSIGNED as JASSIGNED  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import dryrun as jdr  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.analysis.collectives import CollectiveLog, collective_bytes  # noqa: E402
from repro_torch.config import ALL_SHAPES, get_arch  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

MESHES = {"16x16": (16, 16), "32x8": (32, 8)}


class _JaxMesh:
    """Duck-typed mesh of the JAX package's form."""
    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


class _TorchMesh:
    """Duck-typed mesh of a ``DeviceMesh``'s form."""
    def __init__(self, shape, names=("data", "model")):
        self.mesh_dim_names = names
        self.shape = tuple(shape)


_SHAPES = {}


def _param_shapes(arch):
    if arch not in _SHAPES:
        _SHAPES[arch] = (jax.eval_shape(lambda k: JT.init_params(jax_get_arch(arch), k),
                                        jax.random.PRNGKey(0)),
                         sh.param_shapes(get_arch(arch)))
    return _SHAPES[arch]


def _jax_leaves(tree):
    """[(key path as strings, spec tuple)] of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return [(tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path), tuple(s))
            for path, s in flat]


def _port_leaves(tree):
    out = []
    sh.walk(tree, lambda path, leaf: out.append((path, tuple(leaf.shape))))
    return out


def _same_specs(jspecs, tspecs, tshapes):
    jl = _jax_leaves(jspecs)
    assert len(jl) == len(_port_leaves(tshapes))
    for path, spec in jl:
        assert sh.leaf_at(tspecs, path) == spec, (path, spec, sh.leaf_at(tspecs, path))


def _policies():
    return [sh.Policy(), dataclasses.replace(dr.OPTIMIZED_POLICY, moe_expert_parallel=True)]


def _jax_policy(p):
    return jsh.Policy(**dataclasses.asdict(p))


def test_assigned_matches_jax():
    assert ASSIGNED == JASSIGNED
    assert [s.name for s in ALL_SHAPES] == [s.name for s in JSHAPES]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_jax(arch, mesh):
    jshapes, tshapes = _param_shapes(arch)
    for training in (True, False):
        for pol in _policies():
            js = jsh.param_specs(jax_get_arch(arch), _JaxMesh(MESHES[mesh]), training=training,
                                 policy=_jax_policy(pol))
            ts = sh.param_specs(get_arch(arch), _TorchMesh(MESHES[mesh]), training=training,
                                policy=pol, shapes=tshapes)
            _same_specs(js, ts, tshapes)


def test_param_shapes_match_jax():
    """The meta tree the port's rules walk has JAX's leaves and shapes."""
    for arch in ASSIGNED:
        jshapes, tshapes = _param_shapes(arch)
        jl = {p: tuple(leaf.shape) for p, leaf in
              ((tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf)
               for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0])}
        tl = dict(_port_leaves(tshapes))
        assert jl == tl, arch


def _jax_cache_tree(cfg, batch, seq_len):
    return jdr.cache_template(cfg, batch, seq_len)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_specs_match_jax(arch, mesh):
    """Decode's cache (batch 128 over dp, and long_500k's batch 1, whose
    sequence takes the dp axes) for both policies' cache choices; the
    port's extra leaf, ``cross_valid``, takes ``enc_mask``'s rule."""
    for shape in ("decode_32k", "long_500k"):
        s = jdr.get_shape(shape)
        jcfg, _ = jdr.serving_variant(jax_get_arch(arch), s)
        tcfg, _ = dr.serving_variant(get_arch(arch), s)
        jtree = _jax_cache_tree(jcfg, s.global_batch, s.seq_len)
        ttree = dr.cache_template(tcfg, s.global_batch, s.seq_len)
        for pol in (sh.Policy(), sh.Policy(seq_sharded_cache=False)):
            js = jsh.cache_specs_for(jtree, jcfg, _JaxMesh(MESHES[mesh]), s.global_batch,
                                     _jax_policy(pol))
            ts = sh.cache_specs_for(ttree, tcfg, _TorchMesh(MESHES[mesh]), s.global_batch, pol)
            for path, spec in _jax_leaves(js):
                assert sh.leaf_at(ts, path) == spec, (path, spec)
            n_port = len(_port_leaves(ttree))
            assert n_port == len(_jax_leaves(js)) + (1 if tcfg.encdec else 0)
            if tcfg.encdec is not None:
                b = "data" if s.global_batch % MESHES[mesh][0] == 0 else None
                assert ts["cross_valid"] == (b, None)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_template_matches_jax(arch):
    """The port's decode cache tree has JAX's leaves and shapes, and one
    more for an enc-dec model: ``cross_valid``."""
    jtree = _jax_cache_tree(jax_get_arch(arch), 4, 64)
    ttree = dr.cache_template(get_arch(arch), 4, 64)
    for path, leaf in _port_leaves(ttree):
        if path == ("cross_valid",):
            assert leaf == (4, get_arch(arch).encdec.max_source_positions)
            continue
        assert tuple(sh.leaf_at(jtree, path).shape) == leaf, path


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_act_and_batch_specs_match_jax(mesh):
    for arch in ASSIGNED:
        for s in ALL_SHAPES:
            js = jdr.get_shape(s.name)
            for pol in (sh.Policy(), sh.Policy(act_model_sharded=False)):
                assert sh.act_spec(get_arch(arch), _TorchMesh(MESHES[mesh]), s.global_batch,
                                   pol) == tuple(jsh.act_spec(jax_get_arch(arch),
                                                              _JaxMesh(MESHES[mesh]),
                                                              js.global_batch,
                                                              _jax_policy(pol)))
            jb = jsh.batch_specs(jax_get_arch(arch), js, _JaxMesh(MESHES[mesh]))
            tb = sh.batch_specs(get_arch(arch), s, _TorchMesh(MESHES[mesh]))
            assert tb == {k: tuple(v) for k, v in jb.items()}, (arch, s.name)


def test_multi_pod_specs_match_jax():
    """On (pod, data, model) the dp axes are a tuple, as in JAX."""
    shape = (2, 32, 8)
    names = ("pod", "data", "model")
    for arch in ("qwen3-1.7b", "mixtral-8x7b", "jamba-v0.1-52b"):
        jshapes, tshapes = _param_shapes(arch)
        js = jsh.param_specs(jax_get_arch(arch), _JaxMesh(shape, names), training=True)
        ts = sh.param_specs(get_arch(arch), _TorchMesh(shape, names), training=True,
                            shapes=tshapes)
        _same_specs(js, ts, tshapes)
    assert tmesh.dp_axes(_TorchMesh(shape, names)) == ("pod", "data")
    assert tmesh.axis_size(_TorchMesh(shape, names), ("pod", "data")) == 64


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = _TorchMesh((2, 32, 8), ("pod", "data", "model"))
    assert sh.placements((None, "model"), m) == (Replicate(), Replicate(), Shard(1))
    assert sh.placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sh.placements((("data", "pod"), None), m)       # not in the mesh's order
    with pytest.raises(ValueError):
        sh.placements(("model", "model"), m)


def test_production_mesh_shape():
    """The production mesh keeps 'model' inside one 8-card node."""
    try:
        m = tmesh.make_production_mesh()
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (32, 8)
        assert tmesh.make_production_mesh() is m
        mp = tmesh.make_production_mesh(multi_pod=True)
        assert mp.mesh_dim_names == ("pod", "data", "model") and tuple(mp.shape) == (2, 32, 8)
    finally:
        tmesh.teardown_mesh()
    assert not torch.distributed.is_initialized()


def test_mesh_constants_are_the_h100s():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12
    assert tmesh.AXIS_BW == {"model": 450e9, "data": 50e9, "pod": 50e9}


# ---------------------------------------------------------------------------
# collectives and the roofline


def test_recorded_collectives_match_the_hlo_parser():
    """``test_hlo_collective_parser``'s three collectives, fed as recorded
    calls, give JAX's ``CollectiveStats``."""
    txt = """
  %ag = bf16[16,1024]{1,0} all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[256]{0} all-reduce(%x), replica_groups={{0,1}}, to_apply=%sum
  %cp = bf16[8,8]{1,0} collective-permute(%y), source_target_pairs={{0,1}}
  %noise = f32[4]{0} add(%a, %b)
"""
    j = parse_collectives(txt)
    log = CollectiveLog()
    log.record("all-gather", 16 * 1024 * 2, 4, "model")
    log.record("all-reduce", 256 * 4, 2, "data")
    log.record("collective-permute", 8 * 8 * 2, 2, "model")
    t = log.stats()
    assert t.counts == j.counts
    assert t.bytes_per_chip == pytest.approx(j.bytes_per_chip, rel=1e-12)
    assert t.by_kind == pytest.approx(j.by_kind, rel=1e-12)
    assert t.by_axis == pytest.approx({"model": 16 * 1024 * 2 * 3 / 4 + 128, "data": 1024.0})


@pytest.mark.parametrize("kind,expect", [("all-gather", 750.0), ("reduce-scatter", 750.0),
                                         ("all-reduce", 1500.0), ("all-to-all", 750.0),
                                         ("collective-permute", 1000.0)])
def test_collective_arithmetic(kind, expect):
    assert collective_bytes(kind, 1000, 4) == expect
    with pytest.raises(ValueError):
        collective_bytes("broadcast", 1000, 4)


def test_extrapolate_matches_jax():
    pts = [(2, 10.0, 100.0, 4.0), (4, 18.0, 160.0, 6.0)]
    for layers in (4, 10, 95):
        j = jrl.extrapolate(*(jrl.ProbePoint(*p) for p in pts), layers=layers)
        t = rl.extrapolate(*(rl.ProbePoint(*p) for p in pts), layers=layers)
        for k in ("flops", "bytes", "coll", "flops_per_layer", "coll_per_layer"):
            assert t[k] == j[k], k


def test_roofline_terms_on_the_h100_constants():
    tot = {"flops": 989e12, "bytes": 6.7e12, "coll": 95e9,
           "coll_by_axis": {"model": 45e9, "data": 50e9}}
    r = rl.build_roofline("a", "s", "m", 256, tot, model_flops=989e12 * 128)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.1 + 1.0)
    assert r.bottleneck == "memory" and r.step_time_s == r.memory_s
    assert r.useful_ratio == pytest.approx(0.5)
    assert set(r.as_row()) == set(jrl.build_roofline("a", "s", "m", 256, tot, 1.0).as_row())
