"""The port's mesh layout rules (`repro_torch/launch/sharding.py`,
`runtime.py`, `serve/kvcache.py`) against the JAX package's, on abstract
meshes: no process, no device, so the production meshes of 256 and 512
devices are checked as they are.

A layout is a tuple of `PartitionSpec` entries on both sides: the port's
rules return one, and `tuple(P)` of JAX's compares with it directly.
Every arch's parameter tree is taken from JAX's `eval_shape` (paths and
shapes, which is all a rule reads; `convert` maps the trees one to one),
every decode cache from both packages' `init_caches` (the port's on the
meta device).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, get_config as j_get_config
from repro.configs.shapes import decode_context
from repro.core.qtensor import QTensor as JQTensor
from repro.launch import sharding as JS
from repro.models import transformer as JT
from repro.runtime import abstract_mesh as j_abstract_mesh
from repro.runtime import use_mesh as j_use_mesh
from repro.serve import kvcache as JKV
from repro_torch import runtime as RT
from repro_torch.configs import get_config
from repro_torch.core.qtensor import QTensor
from repro_torch.launch import sharding as S
from repro_torch.models import transformer as T
from repro_torch.serve import kvcache as KV
from repro_torch.serve.kvcache import AttnCache

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model"))}


def _meshes(which):
    sizes, names = MESHES[which]
    return j_abstract_mesh(sizes, names), RT.abstract_mesh(sizes, names)


def _key(p) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _spec(ns) -> tuple:
    return tuple(ns.spec) if hasattr(ns, "spec") else tuple(ns)


@pytest.mark.parametrize("multi", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspec_equals_jax(arch, multi):
    """Every parameter of every arch, at full width, on the production
    meshes: the port's layout is JAX's, leaf by leaf (FSDP over data, TP
    over model, the MoE's expert or inner-TP fallback, the vocab axis)."""
    jmesh, tmesh = _meshes(multi)
    cfg = j_get_config(arch)
    params = jax.eval_shape(lambda k: JT.model_init(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        want = tuple(JS.param_pspec(path, leaf, jmesh))
        meta = torch.empty(leaf.shape, device="meta")
        got = S.param_pspec(tuple(_key(p) for p in path), meta, tmesh)
        assert got == want, (path, leaf.shape)
        assert S.serve_param_pspec(tuple(_key(p) for p in path), meta,
                                   tmesh) == tuple(
            JS.serve_param_pspec(path, leaf, jmesh))
        n += 1
    assert n > 5


def test_row_col_and_moe_modes_as_jax():
    """JAX's own cases (tests/test_sharding.py): column and row parallel,
    expert-parallel where E divides, TP inside the experts where not."""
    _, mesh = _meshes("single")
    f = lambda name, shape, path=(): S.param_pspec(
        path + (name,), torch.empty(shape, device="meta"), mesh)
    assert f("Wq", (4096, 4096)) == ("data", "model")
    assert f("Wo", (4096, 4096)) == ("model", "data")
    assert f("Wgate", (128, 2048, 768), ("moe",)) == ("model", "data", None)
    assert f("Wgate", (8, 4096, 14336), ("moe",)) == (None, "data", "model")
    assert f("Wdown", (8, 14336, 4096), ("moe",)) == (None, "model", "data")
    assert f("norm1", (4096,)) == ()


@pytest.mark.parametrize("case", [
    ("data", "model", 128, 64, None),
    ("data", "model", 120, 64, None),     # pad rows: K entry dropped
    ("data", "model", 48, 64, None),      # 3 code rows on 2 shards
    (None, "data", "model", (4, 128, 64), (1, 1, 64)),
])
def test_qtensor_pspecs_equals_jax(case):
    jmesh, tmesh = _meshes("small")
    if len(case) == 5 and isinstance(case[3], tuple):
        spec, shape, sshape = case[:3], case[3], case[4]
    else:
        spec, shape, sshape = case[:2], case[2:4], case[4]
    w = np.zeros(shape, np.float32)
    jq = JQTensor.from_master(jnp.asarray(w), "ternary",
                              scale=None if sshape is None
                              else jnp.ones(sshape))
    tq = QTensor.from_master(torch.from_numpy(w), "ternary",
                             scale=None if sshape is None
                             else torch.ones(sshape))
    jc, js = JS.qtensor_pspecs(P(*spec), jq, jmesh)
    tc, ts = S.qtensor_pspecs(tuple(spec), tq, tmesh)
    assert tc == tuple(jc)
    assert ts == (None if js is None else tuple(js))


@pytest.mark.parametrize("which", ["single", "multi", "small"])
@pytest.mark.parametrize("batch,cap,heads", [
    (128, 32896, 16), (128, 32896, 8), (1, 524416, 16), (4, 100, 3),
    (6, 64, 4), (2, 33, 2)])
def test_kv_pspec_equals_jax(which, batch, cap, heads):
    jmesh, tmesh = _meshes(which)
    with j_use_mesh(jmesh):
        want = tuple(JKV.kv_pspec(batch, cap, heads))
    with RT.use_mesh(tmesh):
        got = KV.kv_pspec(batch, cap, heads)
    assert got == want
    assert KV.kv_pspec(batch, cap, heads) == ()  # no mesh: JAX's P()


def _flat_layouts(tree) -> list:
    """The port's layouts in JAX's flatten order: an AttnCache's k, v,
    pos, a state's fields, dict keys sorted, containers in order (a
    layout is a tuple of entries, a container holds nodes)."""
    if isinstance(tree, AttnCache):
        return [tree.k, tree.v, tree.pos]
    if hasattr(tree, "_fields"):
        return list(tree)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_layouts(tree[k])]
    if isinstance(tree, (list, tuple)) and all(
            isinstance(v, (dict, AttnCache)) or hasattr(v, "_fields")
            for v in tree):
        return [x for v in tree for x in _flat_layouts(v)]
    return [tree]


def _jax_layouts(tree) -> list:
    return [_spec(x) for x in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


@pytest.mark.parametrize("which", ["single", "small"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_pool_shardings_equal_jax(arch, which):
    """Every arch's decode caches (reduced) and its engine's slot pool:
    `cache_shardings`, `slot_axis` and `serve_pool_shardings` as JAX's."""
    jmesh, tmesh = _meshes(which)
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    ctx, src = decode_context(jcfg, 64)
    for batch in (4, 32):
        jc = jax.eval_shape(lambda: JT.init_caches(jcfg, batch, ctx,
                                                   src_len=src))
        tc = T.init_caches(tcfg, batch, ctx, src_len=src, device="meta")
        assert _flat_layouts(S.cache_shardings(tc, tmesh)) == \
            _jax_layouts(JS.cache_shardings(jc, jmesh))
    jp = jax.eval_shape(lambda: JT.init_caches(jcfg, 8, ctx, src_len=src,
                                               per_slot=True))
    jr = jax.eval_shape(lambda: JT.init_caches(jcfg, 1, ctx, src_len=src,
                                               per_slot=True))
    tp = T.init_caches(tcfg, 8, ctx, src_len=src, per_slot=True,
                       device="meta")
    tr = T.init_caches(tcfg, 1, ctx, src_len=src, per_slot=True,
                       device="meta")
    assert _flat_layouts(S.serve_pool_shardings(tp, tr, tmesh)) == \
        _jax_layouts(JS.serve_pool_shardings(jp, jr, jmesh))


def test_rnn_pool_and_slot_axis_as_jax():
    jmesh, tmesh = _meshes("small")
    pool = {"h": (2, 8, 48), "c": (2, 8, 48), "pos": (8,)}
    ref = {"h": (2, 1, 48), "c": (2, 1, 48), "pos": (1,)}
    want = JS.serve_pool_shardings(
        {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in pool.items()},
        {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in ref.items()},
        jmesh)
    got = S.serve_pool_shardings(
        {k: torch.empty(v, device="meta") for k, v in pool.items()},
        {k: torch.empty(v, device="meta") for k, v in ref.items()}, tmesh)
    assert {k: _spec(v) for k, v in want.items()} == got
    for p, s in (((2, 8, 48), (2, 1, 48)), ((8,), (1,)), ((4, 16), (4, 16))):
        assert KV.slot_axis(p, s) == JKV.slot_axis(p, s)
    with pytest.raises(ValueError, match="must be 1"):
        KV.slot_axis((2, 8, 48), (2, 3, 48))


def test_batch_and_state_shardings_as_jax():
    jmesh, tmesh = _meshes("multi")
    for shape in ((64, 8), (3, 8), (32,)):
        want = JS.batch_shardings({"t": jax.ShapeDtypeStruct(shape,
                                                             jnp.int32)},
                                  jmesh)["t"]
        got = S.batch_shardings({"t": torch.empty(shape, device="meta")},
                                tmesh)["t"]
        assert got == _spec(want)


def test_constrain_and_spec_for_outside_a_mesh():
    """No mesh: `spec_for` is JAX's P() and `constrain`/`constrain_cache`
    return their argument itself; on a mesh a plain tensor passes too."""
    x = torch.arange(6.0).reshape(2, 3)
    assert RT.spec_for(x.shape, "data", "model") == ()
    assert RT.constrain(x, "data", "model") is x
    c = KV.cache_init(2, 8, 2, 4, torch.float32)
    assert KV.constrain_cache(c) is c
    _, tmesh = _meshes("small")
    with RT.use_mesh(tmesh):
        assert RT.spec_for((4, 6), ("pod", "data"), "model") == ("data",
                                                                  None)
        assert RT.spec_for((6, 8), None, "model") == (None, "model")
        assert RT.constrain(x, "data", "model") is x
    assert RT.current_mesh() is None


@pytest.mark.parametrize("spec,want", [
    (("data", "model"), "S0 S1"), ((None, "model"), "R S1"),
    ((("data",), None), "S0 R"), ((), "R R"), (("model", None), "R S0")])
def test_placements_follow_the_mesh_dims(spec, want):
    """An entry naming an axis shards that tensor dim on the axis's mesh
    dim; every other mesh dim replicates."""
    _, mesh = _meshes("small")
    got = " ".join(f"S{p.dim}" if p.is_shard() else "R"
                   for p in RT.placements(spec, mesh))
    assert got == want
    _, multi = _meshes("multi")
    pl = RT.placements((("pod", "data"), "model"), multi)
    assert [p.dim for p in pl] == [0, 0, 1]
    with pytest.raises(ValueError, match="order"):
        RT.placements((("data", "pod"), None), multi)
    with pytest.raises(ValueError, match="not on the mesh"):
        RT.placements(("pod", None), mesh)
