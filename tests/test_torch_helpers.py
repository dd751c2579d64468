"""The JAX package's thin public helpers, each against its port
counterpart on the CPU: `launch/serve.packed_model_bytes`,
`core/qlinear.is_quantizable`, `core/quantize.path_str`,
`serve/kvcache.cache_bytes`, `read_row` and `write_row`, the
`ssm_state_init` and `rwkv_state_init` aliases, and `data/loader`'s
`batch_sharding` and `shard_batch`.  All exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro.configs import get_config as j_get_config
from repro.core import bnlstm as JBL
from repro.core import qlinear as JQL
from repro.core import quantize as JQ
from repro.core import recurrent_bn as JBN
from repro.data import loader as JLD
from repro.launch import serve as JSV
from repro.models import mamba2 as JM2
from repro.models import rwkv6 as JRW
from repro.runtime import abstract_mesh as j_abstract_mesh
from repro.serve import kvcache as JKV
from repro_torch import convert
from repro_torch import runtime as RT
from repro_torch.configs import get_config
from repro_torch.core import bnlstm as BL
from repro_torch.core import qlinear as QL
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import tree_paths
from repro_torch.data import loader as LD
from repro_torch.launch import serve as SV
from repro_torch.models import mamba2 as M2
from repro_torch.models import rwkv6 as RW
from repro_torch.serve import kvcache as KV


def test_packed_model_bytes_matches_jax():
    """The (fp32-equivalent, actual) bytes of one exported BN-LSTM tree."""
    kw = dict(vocab=37, d_hidden=48)
    jcfg = JBL.RNNConfig(quant=JQ.QuantSpec(mode="ternary"), **kw)
    tcfg = BL.RNNConfig(quant=Q.QuantSpec(mode="ternary"), **kw)
    var = jax.tree.map(np.asarray, jax.jit(
        JBL.rnn_lm_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    want = JSV.packed_model_bytes(jax.jit(
        JBL.export_packed_rnn, static_argnums=1)(var["params"], jcfg))
    tparams = convert.from_numpy(var["params"], device="cpu")
    got = SV.packed_model_bytes(BL.export_packed_rnn(tparams, tcfg))
    assert got == want and got[1] < got[0]


@pytest.mark.parametrize("spec", [
    {}, {"include": ("wx", "wh")}, {"quantize_embeddings": True},
    {"exclude": ("Wo",)}])
def test_is_quantizable_matches_jax(spec):
    names = ["Wq", "Wo", "wx", "wh", "embed", "head", "b", "sWq", "router"]
    for name in names:
        assert QL.is_quantizable(name, Q.QuantSpec(**spec)) == \
            JQL.is_quantizable(name, JQ.QuantSpec(**spec)), name
    assert QL.is_quantizable("Wq") == JQL.is_quantizable("Wq")


def test_path_str_renders_jax_key_paths():
    """Dict keys, list indices, tuple items and NamedTuple fields: each
    leaf's path reads the same on both sides, in the same order."""
    bn = JBN.BNParams(phi=np.ones(3), gamma=np.zeros(3))
    layer = {"wx": np.zeros((2, 3)), "bn_x": bn, "b": np.zeros(3)}
    tree = {"model": {"params": {"layers": [layer, dict(layer)],
                                 "head": {"ws": np.zeros((3, 2))}}},
            "stack": (np.zeros(2), [np.ones(1)])}
    want = [JQ.path_str(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = [Q.path_str(p) for p, _ in
           tree_paths(convert.from_numpy(tree, device="cpu"))]
    assert got == want and "model/params/layers/1/bn_x/phi" in got


def test_cache_bytes_and_rows_match_jax():
    """`cache_bytes` of a cache; `write_row` then `read_row` of a stacked
    pool leaf (L, B, ...) along its slot axis, and a 1-slot pool's whole
    replace."""
    jc = JKV.cache_init(3, 16, 2, 8, jnp.bfloat16)
    tc = KV.cache_init(3, 16, 2, 8, torch.bfloat16, device="cpu")
    assert KV.cache_bytes(tc) == JKV.cache_bytes(jc) == 3 * 16 * 2 * 8 * 2 * 2
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
    sub = rng.normal(size=(2, 1, 5, 3)).astype(np.float32)
    want = np.asarray(JKV.write_row(jnp.asarray(pool), jnp.asarray(sub), 2))
    tpool = torch.from_numpy(pool.copy())
    got = KV.write_row(tpool, torch.from_numpy(sub), 2)
    assert got is tpool
    np.testing.assert_array_equal(got.numpy(), want)
    back = KV.read_row(got, sub.shape, 2)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        JKV.read_row(jnp.asarray(want), sub.shape, 2)))
    assert KV.write_row(got, back, 2) is got
    np.testing.assert_array_equal(got.numpy(), want)
    whole = KV.write_row(torch.zeros(1, 3), torch.ones(1, 3), 0)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(
        JKV.write_row(jnp.zeros((1, 3)), jnp.ones((1, 3)), 0)))


@pytest.mark.parametrize("arch,jmod,tmod,name", [
    ("zamba2-1.2b", JM2, M2, "ssm_state_init"),
    ("rwkv6-7b", JRW, RW, "rwkv_state_init")])
def test_state_init_aliases_match_jax(arch, jmod, tmod, name):
    """The historical names are `state_init` on both sides: the same
    leaves, shapes and dtypes at the reduced config."""
    assert getattr(tmod, name) is tmod.state_init
    want = getattr(jmod, name)(j_get_config(arch).reduced(), 3,
                               per_slot=True)
    got = getattr(tmod, name)(get_config(arch).reduced(), 3, per_slot=True)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("sizes,names", [
    ((2, 4, 2), ("pod", "data", "model")), ((4, 2), ("data", "model")),
    ((8,), ("model",))])
def test_batch_sharding_matches_jax(sizes, names):
    want = JLD.batch_sharding(j_abstract_mesh(sizes, names)).spec
    assert LD.batch_sharding(RT.abstract_mesh(sizes, names)) == tuple(want)
    assert LD.batch_sharding(None) is JLD.batch_sharding(None) is None


@pytest.fixture
def one_rank_mesh():
    from repro_torch.launch import mesh as M
    m = M.make_serve_mesh("data=1", device="cpu")
    yield m
    torch.distributed.destroy_process_group()


def test_shard_batch_matches_jax(one_rank_mesh):
    """Without a mesh the batch is as given (JAX's `device_put`); on a
    one-rank data mesh each leaf is a DTensor over 'data' whose local block
    is the whole batch."""
    b = {"tokens": np.arange(12, dtype=np.int32).reshape(4, 3)}
    want = JLD.shard_batch(b, None)
    tb = {"tokens": torch.from_numpy(b["tokens"])}
    assert LD.shard_batch(tb, None) is tb
    got = LD.shard_batch(tb, one_rank_mesh)["tokens"]
    assert isinstance(got, DTensor)
    np.testing.assert_array_equal(got.to_local().numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got.full_tensor().numpy(), b["tokens"])
