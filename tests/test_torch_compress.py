"""The port's gradient compression (`repro_torch.train.compress`) against
the JAX package's on the CPU: JAX's own compression tests ported, and
`ternary_compress`, `compress_tree` and `compressed_bytes` fed JAX's
uniform draws (`uniform(key, shape)`, one key a leaf from
`split(key, n_leaves)` in flatten order) and held bit-equal: both sides
take max |g| + 1e-12, divide by it once (IEEE, a same-device tensor in the
port), compare u < p strictly and multiply by the scale, all in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compress as JC
from repro_torch.core import qlinear as QL
from repro_torch.core.qtensor import tree_leaves, tree_paths
from repro_torch.train import compress as C

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# --- JAX's compression tests (tests/test_train.py), ported -------------------


@pytest.mark.parametrize("seed", [0, 1, 17, 2**31 - 1])
def test_ternary_compress_support_and_scale(seed):
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(32, generator=gen) * 0.1
    t, scale = C.ternary_compress(g, torch.rand(32, generator=gen))
    levels = set(np.unique(np.round((t / scale).numpy(), 5)))
    assert levels <= {-1.0, 0.0, 1.0}
    assert float(scale) == pytest.approx(float(g.abs().max()), rel=1e-6)


def test_ternary_compress_unbiased():
    g = torch.tensor([0.05, -0.02, 0.0, 0.08])
    u = torch.rand((6000, 4), generator=torch.Generator().manual_seed(0))
    ts = torch.stack([C.ternary_compress(g, row)[0] for row in u])
    np.testing.assert_allclose(ts.mean(0).numpy(), g.numpy(), atol=6e-3)


def test_error_feedback_conserves_signal():
    """residual + emitted == corrected gradient."""
    g = {"w": torch.tensor([0.03, -0.07, 0.01])}
    res = {"w": torch.tensor([0.01, 0.0, -0.02])}
    out, new_res = C.compress_tree(g, [torch.rand(3)], res)
    np.testing.assert_allclose((out["w"] + new_res["w"]).numpy(),
                               (g["w"] + res["w"]).numpy(), rtol=1e-6)


def test_compressed_bytes_ratio():
    full, packed = C.compressed_bytes({"w": torch.zeros((1024, 1024))})
    assert full / packed > 15  # about 16x (2-bit codes and a scale)


# --- bit-equal to JAX with its draws injected --------------------------------


@pytest.mark.parametrize("shape,kind", [
    ((64,), "normal"), ((24, 40), "normal"), ((3, 5, 7), "normal"),
    ((16,), "zeros"), ((33,), "one-hot"), ((8, 8), "ties")])
def test_ternary_compress_is_jax_bit_for_bit(shape, kind):
    rng = np.random.default_rng(5)
    g = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if kind == "zeros":
        g[:] = 0.0
    elif kind == "one-hot":
        g[:] = 0.0
        g[7] = -0.25
    elif kind == "ties":  # repeated magnitudes, both signs, exact p = 1
        g = np.sign(g) * np.float32(0.125)
    key = jax.random.PRNGKey(11)
    jt, js = JC.ternary_compress(jnp.asarray(g), key)
    u = jax.random.uniform(key, shape, jnp.float32)
    t, s = C.ternary_compress(_t(g), _t(u))
    assert _bits(s) == np.asarray(js).view(np.uint32)
    np.testing.assert_array_equal(_bits(t), np.asarray(jt).view(np.uint32))


def _jax_tree_draws(grads, key) -> list:
    """The u JAX's `compress_tree` draws from `key`, leaf by leaf."""
    leaves = jax.tree.leaves(grads)
    keys = jax.random.split(key, len(leaves))
    return [_t(jax.random.uniform(k, l.shape, jnp.float32))
            for k, l in zip(keys, leaves)]


def _grad_tree(seed):
    """A tree whose flatten order is not its insertion order: dict keys out
    of order, a list and a tuple inside."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.05 * rng.standard_normal(s)).astype(np.float32)
    return {"wz": f(6, 4), "layers": [{"wh": f(4, 4), "b": f(4)},
                                      {"wh": f(4, 4), "b": f(4)}],
            "emb": (f(3, 4), f(2))}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return _t(tree)


@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_tree_is_jax_bit_for_bit(with_residual):
    g = _grad_tree(0)
    res = _grad_tree(1) if with_residual else None
    key = jax.random.PRNGKey(3)
    jout, jres = JC.compress_tree(jax.tree.map(jnp.asarray, g), key,
                                  None if res is None
                                  else jax.tree.map(jnp.asarray, res))
    out, new_res = C.compress_tree(_to_torch(g), _jax_tree_draws(g, key),
                                   None if res is None else _to_torch(res))
    assert [p for p, _ in tree_paths(out)] == [
        tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in jax.tree_util.tree_leaves_with_path(jout)]
    for want, got in ((jout, out), (jres, new_res)):
        for j, t in zip(jax.tree.leaves(want), tree_leaves(got)):
            np.testing.assert_array_equal(_bits(t),
                                          np.asarray(j).view(np.uint32))


def test_compressed_bytes_equal_jax():
    g = _grad_tree(2)
    assert C.compressed_bytes(_to_torch(g)) == JC.compressed_bytes(
        jax.tree.map(jnp.asarray, g))


# --- the port's own draw -----------------------------------------------------


def test_step_noise_is_a_function_of_seed_step_rank_and_leaf():
    g = _to_torch(_grad_tree(0))
    draw = lambda *a: list(C.step_noise(g, *a))
    a = draw(5, 3, 0)
    assert [tuple(u.shape) for u in a] == [tuple(x.shape)
                                           for x in tree_leaves(g)]
    assert all(torch.equal(x, y) for x, y in zip(a, draw(5, 3, 0)))
    assert all(float(u.min()) >= 0.0 and float(u.max()) < 1.0 for u in a)
    for other in (draw(6, 3, 0), draw(5, 4, 0), draw(5, 3, 1)):
        assert not any(torch.equal(x, y) for x, y in zip(a, other))
    # every leaf its own stream, and none the model noise's
    assert len({C.leaf_seed(5, 3, 0, i) for i in range(64)}) == 64
    model = QL.step_noise(5, 3)("wh", a[1])
    assert not torch.equal(model, a[1])
