"""The port's transformer-pool training path against the JAX package on
the CPU: the stochastic `quantize_tree` and its straight-through
gradients, `clip_tree`, the packed-comms round trip, `lm_loss` and every
leaf's gradient for eight archs, MoE routing with capacity drops, remat
and the parallel block, `make_train_step`, a JAX train state carried
across by `convert`, and the training launcher with its resume.

Every arch at `reduced()` size (d_model 64, 4 heads of 16, vocab 256,
fp32).  JAX's masters are carried across with `repro_torch.convert`, the
norms, channel scales, zero-init LoRA, bonus and bias leaves and the
cross-attention gates walked off init, so that every leaf's gradient is
tested on values that matter.  The noise is JAX's own:
`uniform(fold_in(sub, crc32(path) & 0x7FFFFFFF), leaf.shape)` with `sub`
from `split(state.rng)`, injected into the port as {path: u}.

Tolerances, each with its reason:
  * the quantized values and their STE gradients: equal (the same u, an
    IEEE division and a comparison on both sides);
  * loss within 1e-5 relative, gradients within 1e-4 relative L2 a leaf:
    fp32 sums in other orders through up to five layers of attention,
    routing, scans and the head;
  * three SGD steps: params within 1e-5; an AdamW step only where |g| >
    1e-4 max|g| (its first update is +-lr an element, so an element whose
    gradient rounds to 0 may flip sign).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import qlinear as JQL
from repro.core import quantize as JQ
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import qlinear as QL
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import tree_leaves, tree_map, tree_paths
from repro_torch.launch import train as LT
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(1)
TRAIN_ARCHS = ("qwen3-0.6b", "gemma3-27b", "mixtral-8x7b",
               "qwen3-moe-30b-a3b", "rwkv6-7b", "zamba2-1.2b",
               "whisper-base", "llama-3.2-vision-90b")
OFF_INIT = ("xgate", "bfc1", "bfc2", "lora_B", "wB", "u", "conv_b")
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch: str, **over):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return jcfg, tcfg


_MASTERS = {}


def _masters(arch: str, jcfg):
    """JAX reduced masters with every zero-init or unit-init leaf that
    would hide a gradient walked off init, made once per arch."""
    if arch not in _MASTERS:
        rng = np.random.default_rng(1)

        def walk(path, a):
            name = getattr(path[-1], "key", "")
            if (name in OFF_INIT or "norm" in name or name.startswith("s")
                    or name.startswith("ln")):
                return a + 0.2 * rng.standard_normal(a.shape).astype(
                    np.float32)
            return a
        p = JT.model_init(jax.random.PRNGKey(0), jcfg)
        _MASTERS[arch] = jax.tree_util.tree_map_with_path(walk, p)
    return _MASTERS[arch]


def _batch(cfg, seed: int = 3) -> dict:
    """numpy tokens and targets, and the family's frames or image
    tokens."""
    rng = np.random.default_rng(seed)
    n = S // 2 if cfg.family == "audio" else S
    b = {"tokens": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)}
    if cfg.family == "audio":
        b["enc_frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        b["img"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return b


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_noise(jp, spec, sub) -> dict:
    """The uniform noise JAX's quantize_tree draws from `sub`, by path."""
    out = {}
    pol = spec.policy()

    def f(path, leaf):
        if pol.matches(path, leaf):
            name = JQ.path_str(path)
            k = jax.random.fold_in(sub, zlib.crc32(name.encode()) & 0x7FFFFFFF)
            out[name] = torch.from_numpy(np.array(
                jax.random.uniform(k, leaf.shape, leaf.dtype)))
        return leaf
    jax.tree_util.tree_map_with_path(f, jp)
    return out


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(got.detach().double().numpy() - want)
    return diff / max(np.linalg.norm(want), 1e-30)


def _grads_close(tg, jg, tol=1e-4):
    jl = jax.tree_util.tree_leaves_with_path(jg)
    tl = tree_paths(tg)
    assert [JQ.path_str(p) for p, _ in jl] == ["/".join(p) for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        j = np.asarray(j)
        if not np.any(j):
            assert not torch.any(t), JQ.path_str(path)
            continue
        assert _rel(t, j) <= tol, (JQ.path_str(path), _rel(t, j))


# ---------------------------------------------------------------------------
# quantize_tree, clip_tree, packed comms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["binary", "ternary"])
def test_stochastic_quantize_tree_matches_jax(mode):
    """JAX's noise through both packages: every sampled leaf equal, value
    for value, and its straight-through gradient equal."""
    jcfg, tcfg = _cfgs("qwen3-0.6b")
    jp = _masters("qwen3-0.6b", jcfg)
    tp = convert.from_numpy(_np(jp), "cpu")
    jspec = JQ.QuantSpec(mode=mode, norm="channel")
    tspec = Q.QuantSpec(mode=mode, norm="channel")
    key = jax.random.PRNGKey(5)
    noise = _jax_noise(jp, jspec, key)
    assert "stack/0/attn/Wq" in noise and "embed" not in noise
    jq = JQL.quantize_tree(jp, jspec, key)
    tq = QL.quantize_tree(tp, tspec, noise=noise)
    for (_, j), (_, t) in zip(jax.tree_util.tree_leaves_with_path(jq),
                              tree_paths(tq)):
        assert np.array_equal(t.numpy(), np.asarray(j))

    rng = np.random.default_rng(6)
    coef = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), _np(jp))
    jgrad = jax.grad(lambda p: sum(
        jnp.sum(q * c) for q, c in zip(
            jax.tree.leaves(JQL.quantize_tree(p, jspec, key)),
            jax.tree.leaves(coef))))(jp)
    leaves = tree_map(lambda t: t.requires_grad_(True),
                      convert.from_numpy(_np(jp), "cpu"))
    q = QL.quantize_tree(leaves, tspec, noise=noise)
    loss = sum((a * torch.from_numpy(c)).sum()
               for a, c in zip(tree_leaves(q), jax.tree.leaves(coef)))
    loss.backward()
    for (_, j), (_, t) in zip(jax.tree_util.tree_leaves_with_path(jgrad),
                              tree_paths(leaves)):
        assert np.array_equal(t.grad.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="requires noise"):
        QL.quantize_tree(tp, tspec)


def test_step_noise_is_a_function_of_seed_step_and_path():
    w = torch.zeros((8, 4))
    a = QL.step_noise(3, 7)("stack/0/attn/Wq", w)
    assert torch.equal(a, QL.step_noise(3, 7)("stack/0/attn/Wq", w))
    assert a.shape == w.shape and 0 <= a.min() and a.max() < 1
    for other in (QL.step_noise(3, 8)("stack/0/attn/Wq", w),
                  QL.step_noise(4, 7)("stack/0/attn/Wq", w),
                  QL.step_noise(3, 7)("stack/0/attn/Wk", w)):
        assert not torch.equal(a, other)
    assert QL.leaf_crc("stack/0/attn/Wq") == (
        zlib.crc32(b"stack/0/attn/Wq") & 0x7FFFFFFF)


def test_clip_tree_matches_jax():
    jcfg, _ = _cfgs("qwen3-0.6b")
    jp = jax.tree.map(lambda a: 3.0 * a, _masters("qwen3-0.6b", jcfg))
    tp = convert.from_numpy(_np(jp), "cpu")
    for mode in ("ternary", "binary", "none"):
        jspec = JQ.QuantSpec(mode=mode, norm="channel")
        tspec = Q.QuantSpec(mode=mode, norm="channel")
        jc = JQL.clip_tree(jp, jspec)
        tc = QL.clip_tree(tp, tspec)
        for (_, j), (_, t) in zip(jax.tree_util.tree_leaves_with_path(jc),
                                  tree_paths(tc)):
            assert np.array_equal(t.numpy(), np.asarray(j))


def _comms_params():
    rng = np.random.default_rng(0)
    return {"Wq": (rng.standard_normal((64, 32)) * 0.02).astype(np.float32),
            "stack": {"Wup": (rng.standard_normal((3, 48, 16)) * 0.02
                              ).astype(np.float32)}}


@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_packed_comms_is_bit_exact(mode):
    """The quantize -> pack -> unpack round trip gives the plain sample,
    bit for bit, and JAX's."""
    np_p = _comms_params()
    tp = {k: convert.from_numpy(v, "cpu") for k, v in np_p.items()}
    spec = Q.QuantSpec(mode=mode, norm="channel")
    jspec = JQ.QuantSpec(mode=mode, norm="channel", packed_comms=True)
    key = jax.random.PRNGKey(2)
    noise = _jax_noise(np_p, jspec, key)
    plain = QL.quantize_tree(tp, spec, torch.float32, noise)
    packed = QL.quantize_tree(tp, dataclasses.replace(spec, packed_comms=True),
                              torch.float32, noise)
    jq = JQL.quantize_tree(np_p, jspec, key, compute_dtype=jnp.float32)
    for a, b, j in zip(tree_paths(plain), tree_paths(packed),
                       jax.tree.leaves(jq)):
        assert torch.equal(a[1], b[1])
        assert np.array_equal(b[1].numpy(), np.asarray(j))


def test_packed_comms_gradients_flow_to_masters():
    spec = Q.QuantSpec(mode="ternary", norm="channel", packed_comms=True)
    w = torch.from_numpy(_comms_params()["Wq"][:32, :16]).requires_grad_(True)
    q = QL.quantize_tree({"Wq": w}, spec, noise=QL.step_noise(1, 0))
    (q["Wq"] * 2.0).sum().backward()
    assert torch.allclose(w.grad, torch.full_like(w, 2.0))


def test_packed_comms_skips_non_multiple_k():
    """K not a multiple of the group takes the plain cast: no crash, at
    most three values."""
    spec = Q.QuantSpec(mode="ternary", norm="channel", packed_comms=True)
    w = torch.from_numpy(_comms_params()["Wq"][:30, :8])
    q = QL.quantize_tree({"Wq": w}, spec, noise=QL.step_noise(1, 0))["Wq"]
    assert len(torch.unique(torch.round(q / q.abs().max(), decimals=4))) <= 3
    plain = QL.quantize_tree({"Wq": w}, dataclasses.replace(
        spec, packed_comms=False), noise=QL.step_noise(1, 0))["Wq"]
    assert torch.equal(q, plain)


# ---------------------------------------------------------------------------
# lm_loss and its gradients, every family
# ---------------------------------------------------------------------------


def _jax_value_and_grad(jp, batch, jcfg, sub):
    f = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, training=True, rng=sub), has_aux=True))
    return f(jp)


def _port_value_and_grad(tp, batch, tcfg, noise):
    return TS.value_and_grad(
        lambda leaves: T.lm_loss(leaves, _torch_batch(batch), tcfg,
                                 training=True, noise=noise), tp)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    """JAX's noise injected: the training loss within 1e-5 relative, the
    nll and MoE aux loss too, every leaf's gradient within 1e-4 relative
    L2."""
    jcfg, tcfg = _cfgs(arch)
    jp = _masters(arch, jcfg)
    tp = convert.from_numpy(_np(jp), "cpu")
    batch = _batch(tcfg)
    sub = jax.random.split(jax.random.PRNGKey(2))[1]
    (jl, jaux), jg = _jax_value_and_grad(jp, batch, jcfg, sub)
    tl, taux, tg = _port_value_and_grad(tp, batch, tcfg,
                                        _jax_noise(jp, jcfg.quant, sub))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("nll", "moe_aux"):
        assert abs(taux[k].item() - float(jaux[k])) <= 1e-5 * max(
            abs(float(jaux[k])), 1e-6), k
    _grads_close(tg, jg)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_training_routes_and_drops_as_jax(arch):
    """Capacity routing under training (no_drop False) on one layer's
    router logits, skewed to expert 0 so that tokens are dropped: JAX's
    dispatch and combine tensors, built from the port's slots, equal; the same
    (token, choice) pairs dropped; and the layer's output, aux loss and
    input gradient against JAX's."""
    jcfg, tcfg = _cfgs(arch)
    jp = _masters(arch, jcfg)["stack"][0]["moe"]
    jp = jax.tree.map(lambda a: a[0], jp)
    jp = dict(jp, router=jp["router"] + jnp.array([2.0] + [0.0] * (
        jcfg.n_experts - 1)))
    tp = convert.from_numpy(_np(jp), "cpu")
    # a positive mean: every token's expert-0 logit gains about 2 * d / 2
    x = (np.random.default_rng(4).standard_normal(
        (B, S, jcfg.d_model)) + 0.5).astype(np.float32)
    T_ = B * S
    cap = MOE.capacity(T_, tcfg)
    logits = torch.from_numpy(x.reshape(T_, -1)) @ tp["router"]
    jd, jc, ja = JMOE.route(jnp.asarray(logits.numpy()), jcfg, cap)
    td, tc, ta = MOE.route(logits, tcfg, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    _, _, _, keep, _ = MOE.route_slots(logits, tcfg, cap)
    dropped = int((~keep).sum())
    assert dropped > 0
    assert dropped == T_ * tcfg.topk - int(np.asarray(jd).sum())

    (jy, jaux), jvjp = jax.vjp(lambda xx: JMOE.moe_apply(jp, xx, jcfg),
                               jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = MOE.moe_apply(tp, xt, tcfg)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    assert abs(taux.item() - float(jaux)) <= 1e-6
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    (ty * torch.from_numpy(cot)).sum().backward()
    jgx, = jvjp((jnp.asarray(cot), jnp.zeros((), jnp.float32)))
    assert _rel(xt.grad, jgx) <= 1e-5


def test_remat_full_dots_and_off_are_equal():
    """One loss and gradient with remat off, full and "dots": the same
    numbers (recomputation replays the same ops on the same inputs)."""
    out = []
    for over in ({"remat": False}, {"remat": True},
                 {"remat": True, "remat_policy": "dots"}):
        jcfg, tcfg = _cfgs("zamba2-1.2b", **over)
        jp = _masters("zamba2-1.2b", jcfg)
        tp = convert.from_numpy(_np(jp), "cpu")
        batch = _batch(tcfg)
        out.append(_port_value_and_grad(tp, batch, tcfg,
                                        QL.step_noise(1, 0)))
    for loss, _, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for (_, a), (_, b) in zip(tree_paths(grads), tree_paths(out[0][2])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b"])
def test_parallel_block_matches_jax(arch):
    """PaLM's parallel block (one pre-norm, attention and MLP summed into
    the residual): the training loss and gradients against JAX's, and
    the cached prefill's logits against the uncached forward's."""
    jcfg, tcfg = _cfgs(arch, parallel_block=True)
    jp = _masters(arch, dataclasses.replace(jcfg, parallel_block=False))
    tp = convert.from_numpy(_np(jp), "cpu")
    batch = _batch(tcfg)
    sub = jax.random.split(jax.random.PRNGKey(3))[1]
    (jl, _), jg = _jax_value_and_grad(jp, batch, jcfg, sub)
    tl, _, tg = _port_value_and_grad(tp, batch, tcfg,
                                     _jax_noise(jp, jcfg.quant, sub))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    _grads_close(tg, jg)
    with torch.no_grad():
        tok = torch.from_numpy(batch["tokens"])
        full, _ = T.forward(tp, tok, tcfg)
        last, _ = T.prefill(tp, tok, T.init_caches(tcfg, B, S), tcfg)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_mamba_scan_is_differentiable_and_serving_keeps_its_form():
    """ssd_chunked with gradients on (out of place) equals the serving
    form (in place) and backpropagates."""
    from repro_torch.models import mamba2 as M
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 20, 3, 4, generator=g)
    dt = torch.rand(2, 20, 3, generator=g)
    A = -torch.rand(3, generator=g) * 4
    Bm, Cm = torch.randn(2, 20, 5, generator=g), torch.randn(2, 20, 5,
                                                             generator=g)
    with torch.no_grad():
        y0, h0 = M.ssd_chunked(x, dt, A, Bm, Cm, 8)
    xr = x.clone().requires_grad_(True)
    y1, h1 = M.ssd_chunked(xr, dt, A, Bm, Cm, 8)
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())
    y1.sum().backward()
    assert torch.isfinite(xr.grad).all() and xr.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _jax_steps(jcfg, jopt, jp, batch, n):
    """n JAX steps; returns (states after each, the noise of each step)."""
    jstate = JTS.train_state_init(jp, jopt, jax.random.PRNGKey(7))
    step = jax.jit(JTS.make_train_step(jcfg, jopt))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    states, noises = [], []
    for _ in range(n):
        sub = jax.random.split(jstate.rng)[1]
        noises.append(_jax_noise(jstate.params, jcfg.quant, sub))
        jstate, _ = step(jstate, jb)
        states.append(jstate)
    return states, noises


def test_three_sgd_steps_match_jax():
    jcfg, tcfg = _cfgs("qwen3-0.6b")
    jp = _masters("qwen3-0.6b", jcfg)
    jopt = JOPT.OptConfig(kind="sgd", lr=1e-2, momentum=0.9, clip_norm=1.0)
    topt = OPT.OptConfig(kind="sgd", lr=1e-2, momentum=0.9, clip_norm=1.0)
    batch = _batch(tcfg)
    states, noises = _jax_steps(jcfg, jopt, jp, batch, 3)
    tstate = TS.train_state_init(convert.from_numpy(_np(jp), "cpu"), topt, 7)
    step = TS.make_train_step(tcfg, topt)
    for noise in noises:
        tstate, m = step(tstate, _torch_batch(batch), noise=noise)
    assert int(tstate.opt.step) == 3 and np.isfinite(float(m["loss"]))
    for (_, j), (_, t) in zip(
            jax.tree_util.tree_leaves_with_path(states[-1].params),
            tree_paths(tstate.params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


def test_adamw_step_matches_jax_where_the_gradient_is_not_rounding():
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b")
    jp = _masters("qwen3-moe-30b-a3b", jcfg)
    jopt = JOPT.OptConfig(lr=1e-3, warmup_steps=2, clip_norm=1.0)
    topt = OPT.OptConfig(lr=1e-3, warmup_steps=2, clip_norm=1.0)
    batch = _batch(tcfg)
    states, noises = _jax_steps(jcfg, jopt, jp, batch, 1)
    tstate = TS.train_state_init(convert.from_numpy(_np(jp), "cpu"), topt, 7)
    tstate, _ = TS.make_train_step(tcfg, topt)(tstate, _torch_batch(batch),
                                               noise=noises[0])
    g = jax.tree_util.tree_leaves(states[0].opt.m)
    for (path, j), (_, t), m in zip(
            jax.tree_util.tree_leaves_with_path(states[0].params),
            tree_paths(tstate.params), g):
        m = np.abs(np.asarray(m))
        held = m > 1e-4 * m.max() if m.max() > 0 else np.zeros_like(m, bool)
        np.testing.assert_allclose(t.numpy()[held], np.asarray(j)[held],
                                   rtol=0, atol=1e-5,
                                   err_msg=JQ.path_str(path))


def test_a_jax_train_state_trains_on_in_the_port():
    """A JAX transformer TrainState after one JAX step, carried across by
    `convert` (params and the AdamW state), takes the next step in the
    port as JAX takes it."""
    jcfg, tcfg = _cfgs("llama-3.2-vision-90b")
    jp = _masters("llama-3.2-vision-90b", jcfg)
    jopt = JOPT.OptConfig(kind="sgd", lr=1e-2, momentum=0.9, clip_norm=1.0)
    topt = OPT.OptConfig(kind="sgd", lr=1e-2, momentum=0.9, clip_norm=1.0)
    batch = _batch(tcfg)
    states, noises = _jax_steps(jcfg, jopt, jp, batch, 2)
    tstate = convert.from_numpy(_np(states[0]), "cpu", noise_seed=7)
    assert isinstance(tstate, TS.TrainState) and tstate.bn_state is None
    assert int(tstate.opt.step) == 1
    tstate, _ = TS.make_train_step(tcfg, topt)(tstate, _torch_batch(batch),
                                               noise=noises[1])
    for (_, j), (_, t) in zip(
            jax.tree_util.tree_leaves_with_path(states[1].params),
            tree_paths(tstate.params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
    back = convert.to_numpy(tstate)
    assert back["bn_state"] is None and back["residual"] is None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


ARGS = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch",
        "4", "--seq", "16"]


def test_launcher_trains_a_pool_arch(capsys):
    state = LT.main(ARGS + ["--steps", "12", "--log-every", "1"])
    assert int(state.opt.step) == 12
    out = capsys.readouterr().out
    lines = [l.split() for l in out.splitlines() if l.startswith("step ")]
    assert len(lines) == 12 and all(l[4] == "lr" and l[6] == "gnorm"
                                    for l in lines)
    assert np.isfinite([float(l[3]) for l in lines]).all()
    assert "qwen3-0.6b: dense family" in out and "done: 12 steps" in out


def test_launcher_resume_round_trip_is_bit_equal(tmp_path):
    """6 steps with a checkpoint every 5, then --resume auto to 10: the
    final checkpoint equals an uninterrupted 10-step run's, leaf for leaf
    (JAX's tests/test_system.py resume round trip)."""
    args = ARGS + ["--ckpt-every", "5", "--log-every", "100"]
    LT.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--steps", "6"])
    LT.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--steps", "10",
                    "--resume", "auto"])
    assert CK.latest_step(tmp_path / "a") == 10
    LT.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--steps", "10"])
    final = "step_00000010"
    assert LT._ckpt_bit_equal(tmp_path / "a" / final, tmp_path / "b" / final)


@pytest.mark.parametrize("argv,what", [
    (["--arch", "whisper-base"], "enc_frames"),
    (["--arch", "llama-3.2-vision-90b"], "img"),
    (["--arch", "qwen3-0.6b", "--pipeline"], "rnn-paper")])
def test_launcher_refuses_what_the_token_stream_cannot_train(argv, what):
    with pytest.raises(SystemExit, match=what):
        LT.main(argv + ["--reduced", "--device", "cpu", "--steps", "1"])
