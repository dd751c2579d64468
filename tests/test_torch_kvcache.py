"""The port's kv caches (`serve/kvcache.py`) and the engine's generic slot
helpers against the JAX package on the CPU, bit for bit: every function
here moves or selects bytes and computes no float, so the port's caches
must equal JAX's exactly.  The port writes k/v in place where JAX returns
new arrays; each test compares the returned caches."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kvcache as JK
from repro_torch.serve import kvcache as K
from repro_torch.serve.engine import (tree_gather_slot, tree_reset_slots,
                                      tree_write_slot)
from repro_torch.serve.prefixcache import narrow_state, tree_bytes, widen_state

H, HD = 2, 4


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(batch, cap, *, ring=False, per_slot=True, pos=None, lead=(),
          seed=0):
    """(JAX cache, port cache) holding the same random bytes and pos."""
    k, v = _rand(lead + (batch, cap, H, HD), seed), _rand(
        lead + (batch, cap, H, HD), seed + 1)
    if pos is None:
        pos = np.zeros(lead + ((batch,) if per_slot else ()), np.int32)
    pos = np.asarray(pos, np.int32)
    j = JK.AttnCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), ring)
    t = K.AttnCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                    torch.from_numpy(pos.copy()), ring)
    return j, t


def _same(t: K.AttnCache, j) -> None:
    assert np.array_equal(t.k.numpy(), np.asarray(j.k))
    assert np.array_equal(t.v.numpy(), np.asarray(j.v))
    assert np.array_equal(t.pos.numpy(), np.asarray(j.pos))
    assert t.ring == j.ring


def test_init_and_positions_match_jax():
    for ring in (False, True):
        for per_slot in (False, True):
            t = K.cache_init(3, 8, H, HD, torch.float32, ring=ring,
                             per_slot=per_slot)
            j = JK.cache_init(3, 8, H, HD, jnp.float32, ring=ring,
                              per_slot=per_slot)
            _same(t, j)
            for pos in ([0, 5, 13] if per_slot else [11]):
                p = np.array(pos if per_slot else pos[0] if isinstance(pos, list)
                             else pos, np.int32)
                t2, j2 = t._replace(pos=torch.from_numpy(p)), j._replace(
                    pos=jnp.asarray(p))
                assert np.array_equal(K.cache_positions(t2).numpy(),
                                      np.asarray(JK.cache_positions(j2)))
    st = K.cache_init(2, 8, H, HD, torch.float32, per_slot=True, lead=(3,))
    assert st.k.shape == (3, 2, 8, H, HD) and st.pos.shape == (3, 2)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("S", [1, 3, 9])
def test_per_slot_update_with_live_matches_jax(ring, S):
    """Rows at their own depths (a ring one wrapping), a dead row frozen,
    a chunk longer than a ring's capacity keeping its tail."""
    j, t = _pair(3, 8, ring=ring, pos=[0, 6, 13] if ring else [0, 2, 5])
    kn, vn = _rand((3, S, H, HD), 7), _rand((3, S, H, HD), 8)
    for live in (None, np.array([True, False, True])):
        jl = None if live is None else jnp.asarray(live)
        tl = None if live is None else torch.from_numpy(live)
        j2 = JK.cache_update(j, jnp.asarray(kn), jnp.asarray(vn), jl)
        t2 = K.cache_update(t, torch.from_numpy(kn), torch.from_numpy(vn), tl)
        _same(t2, j2)
        j, t = j2, t2


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("S", [1, 4, 11])
def test_lockstep_update_matches_jax(ring, S):
    if not ring and S == 11:
        S = 6  # a non-ring cache takes at most its capacity
    j, t = _pair(2, 8, ring=ring, per_slot=False, pos=5)
    kn, vn = _rand((2, S, H, HD), 3), _rand((2, S, H, HD), 4)
    _same(K.cache_update(t, torch.from_numpy(kn), torch.from_numpy(vn)),
          JK.cache_update(j, jnp.asarray(kn), jnp.asarray(vn)))
    with pytest.raises(ValueError, match="per-slot"):
        K.cache_update(t, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.ones(2, dtype=torch.bool))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_slot_surgery_matches_jax(lead):
    """gather, write and reset on a bare pool and on a layer-stacked one;
    writing a gathered row back is the identity."""
    pos = np.array([[1, 4, 7]] * 3 if lead else [1, 4, 7], np.int32)
    j, t = _pair(3, 8, pos=pos, lead=lead)
    jref = JK.cache_init(1, 8, H, HD, jnp.float32, per_slot=True)
    if lead:
        jref = JK.AttnCache(jnp.zeros((3, 1, 8, H, HD)), jnp.zeros((3, 1, 8, H, HD)),
                            jnp.zeros((3, 1), jnp.int32))
    _same(K.cache_gather_slot(t, 1), JK.cache_gather_slot(j, jref, 1))
    sj, st = _pair(1, 8, pos=np.full(lead + (1,), 6, np.int32), lead=lead,
                   seed=9)
    _same(K.cache_write_slot(t, st, 2), JK.cache_write_slot(j, sj, 2))
    j = JK.cache_write_slot(j, sj, 2)
    before = t.k.clone()
    K.cache_write_slot(t, K.cache_gather_slot(t, 0), 0)
    assert torch.equal(before, t.k)
    mask = np.array([True, False, True])
    _same(K.cache_reset_slots(t, [0, 2]),
          JK.cache_reset_slots(j, jnp.asarray(mask)))
    with pytest.raises(ValueError, match="per-slot"):
        K.cache_gather_slot(_pair(2, 8, per_slot=False)[1], 0)


def test_narrow_widen_match_jax():
    for lead in ((), (2,)):
        j, t = _pair(1, 8, pos=np.full(lead + (1,), 5, np.int32), lead=lead)
        jn, tn = JK.cache_narrow(j, 5), K.cache_narrow(t, 5)
        _same(tn, jn)
        _same(K.cache_widen(tn, tuple(t.k.shape)),
              JK.cache_widen(jn, j.k.shape))
    with pytest.raises(ValueError, match="non-ring"):
        K.cache_narrow(_pair(1, 8, ring=True)[1], 4)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_spec_snapshot_and_commit_match_jax(lead):
    """Snapshot a span, overwrite it, commit keep = 0 .. span per row:
    equal to JAX's, and keep = 0 restores the snapshot bit for bit."""
    pos = np.array([[2, 5, 7]] * 2 if lead else [2, 5, 7], np.int32)
    j, t = _pair(3, 9, pos=pos, lead=lead)
    span = 3
    js, ts = JK.cache_spec_snapshot(j, span), K.cache_spec_snapshot(t, span)
    for a, b in zip(ts, js):
        assert np.array_equal(a.numpy(), np.asarray(b))
    t0 = K.AttnCache(t.k.clone(), t.v.clone(), t.pos.clone())
    kn, vn = _rand(lead + (3, span, H, HD), 5), _rand(lead + (3, span, H, HD), 6)
    if lead:  # overwrite layer by layer, as the stacked step does
        for l in range(lead[0]):
            one = K.AttnCache(t.k[l], t.v[l], t.pos[l])
            K.cache_update(one, torch.from_numpy(kn[l]), torch.from_numpy(vn[l]))
        j = JK.AttnCache(*[jnp.stack(x) for x in zip(*[
            (c.k, c.v, c.pos) for c in [JK.cache_update(
                JK.AttnCache(j.k[l], j.v[l], j.pos[l]), jnp.asarray(kn[l]),
                jnp.asarray(vn[l])) for l in range(lead[0])]])])
    else:
        t = K.cache_update(t, torch.from_numpy(kn), torch.from_numpy(vn))
        j = JK.cache_update(j, jnp.asarray(kn), jnp.asarray(vn))
    keep = np.array([0, 2, 3], np.int32)
    tc = K.cache_spec_commit(t, ts, torch.from_numpy(keep))
    jc = JK.cache_spec_commit(j, js, jnp.asarray(keep))
    _same(tc, jc)
    assert torch.equal(tc.k[..., 0, :, :, :], t0.k[..., 0, :, :, :])
    with pytest.raises(ValueError, match="non-ring"):
        K.cache_spec_snapshot(_pair(2, 8, ring=True)[1], 2)


def test_tree_slot_helpers_invert_and_scrub():
    """tree_gather_slot inverts tree_write_slot over a stacked-and-tail
    cache tree; a scrubbed row reads as unwritten; narrow/widen round
    trips through the tree helpers and tree_bytes counts caches."""
    pool = {"stack": ({"attn": _pair(3, 8, pos=[[1, 2, 3]] * 2, lead=(2,))[1]},),
            "tail": ({"attn": _pair(3, 8, pos=[4, 5, 6])[1]},)}
    sub = {"stack": ({"attn": _pair(1, 8, pos=[[7]] * 2, lead=(2,), seed=4)[1]},),
           "tail": ({"attn": _pair(1, 8, pos=[7], seed=5)[1]},)}
    tree_write_slot(pool, sub, 1)
    got = tree_gather_slot(pool, 1)
    for a, b in ((got["stack"][0]["attn"], sub["stack"][0]["attn"]),
                 (got["tail"][0]["attn"], sub["tail"][0]["attn"])):
        assert torch.equal(a.k, b.k) and torch.equal(a.pos, b.pos)
    narrow = narrow_state(got, 7)
    assert narrow["tail"][0]["attn"].k.shape == (1, 7, H, HD)
    assert tree_bytes(narrow) < tree_bytes(got)
    wide = widen_state(narrow, pool)
    assert wide["stack"][0]["attn"].k.shape == (2, 1, 8, H, HD)
    assert torch.equal(wide["stack"][0]["attn"].k[:, :, :7],
                       sub["stack"][0]["attn"].k[:, :, :7])
    tree_reset_slots(pool, [1])
    assert pool["stack"][0]["attn"].pos.tolist() == [[1, 0, 3]] * 2
    assert pool["tail"][0]["attn"].pos.tolist() == [4, 0, 6]
    with pytest.raises(TypeError, match="attention caches"):
        tree_gather_slot({"x": torch.zeros(3)}, 0)
