"""The model code's per-rank DTensor paths on a mesh, on real data, against
the same model with no mesh (mesh=None) on the same inputs.

These paths run only where the 'model' axis meets a dim it does not divide
or an op DTensor cannot lay out, so the production meshes take them and
the (2, 2) tests of tests/test_torch_tp.py do not:

  * reduced qwen3-0.6b (4 query, 2 KV heads) at (data, model) = (1, 4):
    the KV projections gathered before the head reshape (`split_heads`),
    the cache split along its length (`kv_pspec`), each rank writing the
    slots of its own range (`kvcache._write`) and scoring its own keys
    (`layers._sdpa_split_keys`); in training each rank projecting the KV
    heads its query heads read (`layers._attend_kv_local`).  Serving: a
    6-token prefill, a 5-token chunk across the ranks' ranges, three
    decode steps, capacity 16; and a 40-token prefill, longer than a
    rank's 36 slots, each rank projecting the tokens of its own slots
    (`layers.kv_write_local`), then the same chunk and steps;
  * reduced rwkv6-7b and zamba2-1.2b at (2, 2): the chunked scans rank by
    rank (`runtime.on_shards`: batch and heads apart, the shared inputs'
    gradients summed over the ranks that split the work) and rwkv6's
    row-parallel sums reduced before the elementwise ops (`runtime.reduced`);
  * reduced mixtral-8x7b with 3 experts at (2, 2), trained: the experts'
    products and the combine rank by rank with the capacity axis over
    'model' (`moe._expert_mm`, `_combine`), the expert weights' gradients
    summed over the ranks;
  * reduced qwen3-0.6b with a padded vocabulary (250 of 256) at (2, 2)
    and (1, 4): `lm_loss` (deterministic quantization) and its gradients
    with the logits split over the vocabulary (`transformer._vocab_parallel`,
    the targets on every rank's range) and the table looked up shard by
    shard (`_vocab_lookup`), against mesh=None and against JAX's
    `lm_loss` on the same inputs; at (1, 4) the KV heads (2) are whole
    on every rank (`layers._head_proj`).

Each rank is a gloo child process (a file store, a timeout for each); the
meshes are built over the first D * M of 4 ranks.  Training is one SGD
step at learning rate 1 (its update is the gradient, where AdamW's first
step is its sign, and large beside the parameters' rounding); the
tolerances are fp32 sums over other shard boundaries (measured on torch
2.13: serving at most 1.8e-6, updates at most 6.7e-6):
  * serving logits and caches: max |mesh - plain| <= 2e-5 max |plain|;
  * training: the loss within 1e-6 relative; each leaf's update within
    2e-5 relative L2 of the plain step's;
  * the loss: within 1e-6 relative, each gradient within 2e-5 relative
    L2, the embedding's rows within 2e-5 of max |plain|, of mesh=None's
    and of JAX's.
"""
import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
CHILD_TIMEOUT = 300
WORLD = 4
SERVE_REL = 2e-5
LOSS_REL = 1e-6
UPDATE_REL = 2e-5
CASES = [("qwen3-0.6b", (1, 4), "serve"), ("qwen3-0.6b", (1, 4), "train"),
         ("qwen3-0.6b", (1, 4), "serve_long"),
         ("rwkv6-7b", (2, 2), "serve"), ("rwkv6-7b", (2, 2), "train"),
         ("zamba2-1.2b", (2, 2), "serve"), ("zamba2-1.2b", (2, 2), "train"),
         ("mixtral-8x7b", (2, 2), "train"), ("qwen3-0.6b", (2, 2), "loss"),
         ("qwen3-0.6b", (1, 4), "loss")]
# 3 experts on a 2-way model axis: the MoE splits its capacity axis over
# 'model' (as mixtral's 8 experts on the production mesh's 16)
OVERRIDES = {"mixtral-8x7b": {"n_experts": 3}}
LOSS_VOCAB = 250  # padded to 256: 6 pad columns on the last rank's range
B, CHUNKS, STEPS, CAP, T_SEQ = 4, (6, 5), 3, 16, 16
# a first chunk longer than a rank's 36 of the cache's 144 slots: each rank
# projects the tokens of its own slots (`layers.kv_write_local`)
LONG_CHUNKS = (40, 5)


def _flat(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _flat(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return []


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def serve(cfg, mesh, chunks=CHUNKS) -> dict:
    """Prefill CHUNKS then STEPS decode steps: every call's logits, the
    caches' whole tensors, and which cache leaves the mesh splits along
    their length."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import sharding as S
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_mesh

    params = T.model_init(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (B, n), generator=g)
               for n in chunks]
    tokens = [torch.randint(0, cfg.vocab, (B,), generator=g)
              for _ in range(STEPS)]
    caches = T.init_caches(cfg, B, CAP, device="cpu")
    logits, length_split = [], []
    on_mesh = contextlib.ExitStack()
    if mesh is not None:
        on_mesh.enter_context(use_mesh(mesh, param_rules=S.param_pspec,
                                       compute_rules=S.compute_param_pspec))
        on_mesh.enter_context(implicit_replication())
    with torch.no_grad(), on_mesh:
        lay = lambda t: t
        if mesh is not None:
            params = S.distribute(params, S.param_shardings(params, mesh),
                                  mesh)
            caches = S.distribute(caches, S.cache_shardings(caches, mesh),
                                  mesh)
            length_split = [any(p.is_shard(t.dim() - 3)
                                for p in t.placements)
                            for t in _flat(caches)
                            if isinstance(t, DTensor) and t.dim() >= 4]
            lay = lambda t: S.distribute({"t": t}, S.batch_shardings(
                {"t": t}, mesh), mesh)["t"]
        for t in prompts:
            lg, caches = T.prefill(params, lay(t), caches, cfg)
            logits.append(_whole(lg))
        for t in tokens:
            lg, caches = T.decode_step(params, lay(t), caches, cfg)
            logits.append(_whole(lg))
    return {"logits": logits, "caches": [_whole(t) for t in _flat(caches)],
            "length_split": length_split}


def train(cfg, mesh) -> dict:
    """One SGD step from model_init's state: the loss and each leaf's
    update, whole."""
    from repro_torch.core.qtensor import tree_paths
    from repro_torch.data import loader as LD
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    opt = OptConfig(kind="sgd", lr=1.0)
    params = T.model_init(torch.Generator().manual_seed(0), cfg)
    before = [l.clone() for _, l in tree_paths(params)]
    state = TS.train_state_init(params, opt, 0)
    toks = torch.randint(0, cfg.vocab, (B, T_SEQ + 1),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int()}
    if mesh is not None:
        batch = LD.data_block(batch, mesh)
    state, m = TS.make_train_step(cfg, opt, mesh=mesh)(state, batch)
    return {"loss": float(m["loss"]),
            "update": {"/".join(p): _whole(l) - b for (p, l), b in
                       zip(tree_paths(state.params), before)}}


def loss_batch(cfg) -> dict:
    """A (B, T_SEQ) batch from a seed, its targets on every vocabulary
    range of a 4-way split."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(B, T_SEQ + 1)).astype(np.int32)
    toks[0, 1:5] = [1, 70, 140, cfg.vocab - 1]
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def loss(cfg, mesh) -> dict:
    """`lm_loss` at training=False and its gradients from model_init's
    parameters, and the embedding's rows of the batch: whole tensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.qtensor import tree_paths
    from repro_torch.data import loader as LD
    from repro_torch.launch import sharding as S
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_mesh
    from repro_torch.train import train_step as TS

    params = T.model_init(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in loss_batch(cfg).items()}
    on_mesh = contextlib.ExitStack()
    if mesh is not None:
        params = S.distribute(params, S.param_shardings(params, mesh), mesh)
        batch = TS.shard_batch(LD.data_block(batch, mesh), mesh)
        on_mesh.enter_context(use_mesh(mesh, param_rules=S.param_pspec))
        on_mesh.enter_context(implicit_replication())
    with on_mesh:
        value, _, grads = TS.value_and_grad(
            lambda l: T.lm_loss(l, batch, cfg, training=False), params)
        with torch.no_grad():
            rows = T._embed(T._serve_quant(params, cfg), batch["tokens"],
                            cfg)
    return {"loss": float(_whole(value)), "rows": _whole(rows),
            "grads": {"/".join(p): _whole(g) for p, g in tree_paths(grads)}}


def rank_runs(rank: int) -> dict:
    """Every case on this rank: the plain run and the mesh run (the mesh
    over the first D * M ranks; the others take part in making it)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    out = {}
    for arch, shape, kind in CASES:
        mesh = M.first_ranks_mesh("cpu", shape, ("data", "model"))
        if mesh.get_coordinate() is None:
            continue
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  **OVERRIDES.get(arch, {}))
        if kind == "loss":
            cfg = dataclasses.replace(cfg, vocab=LOSS_VOCAB)
        run = {"serve": serve, "train": train, "loss": loss,
               "serve_long": lambda c, m: serve(c, m, LONG_CHUNKS)}[kind]
        out[(arch, shape, kind)] = (run(cfg, None), run(cfg, mesh))
    return out


WORKER = textwrap.dedent('''
    import pickle, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out = sys.argv[1:]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=int(rank), world_size=int(world))
    import test_torch_mesh_paths as D
    got = D.rank_runs(int(rank))
    with open(out.format(rank), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """WORLD gloo ranks at once, each under CHILD_TIMEOUT; all killed on
    a timeout or a failure.  [each rank's {case: (plain, mesh)}]."""
    tmp = tmp_path_factory.mktemp("mesh_paths")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]
        + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(OMP_NUM_THREADS="1", TORCH_CPP_LOG_LEVEL="ERROR")
    out = str(tmp / "out{}.pkl")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD),
         str(tmp / "store"), out], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, f"rank exited {p.returncode}:\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for r in range(WORLD):
        with open(out.format(r), "rb") as f:
            got.append(pickle.load(f))
    return got


def _rel_max(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / max(float(want.double().abs().max()), 1e-30))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _jax_loss(cfg_kw: dict) -> dict:
    """JAX's `lm_loss` (training=False) and its gradients on the loss
    case's parameters and batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as JT
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import tree_map, tree_paths
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), **cfg_kw)
    params = tree_map(lambda t: jnp.asarray(t.numpy()), T.model_init(
        torch.Generator().manual_seed(0), cfg))
    jcfg = dataclasses.replace(j_get_config("qwen3-0.6b").reduced(),
                               **cfg_kw)
    batch = {k: jnp.asarray(v) for k, v in loss_batch(cfg).items()}
    (value, _), grads = jax.value_and_grad(
        lambda p: JT.lm_loss(p, batch, jcfg, training=False),
        has_aux=True)(params)
    return {"loss": float(value),
            "grads": {"/".join(p): np.asarray(g)
                      for p, g in tree_paths(tree_map(np.asarray, grads))}}


@pytest.mark.parametrize("arch,shape,kind", CASES)
def test_mesh_path_matches_no_mesh(ranks, arch, shape, kind):
    case = (arch, shape, kind)
    runs = [r[case] for r in ranks if case in r]
    assert len(runs) == shape[0] * shape[1]
    if kind == "loss":
        want = _jax_loss({"vocab": LOSS_VOCAB})
        plain = runs[0][0]
        assert abs(plain["loss"] - want["loss"]) <= LOSS_REL * abs(
            want["loss"])
        assert list(plain["grads"]) == list(want["grads"])
        bad = {k: _rel_l2(plain["grads"][k], g)
               for k, g in want["grads"].items()
               if not _rel_l2(plain["grads"][k], g) <= UPDATE_REL}
        assert not bad, bad
    for plain, mesh in runs:
        if kind == "loss":
            assert abs(mesh["loss"] - plain["loss"]) <= LOSS_REL * abs(
                plain["loss"])
            assert _rel_max(mesh["rows"], plain["rows"]) <= SERVE_REL
            bad = {k: _rel_l2(mesh["grads"][k], g)
                   for k, g in plain["grads"].items()
                   if not _rel_l2(mesh["grads"][k], g) <= UPDATE_REL}
            assert not bad, bad
        elif kind.startswith("serve"):
            assert len(mesh["logits"]) == len(CHUNKS) + STEPS
            for got, want in zip(mesh["logits"], plain["logits"]):
                assert _rel_max(got, want) <= SERVE_REL
            assert len(mesh["caches"]) == len(plain["caches"])
            for got, want in zip(mesh["caches"], plain["caches"]):
                assert got.shape == want.shape
                assert _rel_max(got, want) <= SERVE_REL
            # 2 KV heads on a 4-way model axis: the cache is split along
            # its length, so the per-rank write and attention ran
            if arch == "qwen3-0.6b":
                assert mesh["length_split"] and all(mesh["length_split"])
        else:
            assert abs(mesh["loss"] - plain["loss"]) <= LOSS_REL * abs(
                plain["loss"])
            assert list(mesh["update"]) == list(plain["update"])
            bad = {}
            for k, want in plain["update"].items():
                got = mesh["update"][k]
                rel = float((got - want).norm() / max(float(want.norm()),
                                                      1e-30))
                if not rel <= UPDATE_REL:
                    bad[k] = rel
            assert not bad, bad
