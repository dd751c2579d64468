"""The port's dry-run (`repro_torch/launch/dryrun.py`) on the CPU: its
per-rank counts against JAX's `_measure` on one mesh, its cells at full
width on the production mesh, and the collectives it records.

Every count runs in a child process, each with a timeout of its own: the
port's as rank 0 of a fake process group (which must not meet the gloo
groups other tests make in this process), JAX's under
`XLA_FLAGS=--xla_force_host_platform_device_count=8`.  All children start
at once.

Against JAX.  Both count a reduced qwen3-0.6b (8 query and 4 KV heads, so
the model axis divides the heads as it divides qwen3's 16 query heads at
full width; attention in one chunk and remat off, because XLA counts a
`lax.map` body once (JAX's query chunks) and CSEs JAX's unrolled
`checkpoint(prevent_cse=False)` away, where the port runs every chunk
and recomputes) on a (2, 4) ("data", "model") mesh, at reduced shapes
under the cells' names (train B = 16, T = 256; prefill B = 8, S = 256;
decode B = 16 over 256); JAX's `make_production_mesh` is pointed at
that mesh, in its child only, and its scan unrolled (`unroll=True`), so
no scan correction enters.

Tolerances, per rank: model_flops equal (the same arithmetic); every
other count within a factor of MARGIN (1.25) either way of its ratio to
JAX's as measured on torch 2.13 and jax 0.9 (EXPECTED; the port's
collectives follow DTensor's placements, which change with the torch
version and the mesh's device type).  The ratios, port over JAX, and
what carries them (the port's `elementwise_flops` and `collective_sites`
name the ops):
  * FLOPs 0.901 / 0.901 / 0.845 (train / prefill / decode).  The port
    counts the products only, and runs none of them replicated over
    'model' (the residual stream is whole there, each rank's products
    its own shard's); XLA's count adds its elementwise ops;
  * bytes 1.003 / 0.984 / 0.277, both fusion-blind over other op sets;
    a gather counts its rows and an in-place cache write its update, as
    XLA's cost analysis counts them;
  * all-gather 0.520 / 0.583 / 1.071: the parameters' FSDP gathers, the
    table whole where a call's rows outweigh it (training and prefill
    here; decode looks its rows up shard by shard), as XLA's; no
    activation is gathered (the loss is vocabulary-parallel, the
    row-parallel sums all-reduced, attention per rank on its heads);
  * all-reduce 1.585 / 0.857 / 1.000: the row-parallel products' sums,
    decode's looked-up rows, and in training one all-reduce of the
    summed input gradients of each block's column-parallel products, and
    one of the head's: 4 a layer and the head's, the layout's least.  JAX's
    `_measure` misses XLA's all-reduces of several operands (a tuple
    shape its pattern does not read): counted with them (`jax_full`),
    XLA's training all-reduce is 1.249e7 against the port's 7.12e6, most
    of it in f32, to which XLA's CPU backend widens a bf16 all-reduce
    (`jax_full`'s `promoted`).  A row-parallel product's channel scale
    takes its gradient on each rank's partial sums (`runtime.scaled_sum`):
    torch 2.11's DTensor otherwise all-reduced the product again for it,
    two more a layer in the backward, which torch 2.13's (these ratios')
    never did, so the ratios stand;
  * reduce-scatter, which XLA's partitioner does not issue here, against
    XLA's all-reduce: 0.0100 / 0 / 0 (the weights' and the table's
    gradients back to their FSDP shards).
Ring factors and the FSDP gather bytes are exact: checked leaf by leaf.

The production case in miniature: train_4k with 2 KV heads, which the
4 'model' ranks do not divide (qwen3-0.6b's 8 on 16), in the same two
children.  Each rank projects the one KV head its query heads read, so
two ranks project each head, where XLA projects half a head a rank and
exchanges the halves; the port's FLOPs stay under KV2_FLOP_LIMIT times
JAX's (0.930 measured), its reductions within MARGIN of XLA's all-reduce
with its tuples (0.550 measured).

At the end of this file, a one-off like-for-like count at full width
(not a test; `python tests/test_torch_dryrun.py`).
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline as R

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = 240
MARGIN = 1.25  # either way of the measured ratio (the module docstring)
# port / JAX per rank, measured; reduce-scatter over JAX's all-reduce
EXPECTED = {
    "train_4k": {"flops": 0.901, "bytes": 1.003, "all-gather": 0.520,
                 "all-reduce": 1.585, "reduce-scatter": 0.0100},
    "prefill_32k": {"flops": 0.901, "bytes": 0.984, "all-gather": 0.583,
                    "all-reduce": 0.857, "reduce-scatter": 0.0},
    "decode_32k": {"flops": 0.845, "bytes": 0.277, "all-gather": 1.071,
                   "all-reduce": 1.000, "reduce-scatter": 0.0}}
GATHER_LIMIT = 2.0  # the port's all-gather over JAX's, every kind
KV2_FLOP_LIMIT = 1.15  # the port's FLOPs over JAX's, KV heads split

# the cells' shapes, reduced; (name, seq_len, global_batch, kind)
SMALL = (("train_4k", 256, 16, "train"), ("prefill_32k", 256, 8, "prefill"),
         ("decode_32k", 256, 16, "decode"))
KINDS = [name for name, *_ in SMALL]
KV2 = "train_kv2"  # train_4k at n_kv = 2: 'model' (4) does not divide it

PRELUDE = f"""
import dataclasses, json, sys
SMALL = {SMALL!r}
KV2 = {KV2!r}

def reduced(get_config, **kw):
    cfg = get_config("qwen3-0.6b").reduced()
    return dataclasses.replace(cfg, n_heads=8, n_kv=4, attn_chunk=256,
                               remat=False, **kw)

# (result key, config, shape name): the cells, and the train cell with
# KV heads that 'model' does not divide
def cells(cfg):
    return ([(name, cfg, name) for name, *_ in SMALL]
            + [(KV2, dataclasses.replace(cfg, n_kv=2), "train_4k")])
"""

# every kind's wire bytes from the HLO text `_measure` reads (`texts`),
# an all-reduce of several operands (a tuple shape) included, and a
# collective-permute's result bytes; `promoted` the all-reduces XLA's CPU
# backend widened to f32 (their reduction `*_promoted`), as counted
FULL_WIRE = r"""
import re
import numpy as np
from repro.launch import dryrun as JD
texts = []
_wire = JD.collective_wire_bytes
JD.collective_wire_bytes = lambda text: (texts.append(text), _wire(text))[1]
SIZE = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4, "f16": 2, "pred": 1}
def full_wire(text):
    out = {}
    for line in text.splitlines():
        m = re.search(r"=\s+(\(.*?\)|\S+)\s+(all-reduce|all-gather|"
                      r"reduce-scatter|all-to-all|collective-permute)"
                      r"(?:-start)?\(", line)
        if not m or "-done" in line:
            continue
        n = sum(SIZE.get(dt, 4) * int(np.prod([int(d) for d in dims.split(",")
                                                if d]))
                for dt, dims in re.findall(r"([a-z]+\d*)\[([\d,]*)\]",
                                           m.group(1)))
        kind = m.group(2)
        if kind == "collective-permute":
            out[kind] = out.get(kind, 0.0) + n
            continue
        g = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
        if not g or int(g.group(2)) <= 1:
            continue
        frac = 1 - 1 / int(g.group(2))
        wire = 2 * n * frac if kind == "all-reduce" else n * frac
        out[kind] = out.get(kind, 0.0) + wire
        if kind == "all-reduce" and re.search(r"to_apply=%?[\w.]*_promoted",
                                              line):
            out["promoted"] = out.get("promoted", 0.0) + wire
    return out
"""

JAX_CHILD = PRELUDE + """
import jax
import numpy as np
jax.devices()  # 8 host devices, before dryrun's own XLA_FLAGS
from repro.configs import get_config
from repro.configs.shapes import SHAPES, ShapeSpec
from repro.launch import dryrun as JD
from repro.launch.roofline import model_flops
""" + FULL_WIRE + """
# Auto axes, as tests/test_torch_tp.py's mesh: jax.make_mesh's Explicit
# axes refuse the package's with_sharding_constraint calls
JD.make_production_mesh = lambda multi_pod=False: jax.sharding.Mesh(
    np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
for name, S, B, kind in SMALL:
    SHAPES[name] = ShapeSpec(name, S, B, kind)
out = {}
for key, cfg, name in cells(reduced(get_config, unroll=True)):
    m = JD._measure(cfg, name, False)
    out[key] = {k: m[k] for k in ("flops", "bytes_accessed", "collectives",
                                  "n_chips")}
    out[key]["model_flops"] = model_flops(cfg, SHAPES[name], m["n_chips"])
    out[key]["jax_full"] = full_wire(texts[-1])
print("RESULT " + json.dumps(out))
"""

PORT_CHILD = PRELUDE + """
import torch
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core.qtensor import tree_map_with_path
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import first_ranks_mesh
from repro_torch.launch.roofline import model_flops
for name, S_, B, kind in SMALL:
    SHAPES[name] = ShapeSpec(name, S_, B, kind)
cfg = reduced(get_config)
D.fake_group(8)
out = {"cells": {}, "one": {}, "gathers": []}
mesh = first_ranks_mesh(D.mesh_device(), (2, 4), ("data", "model"))
for key, kcfg, name in cells(cfg):
    c = D.count_step(kcfg, name, mesh)
    c["model_flops"] = model_flops(kcfg, SHAPES[name], c["n_chips"])
    out["cells"][key] = c
one = first_ranks_mesh(D.mesh_device(), (1, 1), ("data", "model"))
for name in ("train_4k", "decode_32k"):
    out["one"][name] = D.count_step(cfg, name, one)["collectives"]

# each leaf from its FSDP storage layout to its compute layout
params = D.params_struct(cfg)
lay = S.param_shardings(params, mesh)
comp = tree_map_with_path(
    lambda p, leaf: S.compute_param_pspec(p, leaf, mesh), params)
def gather(path, leaf, spec, cspec):
    d = S.to_dtensor(leaf, spec, mesh)
    counter = D.RankCounter()
    with counter:
        got = d.redistribute(mesh, S.placements(cspec, mesh))
    local = got.to_local()
    out["gathers"].append({"path": "/".join(path), "spec": repr(spec),
                           "records": counter.records,
                           "local_bytes": local.numel() * local.element_size()})
    return None
tree_map_with_path(gather, params, lay, comp)
print("RESULT " + json.dumps(out))
"""

FULL_CHILD = """
import json, sys
from repro_torch.launch import dryrun as D
arch, shape = sys.argv[1], sys.argv[2]
cell = D.run_cell(arch, shape, False)
cell.pop("traceback", None)
print("RESULT " + json.dumps(cell))
"""

# qwen3-0.6b's decode_32k at full width on the 256-rank mesh, cut to one
# layer: XLA's compiled step's products (its dots; attention's two
# einsums apart) and its elementwise outputs by opcode, read from the HLO,
# beside the port's count of the same cell
DECODE_GAP_JAX = """
import dataclasses, json, re
import jax
import numpy as np
jax.devices()
from repro.configs import get_config
from repro.launch import dryrun as JD
JD.make_production_mesh = lambda multi_pod=False: jax.sharding.Mesh(
    np.asarray(jax.devices()[:256]).reshape(16, 16), ("data", "model"))
cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=1, unroll=True)
compiled = JD.lower_cell(cfg, "decode_32k", False)[0].compile()
text = compiled.as_text()
shape_of, dots, attn, elems = {}, 0.0, 0.0, {}
head = re.compile(r"\\s*(?:ROOT )?%?([\\w.\\-]+) = \\w+\\[([\\d,]*)\\]\\S* ([\\w\\-]+)\\(")
dims = lambda s: [int(x) for x in s.split(",") if x]
for line in text.splitlines():
    m = head.match(line)
    if m:
        shape_of[m.group(1)] = dims(m.group(2))
for line in text.splitlines():
    m = head.match(line)
    if not m:
        continue
    out, op = dims(m.group(2)), m.group(3)
    n = int(np.prod(out)) if out else 1
    if op == "dot":
        lhs = re.search(r"dot\\([^%]*%([\\w.\\-]+)", line).group(1)
        k = re.search(r"lhs_contracting_dims=\\{([\\d,]*)\\}", line)
        f = 2.0 * n * int(np.prod([shape_of[lhs][i] for i in dims(k.group(1))]))
        dots += f
        if "bhgqk" in line:
            attn += f
    elif op in ("convert", "select", "dynamic-update-slice"):
        elems[op] = elems.get(op, 0) + n
print("RESULT " + json.dumps({"flops": compiled.cost_analysis()["flops"],
                              "dots": dots, "attention": attn,
                              "elements": elems}))
"""

DECODE_GAP_PORT = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.kernels import dispatch
from repro_torch.launch import dryrun as D
attn = []
dispatch.META_LISTENERS.append(
    lambda name, flops, moved, ops: attn.append(flops)
    if name == "ordered_bmm" else None)
cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=1)
c = D.count_cell(cfg, "decode_32k", False)
print("RESULT " + json.dumps({"flops": c["flops"], "attention": sum(attn),
                              "elementwise": c["elementwise_flops"]}))
"""

FULL_CELLS = [("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
              ("qwen3-0.6b", "decode_32k"), ("qwen3-moe-30b-a3b", "decode_32k"),
              ("qwen3-0.6b", "long_500k")]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def children():
    """Start every child at once; wait for each within its timeout, kill
    them all on a timeout or a failure.  {key: the child's RESULT}."""
    cmds = {"jax": ([sys.executable, "-c", textwrap.dedent(JAX_CHILD)],
                    _env(JAX_PLATFORMS="cpu", XLA_FLAGS=
                         "--xla_force_host_platform_device_count=8")),
            "port": ([sys.executable, "-c", textwrap.dedent(PORT_CHILD)],
                     _env())}
    cmds["gap_jax"] = ([sys.executable, "-c", DECODE_GAP_JAX], _env(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=256"))
    cmds["gap_port"] = ([sys.executable, "-c", DECODE_GAP_PORT], _env())
    for arch, shape in FULL_CELLS:
        cmds[(arch, shape)] = ([sys.executable, "-c", FULL_CHILD, arch,
                                shape], _env())
    return _run(cmds, CHILD_TIMEOUT)[0]


def _run(cmds: dict, timeout: float) -> tuple:
    """Start every child of `cmds` ({key: (argv, env)}) at once; wait for
    each in turn within `timeout` s, kill them all on a timeout or a
    failure.  ({key: the child's RESULT}, {key: seconds from the start to
    its end})."""
    t0 = time.time()
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=e,
                                 cwd=ROOT) for k, (c, e) in cmds.items()}
    out, secs = {}, {}
    try:
        for k, p in procs.items():
            so, se = p.communicate(timeout=timeout)
            secs[k] = round(time.time() - t0, 1)
            lines = [l for l in so.splitlines() if l.startswith("RESULT ")]
            assert p.returncode == 0 and lines, (
                f"child {k} exited {p.returncode}: {se[-3000:]}")
            out[k] = json.loads(lines[-1][len("RESULT "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, secs


@pytest.mark.parametrize("kind", KINDS)
def test_counts_agree_with_jax_measure(children, kind):
    """Per rank on the (2, 4) mesh, each count within MARGIN of its
    measured ratio to JAX's (the module docstring); each collective kind
    printed beside JAX's, with the port's sites."""
    jx, pt = children["jax"][kind], children["port"]["cells"][kind]
    assert pt["n_chips"] == jx["n_chips"] == 8
    assert pt["model_flops"] == jx["model_flops"]
    cj, cp = jx["collectives"], pt["collectives"]
    assert set(cj) == {"all-gather", "all-reduce"}
    assert {"all-gather", "all-reduce"} <= set(cp) <= {
        "all-gather", "all-reduce", "reduce-scatter"}
    got = {"flops": pt["flops"] / jx["flops"],
           "bytes": pt["bytes_accessed"] / jx["bytes_accessed"],
           "all-gather": cp["all-gather"] / cj["all-gather"],
           "all-reduce": cp["all-reduce"] / cj["all-reduce"],
           "reduce-scatter": cp.get("reduce-scatter", 0.0)
           / cj["all-reduce"]}
    for k in ("all-gather", "all-reduce", "reduce-scatter"):
        print(f"{kind} {k:15s} jax {cj.get(k, 0.0):.4e} (with its tuples "
              f"{jx['jax_full'].get(k, 0.0):.4e}) port "
              f"{cp.get(k, 0.0):.4e}")
    print(f"{kind} flops jax {jx['flops']:.4e} port {pt['flops']:.4e} "
          f"(+ elementwise {pt['elementwise_flops']:.4e}); bytes jax "
          f"{jx['bytes_accessed']:.4e} port {pt['bytes_accessed']:.4e}")
    for site, b in pt["collective_sites"].items():
        print(f"{kind}   {site}: {b:.4e}")
    for k, want in EXPECTED[kind].items():
        assert want / MARGIN <= got[k] <= want * MARGIN, (k, got[k], want)


@pytest.mark.parametrize("kind", KINDS)
def test_no_more_gathered_or_reduced_than_jax(children, kind):
    """Per rank on the (2, 4) mesh: the port's all-gather at most
    GATHER_LIMIT times JAX's, and its reductions (all-reduce and
    reduce-scatter) within MARGIN of XLA's all-reduce counted with its
    tuple operands (the port's lookup sums its rows over all of 'model',
    XLA's over half of it), so no gather is traded for a larger
    reduction."""
    jx, pt = children["jax"][kind], children["port"]["cells"][kind]
    cj, cp = jx["collectives"], pt["collectives"]
    assert jx["jax_full"]["all-gather"] == pytest.approx(cj["all-gather"])
    assert cp["all-gather"] <= GATHER_LIMIT * cj["all-gather"]
    assert cp["all-reduce"] + cp.get("reduce-scatter", 0.0) <= \
        MARGIN * jx["jax_full"]["all-reduce"]


def test_kv_heads_that_model_does_not_divide(children):
    """train_4k with 2 KV heads on the (2, 4) mesh (remat off, one chunk):
    the production cell's 8 KV heads on 16 'model' ranks in miniature.
    Each rank projects the one KV head its query heads read, so two ranks
    project each head; the port's FLOPs at most KV2_FLOP_LIMIT times
    JAX's, and its reductions within MARGIN of XLA's all-reduce counted
    with its tuple operands."""
    jx, pt = children["jax"][KV2], children["port"]["cells"][KV2]
    cp = pt["collectives"]
    red = cp["all-reduce"] + cp.get("reduce-scatter", 0.0)
    print(f"{KV2} flops jax {jx['flops']:.4e} port {pt['flops']:.4e}; "
          f"reductions XLA with its tuples {jx['jax_full']['all-reduce']:.4e}"
          f" port {red:.4e}")
    assert pt["model_flops"] == jx["model_flops"]
    assert pt["flops"] <= KV2_FLOP_LIMIT * jx["flops"]
    assert red <= MARGIN * jx["jax_full"]["all-reduce"]


@pytest.mark.parametrize("kind", KINDS)
def test_memory_keys_are_jax_s(children, kind):
    mem = children["port"]["cells"][kind]["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes"}
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["temp_bytes"] > 0
    # the caches are updated in place: a serving step's outputs alias them
    if kind != "train_4k":
        assert mem["alias_bytes"] > 0


@pytest.mark.parametrize("kind", ["train_4k", "decode_32k"])
def test_one_rank_mesh_counts_no_collective(children, kind):
    assert children["port"]["one"][kind] == {}


def test_fsdp_gathers_are_the_layout_s_leaf_by_leaf(children):
    """A leaf whose storage layout splits it over 'data' is gathered to
    its compute layout by one all-gather over the 2 data ranks, of its
    compute-layout shard's bytes; a leaf that is not moves nothing."""
    gathers = children["port"]["gathers"]
    assert gathers
    n_sharded = 0
    for g in gathers:
        if "'data'" in g["spec"]:
            n_sharded += 1
            assert g["records"] == [["all-gather", float(g["local_bytes"]),
                                     2]], g
        else:
            assert g["records"] == [], g
        wire = R.collective_wire_bytes(tuple(r) for r in g["records"])
        assert wire == ({"all-gather": g["local_bytes"] / 2}
                        if g["records"] else {})
    assert n_sharded >= 7  # every projection of a layer, the embedding


@pytest.mark.parametrize("arch,shape", FULL_CELLS)
def test_full_width_cells_on_the_production_mesh(children, arch, shape):
    """run_cell at full width on the 256-rank mesh: ok, FLOPs counted,
    the dominant term one of the three; long_500k skipped with JAX's
    reason for a full-attention arch."""
    cell = children[(arch, shape)]
    assert (cell["arch"], cell["shape"], cell["mesh"]) == (arch, shape,
                                                          "single")
    if shape == "long_500k":
        assert cell["status"] == "skipped"
        assert cell["reason"] == ("pure full-attention arch — long_500k "
                                  "needs sub-quadratic attention")
        return
    assert cell["status"] == "ok", cell.get("error")
    assert cell["n_chips"] == 256 and cell["flops"] > 0
    assert cell["raw"] == {k: cell[k] for k in ("flops", "bytes_accessed",
                                                "collectives")}
    rf = cell["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    cfg, spec = get_config(arch), SHAPES[shape]
    assert rf["model_flops_per_chip"] == R.model_flops(cfg, spec, 256)
    assert rf["t_compute_s"] == cell["flops"] / R.PEAK_FLOPS
    assert cell["count_s"] > 0


def test_counter_counts_what_gathers_and_in_place_writes_move():
    """A gather counts its rows (output read and written, indices read),
    not its table; an in-place scatter three update sizes and its
    indices, not its destination (XLA's cost analysis); the least traffic
    reads each argument byte once however many ops read it, a slice at a
    time or gathered."""
    import torch
    import torch.nn.functional as F
    from repro_torch.launch import dryrun as D

    table = torch.empty((1000, 64), device="meta")          # 256,000 B
    stack = torch.empty((4, 32, 64), device="meta")         # 32,768 B
    cache = torch.empty((2, 100, 64), device="meta")        # 51,200 B
    ids = torch.empty((8,), dtype=torch.int64, device="meta")
    slot = torch.empty((1,), dtype=torch.int64, device="meta")

    def step():
        x = F.embedding(ids, table)                  # (8, 64): 2,048 B
        for r in range(4):                           # each layer's slice
            x = x @ stack[r].T[:64, :32] @ stack[r]  # reads stack[r] twice
        cache[:, slot] = x[:2, None]                 # a (2, 1, 64) update
        return x @ table.T                           # the tied head

    counts, _ = D.count_call(step, (table, stack, cache, ids, slot))
    fp = 4
    gather = 2 * 8 * 64 * fp + 8 * 8
    scatter = 3 * 2 * 64 * fp + 8
    assert counts["bytes_accessed"] > gather + scatter
    c = D.RankCounter()
    with c:
        F.embedding(ids, table)
    assert c.bytes == gather
    c = D.RankCounter()
    with c:
        cache[:, slot] = torch.empty((2, 1, 64), device="meta")
    assert c.bytes == scatter
    # the arguments once each (the cache: its one written slot, each
    # row), the ids and slot, and the fresh logits (8, 1000) written
    assert counts["min_bytes"] == (256000 + 32768 + 64 + 8
                                   + 2 * 64 * fp + 8 * 1000 * fp)


def test_decode_flops_gap_is_xla_s_elementwise_work_over_the_cache(children):
    """qwen3-0.6b's decode_32k on the 256-rank mesh, one layer: the
    port's attention products (`ordered_bmm` over each rank's 2048 keys
    of the length-sharded cache, every query head) are XLA's attention
    einsums within 1 %; XLA's FLOPs beyond its products are its converts,
    selects and dynamic-update-slices over the rank's whole cache (one
    FLOP an element), which the port, writing one slot in place, does not
    run.  This is the decode FLOP gap of the production cells."""
    jx, pt = children["gap_jax"], children["gap_port"]
    print(f"decode_32k, 1 layer: XLA flops {jx['flops']:.4e}, dots "
          f"{jx['dots']:.4e} (attention {jx['attention']:.4e}), elementwise "
          f"outputs {jx['elements']}; port flops {pt['flops']:.4e} "
          f"(attention {pt['attention']:.4e}, elementwise "
          f"{pt['elementwise']:.4e})")
    assert abs(pt["attention"] / jx["attention"] - 1) <= 0.01
    rest = jx["flops"] - jx["dots"]
    assert rest >= 0.5 * jx["flops"]
    assert sum(jx["elements"].values()) >= 0.9 * rest
    assert pt["elementwise"] <= 0.05 * rest


# ---------------------------------------------------------------------------
# Like for like at full width: a one-off count, not a test.
#   PYTHONPATH=src python tests/test_torch_dryrun.py [--side both|port]
# counts qwen3-0.6b train_4k on the (16, 16) mesh, per rank, with remat off
# and attention in one chunk on both sides, and writes LFL_OUT.  JAX's side
# (a child on the CPU, 256 host devices) unrolls its layers, so XLA counts
# each once, and points its `attn_apply`, which passes a chunk of its own
# (1024) rather than the config's, at the config's; its collectives are
# also read with FULL_WIRE (tuple all-reduces, collective-permutes).  The
# port's side is `count_cell`'s, like for like and at the production
# config; and, to show what JAX's sweep count (`run_cell`) misses, that
# count and its steps to the like-for-like one (LFL_VARIANTS).  `--side
# port` counts the port's side only (a host without JAX, such as the
# card's) and adds it beside the sides already in LFL_OUT.
# ---------------------------------------------------------------------------

LFL_OUT = ROOT / "results" / "torch_dryrun" / \
    "like_for_like__qwen3-0.6b__train_4k.json"
LFL_TIMEOUT = 900
LFL_CFG = ('dataclasses.replace(get_config("qwen3-0.6b"), remat=False, '
           'attn_chunk=4096)')

# JAX's side, one variant a child (argv[1]): "like_for_like" as above;
# the yardstick's steps from it: "run_cell" (the sweep's count: remat on,
# scanned layers and their correction, four query chunks), "run_cell,
# remat off", and "unrolled, remat off" (four query chunks)
LFL_VARIANTS = ("like_for_like", "run_cell", "run_cell, remat off",
                "unrolled, remat off")
LFL_JAX = """
import dataclasses, json, sys
import jax
jax.devices()  # 256 host devices, before dryrun's own XLA_FLAGS
from repro.configs import get_config
from repro.configs.shapes import SHAPES
from repro.launch.roofline import model_flops
from repro.models import layers as JL
""" + FULL_WIRE + """
JD.make_production_mesh = lambda multi_pod=False: jax.sharding.Mesh(
    np.asarray(jax.devices()[:256]).reshape(16, 16), ("data", "model"))
variant = sys.argv[1]
cfg = dataclasses.replace(""" + LFL_CFG + """, unroll=True)
if variant == "like_for_like":
    _attention = JL.attention
    JL.attention = lambda q, k, v, **kw: _attention(
        q, k, v, **{**kw, "chunk": cfg.attn_chunk})
if variant.startswith("run_cell"):
    if variant.endswith("remat off"):
        _get = JD.get_config
        JD.get_config = lambda arch: dataclasses.replace(_get(arch),
                                                         remat=False)
    m = JD.run_cell("qwen3-0.6b", "train_4k", False)
    assert m["status"] == "ok", m
else:
    m = JD._measure(cfg, "train_4k", False)
    m["full_wire"] = full_wire(texts[-1])
out = {k: m[k] for k in ("flops", "bytes_accessed", "collectives", "n_chips",
                         "full_wire") if k in m}
out["model_flops"] = model_flops(cfg, SHAPES["train_4k"], m["n_chips"])
out["jax"] = jax.__version__
print("RESULT " + json.dumps(out))
"""

LFL_PORT = """
import dataclasses, json
import torch
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.roofline import model_flops
out = {"torch": torch.__version__, "mesh_device": D.mesh_device()}
for key, cfg in (("like_for_like", """ + LFL_CFG + """),
                 ("production", get_config("qwen3-0.6b"))):
    c = D.count_cell(cfg, "train_4k", False)
    out[key] = {k: c[k] for k in ("flops", "elementwise_flops",
                                  "bytes_accessed", "collectives",
                                  "collective_sites", "n_chips", "count_s")}
    out[key]["model_flops"] = model_flops(cfg, SHAPES["train_4k"], 256)
print("RESULT " + json.dumps(out))
"""


def _lfl_ratios(port: dict, jax: dict) -> dict:
    """The port's like-for-like counts over JAX's: FLOPs (the port's
    products, and with its elementwise ops, which XLA's count holds);
    reductions (all-reduce and reduce-scatter) over XLA's all-reduce with
    its tuples, as XLA's CPU backend counts it (f32) and with the
    all-reduces it widened at their bf16 width; all-gather."""
    full = jax["full_wire"]
    c = port["collectives"]
    red = c.get("all-reduce", 0.0) + c.get("reduce-scatter", 0.0)
    return {
        "flops": port["flops"] / jax["flops"],
        "flops_with_elementwise": (port["flops"] + port["elementwise_flops"])
        / jax["flops"],
        "reductions_over_xla_full": red / full["all-reduce"],
        "reductions_over_xla_full_bf16": red / (
            full["all-reduce"] - full.get("promoted", 0.0) / 2),
        "reductions_over_jax_measure": red / jax["collectives"]["all-reduce"],
        "all_gather_over_xla": c.get("all-gather", 0.0)
        / full["all-gather"]}


def like_for_like(argv=None) -> dict:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", choices=("both", "port"), default="both")
    ap.add_argument("--out", type=Path, default=LFL_OUT)
    args = ap.parse_args(argv)
    rec = json.loads(args.out.read_text()) if args.out.exists() else {}
    cmds = {"port": ([sys.executable, "-c", LFL_PORT], _env())}
    if args.side == "both":
        for v in LFL_VARIANTS:
            cmds[v] = ([sys.executable, "-c", LFL_JAX, v], _env(
                JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=256"))
    got, secs = _run(cmds, LFL_TIMEOUT)
    rec["cell"] = ("qwen3-0.6b train_4k, 256 ranks as (16 data, 16 model), "
                   "per rank; like for like: remat off, attention in one "
                   "chunk of 4096, JAX's layers unrolled")
    cmd = ("PYTHONPATH=src python tests/test_torch_dryrun.py "
           f"--side {args.side}")
    if args.side == "both":
        rec["jax"] = {**got["like_for_like"], "seconds": secs["like_for_like"],
                      "command": cmd}
        rec["jax_yardstick"] = {v: {**got[v], "seconds": secs[v]}
                                for v in LFL_VARIANTS[1:]}
    port = got["port"]
    key = f"{port['mesh_device']} mesh, torch {port['torch']}"
    rec.setdefault("port", {})[key] = {**port, "seconds": secs["port"],
                                       "command": cmd}
    rec["ratios"] = {k: _lfl_ratios(p["like_for_like"], rec["jax"])
                     for k, p in rec["port"].items()}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps(rec["ratios"], indent=1))
    return rec


if __name__ == "__main__":
    like_for_like()
