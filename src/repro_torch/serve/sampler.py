"""Token sampling for the serving loop, ported from `repro/serve/sampler.py`.

`sample_slots` is the per-slot form the engine uses: every row carries its
own request seed, token counter, temperature and top-k.  `sample`, which
the lockstep `drive_session` uses, is the same function with one
temperature and top-k for the batch, so a request's stream is the same
served alone or among others.

The draws are counter-based, where JAX carries a `jax.random` key chain
per slot.  The uniform for request seed s, token index i, stream j and
vocab column v is a pure integer hash of (s, i, j, v) (`uniforms`),
computed with int64 tensor ops on the logits' device and turned into
Gumbel noise; the draw is the argmax of the filtered logits plus that
noise.  So a draw needs no generator state: a slot's stream depends only
on (prompt, seed, temperature, top-k), however the engine batched it.
The integer ops give the same bits on the CPU and the card; the float
`log` of the Gumbel transform may round differently between the two.
Since the noise is a function of the token index, `gumbel` can draw many
tokens' at once and `draw` consume it: `drive_session` draws a whole
session's before its first step, so a step costs the filter and an argmax
(`draw_batch`: one temperature and top-k for the batch, fewer ops, the
same bits as the per-row filter).
`jax.random` draws other numbers, so parity with JAX at temperature > 0
holds by distribution only.

Streams keep the draws of one token apart: `SAMPLE` for plain sampling,
and for speculative decoding `DRAFT` (proposals), `ACCEPT` (the accept
uniforms), `RESIDUAL` and `BONUS` (the trailing token), as JAX's
`fold_in` and three-way key split do.

The speculative half (`filtered_probs`, `residual_probs`,
`categorical_slots`, `spec_accept`) is JAX's: at temperature 0 the
distributions are exact one-hots, so the accept rule is "accept iff the
draft is the target's argmax" and greedy speculative decoding is plain
greedy decoding, byte for byte.
"""
from __future__ import annotations

from typing import Union

import torch

SAMPLE, DRAFT, ACCEPT, RESIDUAL, BONUS = range(5)

_M32 = 0xFFFFFFFF
# C. Wellons' 32-bit integer hash; its multipliers, and the golden-ratio
# one, are below 2^31, so a product with a 32-bit value stays below 2^63
# in int64 (the CPU build has no uint64 arithmetic)
_K1, _K2, _GOLD = 0x21F0AAAD, 0x735A2D97, 0x61C88647

IntLike = Union[int, torch.Tensor]


def _mix(x):
    """The hash of x in [0, 2^32): an int64 tensor or a Python int."""
    x = x ^ (x >> 16)
    x = (x * _K1) & _M32
    x = x ^ (x >> 15)
    x = (x * _K2) & _M32
    return x ^ (x >> 15)


def _rows(v: IntLike, B: int, device, mix: bool = False) -> torch.Tensor:
    """An int or (B,) ints as (B,) int64 on `device`, mod 2^32, hashed
    with `mix`; an int is hashed on the host and filled on the device, so
    no host copy waits for it."""
    if not isinstance(v, torch.Tensor):
        v = int(v) & _M32
        return torch.full((B,), _mix(v) if mix else v, dtype=torch.int64,
                          device=device)
    t = v.to(device=device, dtype=torch.int64)
    t = (t.reshape(-1) if t.dim() else t.reshape(1)).expand(B) & _M32
    return _mix(t) if mix else t


def uniforms(seeds: IntLike, counters: IntLike, stream: int, shape,
             device) -> torch.Tensor:
    """Uniforms in (0, 1), float32, of `shape` (B, ..., V): element [b, ...,
    v] is a hash of (seeds[b], counters[b] + the position along the middle
    axis, `stream`, v), each taken mod 2^32.  seeds and counters are ints
    or (B,) int tensors; a middle axis of size T (shape (B, T, V)) counts
    up from counters[b], one token a position."""
    B, V = shape[0], shape[-1]
    dev = torch.device(device)
    ctr = _rows(counters, B, dev)
    if len(shape) == 3:
        ctr = ctr[:, None] + torch.arange(shape[1], device=dev)
    seed = _rows(seeds, B, dev, mix=True).reshape(
        (B,) + (1,) * (ctr.dim() - 1))
    key = _mix(seed ^ ((ctr * _GOLD) & _M32))
    col = (torch.arange(V, device=dev) * _GOLD
           + _mix(stream + 1)) & _M32
    h = _mix(key[..., None] ^ col)
    # 23 high bits, centred in their cell: exact in float32 (24 bits would
    # round the top cell up to 1.0), so never 0 or 1
    return ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def gumbel(seeds: IntLike, counters: IntLike, stream: int, shape,
           device) -> torch.Tensor:
    """Gumbel noise -log(-log(u)) of `uniforms(seeds, counters, stream,
    shape)`: shape (B, V) for one token a row, (B, T, V) for T tokens from
    counters on (what `drive_session` draws for a whole session at once:
    the noise is a function of the token index, not of when it is drawn)."""
    return -torch.log(-torch.log(uniforms(seeds, counters, stream, shape,
                                          device)))


def _masked(logits: torch.Tensor, vocab: int = 0) -> torch.Tensor:
    """Columns past `vocab` at the dtype's minimum."""
    V = logits.shape[-1]
    if vocab and V > vocab:
        keep = torch.arange(V, device=logits.device) < vocab
        logits = torch.where(keep, logits, torch.finfo(logits.dtype).min)
    return logits


def _greedy(logits: torch.Tensor, vocab: int = 0):
    """(vocab-masked logits, their argmax (B,) int32, ties to the lowest
    index): what a temperature <= 0 row takes."""
    logits = _masked(logits, vocab)
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


def _filtered(logits: torch.Tensor, temperature: torch.Tensor,
              top_k: torch.Tensor, vocab: int = 0):
    """The per-slot filtering `sample_slots` and `filtered_probs` share:
    vocab mask, temperature scaling, sort-based top-k.  Returns (final
    logits, greedy (B,) int32); greedy is the argmax of the vocab-masked
    logits before scaling (ties to the lowest index), what a temperature
    <= 0 slot takes.  The k-th largest value comes from a descending sort,
    so a per-slot k needs no static k."""
    V = logits.shape[-1]
    neg = torch.finfo(logits.dtype).min
    logits, greedy = _greedy(logits, vocab)
    t = temperature.to(device=logits.device, dtype=logits.dtype)[:, None]
    scaled = logits / torch.where(t > 0, t, torch.ones_like(t))
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k = top_k.to(device=logits.device, dtype=torch.int64)
    kth = torch.gather(desc, -1, (k - 1).clamp(0, V - 1)[:, None])
    filtered = torch.where(scaled >= kth, scaled, neg)
    final = torch.where((k > 0)[:, None], filtered, scaled)
    return final, greedy


def draw(logits: torch.Tensor, noise: torch.Tensor, *,
         temperature: torch.Tensor, top_k: torch.Tensor,
         vocab: int = 0) -> torch.Tensor:
    """The draw given its Gumbel noise (B, V) (`gumbel`): the argmax of the
    filtered logits plus the noise where temperature > 0, the greedy id
    elsewhere.  temperature (B,) fp, top_k (B,) int -> (B,) int32."""
    final, greedy = _filtered(logits, temperature, top_k, vocab)
    drawn = torch.argmax(final.float() + noise, dim=-1).to(torch.int32)
    return torch.where(temperature.to(logits.device) > 0, drawn, greedy)


def draw_batch(logits: torch.Tensor, noise: torch.Tensor, *,
               temperature: float, top_k: int = 0,
               vocab: int = 0) -> torch.Tensor:
    """`draw` with one temperature (> 0) and top-k for the whole batch, as
    `drive_session` samples: the same filter written for scalars, in a
    third of the ops, and the same bits.  The temperature divides as a
    tensor on the logits' device (a CPU scalar would become a reciprocal
    multiply on CUDA), and `topk` finds the k-th value the sort finds."""
    scaled = _masked(logits, vocab) / torch.full(
        (), float(temperature), dtype=logits.dtype, device=logits.device)
    if top_k > 0:
        kth = torch.topk(scaled, min(int(top_k), scaled.shape[-1]),
                         dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.finfo(scaled.dtype).min)
    return torch.argmax(scaled.float() + noise, dim=-1).to(torch.int32)


def sample_slots(logits: torch.Tensor, seeds: IntLike, counters: IntLike, *,
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 vocab: int = 0, stream: int = SAMPLE) -> torch.Tensor:
    """Per-slot sampling: logits (B, V); seeds and counters (B,) ints (the
    request's seed and the index of the token drawn); temperature (B,)
    fp, top_k (B,) int -> (B,) int32.  temperature <= 0 is greedy for that
    row; top_k <= 0 keeps every token.  A row's draw depends on its own
    logits, seed, counter and settings only."""
    return draw(logits, gumbel(seeds, counters, stream, logits.shape,
                               logits.device),
                temperature=temperature, top_k=top_k, vocab=vocab)


def sample(logits: torch.Tensor, seeds: IntLike, counter: IntLike = 0, *,
           temperature: float = 1.0, top_k: int = 0,
           vocab: int = 0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32 with one temperature and top-k for the
    batch: what `sample_slots` draws with those broadcast.  `seeds` is an
    int or (B,) ints, `counter` the index of the token drawn (an int or
    (B,)).  temperature <= 0 means greedy, without drawing noise."""
    if temperature <= 0.0:
        return _greedy(logits, vocab)[1]
    return draw_batch(logits, gumbel(seeds, counter, SAMPLE, logits.shape,
                                     logits.device),
                      temperature=temperature, top_k=top_k, vocab=vocab)


# ---------------------------------------------------------------------------
# speculative decoding: rejection-sampling acceptance
# ---------------------------------------------------------------------------


def filtered_probs(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, vocab: int = 0) -> torch.Tensor:
    """The distribution `sample_slots` draws from, (B, V) float32: softmax
    of the filtered logits, and an exact one-hot at the greedy argmax where
    temperature <= 0 (what makes greedy speculation byte-exact)."""
    final, greedy = _filtered(logits.float(), temperature, top_k, vocab)
    probs = torch.softmax(final, dim=-1)
    onehot = torch.nn.functional.one_hot(greedy.long(), logits.shape[-1]).to(
        probs.dtype)
    t = temperature.to(logits.device)
    return torch.where((t > 0)[:, None], probs, onehot)


def residual_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """norm(max(p - q, 0)) over the last axis; where the residual has no
    mass (p == q up to rounding), p itself."""
    r = (p - q).clamp_min(0.0)
    s = r.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, r / torch.where(s > 0, s, torch.ones_like(s)),
                       p)


def categorical_slots(seeds: IntLike, counters: IntLike, stream: int,
                      probs: torch.Tensor) -> torch.Tensor:
    """A draw from each probability row (B, V) -> (B,) int32; a one-hot row
    draws its hot index (log turns the zeros into -inf)."""
    g = gumbel(seeds, counters, stream, probs.shape, probs.device)
    return torch.argmax(torch.log(probs) + g, dim=-1).to(torch.int32)


def spec_accept(p_logits: torch.Tensor, q_logits: torch.Tensor,
                drafts: torch.Tensor, seeds: IntLike, counters: IntLike, *,
                temperature: torch.Tensor, top_k: torch.Tensor,
                vocab: int = 0):
    """Leviathan-style accept/reject over a batch of slots.

    p_logits (B, K+1, V): the target's logits at every verify position (K
    is the bonus position); q_logits (B, K, V): the draft's; drafts (B, K)
    the proposals; seeds and counters (B,): the request seed and the token
    index of position 0; temperature/top_k (B,): the same filtering on p
    and q, so the accepted stream follows the target's distribution.

    Returns (n_acc (B,) int32, out (B, K+1) int32): slot b emits
    out[b, :n_acc[b]], its accepted drafts and one trailing token (the
    residual draw at the first rejection, or the bonus draw when every
    draft survived); 1 <= n_acc <= K+1.  Position k's accept uniform is
    stream ACCEPT at counter + k; the trailing token at position m draws
    stream RESIDUAL or BONUS at counter + m."""
    B, Kp1, V = p_logits.shape
    K = Kp1 - 1
    dev = p_logits.device
    P = torch.stack([filtered_probs(p_logits[:, i], temperature, top_k,
                                    vocab) for i in range(Kp1)], dim=1)
    Q = torch.stack([filtered_probs(q_logits[:, i], temperature, top_k,
                                    vocab) for i in range(K)], dim=1)
    u = uniforms(seeds, counters, ACCEPT, (B, K, 1), dev)[..., 0]
    d = drafts.long()[..., None]
    pd = torch.gather(P[:, :K], -1, d)[..., 0]
    qd = torch.gather(Q, -1, d)[..., 0]
    # u < p(d)/q(d) without a division: q(d) = 0 rejects, and a one-hot
    # ratio of exactly 1 always accepts
    accept = u * qd < pd
    n_d = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    pos = n_d.clamp_max(K - 1).long()
    rows = torch.arange(B, device=dev)
    ctr = _rows(counters, B, dev) + n_d
    t_res = categorical_slots(seeds, ctr, RESIDUAL,
                              residual_probs(P[rows, pos], Q[rows, pos]))
    t_bonus = categorical_slots(seeds, ctr, BONUS, P[:, K])
    final = torch.where(n_d == K, t_bonus, t_res)
    cols = torch.arange(K + 1, device=dev)[None]
    dpad = torch.cat([drafts.to(torch.int32),
                      torch.zeros((B, 1), dtype=torch.int32, device=dev)], 1)
    out = torch.where(cols == n_d[:, None], final[:, None], dpad)
    return (n_d + 1).to(torch.int32), out.to(torch.int32)
