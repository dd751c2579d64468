"""A copy of `repro/data/synth.py` (numpy only, so the port imports no JAX
package): the same bytes for the same seed and step.

Synthetic datasets: learnable stand-ins for the paper's corpora when the
originals aren't on disk (offline container).  All are deterministic in
(seed, step) — stateless restart, same as data/text.py.

  * markov_bytes: an order-2 character process with a skewed transition
    table — has real structure (achievable BPC well below log2(V)), so
    quantized-vs-fp comparisons are meaningful.
  * seq_mnist_like: class-conditional 28x28 binary images (prototype +
    noise) processed pixel-by-pixel, the paper's sequential-MNIST shape.
  * token_stream: uniform token batches for throughput/dry-run work.
"""
from __future__ import annotations

import numpy as np


def markov_bytes(n: int, vocab: int = 64, seed: int = 0,
                 temperature: float = 0.3) -> np.ndarray:
    """Order-2 Markov chain over `vocab` symbols with sparse/skewed rows."""
    rng = np.random.default_rng(seed)
    logits = rng.gumbel(size=(vocab, vocab, vocab)) / temperature
    # sparsify: keep top-8 transitions per context
    k = min(8, vocab)
    thresh = np.partition(logits, -k, axis=-1)[..., -k][..., None]
    logits = np.where(logits >= thresh, logits, -np.inf)
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    cdf = np.cumsum(p, axis=-1)

    out = np.empty(n, dtype=np.uint16)
    a = b = 0
    u = rng.random(n)
    for i in range(n):
        c = int(np.searchsorted(cdf[a, b], u[i]))
        out[i] = c = min(c, vocab - 1)
        a, b = b, c
    return out


def seq_mnist_like(step: int, batch: int, *, n_classes: int = 10,
                   side: int = 28, noise: float = 0.15, seed: int = 7) -> dict:
    """(images (B, side*side, 1) float32 in {0,1}, labels (B,)) per step."""
    proto_rng = np.random.default_rng(seed)
    protos = (proto_rng.random((n_classes, side * side)) < 0.25).astype(np.float32)
    rng = np.random.default_rng(seed * 1_000_003 + step)
    labels = rng.integers(0, n_classes, size=batch)
    x = protos[labels]
    flip = rng.random((batch, side * side)) < noise
    x = np.where(flip, 1.0 - x, x).astype(np.float32)
    return {"pixels": x[..., None], "labels": labels.astype(np.int32)}


def token_stream(step: int, batch: int, seq: int, vocab: int,
                 seed: int = 0) -> dict:
    rng = np.random.default_rng(seed * 999_983 + step)
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}
