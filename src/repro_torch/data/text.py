"""A copy of `repro/data/text.py` (numpy only, so the port imports no JAX
package): the same bytes for the same seed and step.

Byte/char-level corpus pipeline from local files.

Stateless by construction: every batch is a pure function of (split, step),
so a restarted job resumes exactly (fault-tolerance requirement — no iterator
state in checkpoints).  Window sampling uses a counter-based hash, giving a
reshuffled epoch without materializing permutations.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np


def _mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 — counter-based pseudo-random positions."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class ByteCorpus:
    """A byte-level corpus with train/valid/test splits and a dense vocab."""

    data: np.ndarray          # uint8/uint16 token ids, full corpus
    vocab: int
    itos: np.ndarray          # id -> byte value
    splits: dict              # name -> (start, end)

    @classmethod
    def from_bytes(cls, raw: bytes, *, valid_frac: float = 0.05,
                   test_frac: float = 0.05) -> "ByteCorpus":
        arr = np.frombuffer(raw, dtype=np.uint8)
        uniq, inv = np.unique(arr, return_inverse=True)
        data = inv.astype(np.uint16)
        n = len(data)
        nv, nt = int(n * valid_frac), int(n * test_frac)
        splits = {"train": (0, n - nv - nt),
                  "valid": (n - nv - nt, n - nt),
                  "test": (n - nt, n)}
        return cls(data=data, vocab=int(len(uniq)), itos=uniq, splits=splits)

    @classmethod
    def from_files(cls, paths: Iterable[str | Path], **kw) -> "ByteCorpus":
        raw = b"\n".join(Path(p).read_bytes() for p in sorted(map(str, paths)))
        return cls.from_bytes(raw, **kw)

    @classmethod
    def from_dir(cls, root: str | Path, suffixes: Sequence[str] = (".py", ".md"),
                 limit_bytes: int = 8_000_000, **kw) -> "ByteCorpus":
        """Corpus from a source tree (the offline stand-in for Linux-Kernel/
        War&Peace style corpora; real deployments point this at the dataset)."""
        files, total = [], 0
        for p in sorted(Path(root).rglob("*")):
            if p.suffix in suffixes and p.is_file():
                sz = p.stat().st_size
                if total + sz > limit_bytes:
                    break
                files.append(p)
                total += sz
        return cls.from_files(files, **kw)

    def batch(self, split: str, step: int, batch_size: int, seq: int,
              *, host_id: int = 0, n_hosts: int = 1) -> dict:
        """Deterministic (tokens, targets) for `step`; hosts draw disjoint
        rows of the global batch (rows [host_id*b_local, ...))."""
        s0, s1 = self.splits[split]
        span = s1 - s0 - seq - 1
        b_local = batch_size // n_hosts
        row0 = host_id * b_local
        ctr = (np.uint64(step) << np.uint64(20)) + np.arange(
            row0, row0 + b_local, dtype=np.uint64)
        starts = (s0 + (_mix64(ctr) % np.uint64(span))).astype(np.int64)
        idx = starts[:, None] + np.arange(seq + 1)[None, :]
        windows = self.data[idx]
        return {"tokens": windows[:, :-1].astype(np.int32),
                "targets": windows[:, 1:].astype(np.int32)}

    def decode(self, ids: np.ndarray) -> str:
        return bytes(self.itos[np.asarray(ids)]).decode("utf-8", errors="replace")
