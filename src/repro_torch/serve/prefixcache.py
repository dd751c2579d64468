"""Prefix-state cache for the serving front door, ported from
`repro/serve/prefixcache.py`.

Shared-prefix traffic (a system prompt repeated across requests) is where
carried state pays off: a cached prefix of the RNN is one (L, H) h/c row
pair, and resuming from it is one row copy instead of prefilling the
prefix again.  A transformer's cached prefix is its slot's kv caches
trimmed to the prefix's columns (`narrow_state`); the splice zero-fills
them back to the pool's capacity (`widen_state`) and copies the row.

The cache is keyed on a digest of the token-id prefix at chunk
boundaries, the offsets where the engine's chunked prefill holds a whole,
exact carried state.  On admission the engine looks up the longest cached
boundary prefix of the prompt (capped at size-1: the last chunk must run,
because it samples the first token), splices the entry's state into the
slot and prefills the rest; each full chunk that lands offers the slot's
state back.  A spliced state is the state chunked prefill carries to that
boundary, so a hit streams the bytes a cold prefill would.

A digest collision cannot poison a stream: an entry keeps the exact ids it
was built from, and a lookup whose digest matches but whose ids differ is
refused (counted in `collisions`).  Eviction is LRU under a byte budget
counted on the stored entries (target and, in speculative engines, draft
state).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.qtensor import tree_map
from repro_torch.serve.kvcache import AttnCache, cache_narrow, cache_widen


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor or array in a (nested tuple/list/dict) state,
    attention caches included."""
    if tree is None:
        return 0
    if isinstance(tree, AttnCache):
        return tree_bytes((tree.k, tree.v, tree.pos))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def narrow_state(sub: Any, p: int) -> Any:
    """Narrow a gathered batch-1 slot state for storage: attention caches
    keep only their first `p` kv columns (views; the caller copies); the
    RNN's O(1) leaves are already minimal and pass through."""
    return tree_map(lambda l: cache_narrow(l, p)
                    if isinstance(l, AttnCache) else l, sub)


def widen_state(sub: Any, pool: Any) -> Any:
    """Zero-fill narrowed attention caches back to the pool's capacity (the
    cap axis of `pool`'s matching node), so a splice is the same full-row
    copy admission uses; other leaves pass through."""
    def widen(l, ref):
        if not isinstance(l, AttnCache):
            return l
        ax = l.pos.dim()
        shape = list(l.k.shape)
        shape[ax] = ref.k.shape[ax]
        return cache_widen(l, tuple(shape))
    return tree_map(widen, sub, pool)


@dataclasses.dataclass
class PrefixEntry:
    tokens: np.ndarray          # the exact ids hashed: the poison guard
    state: Any                  # narrowed batch-1 target state (a copy)
    draft_state: Optional[Any]  # the draft's (speculative engines)
    nbytes: int


class PrefixCache:
    """LRU map: token-prefix digest -> carried slot state at that boundary.

    Several engines may share one cache if they agree on the chunk size
    and the state layout: `bind(chunk)` pins the boundary stride on first
    use and refuses a mismatched engine afterwards."""

    def __init__(self, budget_bytes: int):
        if budget_bytes < 1:
            raise ValueError("prefix cache needs a positive byte budget")
        self.budget_bytes = int(budget_bytes)
        self.chunk: Optional[int] = None
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0       # prefill tokens splices made unnecessary
        self.insertions = 0
        self.evictions = 0
        self.collisions = 0       # digest matched, stored ids did not

    def bind(self, chunk: int) -> None:
        if self.chunk is None:
            self.chunk = int(chunk)
        elif self.chunk != int(chunk):
            raise ValueError(
                f"prefix cache is bound to chunk={self.chunk}; an engine "
                f"with prefill_chunk={chunk} would key incompatible "
                f"boundaries")

    @staticmethod
    def _key(tokens: np.ndarray) -> str:
        t = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return hashlib.blake2b(t.tobytes() + t.size.to_bytes(8, "little"),
                               digest_size=16).hexdigest()

    def __len__(self) -> int:
        return len(self._entries)

    def contains(self, tokens: np.ndarray) -> bool:
        """Digest presence only (no LRU touch, no counters): the engine
        skips copying a boundary state that is already cached."""
        return self._key(tokens) in self._entries

    def lookup(self, prompt: np.ndarray,
               limit: Optional[int] = None) -> Tuple[int, Optional[PrefixEntry]]:
        """Longest cached boundary prefix of `prompt`, searched from
        floor(min(limit, len-1) / chunk) * chunk down in chunk strides.
        Returns (p, entry), (0, None) on a miss.  A hit refreshes the LRU
        order; ids that differ at a matching digest are a collision."""
        if self.chunk is None:
            raise RuntimeError("bind(chunk) before lookup")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cap = prompt.size - 1 if limit is None else min(limit, prompt.size - 1)
        p = (cap // self.chunk) * self.chunk
        if p < self.chunk:
            return 0, None  # no cacheable boundary in this prompt
        while p >= self.chunk:
            key = self._key(prompt[:p])
            e = self._entries.get(key)
            if e is not None:
                if e.tokens.size != p or not np.array_equal(e.tokens,
                                                            prompt[:p]):
                    self.collisions += 1
                else:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    self.hit_tokens += p
                    return p, e
            p -= self.chunk
        self.misses += 1
        return 0, None

    def insert(self, tokens: np.ndarray, state: Any,
               draft_state: Optional[Any] = None) -> bool:
        """Store the carried state for prefix `tokens`.  A present key only
        refreshes its LRU place (a boundary's state is deterministic).
        Entries are evicted oldest first until the budget holds; an entry
        larger than the whole budget is refused."""
        tokens = np.asarray(tokens, np.int32).reshape(-1).copy()
        key = self._key(tokens)
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        nbytes = tree_bytes(state) + tree_bytes(draft_state)
        if nbytes > self.budget_bytes:
            return False
        while self.bytes + nbytes > self.budget_bytes and self._entries:
            _, old = self._entries.popitem(last=False)
            self.bytes -= old.nbytes
            self.evictions += 1
        self._entries[key] = PrefixEntry(tokens=tokens, state=state,
                                         draft_state=draft_state,
                                         nbytes=nbytes)
        self.bytes += nbytes
        self.insertions += 1
        return True

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "bytes": self.bytes,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "hit_tokens": self.hit_tokens,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "collisions": self.collisions,
        }
