"""Prefix sharing for the serve engine: port of ``repro/serve/prefix.py``
(host-side Python; the reference's, verbatim but for this docstring) — a
radix index over token prefixes plus refcounted entry accounting for a
fixed-size device-resident prefix store.

The store itself is a second ``init_cache(entries, capacity)`` slot
cache owned by the engine (one row per remembered prefix, holding the
COMPLETE decode state at position ``len(prefix)`` — K/V rows or ring,
latents, SSM conv and h, pos). This file is pure host control plane:

  * :class:`RadixIndex` — a path-compressed radix tree mapping token
    tuples to entry ids, with longest-prefix-match lookup;
  * :class:`PrefixPool` — entry allocation on top of the index:
    refcounts (an entry matched by an admitted request is pinned until
    its on-device copy and suffix prefill complete), LRU eviction of
    unpinned entries, and hit/miss accounting.

Storing a full state row per prefix (rather than aliasing live slot
pages) is what makes reuse EXACT for every family: an SSM's recurrent
state exists only at the position it was snapshotted, and a windowed
K/V ring is overwritten by the donor's own decode — a copy at the chunk
boundary is immune to both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class _Node:
    """Radix-tree node. ``edge`` is the compressed token label from the
    parent; ``entry`` is the store entry id for the prefix ending here."""

    __slots__ = ("edge", "children", "entry", "parent")

    def __init__(self, edge: tuple = (), parent: Optional["_Node"] = None):
        self.edge = edge
        self.children: dict[int, _Node] = {}
        self.entry: Optional[int] = None
        self.parent = parent

    @property
    def depth(self) -> int:
        d, n = 0, self
        while n.parent is not None:
            d += len(n.edge)
            n = n.parent
        return d


def _common(a: tuple, b: tuple) -> int:
    m = min(len(a), len(b))
    i = 0
    while i < m and a[i] == b[i]:
        i += 1
    return i


class RadixIndex:
    """Path-compressed radix tree over token sequences.

    insert / longest / remove are O(len(tokens)); nodes with neither an
    entry nor branching are pruned/merged on removal so the tree stays
    proportional to what is stored.
    """

    def __init__(self):
        self.root = _Node()
        self._nodes: dict[int, _Node] = {}      # entry id -> node

    def __len__(self) -> int:
        return len(self._nodes)

    def insert(self, tokens, entry: int) -> None:
        """Map ``tokens`` (non-empty sequence) to ``entry``."""
        tokens = tuple(int(t) for t in tokens)
        if not tokens:
            raise ValueError("cannot index the empty prefix")
        if entry in self._nodes:
            raise ValueError(f"entry {entry} already indexed")
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                leaf = _Node(tokens[i:], node)
                node.children[tokens[i]] = leaf
                node = leaf
                i = len(tokens)
                break
            m = _common(child.edge, tokens[i:])
            if m == len(child.edge):            # full edge consumed
                node, i = child, i + m
                continue
            # split the edge at m: node -> mid -> child
            mid = _Node(child.edge[:m], node)
            node.children[tokens[i]] = mid
            child.edge = child.edge[m:]
            child.parent = mid
            mid.children[child.edge[0]] = child
            node, i = mid, i + m
        if node.entry is not None:
            raise ValueError(f"prefix already held by entry {node.entry}")
        node.entry = entry
        self._nodes[entry] = node

    def longest(self, tokens) -> Optional[tuple[int, int]]:
        """Longest stored prefix of ``tokens`` -> (entry, match_len)."""
        tokens = tuple(int(t) for t in tokens)
        node, i, best = self.root, 0, None
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            m = _common(child.edge, tokens[i:])
            if m < len(child.edge):             # fell off mid-edge
                break
            node, i = child, i + m
            if node.entry is not None:
                best = (node.entry, i)
        return best

    def get(self, tokens) -> Optional[int]:
        """Exact-match entry id (None if this precise prefix is absent)."""
        m = self.longest(tokens)
        if m is not None and m[1] == len(tuple(tokens)):
            return m[0]
        return None

    def remove(self, entry: int) -> None:
        node = self._nodes.pop(entry)
        node.entry = None
        # prune empty leaves upward, then merge single-child pass-throughs
        while (node.parent is not None and node.entry is None
               and not node.children):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent
        if (node.parent is not None and node.entry is None
                and len(node.children) == 1):
            (child,) = node.children.values()
            child.edge = node.edge + child.edge
            child.parent = node.parent
            node.parent.children[node.edge[0]] = child


# ---------------------------------------------------------------- pool

@dataclasses.dataclass
class _Meta:
    length: int                 # tokens covered by the stored state
    refs: int = 0               # admitted requests pinning this entry
    tick: int = 0               # LRU clock


class PrefixPool:
    """Refcounted LRU allocation of prefix-store entries over a
    :class:`RadixIndex`.

    ``acquire`` pins the matched entry (refcount) so eviction cannot
    recycle its device row while a request is queued or mid-suffix-
    prefill against it; ``release`` unpins. ``insert`` allocates a free
    entry, evicting the least-recently-used UNPINNED entry when full —
    returning None when every entry is pinned (the caller just skips
    the snapshot)."""

    def __init__(self, entries: int, *, min_tokens: int = 1):
        if entries < 1:
            raise ValueError("prefix pool needs >= 1 entry")
        self.entries = entries
        self.min_tokens = max(1, min_tokens)
        self.index = RadixIndex()
        self.meta: dict[int, _Meta] = {}
        self._free = list(range(entries - 1, -1, -1))
        self._tick = 0
        self.stats = {"hits": 0, "misses": 0, "hit_tokens": 0,
                      "inserts": 0, "evictions": 0}

    # ------------------------------------------------------------ match

    def acquire(self, tokens) -> Optional[tuple[int, int]]:
        """Longest-prefix match + pin. Returns (entry, match_len)."""
        m = self.index.longest(tokens)
        if m is None or m[1] < self.min_tokens:
            self.stats["misses"] += 1
            return None
        entry, k = m
        self.meta[entry].refs += 1
        self._touch(entry)
        self.stats["hits"] += 1
        self.stats["hit_tokens"] += k
        return entry, k

    def release(self, entry: int) -> None:
        meta = self.meta[entry]
        if meta.refs <= 0:
            raise ValueError(f"entry {entry} released below zero")
        meta.refs -= 1

    def pin(self, entry: int) -> None:
        """Pin an entry by id — the preemption path holds its snapshot
        this way so eviction cannot recycle the device row before the
        preempted request is re-admitted and replays from it."""
        self.meta[entry].refs += 1
        self._touch(entry)

    # ----------------------------------------------------------- insert

    def insert(self, tokens) -> Optional[int]:
        """Claim an entry for ``tokens``; None = skip (too short, dup,
        or the pool is fully pinned)."""
        tokens = tuple(int(t) for t in tokens)
        if len(tokens) < self.min_tokens or self.index.get(tokens) is not None:
            return None
        if not self._free and not self._evict_one():
            return None
        entry = self._free.pop()
        self.index.insert(tokens, entry)
        self.meta[entry] = _Meta(length=len(tokens))
        self._touch(entry)
        self.stats["inserts"] += 1
        return entry

    def _evict_one(self) -> bool:
        victims = [e for e, m in self.meta.items() if m.refs == 0]
        if not victims:
            return False
        victim = min(victims, key=lambda e: self.meta[e].tick)
        self.index.remove(victim)
        del self.meta[victim]
        self._free.append(victim)
        self.stats["evictions"] += 1
        return True

    def _touch(self, entry: int) -> None:
        self._tick += 1
        self.meta[entry].tick = self._tick

    # ------------------------------------------------------------ state

    def has(self, tokens) -> bool:
        return self.index.get(tokens) is not None

    @property
    def hit_rate(self) -> float:
        n = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / n if n else 0.0
