"""Segment-level radix cache for the fleet simulator.

The discrete-event simulator never materializes token ids — a workflow
call's prompt is modeled as a sequence of *segments*: ``(segment_id,
token_length)`` pairs, where a segment id is a deterministic synthetic
identifier for an atomic token run (a system prompt, a prior call's
prompt delta, a prior call's generated output).  Two calls share a
prefix exactly when their segment sequences share a leading run of ids;
truncated reuse (a child re-sending only part of a parent segment, as in
beam-search verify calls) shares a *partial* final segment.

:class:`RadixCache` is the per-replica model of which KV bytes are live
in HBM:

* ``match(seq)`` — longest cached prefix, in tokens (token-accurate,
  including partial final segments);
* ``insert(seq)`` — register a sequence's KV as resident, creating one
  node per new segment span and splitting nodes on partial overlap;
* ``pin``/``unpin`` — running requests pin their path so eviction can
  never drop KV that is still referenced;
* capacity is a **token budget** (the caller converts the replica's HBM
  byte budget via the cost model's KV-bytes-per-token); LRU leaves are
  evicted until under budget, so ``match`` stops reporting hits for KV
  a real engine would have discarded.

Everything is host-side, deterministic (LRU clock + insertion-ordered
tie-breaks), and O(path length) per operation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from heapq import heapify, heappop, heappush
from itertools import count
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

Segment = Tuple[Hashable, int]  # (segment id, token length)


@dataclass
class _Node:
    seg: Hashable = None
    start: int = 0          # offset of this span within its segment
    length: int = 0         # tokens covered by this node
    parent: Optional["_Node"] = None
    children: Dict[Tuple[Hashable, int], "_Node"] = field(default_factory=dict)
    pins: int = 0
    stamp: int = 0

    def key(self) -> Tuple[Hashable, int]:
        return (self.seg, self.start)


class RadixCache:
    """``head_listeners`` get called as ``cb(op, seg)`` whenever the set
    of resident *head segments* (root children — every cached sequence
    starts at one) changes: ``("add", seg)`` when a head becomes
    resident, ``("del", seg)`` when eviction drops one, and
    ``("reset", None)`` on :meth:`clear`.  Splitting a head node keeps
    its ``(seg, 0)`` key, so no event fires.  Routers index replicas by
    head segment with these hooks (see ``simulator._ReplicaIndex``)."""

    def __init__(self, capacity_tokens: int = 1 << 30):
        self.root = _Node()
        self.capacity_tokens = int(capacity_tokens)
        self.tokens = 0  # total cached tokens across all nodes
        self.clock = 0
        self.head_listeners: List = []
        # lazy LRU heap over evictable leaves: (stamp, tie, node)
        # entries; an entry is fresh iff the node is still an attached
        # childless node carrying that stamp (every leaf-stamp change
        # and every become-a-leaf event pushes a fresh entry, so each
        # current leaf always has one)
        self._lru: List[Tuple[int, int, _Node]] = []
        self._lru_seq = count()
        self.n_nodes = 0
        # measurement/parity knob: evict via the seed's full-tree DFS
        # walk instead of the LRU heap (bench_scale's legacy baseline)
        self.legacy_evict = False

    def _offer(self, node: _Node) -> None:
        if node is not self.root and not node.children:
            heappush(self._lru, (node.stamp, next(self._lru_seq), node))

    def _lru_compact(self) -> None:
        """Drop stale heap entries (rebuild from the live leaves)."""
        fresh = {}
        for stamp, seq, node in self._lru:
            if (node.parent is not None and not node.children
                    and node.stamp == stamp
                    and node.parent.children.get(node.key()) is node):
                cur = fresh.get(id(node))
                if cur is None or (stamp, seq) < cur[:2]:
                    fresh[id(node)] = (stamp, seq, node)
        self._lru = list(fresh.values())
        heapify(self._lru)

    def _head_event(self, op: str, seg) -> None:
        for cb in self.head_listeners:
            cb(op, seg)

    # -- queries -----------------------------------------------------------
    def match(self, seq: Sequence[Segment], touch: bool = True) -> int:
        """Longest cached prefix of ``seq`` in tokens."""
        if touch:
            self.clock += 1
        node, matched, _, _ = self._descend(seq, touch=touch)
        if touch:
            self._offer(node)  # its old heap entry is stale now
        return matched

    # -- updates -----------------------------------------------------------
    def insert(self, seq: Sequence[Segment]) -> int:
        """Make ``seq``'s KV resident; returns the previously-cached
        prefix length in tokens.  Evicts LRU leaves (never the inserted
        path, never pinned paths) until back under the token budget."""
        self.clock += 1
        node, matched, i, off = self._descend(seq, touch=True, split=True)
        for j in range(i, len(seq)):
            seg, slen = seq[j]
            o = off if j == i else 0
            if o >= slen:
                continue
            child = _Node(seg=seg, start=o, length=slen - o, parent=node,
                          stamp=self.clock)
            node.children[child.key()] = child
            self.tokens += child.length
            self.n_nodes += 1
            if node is self.root and self.head_listeners:
                self._head_event("add", seg)
            node = child
        self._offer(node)
        if len(self._lru) > max(1024, 4 * self.n_nodes):
            self._lru_compact()
        path = set()
        walk = node
        while walk is not None:
            path.add(id(walk))
            walk = walk.parent
        while self.tokens > self.capacity_tokens:
            if not self._evict_one(path):
                break
        return matched

    def pin(self, seq: Sequence[Segment]) -> None:
        for n in self._path_nodes(seq):
            n.pins += 1

    def unpin(self, seq: Sequence[Segment]) -> None:
        for n in self._path_nodes(seq):
            if n.pins > 0:
                n.pins -= 1

    def clear(self) -> None:
        self.root = _Node()
        self.tokens = 0
        self.n_nodes = 0
        self._lru = []
        if self.head_listeners:
            self._head_event("reset", None)

    # -- internals ---------------------------------------------------------
    def _descend(self, seq: Sequence[Segment], touch: bool,
                 split: bool = False):
        """Walk as deep as the cache matches ``seq``.

        Returns (deepest node, matched tokens, next segment index,
        offset within that segment).  With ``split=True`` a partial
        match of a node splits it so the returned node ends exactly at
        the match boundary (insert needs an exact attachment point).
        """
        node, matched = self.root, 0
        i, off = 0, 0
        while i < len(seq):
            seg, slen = seq[i]
            if off >= slen:
                i, off = i + 1, 0
                continue
            child = node.children.get((seg, off))
            if child is None:
                break
            take = min(child.length, slen - off)
            if take < child.length:
                # sequence boundary falls inside this node
                if split:
                    child = self._split(child, take)
                matched += take
                off += take
                if touch:
                    child.stamp = self.clock
                node = child
                break
            matched += take
            off += take
            if touch:
                child.stamp = self.clock
            node = child
            if off >= slen:
                i, off = i + 1, 0
        return node, matched, i, off

    def _path_nodes(self, seq: Sequence[Segment]) -> List[_Node]:
        node, _, _, _ = self._descend(seq, touch=False)
        out = []
        while node is not self.root and node is not None:
            out.append(node)
            node = node.parent
        return out

    def _split(self, child: _Node, take: int) -> _Node:
        """Split ``child`` at ``take`` tokens; returns the upper half."""
        parent = child.parent
        upper = _Node(seg=child.seg, start=child.start, length=take,
                      parent=parent, pins=child.pins, stamp=child.stamp)
        del parent.children[child.key()]
        parent.children[upper.key()] = upper
        child.start += take
        child.length -= take
        child.parent = upper
        upper.children[child.key()] = child
        self.n_nodes += 1
        return upper

    def _evict_one(self, protect) -> bool:
        """Drop the least-recently-touched unpinned leaf not on the
        protected path.  Returns False when nothing is evictable.

        Served from the lazy LRU heap in O(log leaves) amortized (the
        seed walked the whole tree per eviction); stale entries are
        discarded on pop, pinned/protected candidates are deferred and
        re-pushed so they stay eligible for later evictions.
        """
        if self.legacy_evict:
            return self._evict_one_walk(protect)
        heap, best, deferred = self._lru, None, []
        while heap:
            stamp, seq, node = heappop(heap)
            parent = node.parent
            if (parent is None or node.children or node.stamp != stamp
                    or parent.children.get(node.key()) is not node):
                continue  # stale: detached, re-touched, or grew children
            if node.pins > 0 or id(node) in protect:
                deferred.append((stamp, seq, node))
                continue
            best = node
            break
        for entry in deferred:
            heappush(heap, entry)
        if best is None:
            return False
        parent = best.parent
        del parent.children[best.key()]
        self.tokens -= best.length
        self.n_nodes -= 1
        if parent is self.root and self.head_listeners:
            self._head_event("del", best.seg)
        self._offer(parent)  # parent may have just become a leaf
        return True

    def _evict_one_walk(self, protect) -> bool:
        """The seed's eviction: DFS the whole tree for the LRU leaf."""
        best = None
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif (n is not self.root and n.pins == 0
                    and id(n) not in protect):
                if best is None or n.stamp < best.stamp:
                    best = n
        if best is None:
            return False
        del best.parent.children[best.key()]
        self.tokens -= best.length
        self.n_nodes -= 1
        if best.parent is self.root and self.head_listeners:
            self._head_event("del", best.seg)
        return True
