"""Host-side radix-style prefix cache (token-id trie), after
``repro.serving.prefix_cache``.

Maps token prefixes to (slot, length) of a sequence whose KV covers that
prefix; the engine copies the prefix KV instead of recomputing prefill.
Eviction is LRU over leaf chains and runs in a loop until the trie is
back under ``max_entries`` (one ``insert`` may add one node per token).
``invalidate_slot`` prunes dead slotless chains so the trie never
accumulates unreachable nodes.

Differences from the reference:

* ``insert`` marks every node of the sequence's path with its slot, not
  only the last one: a slot holding a sequence's KV holds the KV of every
  prefix of it.  So requests that share a system prompt but differ after
  it reuse the prompt's KV; the reference finds a prefix only where a
  whole cached sequence starts the new prompt.  A node shared by several
  sequences names the slot inserted last; invalidating that slot unmarks
  it, which can lose a hit but never returns a stale slot.
* Every childless node carries a slot, so the only nodes that can die are
  those a slot's invalidation unmarks.  Each node knows its parent and
  each slot the nodes it marks: ``invalidate_slot`` touches only those
  nodes and their dead ancestors, not the whole trie.
* An overflowing ``insert`` lists the leaves once and evicts from a heap,
  not one whole-trie walk per evicted leaf.  It picks the same leaves as
  the reference: the least stamp, ties to the first in depth-first order.
* The trie walks are iterative: a prompt thousands of tokens long is a
  chain that deep, past Python's recursion limit.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Set, Tuple


@dataclass(eq=False)  # hashed by identity, for the per-slot sets
class _Node:
    children: Dict[int, "_Node"] = field(default_factory=dict)
    slot: Optional[int] = None  # slot whose cache covers the path to here
    depth: int = 0
    stamp: int = 0
    parent: Optional["_Node"] = None  # None for the root and once detached
    token: int = -1  # the key of this node in its parent's children


class PrefixCache:
    def __init__(self, max_entries: int = 1024):
        self.root = _Node()
        self.max_entries = max_entries
        self.entries = 0
        self.clock = 0
        self._marked: Dict[int, Set[_Node]] = {}  # slot -> nodes naming it

    def insert(self, tokens: Sequence[int], slot: int) -> None:
        self.clock += 1
        node = self.root
        fresh = set()  # nodes created by THIS insert (never evicted below)
        for t in tokens:
            child = node.children.get(t)
            if child is None:
                child = _Node(depth=node.depth + 1, parent=node, token=t)
                node.children[t] = child
                self.entries += 1
                fresh.add(child)
            node = child
            node.stamp = self.clock
            self._mark(node, slot)
        if self.entries > self.max_entries:
            self._evict(fresh)

    def longest_prefix(self, tokens: Sequence[int]) -> Tuple[int, Optional[int]]:
        """Returns (matched_length, slot) of the deepest cached ancestor."""
        self.clock += 1
        node = self.root
        best = (0, None)
        for t in tokens:
            nxt = node.children.get(t)
            if nxt is None:
                break
            node = nxt
            node.stamp = self.clock
            if node.slot is not None:
                best = (node.depth, node.slot)
        return best

    def invalidate_slot(self, slot: int) -> None:
        """Forget every entry backed by ``slot`` and prune the now-dead
        chains: a childless node with no slot serves no lookup and would
        otherwise live in the trie (and count against ``entries``)
        forever."""
        nodes = self._marked.pop(slot, ())
        for node in nodes:
            node.slot = None
        for node in nodes:
            while (node.parent is not None and not node.children
                   and node.slot is None):
                parent = node.parent
                self._detach(node)
                node = parent

    def _mark(self, node: _Node, slot: int) -> None:
        if node.slot is not None:
            self._marked[node.slot].discard(node)
        node.slot = slot
        self._marked.setdefault(slot, set()).add(node)

    def _detach(self, node: _Node) -> None:
        del node.parent.children[node.token]
        node.parent = None
        self.entries -= 1
        if node.slot is not None:
            self._marked[node.slot].discard(node)

    def _evict(self, protect: Set[_Node]) -> None:
        """Drop oldest leaves, each with its exclusive (childless once the
        leaf is gone, slotless) ancestor chain, until the trie is back
        under ``max_entries`` or only ``protect`` is left to evict."""
        order = {}  # node -> its index in depth-first pre-order
        heap = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            order[node] = len(order)
            if node.children:
                stack.extend(reversed(node.children.values()))
            elif node is not self.root and node not in protect:
                heap.append((node.stamp, order[node], node))
        heapq.heapify(heap)
        while self.entries > self.max_entries and heap:
            _, _, node = heapq.heappop(heap)
            # prune from the leaf up
            while not node.children and node not in protect:
                parent = node.parent
                self._detach(node)
                if parent.slot is not None or parent is self.root:
                    break
                node = parent
            if (parent is not self.root and not parent.children
                    and parent not in protect):
                heapq.heappush(heap, (parent.stamp, order[parent], parent))
