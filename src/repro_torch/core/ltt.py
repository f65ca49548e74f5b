"""Lazy Tail Tree (LTT, §5.5.2): tails of the inheritance tree under lazy range updates.

Logically the LTT is the inheritance tree with each log's current *tail* (and a
*blocked* counter used by promote semantics, §5.6) at its node. Physically it is
the Euler tour of that tree stored in a balanced BST (here: a treap with parent
pointers), so that

* an append of ``k`` records to log ``P`` becomes a **range add** of ``k`` over
  the contiguous Euler-tour range of ``P``'s subtree  — O(log n);
* reading a log's tail is a **point query**                     — O(log n);
* creating a cFork inserts an (enter, exit) marker pair just before the
  parent's exit marker                                          — O(log n);
* squash excises a subtree range; promote excises just the promoted child's
  two markers, which re-parents its children in O(log n).

The *blocked* value is an integer, range-added like tails: each active
promotable cFork of ``X`` contributes +1 over ``subtree(X)`` and -1 over the
promotable child's subtree, so "is this log blocked?" composes under any number
of concurrent promotable forks (a beyond-paper refinement of the paper's
boolean block/unblock; see DESIGN.md §4.5).

``EagerTailMap`` is the same interface with eager per-descendant updates: it is
both the Bolt-ET ablation variant (§6.4) and the oracle for property tests.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Tuple


class _Node:
    __slots__ = ("prio", "left", "right", "parent", "size",
                 "tail", "blocked", "lz_tail", "lz_blk", "log_id", "is_enter")

    def __init__(self, prio: float, log_id: int, is_enter: bool,
                 tail: int = 0, blocked: int = 0) -> None:
        self.prio = prio
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None
        self.parent: Optional[_Node] = None
        self.size = 1
        self.tail = tail        # value stored only meaningfully on enter markers
        self.blocked = blocked
        self.lz_tail = 0        # pending add for BOTH children's subtrees
        self.lz_blk = 0
        self.log_id = log_id
        self.is_enter = is_enter


def _size(x: Optional[_Node]) -> int:
    return x.size if x is not None else 0


def _push(x: _Node) -> None:
    if x.lz_tail or x.lz_blk:
        for c in (x.left, x.right):
            if c is not None:
                c.tail += x.lz_tail
                c.blocked += x.lz_blk
                c.lz_tail += x.lz_tail
                c.lz_blk += x.lz_blk
        x.lz_tail = 0
        x.lz_blk = 0


def _upd(x: _Node) -> None:
    x.size = 1 + _size(x.left) + _size(x.right)
    if x.left is not None:
        x.left.parent = x
    if x.right is not None:
        x.right.parent = x


def _merge(a: Optional[_Node], b: Optional[_Node]) -> Optional[_Node]:
    if a is None:
        return b
    if b is None:
        return a
    if a.prio > b.prio:
        _push(a)
        a.right = _merge(a.right, b)
        _upd(a)
        return a
    _push(b)
    b.left = _merge(a, b.left)
    _upd(b)
    return b


def _split(t: Optional[_Node], k: int) -> Tuple[Optional[_Node], Optional[_Node]]:
    """First k nodes in `a`, rest in `b`."""
    if t is None:
        return None, None
    _push(t)
    if _size(t.left) >= k:
        a, rest = _split(t.left, k)
        t.left = rest
        _upd(t)
        if a is not None:
            a.parent = None
        return a, t
    keep, b = _split(t.right, k - _size(t.left) - 1)
    t.right = keep
    _upd(t)
    if b is not None:
        b.parent = None
    return t, b


class LazyTailTree:
    """Forest of Euler-tour treaps keyed by log id."""

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)
        self._enter: Dict[int, _Node] = {}
        self._exit: Dict[int, _Node] = {}

    # -- internals ---------------------------------------------------------
    def _mk(self, log_id: int, is_enter: bool, tail: int, blocked: int) -> _Node:
        return _Node(self._rng.random(), log_id, is_enter, tail, blocked)

    @staticmethod
    def _root(x: _Node) -> _Node:
        while x.parent is not None:
            x = x.parent
        return x

    @staticmethod
    def _index(x: _Node) -> int:
        """0-based position of x in its tour (lazy values do not affect order)."""
        idx = _size(x.left)
        while x.parent is not None:
            if x is x.parent.right:
                idx += _size(x.parent.left) + 1
            x = x.parent
        return idx

    @staticmethod
    def _kth(root: _Node, k: int) -> _Node:
        """Node at tour index k (order-statistic walk; lazy values do not
        affect structure, so no push is needed)."""
        x = root
        while True:
            ls = _size(x.left)
            if k < ls:
                x = x.left
            elif k == ls:
                return x
            else:
                k -= ls + 1
                x = x.right

    @staticmethod
    def _value(x: _Node) -> Tuple[int, int]:
        tail, blk = x.tail, x.blocked
        p = x.parent
        while p is not None:
            tail += p.lz_tail
            blk += p.lz_blk
            p = p.parent
        return tail, blk

    def _range(self, root: _Node, i: int, j: int) -> Tuple[Optional[_Node], _Node, Optional[_Node]]:
        """Split root's tour into [0,i), [i,j], (j,end). Middle is non-empty."""
        a, bc = _split(root, i)
        b, c = _split(bc, j - i + 1)
        assert b is not None
        return a, b, c

    def _rejoin(self, a: Optional[_Node], b: Optional[_Node], c: Optional[_Node]) -> None:
        r = _merge(_merge(a, b), c)
        if r is not None:
            r.parent = None

    # -- public API --------------------------------------------------------
    def contains(self, log_id: int) -> bool:
        return log_id in self._enter

    def add_root(self, log_id: int, tail0: int = 0, blocked0: int = 0) -> None:
        assert log_id not in self._enter
        e = self._mk(log_id, True, tail0, blocked0)
        x = self._mk(log_id, False, 0, 0)
        self._enter[log_id] = e
        self._exit[log_id] = x
        r = _merge(e, x)
        assert r is not None
        r.parent = None

    def add_child(self, parent_id: int, child_id: int, tail0: int, blocked0: int) -> None:
        """Insert child's (enter, exit) just before parent's exit marker."""
        assert child_id not in self._enter
        pexit = self._exit[parent_id]
        root = self._root(pexit)
        k = self._index(pexit)
        a, b = _split(root, k)
        e = self._mk(child_id, True, tail0, blocked0)
        x = self._mk(child_id, False, 0, 0)
        self._enter[child_id] = e
        self._exit[child_id] = x
        self._rejoin(a, _merge(e, x), b)

    def get(self, log_id: int) -> Tuple[int, int]:
        """(tail, blocked) of log_id."""
        return self._value(self._enter[log_id])

    def range_add(self, log_id: int, d_tail: int = 0, d_blocked: int = 0) -> None:
        """Add to every log in subtree(log_id), inclusive."""
        if d_tail == 0 and d_blocked == 0:
            return
        e = self._enter[log_id]
        root = self._root(e)
        i = self._index(e)
        j = self._index(self._exit[log_id])
        a, b, c = self._range(root, i, j)
        b.tail += d_tail
        b.blocked += d_blocked
        b.lz_tail += d_tail
        b.lz_blk += d_blocked
        b.parent = None
        self._rejoin(a, b, c)

    def remove_subtree(self, log_id: int) -> List[int]:
        """Excise subtree(log_id); returns removed log ids (incl. log_id)."""
        e = self._enter[log_id]
        root = self._root(e)
        i = self._index(e)
        j = self._index(self._exit[log_id])
        a, b, c = self._range(root, i, j)
        self._rejoin(a, None, c)
        removed = []
        stack = [b]
        while stack:
            n = stack.pop()
            if n is None:
                continue
            if n.is_enter:
                removed.append(n.log_id)
                del self._enter[n.log_id]
                del self._exit[n.log_id]
            stack.append(n.left)
            stack.append(n.right)
        return removed

    def remove_node_keep_children(self, log_id: int) -> None:
        """Excise only log_id's own two markers; its children re-parent to its
        parent in the tour (used by promote, where the promoted child's
        children become the parent's children)."""
        for marker in ("enter", "exit"):
            node = (self._enter if marker == "enter" else self._exit)[log_id]
            root = self._root(node)
            i = self._index(node)
            a, b, c = self._range(root, i, i)
            assert b is node and b.left is None and b.right is None
            self._rejoin(a, None, c)
        del self._enter[log_id]
        del self._exit[log_id]

    def direct_children(self, log_id: int) -> List[int]:
        """Immediate children of log_id in tour order, O(children * log n):
        hop from each child's enter marker to just past its exit marker
        instead of touring the whole subtree (promote re-parents only the
        promoted child's direct children, DESIGN.md §11)."""
        e = self._enter[log_id]
        root = self._root(e)
        i = self._index(e)
        j = self._index(self._exit[log_id])
        out: List[int] = []
        k = i + 1
        while k < j:
            node = self._kth(root, k)
            assert node.is_enter, "tour structure corrupt: expected enter marker"
            out.append(node.log_id)
            k = self._index(self._exit[node.log_id]) + 1
        return out

    def subtree_ids(self, log_id: int) -> List[int]:
        """Log ids in subtree(log_id) in tour order (O(subtree); test/debug use)."""
        e = self._enter[log_id]
        root = self._root(e)
        i = self._index(e)
        j = self._index(self._exit[log_id])
        out: List[int] = []

        def visit(n: Optional[_Node], lo: int, hi: int, base: int) -> None:
            if n is None:
                return
            left_n = _size(n.left)
            my = base + left_n
            if lo < my:
                visit(n.left, lo, min(hi, my), base)
            if lo <= my < hi and n.is_enter:
                out.append(n.log_id)
            if hi > my + 1:
                visit(n.right, max(lo, my + 1), hi, my + 1)

        visit(root, i, j + 1, 0)
        return out


class EagerTailMap:
    """Eager-per-descendant variant: Bolt-ET (§6.4) and property-test oracle.

    Same interface as LazyTailTree; every range op walks the subtree.
    """

    def __init__(self, seed: int = 0) -> None:
        self.tail: Dict[int, int] = {}
        self.blocked: Dict[int, int] = {}
        self.children: Dict[int, List[int]] = {}
        self.parent: Dict[int, Optional[int]] = {}

    def contains(self, log_id: int) -> bool:
        return log_id in self.tail

    def add_root(self, log_id: int, tail0: int = 0, blocked0: int = 0) -> None:
        self.tail[log_id] = tail0
        self.blocked[log_id] = blocked0
        self.children[log_id] = []
        self.parent[log_id] = None

    def add_child(self, parent_id: int, child_id: int, tail0: int, blocked0: int) -> None:
        self.tail[child_id] = tail0
        self.blocked[child_id] = blocked0
        self.children[child_id] = []
        self.parent[child_id] = parent_id
        self.children[parent_id].append(child_id)

    def _walk(self, log_id: int) -> Iterator[int]:
        stack = [log_id]
        while stack:
            x = stack.pop()
            yield x
            stack.extend(self.children[x])

    def get(self, log_id: int) -> Tuple[int, int]:
        return self.tail[log_id], self.blocked[log_id]

    def range_add(self, log_id: int, d_tail: int = 0, d_blocked: int = 0) -> None:
        for x in self._walk(log_id):
            self.tail[x] += d_tail
            self.blocked[x] += d_blocked

    def remove_subtree(self, log_id: int) -> List[int]:
        removed = list(self._walk(log_id))
        p = self.parent[log_id]
        if p is not None:
            self.children[p].remove(log_id)
        for x in removed:
            del self.tail[x], self.blocked[x], self.children[x], self.parent[x]
        return removed

    def direct_children(self, log_id: int) -> List[int]:
        return list(self.children[log_id])

    def remove_node_keep_children(self, log_id: int) -> None:
        p = self.parent[log_id]
        kids = self.children[log_id]
        for k in kids:
            self.parent[k] = p
        if p is not None:
            idx = self.children[p].index(log_id)
            self.children[p][idx:idx + 1] = kids
        del self.tail[log_id], self.blocked[log_id], self.children[log_id], self.parent[log_id]

    def subtree_ids(self, log_id: int) -> List[int]:
        # pre-order; tour order of the treap version is also pre-order
        out = []
        def rec(x: int) -> None:
            out.append(x)
            for c in self.children[x]:
                rec(c)
        rec(log_id)
        return out
