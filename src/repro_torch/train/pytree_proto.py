"""Read and write the tree structure of a checkpoint record as the JAX package
writes it, without JAX.

The reference's ``CheckpointManager.save`` stores its state's structure as
``jax.tree_util.tree_structure(state).serialize_using_proto().hex()``
(``src/repro/train/checkpoint.py:148-149``). That is plain protobuf wire
format:

* the tree: field 1 repeats one node message per node, in post-order (a
  node's children come before it, left to right); field 2 repeats the
  interned strings, the dict keys;
* a node: field 1 its arity, field 2 its kind, and for a dict field 3, a
  message whose field 1 holds the indices of its keys in the string table
  (packed). A field at its default (arity 0) is left out.

The kinds are 1 leaf, 2 list, 3 None, 4 tuple and 5 dict; JAX refuses to
serialize any other node. A dict's children come in the order of its keys as
stored, which is JAX's flatten order (sorted), so the leaves of a record
follow the depth-first order of this tree. Anything else (an unknown kind or
field, a truncated message, children that do not add up to one root) raises
a ``ValueError`` that names the cause: nothing is guessed.

``serialize`` is the inverse of ``parse``, and ``structure`` builds the tree
of a nested dict, list, tuple or None tree as JAX flattens it (dict keys
sorted, anything else a leaf), so ``serialize(structure(state))`` equals
``jax.tree_util.tree_structure(state).serialize_using_proto()`` byte for
byte: a node's arity and dict keys are left out where empty, the keys are
one packed field, and each string is interned once, where the post-order
walk first emits it.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Sequence, Tuple, Union

LEAF, LIST, NONE, TUPLE, DICT = 1, 2, 3, 4, 5
_KINDS = {LEAF: "leaf", LIST: "list", NONE: "None", TUPLE: "tuple", DICT: "dict"}
_VARINT, _LEN = 0, 2

Key = Union[str, int]


class Node:
    """One node of the tree: its kind, its children, and a dict's keys."""

    __slots__ = ("kind", "children", "keys")

    def __init__(self, kind: int, children: List["Node"], keys: Tuple[str, ...] = ()):
        self.kind, self.children, self.keys = kind, children, keys


def _varint(buf: bytes, i: int, what: str) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if i >= len(buf):
            raise ValueError(f"truncated PyTreeDef proto: a varint of {what} runs past "
                             f"the end ({len(buf)} bytes)")
        byte = buf[i]
        i += 1
        out |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return out, i
        shift += 7
        if shift >= 64:
            raise ValueError(f"malformed PyTreeDef proto: a varint of {what} is longer "
                             "than 10 bytes")


def _fields(buf: bytes, what: str) -> Iterator[Tuple[int, int, Any]]:
    """(field, wire type, value) of each field of one message: an int for a
    varint, the bytes for a length-delimited field; other wire types raise."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i, what)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, i = _varint(buf, i, what)
        elif wire == _LEN:
            n, i = _varint(buf, i, what)
            if i + n > len(buf):
                raise ValueError(f"truncated PyTreeDef proto: field {field} of {what} "
                                 f"holds {n} bytes, {len(buf) - i} are left")
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"malformed PyTreeDef proto: wire type {wire} in field "
                             f"{field} of {what}")
        yield field, wire, value


def _expect(field: int, wire: int, want: int, what: str) -> None:
    if wire != want:
        raise ValueError(f"malformed PyTreeDef proto: field {field} of {what} has "
                         f"wire type {wire}, want {want}")


def _key_ids(buf: bytes, what: str) -> List[int]:
    ids: List[int] = []
    for field, wire, value in _fields(buf, what):
        if field != 1:
            raise ValueError(f"malformed PyTreeDef proto: unknown field {field} in {what}")
        if wire == _VARINT:
            ids.append(value)
        else:
            _expect(field, wire, _LEN, what)
            i = 0
            while i < len(value):
                n, i = _varint(value, i, what)
                ids.append(n)
    return ids


def parse(data: bytes) -> Node:
    """The root of the tree a serialized PyTreeDef proto describes."""
    specs: List[Tuple[int, int, List[int]]] = []
    strings: List[str] = []
    for field, wire, value in _fields(data, "the tree"):
        if field == 1:
            _expect(field, wire, _LEN, "the tree")
            what = f"node {len(specs)}"
            arity, kind, ids = 0, 0, []
            for f, w, v in _fields(value, what):
                if f in (1, 2):
                    _expect(f, w, _VARINT, what)
                    arity, kind = (v, kind) if f == 1 else (arity, v)
                elif f == 3:
                    _expect(f, w, _LEN, what)
                    ids = _key_ids(v, f"the dict keys of {what}")
                else:
                    raise ValueError(f"malformed PyTreeDef proto: unknown field {f} in {what}")
            specs.append((arity, kind, ids))
        elif field == 2:
            _expect(field, wire, _LEN, "the tree")
            try:
                strings.append(value.decode("utf-8"))
            except UnicodeDecodeError as e:
                raise ValueError(f"malformed PyTreeDef proto: string {len(strings)} is "
                                 f"not UTF-8 ({e})") from None
        else:
            raise ValueError(f"malformed PyTreeDef proto: unknown field {field} in the tree")
    stack: List[Node] = []
    for n, (arity, kind, ids) in enumerate(specs):
        if kind not in _KINDS:
            raise ValueError(f"PyTreeDef proto node {n} has kind {kind}, which this reader "
                             f"does not know (it reads {sorted(_KINDS)}: "
                             f"{', '.join(_KINDS.values())})")
        if kind in (LEAF, NONE) and arity:
            raise ValueError(f"PyTreeDef proto node {n}: a {_KINDS[kind]} of arity {arity}")
        if kind != DICT and ids:
            raise ValueError(f"PyTreeDef proto node {n}: a {_KINDS[kind]} with dict keys")
        if kind == DICT and len(ids) != arity:
            raise ValueError(f"PyTreeDef proto node {n}: a dict of arity {arity} with "
                             f"{len(ids)} keys")
        if arity > len(stack):
            raise ValueError(f"PyTreeDef proto node {n} takes {arity} children, "
                             f"{len(stack)} come before it")
        bad = [i for i in ids if i >= len(strings)]
        if bad:
            raise ValueError(f"PyTreeDef proto node {n}: key index {bad[0]} outside the "
                             f"{len(strings)} interned strings")
        children = stack[len(stack) - arity:] if arity else []
        del stack[len(stack) - arity:]
        stack.append(Node(kind, children, tuple(strings[i] for i in ids)))
    if len(stack) != 1:
        raise ValueError(f"PyTreeDef proto describes {len(stack)} roots, want 1")
    return stack[0]


def _walk(node: Node, path: Tuple[Key, ...]) -> Iterator[Tuple[Key, ...]]:
    if node.kind == LEAF:
        yield path
        return
    keys: Sequence[Key] = node.keys if node.kind == DICT else range(len(node.children))
    for key, child in zip(keys, node.children):
        yield from _walk(child, path + (key,))


def key_paths(root: Node) -> List[Tuple[Key, ...]]:
    """Each leaf's path from the root (dict keys and list or tuple indices),
    in the order of the record's leaves."""
    return list(_walk(root, ()))


def unflatten(root: Node, leaves: Sequence[Any]) -> Any:
    """The nested dicts, lists, tuples and Nones of ``root`` holding
    ``leaves`` in order; their number must be the tree's."""
    n = len(key_paths(root))
    if n != len(leaves):
        raise ValueError(f"the PyTreeDef proto holds {n} leaves, the record {len(leaves)}")
    it = iter(leaves)

    def build(node: Node) -> Any:
        if node.kind == LEAF:
            return next(it)
        if node.kind == NONE:
            return None
        kids = [build(child) for child in node.children]
        if node.kind == DICT:
            return dict(zip(node.keys, kids))
        return kids if node.kind == LIST else tuple(kids)

    return build(root)


def structure(tree: Any) -> Node:
    """The tree of ``tree`` as JAX flattens it: a dict's children in the
    order of its sorted keys (strings), a list's or tuple's in order, None a
    node of no children, anything else a leaf."""
    if tree is None:
        return Node(NONE, [])
    if isinstance(tree, dict):
        keys = list(tree)
        bad = [k for k in keys if not isinstance(k, str)]
        if bad:
            raise TypeError(f"a PyTreeDef proto names dict keys by strings; got {bad[0]!r}")
        keys.sort()
        return Node(DICT, [structure(tree[k]) for k in keys], tuple(keys))
    if isinstance(tree, (list, tuple)):
        return Node(LIST if isinstance(tree, list) else TUPLE, [structure(t) for t in tree])
    return Node(LEAF, [])


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the order of ``structure(tree)``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return


def _put_field(out: bytearray, field: int, payload: bytes) -> None:
    """A length-delimited field."""
    _put_varint(out, field << 3 | _LEN)
    _put_varint(out, len(payload))
    out += payload


def serialize(root: Node) -> bytes:
    """The PyTreeDef proto of ``root``: the inverse of ``parse``."""
    strings: dict = {}
    nodes = bytearray()

    def emit(node: Node) -> None:
        for child in node.children:
            emit(child)
        msg = bytearray()
        if node.children:
            _put_varint(msg, 1 << 3 | _VARINT)
            _put_varint(msg, len(node.children))
        _put_varint(msg, 2 << 3 | _VARINT)
        _put_varint(msg, node.kind)
        if node.keys:
            ids = bytearray()
            for key in node.keys:
                _put_varint(ids, strings.setdefault(key, len(strings)))
            packed = bytearray()
            _put_field(packed, 1, bytes(ids))
            _put_field(msg, 3, bytes(packed))
        _put_field(nodes, 1, bytes(msg))

    emit(root)
    for key in strings:
        _put_field(nodes, 2, key.encode("utf-8"))
    return bytes(nodes)
