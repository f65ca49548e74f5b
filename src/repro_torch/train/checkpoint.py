"""Checkpoint-as-fork: training state as log lineage (DESIGN.md §17).

Port of ``src/repro/train/checkpoint.py`` onto the port's own copy of the
log. Every behaviour below is the reference's, and so is the record: the
two packages read and write one format. ``save`` writes the state
``{"params": ..., "opt": ...}`` as the reference does: its ``treedef`` the
hex of its PyTreeDef proto (``pytree_proto.serialize``, without JAX), its
leaves in JAX's flatten order as ``.npy`` bytes (bf16 through the uint16
view) with the reference's dtype names. A model (``params`` an
``nn.Module``) and its AdamW state are first mapped into the reference's
layout (``convert.params_to_jax``, ``opt_state_to_jax``: each pattern
entry's layers stacked in one leaf, made only when it is written, so the
host holds one stacked leaf at a time), which needs the model's config
(``save(cfg=...)``); any other nested tree of tensors is written as its own
tree, its dicts in sorted key order as JAX flattens them.

``restore`` reads what either package wrote: ``pytree_proto`` rebuilds the
tree, and a model's state (params holding ``embed``) is mapped back by
``convert``, which needs ``restore(cfg=...)``, since the stacked leaves do
not name the layer kinds. So a job moves between the packages both ways.
Records of the port's earlier writer, whose ``treedef`` is a JSON list of
leaf paths (``params/embed``, ``opt/m/blocks.0.attn.wq``), still restore as
the nested dicts they were.

Checkpoints are log-native, so every checkpoint byte flows through the same
GC/compaction/tiering machinery as stream data:

* ``{prefix}``        — the **catalog**: a root log of JSON manifest records
  (``save`` / ``prune`` ops). Appending the save record IS the atomic commit
  point; replaying the catalog yields the checkpoint index, so the catalog is
  also the audit trail.
* ``{prefix}/data``   — an empty root whose **cForks hold the bytes**: one
  non-promotable fork per checkpoint, leaf ``.npy`` bytes chunked into
  records. Pruning a checkpoint = ``squash`` its fork — the records die in
  metadata, §13 hands the segments to the reaper, §14 compaction squeezes
  survivors. No direct store deletes anywhere.
* **fork-per-experiment**: ``experiment(name)`` opens a *promotable* cFork of
  the catalog. Its saves are manifest records on the fork (visible to the
  experiment, withheld from the trunk per §4.1 — an open experiment holds the
  trunk catalog). ``merge()`` promotes the fork — squash-on-merge lands the
  experiment's manifests in the trunk atomically; ``abandon()`` squashes the
  fork and the experiment's data forks, and chain-GC reclaims every byte.
* **crash orphans**: a crash between the data-fork flush and the catalog
  append leaves a live, unreferenced data fork. ``recover()`` squashes every
  data fork no visible save record references — the §13 reaper path, covered
  by the oracle.

Restore returns the leaves as tensors on the device asked for, and the
data-pipeline cursor still rides ``extra``.

On a mesh, as the reference's header says of its own record, restore stays
mesh-shape agnostic: ``save(mesh=)`` gathers each leaf of a model split over
'model' and of its ZeRO-1 state whole, one at a time, and rank 0 writes the
record one process would write of the gathered model and state;
``restore(mesh=, shardings=)`` lays a model's record out on any mesh (rank 0
reads and broadcasts, each rank keeps its part), whichever mesh or package
wrote it.
"""

from __future__ import annotations

import io
import json
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..convert import (jax_tree, opt_state_from_jax, opt_state_to_jax, params_from_jax,
                       params_to_jax)
from ..core.api import AgileLog, BoltSystem
from ..core.errors import AgileLogError
from ..distributed import tp
from ..distributed.context import get_mesh
from ..distributed.sharding import box_index, distribute, from_chunk
from ..launch.mesh import describe
from ..models.config import ModelConfig
from ..models.layers import resolve_device
from ..models.lm import init_params
from ..streams.records import decode_record, encode_record
from . import pytree_proto
from .optimizer import AdamWConfig, opt_state_shardings


def _unflatten(paths: List[str], leaves: List[Any]) -> Dict:
    tree: Dict = {}
    for path, leaf in zip(paths, leaves):
        head, _, name = path.rpartition("/")
        node = tree
        for key in head.split("/") if head else []:
            node = node.setdefault(key, {})
        node[name] = leaf
    return tree


def _leaf_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array its record holds, and the reference's dtype name
    (bf16 through the uint16 view: numpy has no bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_bytes(leaf: Any) -> Tuple[bytes, str]:
    arr, dt = _leaf_array(leaf)
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue(), dt


def _leaf_chunks(leaf: Any, chunk_bytes: int) -> Tuple[List[bytes], str]:
    """``_leaf_bytes``' bytes cut into records of ``chunk_bytes``, made
    without a whole copy of them: the ``.npy`` header (``np.save``'s, format
    1.0), then the array's own buffer, sliced."""
    arr, dt = _leaf_array(leaf)
    if not arr.flags.c_contiguous or arr.dtype.hasobject:    # np.save's own layout
        raw, dt = _leaf_bytes(leaf)
        return [raw[o:o + chunk_bytes] for o in range(0, len(raw), chunk_bytes)] or [b""], dt
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, np.lib.format.header_data_from_array_1_0(arr))
    head = buf.getvalue()
    data = memoryview(arr.reshape(-1).view(np.uint8))
    total = len(head) + data.nbytes
    chunks = []
    for lo in range(0, total, chunk_bytes):
        hi = min(lo + chunk_bytes, total)
        a, b = max(lo - len(head), 0), max(hi - len(head), 0)      # the data's part
        chunks.append(head[lo:hi] + bytes(data[a:b]) if lo < len(head) else bytes(data[a:b]))
    return chunks or [b""], dt


def _leaf_restore(raw, dt: str, device) -> torch.Tensor:
    """The tensor of a leaf's ``.npy`` bytes (``raw``; a bytearray is read in
    place, anything else copied once)."""
    raw = raw if isinstance(raw, bytearray) else bytearray(raw)
    head = io.BytesIO(bytes(raw[:1 << 17]))     # a header is under 64 KiB and its prefix
    version = np.lib.format.read_magic(head)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(head)
    if fortran or dtype.hasobject:
        return _leaf_restore_slow(bytes(raw), dt, device)
    arr = np.frombuffer(raw, dtype=dtype, count=math.prod(shape), offset=head.tell())
    arr = arr.reshape(shape)
    if dt == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _leaf_restore_slow(raw: bytes, dt: str, device) -> torch.Tensor:
    arr = np.load(io.BytesIO(raw), allow_pickle=False)
    if dt == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _port_paths(rec: Dict) -> Optional[List[str]]:
    """The leaf names of a save record the port's earlier writer wrote;
    None where its treedef is not a JSON list of names."""
    try:
        paths = json.loads(rec["treedef"])
    except ValueError:
        return None
    if isinstance(paths, list) and all(isinstance(p, str) for p in paths):
        return paths
    return None


def _jax_tree(rec: Dict) -> pytree_proto.Node:
    """The tree of a save record in the reference's format (a PyTreeDef
    proto in hex), its leaf count checked against the record's."""
    try:
        data = bytes.fromhex(rec["treedef"])
    except (TypeError, ValueError):
        raise ValueError(f"the checkpoint at step {rec['step']} has a treedef that is "
                         "neither the port's leaf names nor a hex PyTreeDef proto") from None
    try:
        root = pytree_proto.parse(data)
    except ValueError as e:
        raise ValueError(f"the checkpoint at step {rec['step']}: {e}") from None
    n = len(pytree_proto.key_paths(root))
    if n != len(rec["spans"]):
        raise ValueError(f"the checkpoint at step {rec['step']}: its PyTreeDef proto "
                         f"holds {n} leaves, its record {len(rec['spans'])}")
    return root


def _holds_model(root: pytree_proto.Node) -> bool:
    """Whether a record's tree is a model's state in the reference's layout:
    ``{"params": {"embed": ..., ...}, ...}``, as ``init_params`` makes it."""
    top = dict(zip(root.keys, root.children)) if root.kind == pytree_proto.DICT else {}
    params = top.get("params")
    return (params is not None and params.kind == pytree_proto.DICT
            and "embed" in params.keys)


class _Slot:
    """A leaf of the record's tree as ``restore`` on a mesh expects it:
    which part of the state (``params``, ``m``, ``v``, ``master`` or
    ``step``), and the port name or the stacked layers' names it holds."""

    def __init__(self, key: str, names) -> None:
        self.key, self.names = key, names


def _mesh_of(tree: Any) -> Optional[DeviceMesh]:
    """The mesh of the first DTensor of a nested tree, or None."""
    if isinstance(tree, DTensor):
        return tree.device_mesh
    items = (tree.values() if isinstance(tree, dict) else
             tree if isinstance(tree, (list, tuple)) else ())
    return next((m for m in map(_mesh_of, items) if m is not None), None)


def _save_mesh(mesh: Optional[DeviceMesh], params: Any, opt_state: Any) -> Optional[DeviceMesh]:
    """The mesh a save gathers on: ``mesh``, else the ambient ``DeviceMesh``,
    else the mesh of the state's DTensors (a ZeRO-1 state's ``step`` lies on
    the whole mesh); None with one rank in the process group."""
    if mesh is None and isinstance(get_mesh(), DeviceMesh):
        mesh = get_mesh()
    if mesh is None:
        step = opt_state.get("step") if isinstance(opt_state, dict) else None
        mesh = _mesh_of(step) or _mesh_of([opt_state, params])
    if mesh is None or not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return mesh


def _from_rank0(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (``broadcast_object_list``)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class CheckpointManager:
    """Checkpoints as forks of a shared log (see module docstring).

    ``catalog=None`` opens (or creates) the trunk catalog; experiments pass
    their catalog fork explicitly via :meth:`experiment`. ``exp`` tags this
    manager's save records — pruning and abandon only ever squash data forks
    tagged with the manager's own lineage, so an experiment can never
    destroy trunk checkpoints (squash is irreversible even if the catalog
    fork is later abandoned)."""

    def __init__(self, system: BoltSystem, prefix: str = "ckpt",
                 keep: int = 3, chunk_bytes: int = 1 << 20,
                 catalog: Optional[AgileLog] = None, exp: str = "") -> None:
        if isinstance(system, BoltSystem):
            self.system = system
        else:   # the seed signature took a bare ObjectStore — fail loudly
            raise TypeError(
                "CheckpointManager now checkpoints onto the log (DESIGN.md "
                "§17) and needs the BoltSystem, not a bare ObjectStore")
        self.prefix = prefix
        self.keep = keep
        self.chunk_bytes = max(1, chunk_bytes)
        self.exp = exp
        self.catalog = catalog if catalog is not None else self._open(prefix)
        self.data_root = self._open(f"{prefix}/data")

    def _open(self, name: str) -> AgileLog:
        log = self.system.find_log(name)
        return log if log is not None else self.system.create_log(name)

    # ------------------------------------------------------------- catalog
    def _replay(self) -> Dict[int, Dict]:
        """Visible checkpoint index: replay the catalog's save/prune records
        in position order. Under an open experiment the trunk's view caps at
        the fork point (§4.1) — trunk saves sequenced during the experiment
        become visible when it merges or abandons."""
        index: Dict[int, Dict] = {}
        for raw in self.catalog.scan():
            rec = decode_record(raw)
            if rec.get("op") == "save":
                index[rec["step"]] = rec
            elif rec.get("op") == "prune":
                for s in rec["steps"]:
                    index.pop(s, None)
        return index

    # ---------------------------------------------------------------- save
    def save(self, step: int, params: Any, opt_state: Any,
             extra: Optional[Dict] = None, cfg: Optional[ModelConfig] = None,
             mesh: Optional[DeviceMesh] = None) -> int:
        """Write one checkpoint in the reference's record; returns the data
        fork's log id. A model (``params`` an ``nn.Module``) and its AdamW
        state go in the reference's layout, which needs ``cfg``.

        Leaf bytes go to a fresh cFork of the data root first; the catalog
        append is the linearization point (a crash before it leaves only an
        unreferenced fork for :meth:`recover`).

        On a mesh of more than one rank (``mesh``, else the ambient
        ``DeviceMesh``, else the mesh of the state's DTensors) the save is a
        collective: every rank calls it alike, a model split over 'model'
        being this rank's part and a ZeRO-1 state its chunks. Each leaf is
        gathered whole, one at a time (``tp.gather_to_host``), as the
        reference writes a sharded array; rank 0 alone writes to its log,
        and every rank returns rank 0's data fork id. So the record is the
        one a single process writes of the gathered model and state, and
        the other ranks' managers never touch their logs."""
        mesh = _save_mesh(mesh, params, opt_state)
        if isinstance(params, nn.Module):
            if cfg is None:
                raise ValueError("saving a model writes its state in the reference's "
                                 "layout, each pattern entry's layers stacked, which needs "
                                 "the model's config (save(cfg=...))")
            opt_state = opt_state_to_jax(cfg, params, opt_state, lazy=True)
            params = params_to_jax(cfg, params, lazy=True, mesh=mesh)
        state = {"params": params, "opt": opt_state}
        leaves = pytree_proto.leaves(state)
        treedef = pytree_proto.serialize(pytree_proto.structure(state)).hex()
        writer = mesh is None or dist.get_rank() == 0
        fork = self.data_root.cfork(promotable=False) if writer else None
        spans: List[List[int]] = []
        dtypes: List[str] = []
        pos = 0
        for leaf in leaves:
            t = leaf() if callable(leaf) else leaf     # one at a time; gathered on a mesh
            if isinstance(t, torch.Tensor):
                t = tp.host_leaf(t)
            if not writer:
                continue
            chunks, dt = _leaf_chunks(t, self.chunk_bytes)
            del t
            fork.append_batch(chunks).wait()
            spans.append([pos, pos + len(chunks)])
            dtypes.append(dt)
            pos += len(chunks)
        log_id = None
        if writer:
            fork.flush()
            manifest = {
                "op": "save",
                "step": step,
                "data_log": fork.log_id,
                "exp": self.exp,
                "spans": spans,
                "dtypes": dtypes,
                "treedef": treedef,
                "extra": extra or {},
            }
            # atomic commit: this catalog append is the linearization point
            # (withheld-but-sequenced under an open experiment's hold, §4.1)
            self.catalog.append(encode_record(manifest)).wait()
            self._prune()
            log_id = fork.log_id
        if mesh is not None:
            log_id = _from_rank0(log_id)
        return log_id

    def _prune(self) -> List[int]:
        """Keep the newest ``keep`` checkpoints OF THIS LINEAGE: squash the
        data forks of the rest (§13 chain-GC — the reaper deletes, not us)
        and record the retirement in the catalog."""
        if self.keep is None or self.keep <= 0:
            return []
        index = self._replay()
        mine = sorted(s for s, rec in index.items()
                      if rec.get("exp", "") == self.exp)
        victims = mine[:-self.keep]
        if not victims:
            return []
        for s in victims:
            self._squash_data(index[s]["data_log"])
        self.catalog.append(
            encode_record({"op": "prune", "steps": victims})).wait()
        self.system._gc_nudge()
        return victims

    def _squash_data(self, log_id: int) -> None:
        try:
            self.system.open_log(log_id).squash()
        except AgileLogError:
            pass                     # already squashed (re-entrant recover)

    # -------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        return sorted(self._replay())

    def latest_step(self) -> Optional[int]:
        index = self._replay()
        return max(index) if index else None

    def restore(self, step: Optional[int] = None, device=None,
                cfg: Optional[ModelConfig] = None, mesh: Optional[DeviceMesh] = None,
                shardings: Optional[Dict] = None) -> Tuple[int, Any, Any, Dict]:
        """``(step, params, opt_state, extra)`` of the checkpoint at ``step``
        (default the latest), the leaves as tensors on ``device`` (the card
        unless it names another). A model's state (written by either
        package: its params hold ``embed``, each pattern entry's layers
        stacked) needs ``cfg``, the model's config: its params come back by
        ``named_parameters()`` name and its optimizer state in
        ``adamw_init``'s layout. Any other tree comes back as it was saved,
        its dicts in sorted key order.

        On a ``mesh`` (else the ambient ``DeviceMesh``) a model's state is
        laid out as the reference's ``restore(shardings=)`` lays it out,
        whatever mesh wrote it: every rank calls this alike, rank 0 reads
        the record and broadcasts it one tensor at a time, and each rank
        keeps, on the mesh's device, its 'model' slice of each parameter
        (``tp.split_model``'s) and the chunks of ``m``, ``v`` and ``master``
        laid out by ``shardings`` (default ``opt_state_shardings``' rules),
        ``step`` replicated: DTensors, as ``zero1_adamw_init`` makes them.
        No rank's device holds more than its share and one whole tensor."""
        if mesh is None and isinstance(get_mesh(), DeviceMesh):
            mesh = get_mesh()
        if mesh is not None:
            return self._restore_on_mesh(step, cfg, mesh, shardings)
        step = step if step is not None else self.latest_step()
        assert step is not None, "no checkpoint found"
        rec = self._replay().get(step)
        assert rec is not None, f"no checkpoint at step {step}"
        paths = _port_paths(rec)
        root = _jax_tree(rec) if paths is None else None
        model_state = root is not None and _holds_model(root)
        if model_state and cfg is None:
            raise ValueError(
                f"the checkpoint at step {step} holds a model's state in the layout "
                "written by the JAX package: its leaves stack each pattern entry's "
                "layers, so restoring it needs the model's config (restore(cfg=...))")
        device = resolve_device(device)
        fork = self.system.open_log(rec["data_log"])
        records = list(fork.scan())
        leaves = [_leaf_restore(bytearray().join(records[lo:hi]), dt,
                                "cpu" if model_state else device)
                  for (lo, hi), dt in zip(rec["spans"], rec["dtypes"])]
        if root is None:
            state = _unflatten(paths, leaves)
            return step, state.get("params", {}), state.get("opt", {}), rec["extra"]
        state = pytree_proto.unflatten(root, leaves)
        del leaves
        if not model_state:
            return step, state["params"], state["opt"], rec["extra"]
        model = params_from_jax(cfg, state["params"], device=device)
        params = {name: p.detach() for name, p in model.named_parameters()}
        return step, params, opt_state_from_jax(cfg, model, state["opt"]), rec["extra"]

    @torch.no_grad()
    def _restore_on_mesh(self, step: Optional[int], cfg: Optional[ModelConfig],
                         mesh: DeviceMesh, shardings: Optional[Dict]):
        """``restore`` on a mesh (its docstring): rank 0 reads, one record
        leaf at a time, and broadcasts each tensor of it over the default
        group; every rank keeps its part."""
        rec = None
        if dist.get_rank() == 0:
            step = step if step is not None else self.latest_step()
            rec = self._replay().get(step) if step is not None else None
        rec = _from_rank0(rec)
        if rec is None:
            raise ValueError(f"no checkpoint at step {step}" if step is not None
                             else "no checkpoint found")
        step = rec["step"]
        root = _jax_tree(rec) if _port_paths(rec) is None else None
        if root is None or not _holds_model(root) or cfg is None:
            raise ValueError(
                f"restoring the checkpoint at step {step} onto a mesh lays out a model's "
                "state in the reference's layout, which needs the record to hold one and "
                "the model's config (restore(cfg=..., mesh=...))")
        whole = init_params(cfg, None, device="meta")
        opt_keys = dict(zip(root.children[root.keys.index("opt")].keys,
                            root.children[root.keys.index("opt")].children))
        keys = [k for k in ("m", "v", "master") if k in opt_keys]
        want = {"params": jax_tree(cfg, whole, lambda names: _Slot("params", names)),
                "opt": {**{k: jax_tree(cfg, whole, lambda names, k=k: _Slot(k, names))
                           for k in keys}, "step": _Slot("step", "step")}}
        if pytree_proto.serialize(pytree_proto.structure(want)) != bytes.fromhex(rec["treedef"]):
            raise ValueError(f"the checkpoint at step {step} does not hold {cfg.name}'s "
                             f"state with {', '.join(keys)}: its tree differs")
        if shardings is None:
            shardings = opt_state_shardings(cfg, whole, mesh,
                                            AdamWConfig(master_weights="master" in keys))
        shapes = {name: tuple(p.shape) for name, p in whole.named_parameters()}
        mg = tp.model_group(mesh)
        dims = tp.split_dims(cfg, describe(mesh)) if mg is not None else {}
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
        fork = self.system.open_log(rec["data_log"]) if dist.get_rank() == 0 else None
        params: Dict[str, torch.Tensor] = {}
        opt: Dict[str, Any] = {k: {} for k in keys}
        for slot, (lo, hi), dt in zip(pytree_proto.leaves(want), rec["spans"], rec["dtypes"]):
            names = [slot.names] if isinstance(slot.names, str) else slot.names
            shape = () if slot.key == "step" else shapes[names[0]]
            leaf = err = None
            if fork is not None:
                leaf = _leaf_restore(bytearray().join(fork.read(lo, hi)), dt, "cpu")
                stacked = (len(names),) + shape if isinstance(slot.names, list) else shape
                if tuple(leaf.shape) != stacked:
                    err = (f"{slot.key} {names[0]}: the record's {tuple(leaf.shape)} does "
                           f"not fit {cfg.name}'s {stacked}")
            err = _from_rank0(err)
            if err is not None:
                raise ValueError(f"the checkpoint at step {step}: {err}")
            dtype = getattr(torch, dt)
            for g, name in enumerate(names):
                if leaf is not None:
                    t = leaf[g] if isinstance(slot.names, list) else leaf
                    buf = t.to(device, copy=True)
                else:
                    buf = torch.empty(shape, dtype=dtype, device=device)
                dist.broadcast(buf, src=0)
                if slot.key == "step":
                    opt["step"] = distribute(buf, shardings["step"], mesh)
                elif slot.key == "params":
                    if name in dims:
                        dim, n = dims[name][0], shape[dims[name][0]] // mg.size
                        buf = buf.narrow(dim, mg.rank * n, n).clone()
                    params[name] = buf
                else:
                    opt[slot.key][name] = from_chunk(
                        lambda box, buf=buf: buf[box_index(box)].clone(),
                        shardings[slot.key][name], mesh, shape, dtype, device)
                del buf
            del leaf
        return step, params, opt, rec["extra"]

    # ---------------------------------------------------------- experiments
    def experiment(self, name: str) -> "ExperimentCheckpoints":
        """Open a fork-per-experiment (promotable cFork of the catalog).
        While open it holds the trunk catalog (§4.1): trunk saves stay
        sequenced-but-withheld until the experiment merges or abandons."""
        fork = self.catalog.cfork(promotable=True)
        return ExperimentCheckpoints(self, name, fork)

    # -------------------------------------------------------------- recover
    def recover(self) -> List[int]:
        """Squash every live data fork that no visible save record —
        in the trunk catalog or any live experiment fork of it — references:
        the crash-orphan path (a save that died before its catalog append).
        Returns the squashed fork ids; the §13 reaper reclaims the bytes."""
        referenced = {rec["data_log"] for rec in self._replay().values()}
        logs = self.system.metadata.state.logs
        for log_id, meta in logs.items():
            if meta.parent == self.catalog.log_id and meta.alive:
                exp_cat = self.system.open_log(log_id)
                for raw in exp_cat.scan():
                    rec = decode_record(raw)
                    if rec.get("op") == "save":
                        referenced.add(rec["data_log"])
        orphans = [log_id for log_id, meta in logs.items()
                   if meta.parent == self.data_root.log_id and meta.alive
                   and log_id not in referenced]
        for log_id in orphans:
            self._squash_data(log_id)
        if orphans:
            self.system._gc_nudge()
        return orphans


class ExperimentCheckpoints(CheckpointManager):
    """A CheckpointManager whose catalog is a promotable experiment fork.

    Saves land on the fork (trunk checkpoints remain visible through the
    fork's flattened view, so an experiment restores from trunk state and
    checkpoints its own). ``merge()`` promotes — the experiment's manifest
    records join the trunk catalog atomically and the fork squashes
    (squash-on-merge). ``abandon()`` squashes the fork AND the experiment's
    own data forks, handing the whole lineage to chain-GC."""

    def __init__(self, trunk: CheckpointManager, name: str,
                 fork: AgileLog) -> None:
        super().__init__(trunk.system, prefix=trunk.prefix, keep=trunk.keep,
                         chunk_bytes=trunk.chunk_bytes, catalog=fork,
                         exp=name)
        self.trunk = trunk
        self.name = name
        self._state = "open"          # open | merged | abandoned

    def _require_open(self) -> None:
        if self._state != "open":
            raise AgileLogError(f"experiment {self.name!r} already "
                                f"{self._state}")

    def save(self, step: int, params: Any, opt_state: Any,
             extra: Optional[Dict] = None, cfg: Optional[ModelConfig] = None,
             mesh: Optional[DeviceMesh] = None) -> int:
        self._require_open()
        return super().save(step, params, opt_state, extra, cfg, mesh)

    def merge(self) -> None:
        """Squash-on-merge: promote the catalog fork into the trunk —
        every save/prune record this experiment wrote becomes trunk-visible
        in one atomic restructure; the data forks are already shared (they
        hang off the data root), so no bytes move."""
        self._require_open()
        self.catalog.promote()
        self._state = "merged"

    def abandon(self) -> None:
        """Drop the experiment: squash its catalog fork and its own data
        forks — abandon = chain-GC (§13/§17). Trunk checkpoints it could
        see through the fork view are untouched (the ``exp`` tag scopes the
        squash to this lineage)."""
        self._require_open()
        index = self._replay()
        for s, rec in index.items():
            if rec.get("exp", "") == self.exp:
                self._squash_data(rec["data_log"])
        self.catalog.squash()
        self._state = "abandoned"
        self.system._gc_nudge()

    # an experiment left open at block exit held the trunk — resolve it
    def __enter__(self) -> "ExperimentCheckpoints":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._state == "open":
            if exc_type is None:
                self.merge()
            else:
                self.abandon()
