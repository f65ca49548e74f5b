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
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import opt_state_from_jax, opt_state_to_jax, params_from_jax, params_to_jax
from ..core.api import AgileLog, BoltSystem
from ..core.errors import AgileLogError
from ..distributed import tp
from ..models.config import ModelConfig
from ..models.layers import resolve_device
from ..streams.records import decode_record, encode_record
from . import pytree_proto


def _unflatten(paths: List[str], leaves: List[Any]) -> Dict:
    tree: Dict = {}
    for path, leaf in zip(paths, leaves):
        head, _, name = path.rpartition("/")
        node = tree
        for key in head.split("/") if head else []:
            node = node.setdefault(key, {})
        node[name] = leaf
    return tree


def _leaf_bytes(leaf: Any) -> Tuple[bytes, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy can't serialize bf16
            arr, dt = t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        else:
            arr = t.numpy()
            dt = str(arr.dtype)
    else:
        arr = np.asarray(leaf)
        dt = str(arr.dtype)
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue(), dt


def _leaf_restore(raw: bytes, dt: str, device) -> torch.Tensor:
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
             extra: Optional[Dict] = None, cfg: Optional[ModelConfig] = None) -> int:
        """Write one checkpoint in the reference's record; returns the data
        fork's log id. A model (``params`` an ``nn.Module``) and its AdamW
        state go in the reference's layout, which needs ``cfg``.

        Leaf bytes go to a fresh cFork of the data root first; the catalog
        append is the linearization point (a crash before it leaves only an
        unreferenced fork for :meth:`recover`).

        Under a split over 'model' on the ambient mesh it raises before it
        writes anything: a rank holds its slices, whose shapes are not the
        record's (saving a split model is a later part of ROADMAP item 7d)."""
        mg = tp.model_group()
        if mg is not None:
            raise NotImplementedError(
                f"save under a split over 'model' ({mg.size} ranks): a rank holds its "
                "slices, not the whole leaves the record holds; saving a split model "
                f"is a later part of {tp.ROADMAP_ITEM}")
        if isinstance(params, nn.Module):
            if cfg is None:
                raise ValueError("saving a model writes its state in the reference's "
                                 "layout, each pattern entry's layers stacked, which needs "
                                 "the model's config (save(cfg=...))")
            opt_state = opt_state_to_jax(cfg, params, opt_state, lazy=True)
            params = params_to_jax(cfg, params, lazy=True)
        state = {"params": params, "opt": opt_state}
        leaves = pytree_proto.leaves(state)
        treedef = pytree_proto.serialize(pytree_proto.structure(state)).hex()
        fork = self.data_root.cfork(promotable=False)
        spans: List[List[int]] = []
        dtypes: List[str] = []
        pos = 0
        for leaf in leaves:
            raw, dt = _leaf_bytes(leaf() if callable(leaf) else leaf)   # one at a time
            chunks = [raw[o:o + self.chunk_bytes]
                      for o in range(0, len(raw), self.chunk_bytes)] or [b""]
            fork.append_batch(chunks).wait()
            spans.append([pos, pos + len(chunks)])
            dtypes.append(dt)
            pos += len(chunks)
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
        return fork.log_id

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
                cfg: Optional[ModelConfig] = None) -> Tuple[int, Any, Any, Dict]:
        """``(step, params, opt_state, extra)`` of the checkpoint at ``step``
        (default the latest), the leaves as tensors on ``device`` (the card
        unless it names another). A model's state (written by either
        package: its params hold ``embed``, each pattern entry's layers
        stacked) needs ``cfg``, the model's config: its params come back by
        ``named_parameters()`` name and its optimizer state in
        ``adamw_init``'s layout. Any other tree comes back as it was saved,
        its dicts in sorted key order."""
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
        leaves = [_leaf_restore(b"".join(records[lo:hi]), dt,
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
             extra: Optional[Dict] = None, cfg: Optional[ModelConfig] = None) -> int:
        self._require_open()
        return super().save(step, params, opt_state, extra, cfg)

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
