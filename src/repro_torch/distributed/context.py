"""Ambient mesh context.

Port of ``src/repro/distributed/context.py``. ``use_mesh(mesh)`` makes a mesh
(a ``DeviceMesh`` or a ``MeshShape``) ambient; ``pspec`` and ``shard`` filter
axis names to it as the reference does: names not on the mesh are dropped,
``"data"`` widens to ``("pod", "data")``, and an axis group whose size does
not divide the dim falls back to its suffix. ``shard(x, ...)`` does nothing
with no mesh active. Under a mesh it redistributes a ``DTensor`` to the
filtered spec, the counterpart of ``with_sharding_constraint``; a plain
tensor is a rank's own data with no global layout to constrain, and comes
back as it is. The port's models do not call ``shard``: they run on plain
local tensors, and mark the reference's ``shard()`` sites with the
collectives of ``distributed/tp.py`` (``copy_to_model``,
``reduce_from_model``), which a split over 'model' needs there.

A rank's batch is either the whole batch, the same on every rank (the
default), or only its own rows of the global batch, split over 'pod' and
'data' (``use_mesh(mesh, local_rows=True)``, as the ZeRO-1 step enters it
with ``train.step.local_batch``'s rows). The MoE reads which
(``local_rows``): its token groups and its router loss are the global
batch's, as the reference's are.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

from torch.distributed.tensor import DTensor

from ..launch.mesh import Mesh, describe

_ACTIVE_MESH: Optional[Mesh] = None
_LOCAL_ROWS = False

AxisName = Union[str, Sequence[str], None]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (major to minor) the dim is split over. The counterpart
    of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], local_rows: bool = False):
    """Make ``mesh`` ambient. ``local_rows``: each rank's batch holds only
    its own rows of the global batch, split over 'pod' and 'data'; else
    every rank holds the whole batch."""
    global _ACTIVE_MESH, _LOCAL_ROWS
    prev = _ACTIVE_MESH, _LOCAL_ROWS
    _ACTIVE_MESH, _LOCAL_ROWS = mesh, local_rows
    try:
        yield mesh
    finally:
        _ACTIVE_MESH, _LOCAL_ROWS = prev


def get_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def axis_size(name: str) -> int:
    if _ACTIVE_MESH is None:
        return 1
    return describe(_ACTIVE_MESH).shape.get(name, 1)


def local_rows() -> bool:
    """Whether each rank's batch is its own rows of the global batch (see
    ``use_mesh``) on a mesh with more than one rank over 'pod' x 'data'."""
    return _LOCAL_ROWS and axis_size("pod") * axis_size("data") > 1


def _filter_axes(axes, shape=None) -> Optional[P]:
    """Drop axis names not on the active mesh; widen 'data' to ('pod','data')
    (batch-like dims span both data-parallel axes); drop axes whose product
    doesn't divide the dim, keeping the longest suffix that does."""
    if _ACTIVE_MESH is None:
        return None
    sizes = describe(_ACTIVE_MESH).shape

    def keep(i: int, a: AxisName):
        if a is None:
            return None
        if a == "data" or (isinstance(a, tuple) and a == ("data",)):
            a = ("pod", "data")
        if isinstance(a, str):
            a = (a,)
        kept = tuple(x for x in a if x in sizes)
        if not kept:
            return None
        if shape is not None:
            size = 1
            for x in kept:
                size *= sizes[x]
            # try the suffix (e.g. batch=16 divisible by data but not pod*data)
            while kept and shape[i] % size != 0:
                size //= sizes[kept[0]]
                kept = kept[1:]
            if not kept:
                return None
        return kept if len(kept) > 1 else kept[0]

    return P(*[keep(i, a) for i, a in enumerate(axes)])


def shard(x, *axes: AxisName):
    """Redistribute a ``DTensor`` to ``axes`` filtered to the active mesh;
    anything else, or with no mesh, comes back as it is. The models' own
    activation sites use ``tp.copy_to_model`` and ``tp.reduce_from_model``."""
    spec = _filter_axes(axes, getattr(x, "shape", None))
    if spec is None or not isinstance(x, DTensor):
        return x
    from .sharding import placements       # sharding imports this module
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def pspec(*axes: AxisName) -> P:
    """PartitionSpec filtered to the active mesh (P() when no mesh)."""
    spec = _filter_axes(axes)
    return spec if spec is not None else P()
