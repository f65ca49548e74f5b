"""Parameter sharding rules (TP over 'model'; ZeRO over 'data'×'pod').

Port of ``src/repro/distributed/sharding.py``. Rules are name-based with
divisibility-aware fallback: a dim is sharded over an axis only when evenly
divisible, otherwise that dim stays replicated. A parameter's rule is looked
up by the last component of its ``named_parameters()`` name
(``blocks.3.attn.wq`` -> ``wq``), as the reference looks up the last string
key of the leaf's path.

The layer stack. The reference stacks each block-pattern entry's layers
into one leaf of shape ``(n_stack, *shape)`` (and the encoder's over its
layers), and its rules cover the trailing dims. The port keeps one tensor a
layer, so a spec is reckoned on the reference's stacked shape, exactly as
the reference reckons it, and split into the layer's own ``spec`` and the
axis on the stack dim, ``stack``. Only ``zero_extend`` ever puts an axis
there: it takes the largest free divisible dim, which on the (2, 16, 16)
mesh is the stack dim for ``pod`` wherever the layer count is even and no
other free dim divides. Then the reference splits the layers into
contiguous blocks over that axis; the port gives layer ``l`` whole to the
ranks at coordinate ``l // (n_stack / size)`` of the axis (``owner``), where
it is laid out by ``spec`` over the other axes. Every device holds the same
bytes as under the reference's layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..launch.mesh import Mesh, describe
from ..models.config import ModelConfig
from .context import P

# leaf-name -> per-dim axis *preference* for the trailing dims (leading stack
# dims from scan are always unsharded). None = replicate that dim.
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed":   ("model", None),          # (V, D)
    "pos_embed": (None, None),
    "head":    (None, "model"),          # (D, V)
    "vision_proj": (None, None),
    # attention
    "wq":      (None, "model", None),    # (D, H, Dh)
    "wk":      (None, "model", None),    # (D, KH, Dh)
    "wv":      (None, "model", None),
    "wo":      ("model", None, None),    # (H, Dh, D)
    "w_dkv":   (None, None),             # (D, r+rope)  [MLA, small]
    "w_uk":    (None, "model", None),    # (r, H, Dh)
    "w_uv":    (None, "model", None),
    "q_norm":  (None,),
    "k_norm":  (None,),
    "kv_norm": (None,),
    # dense MLP
    "w_in":    (None, "model"),          # (D, F)
    "w_gate":  (None, "model"),
    "w_out":   ("model", None),          # (F, D)
    # MoE (leading E dim)
    "router":  (None, None),             # (D, E) small
    "e_in":    ("model", None, None),    # (E, D, Fe)
    "e_gate":  ("model", None, None),
    "e_out":   ("model", None, None),    # (E, Fe, D)
    # mamba
    "m_in":    (None, None, "model"),    # (D, 2, Di)
    "m_conv":  (None, "model"),          # (W, Di)
    "m_xproj": ("model", None),          # (Di, dtr+2N)
    "m_dt":    (None, "model"),          # (dtr, Di)
    "m_dtb":   ("model",),               # (Di,)
    "m_alog":  ("model", None),          # (Di, N)
    "m_d":     ("model",),               # (Di,)
    "m_out":   ("model", None),          # (Di, D)
    # xLSTM
    "x_up":    (None, None, "model"),    # (D, 2, Di)
    "x_q":     ("model", None, None),    # block-diag (nb, bs, bs): channel-local
    "x_k":     ("model", None, None),
    "x_v":     ("model", None, None),
    "x_if":    ("model", None),          # (Di, 2H) row -> psum
    "x_out":   ("model", None),          # (Di, D)
    "s_gates": (None, None, None),       # sLSTM small: replicate
    "s_rec":   (None, None, None, None),
    "s_out":   (None, None),
}


def _spec_for(name: str, shape: Tuple[int, ...], mesh: Mesh) -> P:
    rule = _RULES.get(name)
    if rule is None:
        return P()  # norms, biases, anything unmatched: replicate
    sizes = describe(mesh).shape
    ndim = len(shape)
    n_lead = ndim - len(rule)
    axes: list = [None] * ndim
    for i, pref in enumerate(rule):
        dim = n_lead + i
        if pref is not None and pref in sizes and shape[dim] % sizes[pref] == 0:
            axes[dim] = pref
    return P(*axes)


def zero_extend(spec: P, shape: Tuple[int, ...], mesh: Mesh,
                axes: Tuple[str, ...] = ("data", "pod")) -> P:
    """ZeRO-1: extend a param spec with data/pod sharding on the largest
    still-unsharded divisible dim (for optimizer state / master weights)."""
    sizes = describe(mesh).shape
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for ax in axes:
        if ax not in sizes or sizes[ax] == 1:
            continue
        cand = [(shape[i], i) for i in range(len(shape))
                if parts[i] is None and shape[i] % sizes[ax] == 0]
        if not cand:
            continue
        _, best = max(cand)
        parts[best] = ax
    return P(*parts)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class Sharding:
    """Where one tensor lives on a mesh: ``spec`` over its own dims and, for
    a layer the reference stacks (``n_stack`` layers, this one ``layer``),
    ``stack``, the mesh axis on the reference's stack dim, if any."""
    spec: P
    stack: Optional[str] = None
    layer: int = 0
    n_stack: int = 0

    def owner(self, mesh: Mesh) -> Optional[int]:
        """The coordinate on ``stack`` of the ranks that hold this layer."""
        if self.stack is None:
            return None
        return self.layer // (self.n_stack // describe(mesh).shape[self.stack])

    def shard_shape(self, shape: Tuple[int, ...], mesh: Mesh) -> Tuple[int, ...]:
        """The shape each rank that holds the tensor keeps of it."""
        sizes = describe(mesh).shape
        out = []
        for i, n in enumerate(shape):
            k = math.prod(sizes[a] for a in _axes_of(self.spec[i] if i < len(self.spec)
                                                     else None))
            assert n % k == 0, (shape, self.spec)
            out.append(n // k)
        return tuple(out)

    def bytes_per_device(self, shape: Tuple[int, ...], itemsize: int,
                         mesh: Mesh) -> float:
        """Bytes a device holds, as the mean over the devices: a layer given
        whole to one coordinate of ``stack`` counts 1/size on each."""
        b = math.prod(self.shard_shape(shape, mesh)) * itemsize
        return b / describe(mesh).shape[self.stack] if self.stack else b


def layer_stacks(cfg: ModelConfig, model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """``(n_stack, layer)`` of each parameter that the reference stacks: a
    decoder layer of pattern entry j is layer g of that entry's stack (the
    converter's pairing, ``convert._leaves``; a dense first layer is not
    stacked), an encoder layer is layer i of the encoder's."""
    out: Dict[str, Tuple[int, int]] = {}
    first, n_pat = int(cfg.first_layer_dense), len(cfg.block_pattern)
    n = len(model.blocks) - first
    for i, blk in enumerate(model.blocks):
        if i < first:
            continue
        g, j = divmod(i - first, n_pat)
        for name, _ in blk.named_parameters():
            out[f"blocks.{i}.{name}"] = (len(range(j, n, n_pat)), g)
    if model.encoder is not None:
        n_enc = len(model.encoder.blocks)
        for i, blk in enumerate(model.encoder.blocks):
            for name, _ in blk.named_parameters():
                out[f"encoder.blocks.{i}.{name}"] = (n_enc, i)
    return out


def param_shardings(cfg: ModelConfig, model: nn.Module, mesh: Mesh,
                    zero: bool = False) -> Dict[str, Sharding]:
    """A ``Sharding`` for each of ``model.named_parameters()``, reckoned on
    the reference's leaf shape; with ``zero`` extended by ``zero_extend``."""
    stacks = layer_stacks(cfg, model)
    out = {}
    for name, p in model.named_parameters():
        n_stack, layer = stacks.get(name, (0, 0))
        shape = ((n_stack,) if n_stack else ()) + tuple(p.shape)
        spec = _spec_for(name.rpartition(".")[2], shape, mesh)
        if zero:
            spec = zero_extend(spec, shape, mesh)
        if n_stack:
            stack = spec[0] if spec else None
            out[name] = Sharding(P(*spec[1:]), stack, layer, n_stack)
        else:
            out[name] = Sharding(spec)
    return out


def placements(spec: P, mesh: Mesh) -> List:
    """DTensor placements, one per mesh dim, of a tensor laid out by
    ``spec``: ``Shard(i)`` where dim i is split over that axis, else
    ``Replicate()``. A dim split over several axes must list them major to
    minor, as DTensor splits repeated ``Shard(i)`` outer mesh dim first."""
    names = describe(mesh).axis_names
    out: List = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = _axes_of(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: dim {i} lists {axes} against the "
                             f"mesh order {names}")
        for d in dims:
            out[d] = Shard(i)
    return out


_SUBMESHES: Dict[Tuple[DeviceMesh, str], List[DeviceMesh]] = {}


def submesh(mesh: DeviceMesh, axis: str, coord: int) -> DeviceMesh:
    """The mesh of the ranks at ``coord`` on ``axis``, named by the other
    axes. Every rank must make the same calls: the submeshes along an axis
    are built together, the first time one is asked for."""
    key = (mesh, axis)
    if key not in _SUBMESHES:
        dim = mesh.mesh_dim_names.index(axis)
        names = tuple(n for n in mesh.mesh_dim_names if n != axis)
        _SUBMESHES[key] = [DeviceMesh(mesh.device_type, mesh.mesh.select(dim, c),
                                      mesh_dim_names=names)
                           for c in range(mesh.mesh.shape[dim])]
    return _SUBMESHES[key][coord]


def layout(sharding: Sharding, mesh: DeviceMesh) -> Tuple[DeviceMesh, List]:
    """The mesh a tensor laid out by ``sharding`` lives on (the submesh of
    its owner coordinate where it has a ``stack`` axis) and its placements."""
    if sharding.stack is not None:
        mesh = submesh(mesh, sharding.stack, sharding.owner(mesh))
    return mesh, placements(sharding.spec, mesh)


def distribute(t: torch.Tensor, sharding: Sharding, mesh: DeviceMesh) -> DTensor:
    """``t``, the same whole tensor on every rank, as a DTensor laid out by
    ``sharding``: each rank keeps its own chunk, with no communication. A
    layer with a ``stack`` axis is a DTensor on the submesh of its owner
    coordinate; other ranks hold an empty local tensor."""
    mesh, places = layout(sharding, mesh)
    return distribute_tensor(t, mesh, places, src_data_rank=None)


Box = Tuple[Tuple[int, ...], Tuple[int, ...]]


def chunk_box(shape: Tuple[int, ...], mesh: DeviceMesh, places, coord) -> Box:
    """``(offsets, sizes)`` of the chunk at coordinate ``coord`` of ``mesh``
    of a tensor of whole ``shape`` laid out by DTensor ``places``: a dim
    split over several mesh dims is split by the outer one first, as
    DTensor splits it. Every split is even (the rules split a dim only
    where the axis divides it)."""
    offs, sizes = [0] * len(shape), list(shape)
    for k, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.size(k)
            assert sizes[pl.dim] % n == 0, (shape, places)
            sizes[pl.dim] //= n
            offs[pl.dim] += coord[k] * sizes[pl.dim]
    return tuple(offs), tuple(sizes)


def box_index(box: Box) -> Tuple[slice, ...]:
    return tuple(slice(o, o + n) for o, n in zip(*box))


def from_chunk(make, sharding: Sharding, mesh: DeviceMesh, shape: Tuple[int, ...],
               dtype: torch.dtype, device) -> DTensor:
    """A DTensor of whole ``shape`` laid out by ``sharding`` whose local
    tensor is ``make(box)``, this rank's chunk (``chunk_box``), made by
    this rank alone with no communication and no whole tensor. A rank that
    holds none (a layer given to another coordinate of its stack axis)
    holds an empty tensor, as ``distribute`` leaves it."""
    mesh, places = layout(sharding, mesh)
    coord = mesh.get_coordinate()
    local = (torch.empty(0, dtype=dtype, device=device) if coord is None
             else make(chunk_box(shape, mesh, places, coord)))
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))
