"""AdamW over the model's named parameters, with optional low-precision moments.

Port of ``src/repro/train/optimizer.py:26-81``: fp32 master weights (the
model's parameters stay in their compute dtype, bf16 for the real configs),
m and v in fp32 or bf16 (``moments_dtype``), global-norm clipping, bias
correction and decoupled weight decay. The state is a dict of tensors keyed
by ``model.named_parameters()`` names: ``{"m": {...}, "v": {...}, "master":
{...}, "step": int32 scalar}``. Unlike the reference, which returns new
arrays, ``adamw_update`` updates the parameters and the state in place
under ``no_grad`` (it holds no second copy of an 8 B-parameter state).

ZeRO-1 (``src/repro/train/optimizer.py:84-96``): ``opt_state_shardings``
lays ``m``, ``v`` and ``master`` out by each parameter's spec extended over
'data' and 'pod' (``zero_extend``), ``step`` replicated;
``zero1_adamw_init`` makes the state DTensors of that layout, each rank
allocating only its own chunks (``distribute_opt_state`` lays out a state
already made whole), and ``zero1_adamw_update`` updates each rank's chunk and gathers the new
parameters onto every rank, with ``adamw_update``'s arithmetic: whole, or
under tensor parallelism (``distributed/tp.py``) each rank's slice of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ..distributed import tp
from ..distributed.context import P
from ..distributed.sharding import (Sharding, _axes_of, distribute, from_chunk,
                                    param_shardings)
from ..launch.mesh import Mesh, describe
from ..models.config import ModelConfig


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"      # 'bfloat16' halves m/v memory
    master_weights: bool = True


def adamw_init(model: nn.Module, cfg: AdamWConfig) -> Dict:
    """Zero moments in ``cfg.moments_dtype`` and, with master weights, an
    fp32 copy of every parameter; step 0."""
    mdt = getattr(torch, cfg.moments_dtype)
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    state = {
        "m": {n: torch.zeros(p.shape, dtype=mdt, device=p.device) for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=mdt, device=p.device) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_weights:
        state["master"] = {n: p.detach().float().clone() for n, p in params.items()}
    return state


def _scalars(grads, step: torch.Tensor, cfg: AdamWConfig,
             mg: Optional[tp.ModelGroup] = None, split=()):
    """The global grad norm, the clip scale and the bias corrections. Under
    a split over 'model' (``mg``) ``grads`` are this rank's slices where
    ``split`` says so: their squares are summed over 'model', and the
    replicated ones counted once (from 'model' rank 0), so every rank has
    the same norm."""
    if mg is None:
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    else:
        sq = torch.zeros((), dtype=torch.float32, device=step.device)
        for g, cut in zip(grads, split):
            if cut or mg.rank == 0:
                sq = sq + g.float().square().sum()
        dist.all_reduce(sq, group=mg.group)
        gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device) ** stepf
    bc2 = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device) ** stepf
    return gnorm, scale, bc1, bc2


def _leaf(g, m, v, w, scale, bc1, bc2, cfg: AdamWConfig):
    """One tensor's update in fp32: ``(w32, m32, v32)``."""
    g = g.float() * scale
    m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
    v32 = v.float() * cfg.b2 + g.square() * (1 - cfg.b2)
    u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
    w32 = w.float()
    return w32 - cfg.lr * (u + cfg.weight_decay * w32), m32, v32


# The elements of a tensor whose fp32 temporaries an update holds at a time:
# _leaf's arithmetic is elementwise, so updating a tensor in blocks changes no
# bit, and its temporaries (about seven fp32 copies) stay 0.5 GiB, not seven
# times the largest chunk (1.24 GB for a rank's half of qwen3-8b's embedding)
_BLOCK = 1 << 24


def _update(g, m, v, w, outs, scale, bc1, bc2, cfg: AdamWConfig) -> None:
    """One tensor's update in place, ``_BLOCK`` elements at a time: ``m``
    and ``v`` take the new moments and each of ``outs`` the new weights,
    each rounded to its own dtype (``w``, the weights read, may be one of
    them). ``m``, ``v`` and ``outs`` are contiguous."""
    gf, wf = g.reshape(-1), w.reshape(-1)
    mf, vf, of = m.view(-1), v.view(-1), [o.view(-1) for o in outs]
    for i in range(0, mf.numel(), _BLOCK):
        sl = slice(i, i + _BLOCK)
        w32, m32, v32 = _leaf(gf[sl], mf[sl], vf[sl], wf[sl], scale, bc1, bc2, cfg)
        mf[sl].copy_(m32)
        vf[sl].copy_(v32)
        for o in of:
            o[sl].copy_(w32)
        del w32, m32, v32


@torch.no_grad()
def adamw_update(model: nn.Module, grads: Mapping[str, torch.Tensor], state: Dict,
                 cfg: AdamWConfig) -> Tuple[nn.Module, Dict, torch.Tensor]:
    """One AdamW step with ``grads`` (keyed like ``model.named_parameters()``)
    clipped to global norm ``cfg.clip_norm``. Updates the parameters and
    ``state`` in place and returns ``(model, state, grad_norm)``, the norm
    taken before clipping, as the reference returns it."""
    params = dict(model.named_parameters())
    step = state["step"] + 1
    gnorm, scale, bc1, bc2 = _scalars(grads.values(), step, cfg)
    for name, p in params.items():          # p rounds to the param dtype
        w = state["master"][name] if "master" in state else p
        _update(grads[name], state["m"][name], state["v"][name], w,
                [p] if w is p else [p, w], scale, bc1, bc2, cfg)
    state["step"] = step
    return model, state, gnorm


def opt_state_shardings(model_cfg: ModelConfig, model: nn.Module, mesh: Mesh,
                        cfg: AdamWConfig) -> Dict:
    """Shardings of the optimizer state, keyed as ``adamw_init``'s: the
    param's TP spec extended with 'data'/'pod' sharding (ZeRO-1), reckoned
    on the reference's stacked leaves (``distributed.sharding``); ``step``
    replicated."""
    zeroed = param_shardings(model_cfg, model, mesh, zero=True)
    state = {"m": zeroed, "v": zeroed, "step": Sharding(P())}
    if cfg.master_weights:
        state["master"] = zeroed
    return state


def distribute_opt_state(state: Dict, shardings: Dict, mesh: DeviceMesh) -> Dict:
    """``state`` (``adamw_init``'s, the same on every rank) as DTensors laid
    out by ``shardings`` (``opt_state_shardings``'s): each rank keeps its
    chunks, with no communication."""
    out = {"step": distribute(state["step"], shardings["step"], mesh)}
    for key in ("m", "v", "master"):
        if key in state:
            out[key] = {n: distribute(t, shardings[key][n], mesh)
                        for n, t in state[key].items()}
    return out


@torch.no_grad()
def zero1_adamw_init(model_cfg: ModelConfig, model: nn.Module, cfg: AdamWConfig,
                     shardings: Dict, mesh: DeviceMesh) -> Dict:
    """``distribute_opt_state(adamw_init(...))``'s DTensors, equal bit for
    bit, each rank allocating only its own chunks: ``m`` and ``v`` zeros in
    ``cfg.moments_dtype``, ``master`` the fp32 chunk of the parameter,
    ``step`` replicated, laid out by ``shardings`` (``opt_state_shardings``
    of the whole model, or of ``init_params(cfg, None, device="meta")``).
    ``model`` is whole, or this rank's part (``tp.split_model``), whose
    split leaves hold the rank's 'model' slice of each chunk. A rank that
    holds no chunk of a layer (one given to another coordinate of its stack
    axis) holds an empty tensor, as ``distribute_opt_state`` leaves it."""
    mdt = getattr(torch, cfg.moments_dtype)
    mg = tp.model_group(mesh)
    dims = tp.split_dims(model_cfg, describe(mesh)) if mg is not None else {}
    state: Dict = {key: {} for key in ("m", "v", "master") if key in shardings}
    device = None
    for name, p in model.named_parameters():
        device = p.device
        shape = tuple(p.shape)
        at = [0] * p.ndim                  # where the rank's part starts in the whole leaf
        if name in dims and p.shape[dims[name][0]] != dims[name][1]:
            dim, whole = dims[name]
            shape = shape[:dim] + (whole,) + shape[dim + 1:]
            at[dim] = mg.rank * p.shape[dim]

        def master(box, p=p, at=at):
            idx = tuple(slice(o - a, o - a + n) for o, a, n in zip(box[0], at, box[1]))
            return p.detach()[idx].to(torch.float32, memory_format=torch.contiguous_format,
                                      copy=True)

        for key in state:
            make = master if key == "master" else (
                lambda box: torch.zeros(box[1], dtype=mdt, device=p.device))
            state[key][name] = from_chunk(make, shardings[key][name], mesh, shape,
                                          torch.float32 if key == "master" else mdt, p.device)
    state["step"] = distribute(torch.zeros((), dtype=torch.int32, device=device),
                               shardings["step"], mesh)
    return state


def _zero_layout(like: DTensor) -> Tuple[Optional[DeviceMesh], Tuple]:
    """The mesh and placements over which ZeRO-1 chunks and gathers a
    parameter of the state tensor ``like``: ``like``'s own, or, where
    'model' has more than one rank, its axes but 'model' (the parameter is
    then this rank's 'model' slice, chunked inside its 'model' coordinate;
    None where no other axis is left)."""
    mesh, names = like.device_mesh, like.device_mesh.mesh_dim_names
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return mesh, like.placements
    keep = tuple(n for n in names if n != "model")
    placements = tuple(pl for n, pl in zip(names, like.placements) if n != "model")
    return (mesh[keep] if keep else None), placements


def _chunk(t: torch.Tensor, mesh: Optional[DeviceMesh], placements) -> torch.Tensor:
    """This rank's chunk of ``t`` (the same on every rank of ``mesh``) laid
    out by ``placements``; ``mesh`` None: ``t``."""
    if mesh is None:
        return t
    return distribute_tensor(t, mesh, placements, src_data_rank=None).to_local()


@torch.no_grad()
def zero1_adamw_update(model: nn.Module, grads: Mapping[str, torch.Tensor],
                       state: Dict, shardings: Dict, mesh: DeviceMesh,
                       cfg: AdamWConfig) -> Tuple[nn.Module, Dict, torch.Tensor]:
    """``adamw_update`` over the ZeRO-1 state of ``distribute_opt_state``.
    ``grads`` are already averaged over the data-parallel ranks, so the
    norm and the clip scale are the same everywhere. Where 'model' has one
    rank, ``model`` and ``grads`` are whole on every rank; with more, they
    are this rank's part (``tp.split_model``), a split leaf its 'model'
    slice. Each rank updates its chunks of ``m``, ``v`` and ``master`` with
    ``adamw_update``'s arithmetic; each parameter (or its 'model' slice) is
    then gathered from the chunks of the ranks that hold it, over the axes
    but 'model', and a layer given to one coordinate of a stack axis is
    broadcast from there along it. A mesh of one device, or of one rank on
    every axis but 'model', communicates nothing here."""
    params = dict(model.named_parameters())
    step = state["step"].to_local() + 1
    mg = tp.model_group(mesh)
    split = [any("model" in _axes_of(a) for a in shardings["m"][n].spec) for n in grads]
    gnorm, scale, bc1, bc2 = _scalars(grads.values(), step, cfg, mg, split)
    for name, p in params.items():
        m = state["m"][name]
        held = m.device_mesh
        if held.get_coordinate() is not None:
            zmesh, zplace = _zero_layout(m)
            w = (state["master"][name].to_local() if "master" in state
                 else _chunk(p, zmesh, zplace))
            gather = not (zmesh is None or zmesh.size() == 1)
            # the new chunk of p (rounded to its dtype): p itself, or gathered after
            wp = torch.empty(w.shape, dtype=p.dtype, device=p.device) if gather else p
            _update(_chunk(grads[name], zmesh, zplace), m.to_local(),
                    state["v"][name].to_local(), w, [w, wp], scale, bc1, bc2, cfg)
            if gather:
                p.copy_(DTensor.from_local(wp, zmesh, zplace, shape=p.shape,
                                           stride=p.stride()).full_tensor())
            del wp
        sh = shardings["m"][name]
        if sh.stack is not None and mesh.size() > 1:
            dist.broadcast(p, group=mesh.get_group(sh.stack), group_src=sh.owner(mesh))
    state["step"] = distribute(step, shardings["step"], mesh)
    return model, state, gnorm
