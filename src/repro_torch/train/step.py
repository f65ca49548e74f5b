"""Train-step builder: microbatch gradient accumulation, AdamW, low-precision grads.

Port of ``src/repro/train/step.py:22``. The batch splits into ``accum``
microbatches along its first axis; each microbatch's gradient is taken by
autograd (on the card the attention and mLSTM gradients are their backward
kernels), added to an accumulator in ``grad_dtype``, and the sum is scaled
by ``1 / accum`` in that dtype before ``adamw_update``. Activation memory is
one microbatch's, as the reference's ``lax.scan`` keeps it.
``make_zero1_train_step`` is the same step under a mesh,
data parallel with the optimizer state sharded (ZeRO-1), and tensor
parallel over the mesh's 'model' axis (``distributed/tp.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..distributed.context import use_mesh
from ..models.config import ModelConfig
from ..models.lm import LM, loss_fn
from .optimizer import AdamWConfig, adamw_update, zero1_adamw_update

# What two computations of one step are held to: this port against the
# reference, or the kernels against their plain versions. fp32: loss, grad
# norm and every updated parameter to 1e-5 (the sums' order only). bf16:
# activations and gradients round to bf16 at different places. Adam's first
# step moves each weight by about lr times the sign of its gradient, so where
# a gradient is near 0 the two can step opposite ways: each tensor's update
# must agree to within lr / 2 on most of its elements, and the updated
# parameters as a whole to a relative RMS of 1e-2; loss and grad norm to 1e-2.
STEP_TOL = 1e-5
BF16_STEP_TOL = {"loss": 1e-2, "grad_norm": 1e-2, "update_agree": 0.95,
                 "params_rel_rms": 1e-2}


def _grads(cfg: ModelConfig, model: LM, batch: Dict[str, torch.Tensor], accum: int,
           gdt: torch.dtype, attn_impl: Optional[str], mlstm_impl: Optional[str]):
    """``(names, grads, loss)``: the mean loss over ``batch`` in ``accum``
    microbatches and its gradient, added in ``gdt``."""
    names, params = zip(*model.named_parameters())
    if accum == 1:
        loss, _ = loss_fn(cfg, model, batch, attn_impl=attn_impl, mlstm_impl=mlstm_impl)
        return names, [g.to(gdt) for g in torch.autograd.grad(loss, params)], loss.detach()
    b = next(iter(batch.values())).shape[0]
    mbs = {key: x.reshape((accum, b // accum) + x.shape[1:]) for key, x in batch.items()}
    grads = [torch.zeros(p.shape, dtype=gdt, device=p.device) for p in params]
    loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for i in range(accum):
        mb_loss, _ = loss_fn(cfg, model, {key: x[i] for key, x in mbs.items()},
                             attn_impl=attn_impl, mlstm_impl=mlstm_impl)
        for acc, g in zip(grads, torch.autograd.grad(mb_loss, params)):
            acc.add_(g.to(gdt))
        loss = loss + mb_loss.detach()
    inv = 1.0 / accum
    for g in grads:                       # in place: one set of grads
        g.mul_(torch.tensor(inv, dtype=gdt, device=g.device))
    return names, grads, loss * inv


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, accum: int = 1,
                    grad_dtype: str = "bfloat16", attn_impl: Optional[str] = None,
                    mlstm_impl: Optional[str] = None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    {"loss", "grad_norm"})``, updating the model and state in place.
    ``attn_impl="plain"`` and ``mlstm_impl="plain"`` take attention and the
    mLSTM scan, and their gradients, through the kernels' plain versions."""
    gdt = getattr(torch, grad_dtype)

    def train_step(model: LM, opt_state: Dict, batch: Dict[str, torch.Tensor]):
        names, grads, loss = _grads(cfg, model, batch, accum, gdt, attn_impl, mlstm_impl)
        model, opt_state, gnorm = adamw_update(model, dict(zip(names, grads)),
                                               opt_state, opt_cfg)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def data_parallel_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh axes a batch is split over: 'pod' and 'data', where present."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def local_batch(batch: Dict[str, torch.Tensor], mesh: DeviceMesh,
                accum: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global ``batch`` of ``accum`` microbatches, the
    reference's ``split_batch`` (``src/repro/train/step.py:25-30``): the
    batch cut into ``accum`` microbatches of b / accum rows, each split over
    'pod' and 'data' (major to minor), whole along 'model'. Data rank r of
    n holds rows i b / accum + r b / (accum n) on to the next rank's of
    microbatch i, the microbatches in order, so that ``_grads``' cut of the
    rank's b / n rows into ``accum`` gives each microbatch's own rows."""
    n, i = 1, 0
    for a in data_parallel_axes(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(a))
        n, i = n * size, i * size + mesh.get_local_rank(a)
    if n == 1:
        return batch
    return {key: x.reshape((accum, n, x.shape[0] // (accum * n)) + x.shape[1:])[:, i]
            .reshape((x.shape[0] // n,) + x.shape[1:]) for key, x in batch.items()}


def make_zero1_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh: DeviceMesh,
                          shardings: Dict, grad_dtype: str = "bfloat16", accum: int = 1):
    """ZeRO-1 data parallelism and tensor parallelism on ``mesh``:
    ``train_step(model, opt_state, batch)`` with ``batch`` this rank's rows
    of ``accum`` microbatches (``local_batch(batch, mesh, accum)``, whole
    along 'model') and ``opt_state`` the DTensors of ``zero1_adamw_init``
    (or ``distribute_opt_state``) laid out by ``shardings``
    (``opt_state_shardings`` of the whole model). The rank's gradient is
    ``_grads``': ``accum`` microbatches, each of its own rows, added in
    ``grad_dtype`` and scaled by 1 / accum, as ``make_train_step`` takes
    them on one rank. Where 'model'
    has one rank the parameters are whole on every rank; with more, the
    model is this rank's part (``tp.split_model``): the step runs under
    ``use_mesh(mesh, local_rows=True)``, so the forward and backward are
    split over 'model' and each gradient is that of the rank's slice of its
    parameter (every block kind; ``tp.check_split`` refuses only the splits
    that straddle, ROADMAP item 7d), and an MoE takes
    its token groups and router loss over the global batch (``moe.py``).
    The gradients and the loss are averaged in fp32 over the 'pod' and 'data' ranks;
    ``zero1_adamw_update`` updates the state's chunks and gathers each
    parameter's slice. With one rank on every axis nothing is averaged, and
    the step's numbers are ``make_train_step``'s."""
    gdt = getattr(torch, grad_dtype)
    groups = [mesh.get_group(a) for a in data_parallel_axes(mesh)
              if mesh.size(mesh.mesh_dim_names.index(a)) > 1]

    def average(t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        for g in groups:
            dist.all_reduce(t, group=g)
        return t / math.prod(dist.get_world_size(g) for g in groups)

    def train_step(model: LM, opt_state: Dict, batch: Dict[str, torch.Tensor]):
        with use_mesh(mesh, local_rows=True):
            names, grads, loss = _grads(cfg, model, batch, accum, gdt, None, None)
        if groups:
            grads = [average(g).to(gdt) for g in grads]
            loss = average(loss)
        model, opt_state, gnorm = zero1_adamw_update(
            model, dict(zip(names, grads)), opt_state, shardings, mesh, opt_cfg)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
