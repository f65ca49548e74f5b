"""AdamW over the model's named parameters, with optional low-precision moments.

Port of ``src/repro/train/optimizer.py:26-81``: fp32 master weights (the
model's parameters stay in their compute dtype, bf16 for the real configs),
m and v in fp32 or bf16 (``moments_dtype``), global-norm clipping, bias
correction and decoupled weight decay. The state is a dict of tensors keyed
by ``model.named_parameters()`` names: ``{"m": {...}, "v": {...}, "master":
{...}, "step": int32 scalar}``. Unlike the reference, which returns new
arrays, ``adamw_update`` updates the parameters and the state in place
under ``no_grad`` (it holds no second copy of an 8 B-parameter state).
ZeRO-1 sharding of the state (``opt_state_shardings``) waits for the
distributed port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
from torch import nn


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


@torch.no_grad()
def adamw_update(model: nn.Module, grads: Mapping[str, torch.Tensor], state: Dict,
                 cfg: AdamWConfig) -> Tuple[nn.Module, Dict, torch.Tensor]:
    """One AdamW step with ``grads`` (keyed like ``model.named_parameters()``)
    clipped to global norm ``cfg.clip_norm``. Updates the parameters and
    ``state`` in place and returns ``(model, state, grad_norm)``, the norm
    taken before clipping, as the reference returns it."""
    params = dict(model.named_parameters())
    step = state["step"] + 1
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device) ** stepf
    bc2 = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device) ** stepf
    mdt = getattr(torch, cfg.moments_dtype)
    masters = state.get("master", params)
    for name, p in params.items():
        g = grads[name].float() * scale
        m32 = state["m"][name].float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = state["v"][name].float() * cfg.b2 + g.square() * (1 - cfg.b2)
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        w32 = masters[name].float()
        w32 = w32 - cfg.lr * (u + cfg.weight_decay * w32)
        p.copy_(w32)                                  # rounds to the param dtype
        state["m"][name].copy_(m32.to(mdt))
        state["v"][name].copy_(v32.to(mdt))
        if "master" in state:
            state["master"][name].copy_(w32)
    state["step"] = step
    return model, state, gnorm


def opt_state_shardings(*args, **kwargs):
    """The reference's ZeRO-1 state shardings (``optimizer.py:84``) need the
    distributed port."""
    raise NotImplementedError("ZeRO-1 optimizer-state sharding is not ported yet "
                              "(ROADMAP.md Queue 1 item 7)")
