"""Shared layer primitives: init helpers, RMSNorm, RoPE, SwiGLU MLP.

Port of ``src/repro/models/layers.py``. Parameters keep the JAX einsum
layouts (``w_in``/``w_gate`` (D, F), ``w_out`` (F, D)), so a JAX parameter
tree converts by a plain copy. An ``init_*`` function given a
``torch.Generator`` draws its weights from it; given ``None`` it leaves them
uninitialised for the converter to fill. Parameters are made frozen;
``lm.init_params(..., trainable=True)`` unfreezes the model for training.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp
from .config import ModelConfig


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Asking for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def dense_init(gen: Optional[torch.Generator], shape, std: float = 0.02,
               dtype: torch.dtype = torch.bfloat16, device=None) -> nn.Parameter:
    """normal * std drawn in fp32 from ``gen``, cast to ``dtype``. Drawn and
    scaled in place: one fp32 temporary, where ``randn(...) * std`` held two
    (24 GiB at once for one of jamba's expert tensors), the same bits."""
    if gen is None:
        w = torch.empty(shape, dtype=dtype, device=device)
    else:
        w = torch.empty(shape, dtype=torch.float32, device=device).normal_(
            generator=gen).mul_(std).to(dtype)
    return nn.Parameter(w, requires_grad=False)


def check_no_graph(state: Optional[Dict[str, torch.Tensor]], x: torch.Tensor,
                   p: nn.Module) -> None:
    """A recurrent block's state is updated in place: refuse one where a
    graph is built."""
    if state is not None and torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in p.parameters())
            or any(t.requires_grad for t in state.values())):
        raise ValueError("a state given to a recurrent block (xLSTM, Mamba) is "
                         "updated in place, which would break the graph autograd "
                         "builds: pass no state under grad (want_state returns "
                         "the final one), or run under torch.no_grad()")


def copy_into(state: Dict[str, torch.Tensor],
              new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy ``new`` into ``state``'s tensors; returns ``state``."""
    for key, t in new.items():
        state[key].copy_(t)
    return state


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, Dh); positions: (S,). Halves, not interleaved; fp32 angles."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (Dh/2,)
    angles = positions[..., :, None].float() * freqs           # (S, Dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- SwiGLU MLP
class MLP(nn.Module):
    """``w_in``, ``w_gate`` (gated only) and ``w_out``; see ``init_mlp``."""

    def __init__(self, w_in: nn.Parameter, w_out: nn.Parameter,
                 w_gate: Optional[nn.Parameter] = None) -> None:
        super().__init__()
        self.w_in = w_in
        self.w_gate = w_gate
        self.w_out = w_out


def init_mlp(gen: Optional[torch.Generator], cfg: ModelConfig, device,
             d_ff: int = 0) -> MLP:
    d_ff = d_ff or cfg.d_ff
    dt = pdtype(cfg)
    w_in = dense_init(gen, (cfg.d_model, d_ff), dtype=dt, device=device)
    w_gate = (dense_init(gen, (cfg.d_model, d_ff), dtype=dt, device=device)
              if cfg.mlp_gated else None)
    w_out = dense_init(gen, (d_ff, cfg.d_model),
                       std=0.02 / (2 * cfg.n_layers) ** 0.5, dtype=dt,
                       device=device)
    return MLP(w_in, w_out, w_gate)


def apply_mlp(p: MLP, x: torch.Tensor, mg: Optional[tp.ModelGroup] = None) -> torch.Tensor:
    """The gated (SwiGLU) or 2-matrix GELU MLP. ``mg``, the 'model' group
    where the rules split d_ff (``tp.ff_group``): x enters this rank's d_ff
    slice through ``copy_to_model`` (``w_in``/``w_gate`` column-parallel,
    the reference's ``src/repro/models/layers.py:67``) and ``w_out``'s
    partial sums leave through ``reduce_from_model`` (row-parallel)."""
    x = tp.copy_to_model(x, mg)
    h = torch.einsum("bsd,df->bsf", x, p.w_in)
    if p.w_gate is not None:
        g = torch.einsum("bsd,df->bsf", x, p.w_gate)
        h = h * F.silu(g.float()).to(h.dtype)
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return tp.reduce_from_model(torch.einsum("bsf,fd->bsd", h, p.w_out), mg)


def init_norm(cfg: ModelConfig, device) -> nn.Parameter:
    """An RMSNorm scale, zero: the norm scales by ``1 + scale``."""
    return nn.Parameter(torch.zeros(cfg.d_model, dtype=pdtype(cfg), device=device),
                        requires_grad=False)
