"""xLSTM blocks: mLSTM (matrix memory, chunkwise prefill) and sLSTM.

Port of ``src/repro/models/xlstm.py``. Parameters keep the JAX layouts
(``x_up`` (D, 2, Di), the block-diagonal ``x_q``/``x_k``/``x_v`` (Di/4, 4, 4),
``x_if`` (Di, 2H) fp32, ``s_gates`` (D, 4, D) fp32, ``s_rec`` (4, H, Dh, Dh)
fp32), so a JAX tree converts by a plain copy.

mLSTM over a full sequence runs ``mlstm_chunk``: the Hopper kernel on the
card, its plain version on the CPU; where a graph is built (grad enabled and
an input or a parameter requiring it) the card's call goes through
``MLSTMChunkFunction``, whose gradient is the Hopper backward kernel. One
decode step (S = 1 with a state) is the O(1) recurrence in plain PyTorch,
the reference's chunk body at chunk 1. sLSTM is a loop over time steps in
plain PyTorch, and its gradient autograd through that loop; the JAX package
has no kernel for it. A block given a state updates it in place and returns
the same dict; so a block given a state while building a graph raises
(the in-place update would overwrite what autograd saved): train with no
state and ``want_state``.

Under a split over 'model' (``tp.channel_group`` of ``x_up``) a rank holds its Di/m
channels of ``x_up``, its blocks of ``x_q``/``x_k``/``x_v`` and its rows of
``x_if`` and ``x_out``, as the reference's rules lay them out: x enters
through ``copy_to_model``, u, z, q, k and v are the rank's channels, the
gates come whole from ``x_if``'s partial sums (``tp.reduce_to_model``: each
rank reads them in part), and ``x_out``'s partial sums leave through
``reduce_from_model``. Heads are contiguous Dh slices of Di, so where
'model' divides H a rank's channels are its H/m heads: the mLSTM (the
kernel on the card, forward and backward) runs those, and its state holds
them. Where it does not, q, k and v are made whole (``tp.gather_channels``),
every rank runs all H heads and keeps its own channels of h, and its state
holds all H heads: the reference's replicated heads
(``src/repro/models/xlstm.py:120-127``). The sLSTM stays whole on every
rank (its ``s_*`` leaves replicated by the rules), computed alike, with no
collective.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp
from ..kernels.mlstm_chunk import init_state, mlstm_chunk
from .config import ModelConfig
from .layers import check_no_graph, copy_into, dense_init, pdtype

QKV_BLOCK = 4  # xLSTM block-diagonal qkv projection block size

State = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    """mLSTM inner dims (proj factor 2)."""
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // cfg.n_heads


def _sdims(cfg: ModelConfig) -> Tuple[int, int]:
    """sLSTM inner dims (proj factor 1)."""
    return cfg.d_model, cfg.d_model // cfg.n_heads


# ===================================================================== mLSTM
class MLSTM(nn.Module):
    """``x_up``, ``x_q``, ``x_k``, ``x_v``, ``x_if``, ``x_out``; see
    ``init_mlstm``."""

    def __init__(self, x_up, x_q, x_k, x_v, x_if, x_out) -> None:
        super().__init__()
        self.x_up, self.x_q, self.x_k, self.x_v = x_up, x_q, x_k, x_v
        self.x_if, self.x_out = x_if, x_out


def init_mlstm(gen: Optional[torch.Generator], cfg: ModelConfig, device) -> MLSTM:
    Di, _ = _dims(cfg)
    D, H = cfg.d_model, cfg.n_heads
    dt = pdtype(cfg)
    nb = Di // QKV_BLOCK
    blk = (nb, QKV_BLOCK, QKV_BLOCK)
    return MLSTM(
        dense_init(gen, (D, 2, Di), dtype=dt, device=device),
        dense_init(gen, blk, std=0.3, dtype=dt, device=device),
        dense_init(gen, blk, std=0.3, dtype=dt, device=device),
        dense_init(gen, blk, std=0.3, dtype=dt, device=device),
        dense_init(gen, (Di, 2 * H), std=0.1, dtype=torch.float32, device=device),
        dense_init(gen, (Di, D), std=0.02 / (2 * cfg.n_layers) ** 0.5, dtype=dt,
                   device=device))


def mlstm_sequence(q, k, v, li, lf, state: Optional[State] = None,
                   chunk: int = 64, impl: Optional[str] = None):
    """q, k, v: (B,H,S,Dh) fp32; li, lf: (B,H,S). The chunkwise scan through
    the kernel's wrapper; returns (h, state). Unlike the reference, S need not
    be a multiple of the chunk."""
    return mlstm_chunk(q.contiguous(), k.contiguous(), v.contiguous(),
                       li.contiguous(), lf.contiguous(), chunk=chunk,
                       state=state, impl=impl)


def mlstm_step(q, k, v, li, lf, state: State) -> torch.Tensor:
    """One decode step: q, k, v (B,H,1,Dh); li, lf (B,H,1). The reference's
    chunk body at chunk 1: h from the state before the step plus the step's
    own term; the state is updated in place. Returns h (B,H,1,Dh)."""
    C, n, m0 = state["C"], state["n"], state["m"]
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]          # (B,H,Dh)
    li, lf = li[..., 0], lf[..., 0]                       # (B,H)
    m = torch.maximum(lf + m0, li)
    f = torch.exp(lf + m0 - m)[..., None]                 # weight of the state
    i = torch.exp(li - m)[..., None]                      # weight of this step
    qC = (q[:, :, None, :] @ C)[:, :, 0]
    h_num = i * (q * k).sum(-1, keepdim=True) * v + f * qC
    den = (q * (i * k + f * n)).sum(-1, keepdim=True).abs()
    h = h_num / torch.maximum(den, torch.exp(-m)[..., None])
    C.mul_(f[..., None]).add_((i * k)[..., :, None] * v[..., None, :])
    n.mul_(f).add_(i * k)
    m0.copy_(m)
    return h[:, :, None]


def _heads_split(cfg: ModelConfig, mg: Optional[tp.ModelGroup]) -> bool:
    """Whether a rank's channels are whole heads it runs alone: 'model'
    splits the channels and divides H."""
    return mg is not None and cfg.n_heads % mg.size == 0


def apply_mlstm(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[State] = None, want_state: bool = False,
                chunk: int = 64, impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B,S,D). With a state and S = 1 it runs one decode step; otherwise
    the chunkwise scan (``impl`` is passed to the kernel's wrapper). A given
    state is updated in place, and refused where a graph is built;
    ``want_state`` returns the final state. Under a split over 'model', the
    rank's channels and heads as the module's docstring says."""
    check_no_graph(state, x, p)
    Di, Dh = _dims(cfg)
    B, S, D = x.shape
    H = cfg.n_heads
    mg = tp.channel_group("x_up", (D, 2, Di))
    x = tp.copy_to_model(x, mg)
    uz = torch.einsum("bsd,dti->bsti", x, p.x_up)
    u, z = uz[:, :, 0], uz[:, :, 1]                          # the rank's Di/m
    Di = u.shape[-1]
    ub = u.reshape(B, S, Di // QKV_BLOCK, QKV_BLOCK)

    def blockproj(w):
        # heads are contiguous Dh slices of Di, as in the reference
        return torch.einsum("bsnc,ncd->bsnd", ub, w).reshape(B, S, Di)

    q, k, v = (blockproj(w).float() for w in (p.x_q, p.x_k, p.x_v))
    gates = tp.reduce_to_model(torch.einsum("bsi,ig->bsg", u.float(), p.x_if), mg)
    li, lf = gates[..., :H], gates[..., H:]                  # (B,S,H)
    if _heads_split(cfg, mg):                                # the rank's heads
        Hl = H // mg.size
        li, lf = li.narrow(-1, mg.rank * Hl, Hl), lf.narrow(-1, mg.rank * Hl, Hl)
    elif mg is not None:                                     # every head, made whole
        q, k, v = (tp.gather_channels(t, mg) for t in (q, k, v))
    Hr = q.shape[-1] // Dh
    q, k, v = (t.reshape(B, S, Hr, Dh).transpose(1, 2) for t in (q, k, v))
    k = k * Dh ** -0.5
    li, lf = li.transpose(1, 2), F.logsigmoid(lf).transpose(1, 2)   # (B,Hr,S)
    if state is not None and S == 1:
        h, new_state = mlstm_step(q, k, v, li, lf, state), state
    else:
        h, new_state = mlstm_sequence(q, k, v, li, lf, state, chunk, impl)
        if state is not None:
            new_state = copy_into(state, new_state)
    h = h.transpose(1, 2).reshape(B, S, Hr * Dh)
    if h.shape[-1] != Di:                                    # the rank's channels of h
        h = h.narrow(-1, mg.rank * Di, Di)
    out = h.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = tp.reduce_from_model(torch.einsum("bsi,id->bsd", out, p.x_out), mg)
    keep = state is not None or want_state
    return out, (new_state if keep else None)


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> State:
    """The zero state of the heads this rank runs: all H, or under a split
    over 'model' that divides them, its H/m."""
    Di, Dh = _dims(cfg)
    mg = tp.channel_group("x_up", (cfg.d_model, 2, Di))
    H = cfg.n_heads // mg.size if _heads_split(cfg, mg) else cfg.n_heads
    return init_state(batch, H, Dh, device)


# ===================================================================== sLSTM
class SLSTM(nn.Module):
    """``s_gates``, ``s_rec``, ``s_out``; see ``init_slstm``."""

    def __init__(self, s_gates, s_rec, s_out) -> None:
        super().__init__()
        self.s_gates, self.s_rec, self.s_out = s_gates, s_rec, s_out


def init_slstm(gen: Optional[torch.Generator], cfg: ModelConfig, device) -> SLSTM:
    Di, Dh = _sdims(cfg)
    D, H = cfg.d_model, cfg.n_heads
    return SLSTM(
        dense_init(gen, (D, 4, Di), dtype=torch.float32, device=device),
        dense_init(gen, (4, H, Dh, Dh), std=Dh ** -0.5, dtype=torch.float32,
                   device=device),
        dense_init(gen, (Di, D), std=0.02 / (2 * cfg.n_layers) ** 0.5,
                   dtype=pdtype(cfg), device=device))


def apply_slstm(p: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[State] = None, want_state: bool = False,
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B,S,D); a loop over the S steps, all in fp32. A given state is
    updated in place, and refused where a graph is built; ``want_state``
    returns the final state."""
    check_no_graph(state, x, p)
    Di, Dh = _sdims(cfg)
    B, S, D = x.shape
    H = cfg.n_heads
    pre = torch.einsum("bsd,dgi->bsgi", x.float(),
                       p.s_gates).reshape(B, S, 4, H, Dh)
    s0 = init_slstm_state(cfg, B, x.device) if state is None else state
    c, n, h, m = s0["sc"], s0["sn"], s0["sh"], s0["sm"]
    # s_rec as (H, Dh, 4 Dh), so each step's recurrence is one batched product
    R = p.s_rec.permute(1, 2, 0, 3).reshape(H, Dh, 4 * Dh)
    hs = []
    for t in range(S):
        rec = torch.bmm(h.transpose(0, 1), R).reshape(H, B, 4, Dh).permute(1, 2, 0, 3)
        zi, zf, zz, zo = (pre[:, t, g] + rec[:, g] for g in range(4))
        lf = F.logsigmoid(zf)
        m_new = torch.maximum(lf + m, zi)
        i_ = torch.exp(zi - m_new)
        f_ = torch.exp(lf + m - m_new)
        c = f_ * c + i_ * torch.tanh(zz)
        n = f_ * n + i_
        h = torch.sigmoid(zo) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, Di).to(x.dtype)
    out = torch.einsum("bsi,id->bsd", out, p.s_out)
    new_state = {"sc": c, "sn": n, "sh": h, "sm": m}
    if state is not None:
        return out, copy_into(state, new_state)
    return out, (new_state if want_state else None)


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> State:
    """c = h = 0, n = 1 and m = 0, as the reference starts (not -1e30)."""
    _, Dh = _sdims(cfg)
    shape = (batch, cfg.n_heads, Dh)
    return {"sc": torch.zeros(shape, device=device),
            "sn": torch.ones(shape, device=device),
            "sh": torch.zeros(shape, device=device),
            "sm": torch.zeros(shape, device=device)}
