"""Mamba selective-SSM mixer (jamba's): a depthwise causal conv, then a
selective scan over the sequence.

Port of ``src/repro/models/ssm.py``. Parameters keep the JAX names and
layouts: ``m_in`` (D, 2, Di), ``m_conv`` (W, Di), ``m_xproj`` (Di, dt_rank +
2N), ``m_dt`` (dt_rank, Di), ``m_dtb`` and ``m_d`` (Di,) in the parameter
dtype, ``m_alog`` (Di, N) in fp32 whatever the parameter dtype, and
``m_out`` (Di, D); so a JAX tree converts by a plain copy.

With no state, the scan h_t = dA_t h_{t-1} + dBx_t runs log-depth
(``selective_scan``: ceil(log2 S) steps of whole-tensor fp32 products with
the reference's combine, no loop over S). The reference leaves its
``associative_scan`` to XLA, with no Pallas kernel; here it is plain
PyTorch too. Given a state (decode, S typically 1) it runs the recurrence
step by step as the reference does (``ssm_recurrence``) and updates the
state in place, so a state given where a graph is built raises. The
rounding points are the reference's: the conv and u in the parameter dtype,
the scan, y and its gate in fp32, y rounded before ``m_out``.

Under a split over 'model' (``tp.channel_group`` of ``m_in``) a rank holds its Di/m
channels of every ``m_*`` leaf, ``m_xproj`` and ``m_out`` by rows, as the
reference's rules lay them out (``src/repro/models/ssm.py:70``, ``:107``):
x enters through ``copy_to_model``, the conv, the scan and its decode state
run on the rank's channels, ``dt_in``, B and C come whole from ``m_xproj``'s
partial sums (``tp.reduce_to_model``: each rank reads them for its own
channels only, so their gradient is summed too), and ``m_out``'s partial
sums leave through ``reduce_from_model``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp
from .config import ModelConfig
from .layers import check_no_graph, copy_into, dense_init, pdtype

State = Dict[str, torch.Tensor]


class Mamba(nn.Module):
    """``m_in``, ``m_conv``, ``m_xproj``, ``m_dt``, ``m_dtb``, ``m_alog``,
    ``m_d``, ``m_out``; see ``init_mamba``."""

    def __init__(self, m_in, m_conv, m_xproj, m_dt, m_dtb, m_alog, m_d, m_out) -> None:
        super().__init__()
        self.m_in, self.m_conv, self.m_xproj, self.m_dt = m_in, m_conv, m_xproj, m_dt
        self.m_dtb, self.m_alog, self.m_d, self.m_out = m_dtb, m_alog, m_d, m_out


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, dt_rank, d_state)."""
    c = cfg.mamba
    return c.expand * cfg.d_model, c.dt_rank or max(1, cfg.d_model // 16), c.d_state


def _fixed(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def init_mamba(gen: Optional[torch.Generator], cfg: ModelConfig, device) -> Mamba:
    """Random projections from ``gen`` in the reference's order; ``m_dtb``
    (softplus^-1 of 0.01), ``m_alog`` (S4's A = -[1..N] per channel) and
    ``m_d`` are the reference's constants."""
    Di, dtr, N = _dims(cfg)
    D, W = cfg.d_model, cfg.mamba.conv_width
    dt = pdtype(cfg)
    m_in = dense_init(gen, (D, 2, Di), dtype=dt, device=device)
    m_conv = dense_init(gen, (W, Di), std=0.1, dtype=dt, device=device)
    m_xproj = dense_init(gen, (Di, dtr + 2 * N), dtype=dt, device=device)
    m_dt = dense_init(gen, (dtr, Di), std=dtr ** -0.5, dtype=dt, device=device)
    m_out = dense_init(gen, (Di, D), std=0.02 / (2 * cfg.n_layers) ** 0.5, dtype=dt,
                       device=device)
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return Mamba(m_in, m_conv, m_xproj, m_dt,
                 _fixed(torch.full((Di,), -4.6, dtype=dt, device=device)),
                 _fixed(torch.log(a).expand(Di, N).clone()),
                 _fixed(torch.ones(Di, dtype=dt, device=device)), m_out)


def init_mamba_state(cfg: ModelConfig, batch: int, device) -> State:
    """``ssm`` (B, Di, N) fp32 and ``conv`` (B, W-1, Di) in the parameter
    dtype, zero; under a split over 'model', of the rank's Di/m channels."""
    Di, _, N = _dims(cfg)
    mg = tp.channel_group("m_in", (cfg.d_model, 2, Di))
    Di = Di if mg is None else Di // mg.size
    W = cfg.mamba.conv_width
    return {"ssm": torch.zeros(batch, Di, N, dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, W - 1, Di, dtype=pdtype(cfg), device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, Di), w: (W, Di). Returns (out, the
    last W-1 input rows (B, W-1, Di)): a prompt shorter than W-1 keeps part
    of the state it was given. Summed in x's dtype as the reference's Python
    ``sum`` of W shifted products, in the same order."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros(x.shape[0], W - 1, x.shape[2])
    xp = torch.cat([state, x], dim=1)                    # (B, S+W-1, Di)
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return out, xp[:, -(W - 1):]


def selective_scan(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """Every h_t of h_t = dA_t h_{t-1} + dBx_t over dim 1 from h = 0, for
    any S: a Hillis-Steele scan whose step at offset d combines position t
    with t - d as the reference's ``(a1 a2, b1 a2 + b2)``, ceil(log2 S)
    steps of whole-tensor products; out of place, so autograd runs through
    it."""
    a, b = dA, dBx
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        if 2 * d < S:                    # the last step needs no new a
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def ssm_recurrence(dA: torch.Tensor, dBx: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The reference's decode: h_t = dA_t h_{t-1} + dBx_t step by step from
    ``h`` (B, Di, N); returns every h_t (B, S, Di, N)."""
    hs = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def apply_mamba(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[State] = None, want_state: bool = False,
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, D). With no state the log-depth scan; ``want_state``
    returns the final ``{"ssm", "conv"}``. With a state (decode) the
    recurrence, the state updated in place and returned (refused where a
    graph is built)."""
    check_no_graph(state, x, p)
    Di, dtr, N = _dims(cfg)
    mg = tp.channel_group("m_in", (cfg.d_model, 2, Di))
    x = tp.copy_to_model(x, mg)
    xz = torch.einsum("bsd,dti->bsti", x, p.m_in)         # (B,S,2,Di): the rank's Di/m
    x_in, z = xz[:, :, 0], xz[:, :, 1]
    x_c, new_conv = _causal_conv(x_in, p.m_conv, None if state is None else state["conv"])
    u = F.silu(x_c.float()).to(x.dtype)

    dbc = tp.reduce_to_model(torch.einsum("bsi,ir->bsr", u, p.m_xproj), mg)  # (B,S,dtr+2N)
    dt_in, Bc, Cc = torch.split(dbc, [dtr, N, N], dim=-1)
    dt = F.softplus(torch.einsum("bsr,ri->bsi", dt_in, p.m_dt).float()
                    + p.m_dtb.float())                    # (B,S,Di)
    A = -torch.exp(p.m_alog)                              # (Di,N)
    dA = torch.exp(dt[..., None] * A)                     # (B,S,Di,N)
    dBx = (dt * u.float())[..., None] * Bc[:, :, None, :].float()

    if state is None:
        h = selective_scan(dA, dBx)
        new_state = ({"ssm": h[:, -1], "conv": new_conv.contiguous()}
                     if want_state else None)
    else:
        h = ssm_recurrence(dA, dBx, state["ssm"])
        new_state = copy_into(state, {"ssm": h[:, -1], "conv": new_conv})

    y = torch.einsum("bsin,bsn->bsi", h, Cc.float())
    y = y + p.m_d.float() * u.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return tp.reduce_from_model(torch.einsum("bsi,id->bsd", y, p.m_out), mg), new_state
