"""Top-k MoE with group-local capacity dispatch.

Port of ``src/repro/models/moe.py``. Parameters keep the JAX layouts:
``router`` (D, E) fp32, ``e_in``/``e_gate`` (E, D, F), ``e_out`` (E, F, D),
E the padded expert count, and a ``shared`` SwiGLU MLP of width
``n_shared * d_expert`` when the config has shared experts. Padded experts
are masked to -1e30 in the router, so no token reaches them; their weights
take a zero gradient, as the reference's do.

``apply_moe`` is the reference's default "gather" dispatch: the tokens split
into G groups (``_groups``: the ambient mesh's 'pod' x 'data' where it
divides T, else the first of 16, 8, 4, 2 that does), and within each group
a stable sort by expert, a capacity of ``_capacity(T / G)`` slots an expert
with the later assignments dropped, a dispatch gather into (G, E, C, D), the
three expert products, and a combine gather whose K contributions are summed
in order. The same groups, capacity and stable order as the reference, so
the same assignments drop. On a rank that holds only its own rows
(``use_mesh(..., local_rows=True)``, the ZeRO-1 step) those rows are one of
the reference's groups, and the router's aux loss is taken over the global
batch (``tp.sum_over_data``). ``cfg.moe_dispatch == "scatter"`` runs
``_apply_moe_scatter``, the reference's ablation with one global capacity.

Under a split over 'model' that cuts the experts (``tp.expert_group``) the
router stays whole: every rank routes every token alike from the same
inputs, then gathers only its own experts' slots (a (G, E/m, C, D) buffer),
runs its experts, combines their contributions and sums the partial outputs
over 'model' once. The shared experts split on their own width
(``tp.shared_group``).

Both gathers are permutations with drops, so each one's transpose is a
gather too (``_PermutationGather``): the backward sums a fixed number of
gathered rows in a fixed order and adds nothing atomically, so it gives the
same bits on every run. The reference leaves the dispatch and the expert
products to XLA (no Pallas kernel); here they are plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp
from ..distributed.context import axis_size, local_rows
from .config import ModelConfig
from .layers import MLP, apply_mlp, dense_init, init_mlp, pdtype


class MoE(nn.Module):
    """``router``, ``e_in``, ``e_gate``, ``e_out`` and, with shared experts,
    the ``shared`` MLP; see ``init_moe``."""

    def __init__(self, router: nn.Parameter, e_in: nn.Parameter,
                 e_gate: nn.Parameter, e_out: nn.Parameter,
                 shared: Optional[MLP] = None) -> None:
        super().__init__()
        self.router, self.e_in, self.e_gate, self.e_out = router, e_in, e_gate, e_out
        self.shared = shared


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig, device) -> MoE:
    m = cfg.moe
    E, D = cfg.n_experts_padded, cfg.d_model
    dt = pdtype(cfg)
    router = dense_init(gen, (D, E), std=0.006, dtype=torch.float32, device=device)
    e_in = dense_init(gen, (E, D, m.d_expert), dtype=dt, device=device)
    e_gate = dense_init(gen, (E, D, m.d_expert), dtype=dt, device=device)
    e_out = dense_init(gen, (E, m.d_expert, D), std=0.02 / (2 * cfg.n_layers) ** 0.5,
                       dtype=dt, device=device)
    shared = (init_mlp(gen, cfg, device, d_ff=m.n_shared * m.d_expert)
              if m.n_shared else None)
    return MoE(router, e_in, e_gate, e_out, shared)


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots an expert per group: counts the padded experts and rounds up to
    a multiple of 128, as the reference does."""
    m = cfg.moe
    c = int(tokens_per_group * m.top_k * m.capacity_factor / cfg.n_experts_padded)
    return max(64, ((c + 127) // 128) * 128)


def _groups(T: int) -> int:
    """The token groups of T tokens, as the reference picks them over the
    global batch: the ambient mesh's 'pod' x 'data' where it divides T
    (each data shard's rows one group), else the first of 16, 8, 4, 2 that
    does. On a rank holding its own rows (``local_rows``) T is its share of
    the global batch, which 'pod' x 'data' divides: its rows are one group."""
    if local_rows():
        return 1
    for cand in (axis_size("pod") * axis_size("data"), 16, 8, 4, 2):
        if cand > 1 and T % cand == 0:
            return cand
    return 1


def _route(xt: torch.Tensor, p: MoE, cfg: ModelConfig):
    """Router probabilities (..., E), the top-k gates renormalised and the
    experts' indices (..., K); fp32 logits, padded experts masked."""
    m = cfg.moe
    E = cfg.n_experts_padded
    logits = xt.float() @ p.router
    if E > m.n_experts:
        pad = torch.arange(E, device=xt.device) >= m.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, eidx


class _PermutationGather(torch.autograd.Function):
    """``out[g, i] = x[g, idx[g, i]]``, ``idx == N`` giving a zero row, where
    every row of x is read at most ``fan`` times. ``inv`` (G, N * fan) lists
    the rows of out that read each row of x (``M`` for none), so the
    gradient is a gather of those rows and a sum over ``fan`` in order."""

    @staticmethod
    def forward(ctx, x, idx, inv, fan: int):
        G, N, D = x.shape
        ctx.save_for_backward(inv)
        ctx.fan, ctx.n_out = fan, idx.shape[1]
        x_pad = torch.cat([x, x.new_zeros(G, 1, D)], dim=1)
        return torch.gather(x_pad, 1, idx[:, :, None].expand(-1, -1, D))

    @staticmethod
    def backward(ctx, dout):
        (inv,) = ctx.saved_tensors
        G, _, D = dout.shape
        d_pad = torch.cat([dout, dout.new_zeros(G, 1, D)], dim=1)
        dx = torch.gather(d_pad, 1, inv[:, :, None].expand(-1, -1, D))
        return dx.reshape(G, -1, ctx.fan, D).sum(2), None, None, None


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = cfg.n_experts_padded, m.top_k
    T = B * S
    xt = x.reshape(T, D)
    if cfg.moe_dispatch != "gather":
        return _apply_moe_scatter(p, x, xt, cfg)

    # ---- group-local dispatch ---------------------------------------------
    G = _groups(T)
    Tl = T // G
    C = _capacity(Tl, cfg)
    xg = xt.reshape(G, Tl, D)
    dev = x.device

    probs, gate, eidx = _route(xg, p, cfg)                     # (G,Tl,E/K)
    with torch.no_grad():
        flat_e = eidx.reshape(G, Tl * K)
        order = torch.argsort(flat_e, dim=-1, stable=True)     # (G, TlK)
        sorted_e = torch.gather(flat_e, 1, order)
        seg_start = torch.searchsorted(
            sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())   # (G, E)
        pos_in_e = (torch.arange(Tl * K, device=dev)[None, :]
                    - torch.gather(seg_start, 1, sorted_e))
        keep = pos_in_e < C
        src_tok = order // K                                   # (G, TlK)
        counts = torch.diff(seg_start, dim=-1, append=torch.full(
            (G, 1), Tl * K, dtype=seg_start.dtype, device=dev))   # (G, E)
        slot_s = seg_start[:, :, None] + torch.arange(C, device=dev)   # (G,E,C)
        valid = torch.arange(C, device=dev) < torch.clamp(counts, max=C)[:, :, None]
        sorted_at_slot = slot_s.clamp(0, Tl * K - 1).reshape(G, E * C)
        slot_tok = torch.where(valid.reshape(G, E * C),
                               torch.gather(src_tok, 1, sorted_at_slot), Tl)
        # the combine's map: each assignment's slot (E*C: dropped), in the
        # tokens' order; and its transpose, each slot's assignment
        slot_sorted = torch.where(keep, sorted_e * C + pos_in_e, E * C)   # (G,TlK)
        inv = torch.argsort(order, dim=-1)
        slot_orig = torch.gather(slot_sorted, 1, inv)
        slot_assign = torch.where(valid.reshape(G, E * C),
                                  torch.gather(order, 1, sorted_at_slot), Tl * K)
    mg = tp.expert_group(cfg)
    El = p.e_in.shape[0]                                       # this rank's experts
    if mg is not None:
        # this rank's experts' slots; every other assignment reads the zero row
        lo, n = mg.rank * El * C, El * C
        slot_tok, slot_assign = slot_tok[:, lo:lo + n], slot_assign[:, lo:lo + n]
        local = slot_orig - lo
        slot_orig = torch.where((local >= 0) & (local < n), local, n)
        # each rank's experts give only a part of these gradients
        xg, gate = tp.copy_to_model(xg, mg), tp.copy_to_model(gate, mg)
    ebuf = _PermutationGather.apply(xg, slot_tok, slot_orig, K).reshape(G, El, C, D)

    # ---- expert FFN ----------------------------------------------------------
    h = torch.einsum("gecd,edf->gecf", ebuf, p.e_in)
    g_ = torch.einsum("gecd,edf->gecf", ebuf, p.e_gate)
    h = h * F.silu(g_.float()).to(h.dtype)
    y = torch.einsum("gecf,efd->gecd", h, p.e_out)            # (G,El,C,D)

    # ---- combine: group-local gathers + unsort ------------------------------
    contrib = _PermutationGather.apply(y.reshape(G, El * C, D), slot_orig,
                                       slot_assign, 1)         # (G,TlK,D)
    contrib = contrib * gate.reshape(G, Tl * K, 1).to(y.dtype)
    out = tp.reduce_from_model(contrib.reshape(G, Tl, K, D).sum(dim=2).reshape(B, S, D), mg)

    aux = _aux_loss(probs.reshape(T, E), eidx.reshape(T, K), cfg)
    if m.n_shared:
        out = out + apply_mlp(p.shared, x, tp.shared_group(cfg))
    return out, aux


def _aux_loss(probs: torch.Tensor, eidx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The router's load-balancing loss over the global batch: on a rank
    holding its own rows, ``density`` and ``density_proxy`` are the sums
    over the data ranks (``tp.sum_over_data``) over the global count."""
    E = cfg.n_experts_padded
    hits = F.one_hot(eidx[:, 0], E).float()
    if local_rows():
        n = probs.shape[0] * axis_size("pod") * axis_size("data")
        density = tp.sum_over_data(hits.sum(0)) / n
        density_proxy = tp.sum_over_data(probs.sum(0)) / n
    else:
        density, density_proxy = hits.mean(0), probs.mean(0)
    return (density * density_proxy).sum() * E * cfg.moe.router_aux_coef


def _apply_moe_scatter(p: MoE, x: torch.Tensor, xt: torch.Tensor,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global sort + scatter dispatch (the reference's ablation baseline).
    Its one capacity over the global batch is refused on a rank that holds
    only its own rows, and the dispatch under a split over 'model' (ROADMAP
    item 7d)."""
    if local_rows():
        raise NotImplementedError(
            f"{cfg.name}: the scatter dispatch's one capacity is the global batch's; "
            "a rank holding its own rows cannot reckon it")
    if tp.model_group() is not None:
        raise NotImplementedError(
            f"{cfg.name}: the scatter dispatch split over 'model' is a later part of "
            f"{tp.ROADMAP_ITEM}")
    m = cfg.moe
    B, S, D = x.shape
    E, K = cfg.n_experts_padded, m.top_k
    T = B * S
    C = _capacity(T, cfg)
    dev = x.device
    probs, gate, eidx = _route(xt, p, cfg)
    aux = _aux_loss(probs, eidx, cfg)

    with torch.no_grad():
        flat_e = eidx.reshape(T * K)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
        pos_in_e = torch.arange(T * K, device=dev) - seg_start[sorted_e]
        keep = pos_in_e < C
        src_tok = order // K
        dest_e = torch.where(keep, sorted_e, E)
        dest_c = torch.where(keep, pos_in_e, 0)
    # dropped assignments all land in the discarded row E
    buf = xt.new_zeros(E + 1, C, D).index_put((dest_e, dest_c), xt[src_tok])
    ebuf = buf[:E]

    h = torch.einsum("ecd,edf->ecf", ebuf, p.e_in)
    g = torch.einsum("ecd,edf->ecf", ebuf, p.e_gate)
    h = h * F.silu(g.float()).to(h.dtype)
    y = torch.einsum("ecf,efd->ecd", h, p.e_out)

    y_pad = torch.cat([y, y.new_zeros(1, C, D)], dim=0)
    contrib = y_pad[dest_e, dest_c]
    contrib = contrib * gate.reshape(T * K)[order][:, None].to(y.dtype)
    out = y.new_zeros(T, D).index_add(0, src_tok, contrib).reshape(B, S, D)
    if m.n_shared:
        out = out + apply_mlp(p.shared, x)
    return out, aux
