"""GQA attention and Multi-head Latent Attention (MLA): the full-sequence
blocks through the flash kernel, and the cached decode steps with a
log-sum-exp combine over cache shards.

Port of ``src/repro/models/attention.py``. Parameters keep the JAX layouts:
GQA's ``wq (D, H, Dh)``, ``wk``/``wv (D, KH, Dh)``, ``wo (H, Dh, D)``;
MLA's ``w_dkv (D, r + rope)``, ``kv_norm (r)``, ``w_uk``/``w_uv (r, H, Dh)``,
``wq (D, H, Dh + rope)``, ``wo (H, Dh, D)``. ``flash_attention`` here is the
kernel wrapper of ``kernels/flash_attention.py``: the model's full-sequence
attention runs the Hopper kernel on the card, MLA's at head dims (Dh + rope,
Dh). GQA caches hold the original (unrepeated) kv heads after qk-norm and
RoPE, in the layout the decode step reads; MLA's hold the compressed
``c_kv`` (r) and the rope key (rope) of each position. ``attention_block``
also takes the reference's cross attention (whisper's decoder: k and v of
the encoder's output, no mask, no RoPE; in decode, the fixed cross cache)
and ``use_rope=False``. Under a split over 'model' (``distributed/tp.py``)
``attention_block`` runs the rank's heads: q, k and v projected on them,
``flash_attention`` over them, ``wo``'s partial sums reduced over 'model';
its cache holds the rank's kv heads. ``mla_block`` splits the same way over
its heads (``tp.mla_group``), its latent cache whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..distributed import tp
from ..kernels.flash_attention import flash_attention
from .config import ModelConfig
from .layers import apply_rope, dense_init, pdtype, rms_norm

__all__ = ["Attention", "MLA", "init_attention", "init_mla", "flash_attention",
           "decode_attention", "attention_block", "mla_block", "init_self_attn_cache"]


# ------------------------------------------------------------------ init
class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` and, with qk-norm, ``q_norm``/``k_norm``."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None) -> None:
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.q_norm, self.k_norm = q_norm, k_norm


def init_attention(gen: Optional[torch.Generator], cfg: ModelConfig,
                   device) -> Attention:
    D, Dh = cfg.d_model, cfg.head_dim_
    H, KH = cfg.n_heads_padded, cfg.n_kv_heads   # params store ORIGINAL kv heads
    dt = pdtype(cfg)
    wq = dense_init(gen, (D, H, Dh), dtype=dt, device=device)
    wk = dense_init(gen, (D, KH, Dh), dtype=dt, device=device)
    wv = dense_init(gen, (D, KH, Dh), dtype=dt, device=device)
    wo = dense_init(gen, (H, Dh, D), std=0.02 / (2 * cfg.n_layers) ** 0.5,
                    dtype=dt, device=device)
    if gen is not None and cfg.n_heads_padded > cfg.n_heads:
        # pad q-slots are the LAST slots of each kv superblock, so real head j
        # keeps its original kv group; their wo rows are zeroed so they cannot
        # affect the output
        sb = H // KH
        real = cfg.n_heads // KH
        keep = (torch.arange(H, device=device) % sb) < real
        wo.data.mul_(keep.to(dt)[:, None, None])
    q_norm = k_norm = None
    if cfg.qk_norm:
        q_norm = nn.Parameter(torch.zeros(Dh, dtype=dt, device=device),
                              requires_grad=False)
        k_norm = nn.Parameter(torch.zeros(Dh, dtype=dt, device=device),
                              requires_grad=False)
    return Attention(wq, wk, wv, wo, q_norm, k_norm)


class MLA(nn.Module):
    """``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``, ``wq`` and ``wo``; see
    ``init_mla``."""

    def __init__(self, w_dkv, kv_norm, w_uk, w_uv, wq, wo) -> None:
        super().__init__()
        self.w_dkv, self.kv_norm = w_dkv, kv_norm
        self.w_uk, self.w_uv = w_uk, w_uv
        self.wq, self.wo = wq, wo


def init_mla(gen: Optional[torch.Generator], cfg: ModelConfig, device) -> MLA:
    """Port of ``init_mla`` (``src/repro/models/attention.py:53``): the joint
    kv down-projection ``w_dkv`` (D, r + rope) with the RMSNorm scale of its
    first r columns, the up-projections ``w_uk``/``w_uv`` (r, H, Dh), the
    query projection ``wq`` (D, H, Dh + rope) and ``wo`` with the
    depth-scaled std. No q-LoRA (the reference reads no ``q_lora_rank``)."""
    m = cfg.mla
    D, Dh, H = cfg.d_model, cfg.head_dim_, cfg.n_heads_padded
    dt = pdtype(cfg)
    w_dkv = dense_init(gen, (D, m.kv_lora_rank + m.rope_head_dim), dtype=dt, device=device)
    kv_norm = nn.Parameter(torch.zeros(m.kv_lora_rank, dtype=dt, device=device),
                           requires_grad=False)
    w_uk = dense_init(gen, (m.kv_lora_rank, H, Dh), dtype=dt, device=device)
    w_uv = dense_init(gen, (m.kv_lora_rank, H, Dh), dtype=dt, device=device)
    wq = dense_init(gen, (D, H, Dh + m.rope_head_dim), dtype=dt, device=device)
    wo = dense_init(gen, (H, Dh, D), std=0.02 / (2 * cfg.n_layers) ** 0.5,
                    dtype=dt, device=device)
    return MLA(w_dkv, kv_norm, w_uk, w_uv, wq, wo)


# ------------------------------------------------------- flash-decode (serve)
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     n_shards: int) -> torch.Tensor:
    """q: (B, H, 1, Dh); caches: (B, KH, L, Dh) cut into ``n_shards`` blocks
    along L. Per-shard partials, combined by log-sum-exp; positions at or past
    ``cache_len`` are masked."""
    B, H, _, Dh = q.shape
    KH, L = k_cache.shape[1], k_cache.shape[2]
    Dhv = v_cache.shape[-1]
    G = H // KH
    pad = (-L) % n_shards
    if pad:   # zero-pad; padded positions sit beyond cache_len and are masked
        k_cache = torch.nn.functional.pad(k_cache, (0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v_cache, (0, 0, 0, pad))
        L = L + pad
    Lc = L // n_shards
    qg = q.reshape(B, KH, G, Dh).float()
    kb = k_cache.reshape(B, KH, n_shards, Lc, Dh).float()
    vb = v_cache.reshape(B, KH, n_shards, Lc, Dhv)
    s = torch.einsum("bkgd,bknld->bkngl", qg, kb) * Dh ** -0.5
    pos = torch.arange(L, device=q.device).reshape(n_shards, Lc)
    s = s.masked_fill((pos >= cache_len)[None, None, :, None, :], float("-inf"))
    m_i = s.amax(-1)                                         # (B,KH,n,G)
    p = torch.exp(s - m_i[..., None])
    p = torch.where(torch.isfinite(m_i)[..., None], p, torch.zeros_like(p))
    l_i = p.sum(-1)
    o_i = torch.einsum("bkngl,bknld->bkngd", p.to(vb.dtype).float(), vb.float())
    m_g = m_i.amax(2, keepdim=True)
    w = torch.exp(m_i - m_g)
    l_g = (l_i * w).sum(2)
    o_g = (o_i * w[..., None]).sum(2) / l_g.clamp_min(1e-30)[..., None]
    return o_g.reshape(B, H, 1, Dhv).to(q.dtype)


# ------------------------------------------------------------------ GQA block
def attention_block(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    kv_x: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_pos: int = 0,
                    max_len: Optional[int] = None,
                    use_rope: bool = True,
                    want_cache: bool = False,
                    cross: bool = False,
                    impl: Optional[str] = None,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Attention of x (B, S, D) over itself, or over ``kv_x`` (cross
    attention: k and v projected from the encoder's output, never masked).

    With ``cache`` it runs one decode step: self attention writes k and v of
    x into the cache at ``cache_pos`` in place, and the returned cache is the
    same dict; with ``cross`` the cache is the fixed cross cache, read over
    its first ``cache_pos`` positions and never written. Without, it attends
    over the full sequence through ``flash_attention`` (``impl`` is passed
    on); ``want_cache`` then returns the post-norm keys (post-RoPE where
    ``use_rope``) and the values, unrepeated: for self attention zero-padded
    to ``max_len`` along the sequence, the cache the decode step reads; for
    ``kv_x`` of the encoder's length, the cross cache. ``use_rope=False``
    leaves q and k without RoPE (the encoder, whisper's decoder forward and
    cross attention, as the reference's ``attention_block`` takes it).

    Under a split over 'model' that cuts ``wq`` (``tp.head_split``) the block
    runs this rank's heads, where the reference's ``shard()`` pins q, k and v
    to 'model' (``src/repro/models/attention.py:202``, ``:239-240``): x
    (and a cross attention's ``kv_x``) enters through ``copy_to_model``, the
    rank's q heads and the kv heads they read are projected and attended,
    and ``wo``'s partial sums leave through ``reduce_from_model`` (``:245``;
    a cross attention's decode too). The cache holds the rank's kv heads:
    the reference splits it on the sequence over 'model' instead (``:144``),
    which would need q gathered and the prefill's cache laid out anew; the
    results are equal (ROADMAP.md Queue 3, quirk 17)."""
    B, S, D = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    sp = tp.head_split(cfg)
    wk, wv, q_norm, k_norm = p.wk, p.wv, p.q_norm, p.k_norm
    if sp is not None:
        x = tp.copy_to_model(x, sp.mg)
        wk, wv = sp.local_kv(wk), sp.local_kv(wv)
        if cfg.qk_norm:             # read by the rank's heads only: gradients summed
            q_norm, k_norm = tp.copy_to_model(q_norm, sp.mg), tp.copy_to_model(k_norm, sp.mg)
    q = torch.einsum("bsd,dhq->bhsq", x, p.wq)                 # (B,H,S,Dh)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)

    if cache is not None and cross:
        # cross-attention decode: k and v were projected at prefill
        out = decode_attention(q, cache["k"], cache["v"], cache_pos,
                               cfg.decode_seq_shards)
        y = torch.einsum("bhsq,hqd->bsd", out, p.wo)
        return tp.reduce_from_model(y, None if sp is None else sp.mg), None
    src = x if kv_x is None else kv_x
    if sp is not None and kv_x is not None:    # the encoder's output, replicated
        src = tp.copy_to_model(kv_x, sp.mg)
    k = torch.einsum("bsd,dhq->bhsq", src, wk)                 # (B,KH,Sk,Dh)
    v = torch.einsum("bsd,dhq->bhsq", src, wv)
    if cfg.qk_norm:
        k = rms_norm(k, k_norm, cfg.norm_eps)
    if use_rope:
        k = apply_rope(k, positions if kv_x is None else
                       torch.arange(src.shape[1], device=x.device), cfg.rope_theta)

    if cache is not None:
        # The cache stores the ORIGINAL kv heads: GQA needs only KH | H, so
        # kv_repeat has no effect here, as in the reference.
        cache["k"][:, :, cache_pos:cache_pos + S] = k.to(cache["k"].dtype)
        cache["v"][:, :, cache_pos:cache_pos + S] = v.to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], cache_pos + S,
                               cfg.decode_seq_shards)
        new_cache = cache
    else:
        # The kernel maps q head h to kv head h // (H / KH), the grouping the
        # reference's kv_repeat followed by h // (H / (KH * rep)) gives, so the
        # repeated copy of k and v is never made. 1500 encoder keys are no
        # multiple of its tile: it masks the keys past Sk itself.
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal and kv_x is None, impl=impl)
        new_cache = None
        if want_cache and kv_x is not None:
            new_cache = {"k": k, "v": v}
        elif want_cache:
            pad = (max_len or S) - S
            new_cache = {"k": torch.nn.functional.pad(k, (0, 0, 0, pad)),
                         "v": torch.nn.functional.pad(v, (0, 0, 0, pad))}
    y = torch.einsum("bhsq,hqd->bsd", out, p.wo)
    return tp.reduce_from_model(y, None if sp is None else sp.mg), new_cache


# ------------------------------------------------------------------ MLA block
def mla_block(p: MLA, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: int = 0,
              max_len: Optional[int] = None,
              want_cache: bool = False,
              impl: Optional[str] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Multi-head Latent Attention over x (B, S, D), port of ``mla_block``
    (``src/repro/models/attention.py:249``); always causal, as the reference.

    Without ``cache``: keys [k_nope, the rope key broadcast over the H heads]
    of Dh + rope dims and values of Dh through ``flash_attention`` (the
    kernel at (192, 128) on the card at deepseek-v2-lite's widths; ``impl``
    is passed on); ``want_cache`` then returns ``{"c_kv", "k_rope"}``
    zero-padded to ``max_len`` along the sequence. With ``cache``, the
    absorbed decode: c_kv and k_rope of x are written into the cache at
    ``cache_pos`` in place; q_nope is taken into latent space by ``w_uk``,
    attends over [c_kv, k_rope] with values c_kv (r + rope key dims, r value
    dims) and comes back by ``w_uv``. Its scores are scaled by
    (r + rope)^-1/2, where the full-sequence path scales by (Dh + rope)^-1/2:
    the reference's ``decode_attention`` takes its scale from q's last dim,
    and the port carries that over (ROADMAP.md Queue 3, quirk 13).

    Under a split over 'model' that cuts the heads (``tp.mla_group``) the
    block runs this rank's H/m heads, where the reference pins q and k to
    'model' (``src/repro/models/attention.py:290-291``): x, ``w_dkv`` and
    ``kv_norm`` enter through ``copy_to_model`` (each rank's heads read the
    whole latent, so their gradients are partial), and ``wo``'s partial
    sums leave through ``reduce_from_model`` (``:296``). The decode scale is
    unchanged. The latent cache is whole on every rank, where the reference
    splits its positions over 'model' (``:144-147``): the bytes are in
    ROADMAP.md Queue 3, quirk 18."""
    m = cfg.mla
    B, S, D = x.shape
    Dh, H, r = cfg.head_dim_, p.wq.shape[1], m.kv_lora_rank    # H: this rank's heads
    if positions is None:
        positions = torch.arange(S, device=x.device)
    mg = tp.mla_group(cfg)
    w_dkv, kv_norm = p.w_dkv, p.kv_norm
    if mg is not None:
        x = tp.copy_to_model(x, mg)
        w_dkv, kv_norm = tp.copy_to_model(w_dkv, mg), tp.copy_to_model(kv_norm, mg)
    qfull = torch.einsum("bsd,dhq->bhsq", x, p.wq)              # (B,H,S,Dh+rope)
    q_nope, q_rope = qfull[..., :Dh], qfull[..., Dh:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = torch.einsum("bsd,dr->bsr", x, w_dkv)                 # (B,S,r+rope)
    c_kv = rms_norm(dkv[..., :r], kv_norm, cfg.norm_eps)
    k_rope = apply_rope(dkv[:, None, :, r:], positions, cfg.rope_theta)  # (B,1,S,rope)

    if cache is not None:
        cache["c_kv"][:, cache_pos:cache_pos + S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, cache_pos:cache_pos + S] = k_rope[:, 0].to(cache["k_rope"].dtype)
        q_lat = torch.einsum("bhsq,rhq->bhsr", q_nope, p.w_uk)   # (B,H,1,r)
        q_cat = torch.cat([q_lat, q_rope], dim=-1)               # (B,H,1,r+rope)
        k_cat = torch.cat([cache["c_kv"], cache["k_rope"]], dim=-1)[:, None]
        out_lat = decode_attention(q_cat, k_cat, cache["c_kv"][:, None],
                                   cache_pos + S, cfg.decode_seq_shards)  # (B,H,1,r)
        out = torch.einsum("bhsr,rhq->bhsq", out_lat, p.w_uv)
        new_cache = cache
    else:
        k_nope = torch.einsum("bsr,rhq->bhsq", c_kv, p.w_uk)
        v = torch.einsum("bsr,rhq->bhsq", c_kv, p.w_uv)
        k = torch.cat([k_nope, k_rope.expand(B, H, S, m.rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, impl=impl)
        new_cache = None
        if want_cache:
            pad = (max_len or S) - S
            new_cache = {"c_kv": torch.nn.functional.pad(c_kv, (0, 0, 0, pad)),
                         "k_rope": torch.nn.functional.pad(k_rope[:, 0], (0, 0, 0, pad))}
    y = torch.einsum("bhsq,hqd->bsd", out, p.wo)
    return tp.reduce_from_model(y, mg), new_cache


def init_self_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                         device) -> Dict[str, torch.Tensor]:
    """Zero k and v caches (B, KH, max_len, Dh) of the original kv heads
    (under a split over 'model', this rank's, ``tp.cache_kv_heads``); for
    an MLA config, ``c_kv`` (B, max_len, r) and ``k_rope`` (B, max_len, rope)."""
    dt = pdtype(cfg)
    if cfg.mla is not None:
        base = (batch, max_len)
        return {"c_kv": torch.zeros(base + (cfg.mla.kv_lora_rank,), dtype=dt, device=device),
                "k_rope": torch.zeros(base + (cfg.mla.rope_head_dim,), dtype=dt,
                                      device=device)}
    shp = (batch, tp.cache_kv_heads(cfg), max_len, cfg.head_dim_)
    return {"k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device)}
