"""The LM: init, full-sequence forward (prefill), loss and the cached decode
step, for the block kinds ``attn+mlp``, ``attn+moe``, ``mla+mlp``,
``mla+moe``, ``mamba+mlp``, ``mamba+moe``, ``mlstm`` and ``slstm``, with an
optional dense first layer, and the two wrappers of the same stack: the
encoder-decoder (whisper) and the VLM (llava).

Port of ``src/repro/models/lm.py``. The JAX package stacks each pattern
entry's parameters over ``n_groups`` and ``lax.scan``s them; here the layers
are an ``nn.ModuleList`` of per-layer blocks in layer order, layer i of kind
``block_pattern[i % len(block_pattern)]``; with ``cfg.first_layer_dense``
layer 0 is the reference's ``first`` block (``{mixer}+mlp``) and layer
i >= 1 is of kind ``block_pattern[(i - 1) % len(block_pattern)]``. The
layer count need not divide by the pattern (the reference asserts it
does), so jamba runs at any depth. Each layer's cache is its own dict:
``{"k", "v"}`` for attention, ``{"c_kv", "k_rope"}`` for MLA, ``{"ssm",
"conv"}`` for Mamba, the recurrent state for xLSTM. An MoE layer's router
aux loss is summed
over the layers into ``forward``'s ``aux``, as the reference's
``_stack_forward`` sums it, and ``loss_fn`` adds it to the loss.

The encoder-decoder (``cfg.encdec``): an ``Encoder`` of plain ``attn+mlp``
blocks, non-causal and without RoPE, over the frame embeddings plus a
learned ``pos_embed``; each decoder layer is a ``CrossBlock``, whose cross
attention after the self mixer reads the encoder's output (or, in decode,
the layer's fixed ``cross_k``/``cross_v`` cache). As the reference does,
``forward`` runs the decoder's self attention without RoPE, while
``decode_step`` ropes its q and new keys (ROADMAP.md Queue 3, quirk 14;
carried over). The VLM (``cfg.vlm``): ``batch["vision_embeds"]`` projected
by ``vision_proj`` (not scaled by sqrt(D), as the tokens are) and put before
the tokens under one causal mask; ``forward`` returns their number as
``n_prefix`` and ``loss_fn`` drops their logits.

``forward`` and ``loss_fn`` build a graph where grad is enabled, so a model
made with ``init_params(..., trainable=True)`` trains; ``cfg.remat`` then
recomputes each block's activations in the backward as the reference's
``_remat`` does (``src/repro/models/lm.py:156``), but block by block where
the reference remats a whole ``block_pattern`` group (the same numbers,
less memory: one block's activations live at a time in the backward).
Every ported block kind has a gradient: attention and MLA through the flash
backward kernel, mLSTM through the mLSTM backward kernel (on the card), sLSTM
by autograd through its step loop, Mamba by autograd through its log-depth
scan (``ssm.py``), MoE by autograd through its dispatch and combine gathers
(``moe.py``). Serving runs under ``torch.no_grad()``:
``decode_step`` here, the prefill in the engine.

Tensor parallelism (``distributed/tp.py``): under ``use_mesh`` of a
``DeviceMesh`` whose 'model' axis has more than one rank, ``forward``,
``loss_fn``, ``decode_step`` and ``init_caches`` run this rank's part of
the model (``tp.split_model``), of any block kind and wrapper: its
attention or MLA heads, its d_ff slice, its experts, its Mamba and mLSTM
channels (the sLSTM whole), the encoder's and the cross attention's heads
as the decoder's, and, where the rules split ``embed``/``head``, its
vocabulary slice, so the logits are this rank's slice (the reference's
``lm.py:289`` layout; ``tp.gather_vocab`` makes them whole). ``pos_embed``
and a VLM's ``vision_proj`` stay whole, so the prefix needs no collective.
The caches hold the rank's share: its kv heads (the cross cache's too), its
Mamba channels, its mLSTM heads. ``check_split`` refuses only a split whose
ranks would straddle kv groups or the mLSTM's qkv blocks (ROADMAP item 7d).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed import tp
from .attention import (MLA, Attention, attention_block, init_attention, init_mla,
                        init_self_attn_cache, mla_block)
from .config import ModelConfig
from .layers import (MLP, apply_mlp, dense_init, init_mlp, init_norm, pdtype,
                     resolve_device, rms_norm)
from .moe import MoE, apply_moe, init_moe
from .ssm import Mamba, apply_mamba, init_mamba, init_mamba_state
from .xlstm import (MLSTM, SLSTM, apply_mlstm, apply_slstm, init_mlstm,
                    init_mlstm_state, init_slstm, init_slstm_state)

_PORTED = ("attn+mlp", "attn+moe", "mla+mlp", "mla+moe", "mamba+mlp", "mamba+moe",
           "mlstm", "slstm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every layer of ``cfg`` is of a
    ported kind (``_PORTED``)."""
    for blk in dict.fromkeys(layer_kinds(cfg)):
        if blk not in _PORTED:
            raise NotImplementedError(f"{cfg.name}: unknown block {blk!r}")


def check_split(cfg: ModelConfig, model: Optional[nn.Module] = None) -> None:
    """Under a split over 'model' on the ambient mesh, raise
    NotImplementedError for a split the port does not make (ranks that
    would straddle kv groups or the mLSTM's qkv blocks: ROADMAP item 7d),
    never computing it whole in silence; and ValueError for a ``model``
    that is not this rank's part (``tp.split_model``)."""
    tp.check_split(cfg)
    if model is not None:
        tp.check_model(cfg, model)


# ================================================================ modules
class Block(nn.Module):
    """One ``attn+mlp`` layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, ln1: nn.Parameter, attn: Attention, ln2: nn.Parameter,
                 mlp: MLP) -> None:
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class CrossBlock(nn.Module):
    """One decoder layer of an encoder-decoder: ``ln1``, ``attn``, ``ln_c``,
    ``cross`` (attention over the encoder's output), ``ln2``, ``mlp``."""

    def __init__(self, ln1: nn.Parameter, attn: Attention, ln_c: nn.Parameter,
                 cross: Attention, ln2: nn.Parameter, mlp: MLP) -> None:
        super().__init__()
        self.ln1, self.attn, self.ln_c, self.cross = ln1, attn, ln_c, cross
        self.ln2, self.mlp = ln2, mlp


class MoEBlock(nn.Module):
    """One ``attn+moe`` layer: ``ln1``, ``attn``, ``ln2``, ``moe``."""

    def __init__(self, ln1: nn.Parameter, attn: Attention, ln2: nn.Parameter,
                 moe: MoE) -> None:
        super().__init__()
        self.ln1, self.attn, self.ln2, self.moe = ln1, attn, ln2, moe


class MLABlock(nn.Module):
    """One ``mla+mlp`` layer: ``ln1``, ``mla``, ``ln2``, ``mlp``."""

    def __init__(self, ln1: nn.Parameter, mla: MLA, ln2: nn.Parameter,
                 mlp: MLP) -> None:
        super().__init__()
        self.ln1, self.mla, self.ln2, self.mlp = ln1, mla, ln2, mlp


class MLAMoEBlock(nn.Module):
    """One ``mla+moe`` layer: ``ln1``, ``mla``, ``ln2``, ``moe``."""

    def __init__(self, ln1: nn.Parameter, mla: MLA, ln2: nn.Parameter,
                 moe: MoE) -> None:
        super().__init__()
        self.ln1, self.mla, self.ln2, self.moe = ln1, mla, ln2, moe


class MambaBlock(nn.Module):
    """One ``mamba+mlp`` layer: ``ln1``, ``mamba``, ``ln2``, ``mlp``."""

    def __init__(self, ln1: nn.Parameter, mamba: Mamba, ln2: nn.Parameter,
                 mlp: MLP) -> None:
        super().__init__()
        self.ln1, self.mamba, self.ln2, self.mlp = ln1, mamba, ln2, mlp


class MambaMoEBlock(nn.Module):
    """One ``mamba+moe`` layer: ``ln1``, ``mamba``, ``ln2``, ``moe``."""

    def __init__(self, ln1: nn.Parameter, mamba: Mamba, ln2: nn.Parameter,
                 moe: MoE) -> None:
        super().__init__()
        self.ln1, self.mamba, self.ln2, self.moe = ln1, mamba, ln2, moe


class MLSTMBlock(nn.Module):
    """One ``mlstm`` layer: ``ln1``, ``mlstm``; no FFN."""

    def __init__(self, ln1: nn.Parameter, mlstm: MLSTM) -> None:
        super().__init__()
        self.ln1, self.mlstm = ln1, mlstm


class SLSTMBlock(nn.Module):
    """One ``slstm`` layer: ``ln1``, ``slstm``; no FFN."""

    def __init__(self, ln1: nn.Parameter, slstm: SLSTM) -> None:
        super().__init__()
        self.ln1, self.slstm = ln1, slstm


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of each layer, in layer order: with a dense first
    layer, layer 0 is ``{mixer}+mlp`` and the pattern starts at layer 1."""
    first = int(cfg.first_layer_dense)
    pattern = [cfg.block_pattern[i % len(cfg.block_pattern)]
               for i in range(cfg.n_layers - first)]
    return [f"{cfg.block_pattern[0].partition('+')[0]}+mlp"] * first + pattern


def init_block(gen: Optional[torch.Generator], cfg: ModelConfig, device,
               kind: str, cross: bool = False) -> nn.Module:
    """One layer of ``kind``; with ``cross`` (an encoder-decoder's decoder
    layers, ``attn+mlp``) a ``CrossBlock``."""
    if cross:
        return CrossBlock(init_norm(cfg, device), init_attention(gen, cfg, device),
                          init_norm(cfg, device), init_attention(gen, cfg, device),
                          init_norm(cfg, device), init_mlp(gen, cfg, device))
    if kind == "mlstm":
        return MLSTMBlock(init_norm(cfg, device), init_mlstm(gen, cfg, device))
    if kind == "slstm":
        return SLSTMBlock(init_norm(cfg, device), init_slstm(gen, cfg, device))
    if kind == "attn+moe":
        return MoEBlock(init_norm(cfg, device), init_attention(gen, cfg, device),
                        init_norm(cfg, device), init_moe(gen, cfg, device))
    if kind == "mla+moe":
        return MLAMoEBlock(init_norm(cfg, device), init_mla(gen, cfg, device),
                           init_norm(cfg, device), init_moe(gen, cfg, device))
    if kind == "mla+mlp":
        return MLABlock(init_norm(cfg, device), init_mla(gen, cfg, device),
                        init_norm(cfg, device), init_mlp(gen, cfg, device))
    if kind == "mamba+moe":
        return MambaMoEBlock(init_norm(cfg, device), init_mamba(gen, cfg, device),
                             init_norm(cfg, device), init_moe(gen, cfg, device))
    if kind == "mamba+mlp":
        return MambaBlock(init_norm(cfg, device), init_mamba(gen, cfg, device),
                          init_norm(cfg, device), init_mlp(gen, cfg, device))
    return Block(init_norm(cfg, device), init_attention(gen, cfg, device),
                 init_norm(cfg, device), init_mlp(gen, cfg, device))


class Encoder(nn.Module):
    """Whisper's encoder: ``pos_embed`` (enc_len, D), ``blocks`` (plain
    ``attn+mlp`` layers) and ``final_norm``."""

    def __init__(self, pos_embed: nn.Parameter, blocks: List[Block],
                 final_norm: nn.Parameter) -> None:
        super().__init__()
        self.pos_embed = pos_embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm


class LM(nn.Module):
    """``embed`` (Vpad, D), ``head`` (D, Vpad) unless tied, ``final_norm`` and
    ``blocks``, one per layer; a VLM's ``vision_proj`` (D, D) and an
    encoder-decoder's ``encoder``, else None."""

    def __init__(self, embed: nn.Parameter, head: Optional[nn.Parameter],
                 final_norm: nn.Parameter, blocks: List[nn.Module],
                 vision_proj: Optional[nn.Parameter] = None,
                 encoder: Optional[Encoder] = None) -> None:
        super().__init__()
        self.embed = embed
        self.head = head
        self.final_norm = final_norm
        self.blocks = nn.ModuleList(blocks)
        self.vision_proj = vision_proj
        self.encoder = encoder


def init_params(cfg: ModelConfig, seed: Optional[int] = 0, device=None,
                trainable: bool = False) -> LM:
    """The model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` (``None`` leaves them uninitialised for the converter). Runs on
    the card unless ``device`` names another. Parameters are frozen for
    serving unless ``trainable``."""
    check_ported(cfg)
    device = resolve_device(device)
    gen = None
    if seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = pdtype(cfg)
    embed = dense_init(gen, (cfg.padded_vocab, cfg.d_model), dtype=dt, device=device)
    head = (None if cfg.tie_embeddings else
            dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype=dt, device=device))
    vision_proj = (None if cfg.vlm is None else
                   dense_init(gen, (cfg.d_model, cfg.d_model), dtype=dt, device=device))
    blocks = [init_block(gen, cfg, device, kind, cross=cfg.is_encdec)
              for kind in layer_kinds(cfg)]
    encoder = None
    if cfg.is_encdec:
        encoder = Encoder(
            dense_init(gen, (cfg.encdec.enc_len, cfg.d_model), dtype=dt, device=device),
            [init_block(gen, cfg, device, "attn+mlp") for _ in range(cfg.encdec.enc_layers)],
            init_norm(cfg, device))
    return LM(embed, head, init_norm(cfg, device), blocks, vision_proj,
              encoder).requires_grad_(trainable)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """Empty caches, one per layer, on the card unless ``device`` names
    another: zero ``{"k", "v"}`` of ``max_len`` positions for attention (and
    ``{"c_kv", "k_rope"}`` for MLA), the initial state ``{"ssm", "conv"}``,
    ``{"C", "n", "m"}`` or ``{"sc", "sn", "sh", "sm"}`` for Mamba, mLSTM and
    sLSTM (which ignore ``max_len``). An encoder-decoder's layers also hold
    zero ``cross_k``/``cross_v`` (B, KH, enc_len, Dh), as the reference's:
    decode attends over them as they are until a prefill's are put there.
    Under a split over 'model' each holds this rank's share: its kv heads,
    its Mamba channels, the mLSTM heads it runs."""
    check_ported(cfg)
    check_split(cfg)
    device = resolve_device(device)

    def attn():
        c = init_self_attn_cache(cfg, batch, max_len, device)
        if cfg.is_encdec:
            shp = (batch, tp.cache_kv_heads(cfg), cfg.encdec.enc_len, cfg.head_dim_)
            c["cross_k"] = torch.zeros(shp, dtype=pdtype(cfg), device=device)
            c["cross_v"] = torch.zeros(shp, dtype=pdtype(cfg), device=device)
        return c

    mamba = lambda: init_mamba_state(cfg, batch, device)  # noqa: E731
    init = {"attn+mlp": attn, "attn+moe": attn, "mla+mlp": attn, "mla+moe": attn,
            "mamba+mlp": mamba, "mamba+moe": mamba,
            "mlstm": lambda: init_mlstm_state(cfg, batch, device),
            "slstm": lambda: init_slstm_state(cfg, batch, device)}
    return {"layers": [init[kind]() for kind in layer_kinds(cfg)]}


# ================================================================== forward
def _apply_block(blk: nn.Module, x: torch.Tensor, cfg: ModelConfig, *,
                 cache=None, want_cache: bool = False, mlstm_impl=None,
                 use_rope: bool = True, enc_out: Optional[torch.Tensor] = None,
                 cross_len: int = 0, **kw):
    """``(x, aux, cache)``: ``aux`` the MoE layer's router loss, else None.
    ``use_rope`` reaches GQA self attention only, as in the reference;
    a ``CrossBlock`` attends over ``enc_out``, or in decode over its
    cache's ``cross_k``/``cross_v`` (``cross_len`` positions)."""
    h = rms_norm(x, blk.ln1, cfg.norm_eps)
    if isinstance(blk, MLSTMBlock):
        y, cache = apply_mlstm(blk.mlstm, h, cfg, state=cache,
                               want_state=want_cache, impl=mlstm_impl)
        return x + y, None, cache
    if isinstance(blk, SLSTMBlock):
        y, cache = apply_slstm(blk.slstm, h, cfg, state=cache,
                               want_state=want_cache)
        return x + y, None, cache
    if isinstance(blk, (MambaBlock, MambaMoEBlock)):
        y, cache = apply_mamba(blk.mamba, h, cfg, state=cache, want_state=want_cache)
    elif isinstance(blk, (MLABlock, MLAMoEBlock)):
        y, cache = mla_block(blk.mla, h, cfg, cache=cache, want_cache=want_cache, **kw)
    else:
        # the self mixer writes only "k" and "v" of a cross layer's cache
        y, new = attention_block(blk.attn, h, cfg, cache=cache, want_cache=want_cache,
                                 use_rope=use_rope, **kw)
        if isinstance(blk, CrossBlock):
            x = x + y
            hc = rms_norm(x, blk.ln_c, cfg.norm_eps)
            if cache is not None and "cross_k" in cache:
                yc, _ = attention_block(blk.cross, hc, cfg, use_rope=False, cross=True,
                                        cache={"k": cache["cross_k"], "v": cache["cross_v"]},
                                        cache_pos=cross_len)
            else:
                yc, cc = attention_block(blk.cross, hc, cfg, kv_x=enc_out, use_rope=False,
                                         want_cache=want_cache, impl=kw.get("impl"))
                if cc:
                    new["cross_k"], new["cross_v"] = cc["k"], cc["v"]
            y = yc
        cache = new
    x = x + y
    h = rms_norm(x, blk.ln2, cfg.norm_eps)
    if isinstance(blk, (MoEBlock, MLAMoEBlock, MambaMoEBlock)):
        y, aux = apply_moe(blk.moe, h, cfg)
        return x + y, aux, cache
    return x + apply_mlp(blk.mlp, h, tp.ff_group(cfg)), None, cache


# The matrix products that ``remat="dots"`` keeps, as the reference's
# ``dots_with_no_batch_dims_saveable`` does: einsum lowers a product with no
# batch dimension to a bmm of batch 1 (or an mm).
def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op == aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` as ``cfg.remat`` says: ``none`` keeps every activation;
    ``full`` keeps the block's inputs and recomputes the rest in the
    backward; ``dots`` also keeps the matrix products' outputs."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat must be none, full or dots, got {cfg.remat!r}")


def _logits(cfg: ModelConfig, model: LM, x: torch.Tensor) -> torch.Tensor:
    """The logits; where the vocabulary splits over 'model', this rank's
    slice of them (x enters the column-parallel head by ``copy_to_model``)."""
    x = tp.copy_to_model(rms_norm(x, model.final_norm, cfg.norm_eps), tp.vocab_group(cfg))
    head = model.embed.T if cfg.tie_embeddings else model.head
    return torch.einsum("bsd,dv->bsv", x, head)


def _embed(cfg: ModelConfig, model: LM, tokens: torch.Tensor) -> torch.Tensor:
    mg = tp.vocab_group(cfg)
    rows = model.embed[tokens] if mg is None else tp.embed_lookup(model.embed, tokens, mg)
    # scaled in the parameter dtype, as the reference multiplies in bf16
    return rows * (cfg.d_model ** 0.5)


def embed_inputs(cfg: ModelConfig, model: LM,
                 batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """The token embeddings, after a VLM's projected ``vision_embeds`` (B, P,
    D) where the batch holds them: ``(x, n_prefix)``, ``n_prefix = P`` or 0.
    The prefix is cast to the embedding's dtype and not scaled by sqrt(D).
    Under a split over 'model' ``vision_proj`` is whole (the rules'), so
    every rank projects the prefix alike and puts it before the
    vocab-parallel embedding's rows, which come back whole: no collective."""
    x = _embed(cfg, model, batch["tokens"])
    if cfg.vlm is None or "vision_embeds" not in batch:
        return x, 0
    v = torch.einsum("bpd,de->bpe", batch["vision_embeds"].to(x.dtype), model.vision_proj)
    return torch.cat([v, x], dim=1), v.shape[1]


def _blocks(cfg: ModelConfig, blocks, x: torch.Tensor, *, want_caches: bool,
            enc_out: Optional[torch.Tensor] = None, **kw):
    """``blocks`` over x: ``(x, aux, caches)``. Where grad is enabled each
    block is rematerialised as ``cfg.remat`` says, ``enc_out`` an argument
    of the rematerialised function so that its gradient flows."""
    caches = [] if want_caches else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled()
    for blk in blocks:
        if grad and x.requires_grad and not want_caches:
            x, a = _remat(lambda x, e, blk=blk: _apply_block(blk, x, cfg, enc_out=e,
                                                             **kw)[:2], cfg)(x, enc_out)
            c = None
        else:
            x, a, c = _apply_block(blk, x, cfg, enc_out=enc_out, want_cache=want_caches,
                                   **kw)
        if a is not None:
            aux = aux + a
        if want_caches:
            caches.append(c)
    return x, aux, caches


def _encode(cfg: ModelConfig, model: LM, frames: torch.Tensor,
            attn_impl: Optional[str] = None) -> torch.Tensor:
    """Whisper's encoder over ``frames`` (B, T, D), the precomputed embeddings
    of the conv front end (the reference's stub): plus ``pos_embed[:T]`` in
    the frames' dtype, the blocks non-causal and without RoPE, RMSNorm.
    Under a split over 'model' the blocks split as the decoder's
    ``attn+mlp`` blocks do; ``pos_embed`` is whole, and so is the output."""
    enc = model.encoder
    x = frames + enc.pos_embed[None, :frames.shape[1]].to(frames.dtype)
    x, _, _ = _blocks(cfg, enc.blocks, x, want_caches=False, causal=False,
                      use_rope=False, impl=attn_impl)
    return rms_norm(x, enc.final_norm, cfg.norm_eps)


def forward(cfg: ModelConfig, model: LM, batch: Dict[str, torch.Tensor], *,
            want_caches: bool = False, max_len: Optional[int] = None,
            attn_impl: Optional[str] = None, mlstm_impl: Optional[str] = None):
    """Full-sequence forward over ``batch["tokens"]`` (B, S), after a VLM's
    ``batch["vision_embeds"]`` (B, P, D) where given; an encoder-decoder
    also needs ``batch["frames"]`` (B, T, D), T at most ``enc_len``. Returns
    ``(logits, aux, caches, n_prefix)`` as the reference does, the logits
    over the prefix and the tokens. With ``want_caches`` the caches are
    those ``decode_step`` continues from, with room for ``max_len``
    positions (default the prefix and S) in attention layers, and an
    encoder-decoder's ``cross_k``/``cross_v`` of T positions.
    ``attn_impl="plain"`` and ``mlstm_impl="plain"`` run attention and the
    mLSTM scan through their kernels' plain versions. Where grad is enabled
    it builds a graph, each block rematerialised as ``cfg.remat`` says.
    Under a split over 'model', the logits are this rank's vocabulary slice
    where the vocabulary splits, and the caches hold its kv heads."""
    check_split(cfg, model)
    x, n_prefix = embed_inputs(cfg, model, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    enc_out = None
    if cfg.is_encdec:
        if "frames" not in batch:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its forward needs "
                             "batch['frames'] (B, T, d_model)")
        enc_out = _encode(cfg, model, batch["frames"], attn_impl)
    x, aux, caches = _blocks(cfg, model.blocks, x, want_caches=want_caches,
                             enc_out=enc_out, causal=True, positions=positions,
                             max_len=max_len, impl=attn_impl, mlstm_impl=mlstm_impl,
                             use_rope=not cfg.is_encdec)
    logits = _logits(cfg, model, x)
    return logits, aux, ({"layers": caches} if want_caches else None), n_prefix


def loss_fn(cfg: ModelConfig, model: LM, batch: Dict[str, torch.Tensor], *,
            attn_impl: Optional[str] = None,
            mlstm_impl: Optional[str] = None) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token NLL over ``batch["labels"]`` (plus the forward's aux
    loss), with the vocabulary padding masked and a VLM prefix's logits
    dropped; ``(loss, {"nll", "aux"})``.
    ``attn_impl`` and ``mlstm_impl`` as ``forward`` takes them."""
    logits, aux, _, n_prefix = forward(cfg, model, batch, attn_impl=attn_impl,
                                       mlstm_impl=mlstm_impl)
    labels = batch["labels"]
    logits = logits[:, n_prefix:n_prefix + labels.shape[1]].float()
    mg = tp.vocab_group(cfg)
    if mg is not None:              # this rank's vocabulary slice
        nll = tp.vocab_parallel_nll(logits, labels, cfg.vocab_size, mg).mean()
        return nll + aux, {"nll": nll, "aux": aux}
    # mask vocab padding out of the partition function
    vmask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    logits = logits.masked_fill(~vmask, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold).mean()
    loss = nll + aux
    return loss, {"nll": nll, "aux": aux}


# ================================================================== decode
@torch.no_grad()
def decode_step(cfg: ModelConfig, model: LM, caches: Dict, tokens: torch.Tensor,
                pos: int):
    """One serving step: tokens (B, 1) at absolute position ``pos`` given the
    caches (after a VLM prefix, ``pos`` counts it). Returns ``(logits,
    caches)``; the caches (KV caches and recurrent states) are updated in
    place (the reference returns new arrays) and the same dict is returned.
    An encoder-decoder's cross attention reads its layers' ``cross_k`` and
    ``cross_v``, and its self attention ropes q and the new keys, as the
    reference's decode does and its forward does not (quirk 14). Under a
    split over 'model' the logits are this rank's vocabulary slice where the
    vocabulary splits (``tp.greedy`` takes the argmax over the ranks)."""
    check_split(cfg, model)
    x = _embed(cfg, model, tokens)
    positions = pos + torch.arange(x.shape[1], device=x.device)
    cross_len = cfg.encdec.enc_len if cfg.is_encdec else 0
    for blk, c in zip(model.blocks, caches["layers"]):
        x, _, _ = _apply_block(blk, x, cfg, positions=positions, cache=c,
                               cache_pos=pos, cross_len=cross_len)
    return _logits(cfg, model, x), caches
