"""Carry a JAX parameter tree, and an AdamW state, into the port by a plain copy.

``params_from_jax(cfg, tree, device)`` takes the tree of
``repro.models.lm.init_params`` as numpy arrays (``jax.device_get``) and
returns the port's ``LM`` with the same values. The JAX tree stacks each
block-pattern entry ``j`` over ``n_groups``; layer ``g * len(pattern) + j`` of
the port is ``groups[j][g]``, or, with a dense first layer, layer 0 is the
tree's unstacked ``first`` block and the groups start at layer 1. Each
block's parameters copy by their dotted names, walked into the tree's
nested dicts: ``ln1``, ``attn``, ``ln2`` and ``mlp`` for ``attn+mlp``;
``moe.router``, ``moe.e_in``, ``moe.e_gate``, ``moe.e_out`` (the padded
experts included) and ``moe.shared.*`` for ``attn+moe``; ``mla.w_dkv``,
``mla.kv_norm``, ``mla.w_uk``, ``mla.w_uv``, ``mla.wq`` and ``mla.wo`` in
place of ``attn`` for ``mla+mlp`` and ``mla+moe``; ``mamba.m_in``,
``mamba.m_conv``, ``mamba.m_xproj``, ``mamba.m_dt``, ``mamba.m_dtb``,
``mamba.m_alog`` (fp32 in either dtype), ``mamba.m_d`` and ``mamba.m_out``
in place of ``attn`` for ``mamba+mlp`` and ``mamba+moe``; ``ln1`` and the
mixer's leaves (``x_up`` .. ``x_out``, ``s_gates`` .. ``s_out``) for
``mlstm`` and ``slstm``; ``ln_c`` and ``cross.*`` besides in an
encoder-decoder's decoder blocks. A VLM's ``vision_proj`` copies as it is; an
encoder-decoder's ``encoder.pos_embed`` and ``encoder.final_norm`` too, and
encoder block ``l`` is ``encoder.groups[0][l]`` of the tree (stacked over
``enc_layers``). bf16 arrays arrive through their ``uint16`` view,
so this module needs neither JAX nor ``ml_dtypes``.

``opt_state_from_jax(cfg, model, state)`` does the same for the state of
``repro.train.optimizer.adamw_init`` / ``adamw_update``: its ``m``, ``v`` and
``master`` trees (each shaped like the parameters) become the port's dicts
keyed by ``model.named_parameters()`` names, and ``step`` an int32 scalar.

``params_to_jax(cfg, model)`` and ``opt_state_to_jax(cfg, model, state)``
are their inverses: the reference's trees, each pattern entry's layers
stacked in one leaf (``groups`` a tuple, as the reference's), ``step`` an
int32 scalar and ``master`` only where the port's state has it. Their leaves
are CPU tensors, since numpy holds no bf16 without ``ml_dtypes``: an fp32 or
int leaf's ``numpy()``, or a bf16 leaf's ``uint16`` view, is the reference's
array bit for bit, and ``params_from_jax``, ``opt_state_from_jax`` and the
checkpoint writer take them as they are. With ``lazy=True`` each leaf is
instead a zero-argument callable that makes it when called, so the
checkpoint writer holds one stacked leaf on the host at a time. A ZeRO-1
state's DTensor leaves, and a model split over 'model' (``params_to_jax(mesh=)``),
are gathered whole leaf by leaf (``tp.gather_to_host``), a collective every
rank makes alike. ``jax_tree`` builds the reference's layout of any leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .distributed import tp
from .models.config import ModelConfig
from .models.lm import LM, init_params


def tensor_from_numpy(arr: Any) -> torch.Tensor:
    """A numpy array (fp32, int or bf16 from ``ml_dtypes``) as a CPU tensor;
    a tensor (a restored checkpoint's leaf) as it is."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


@torch.no_grad()
def _copy(dst: torch.Tensor, src: Any, name: str) -> None:
    t = tensor_from_numpy(src)
    if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
        raise ValueError(f"{name}: JAX {tuple(t.shape)} {t.dtype} does not "
                         f"fit the port's {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(t)


def _leaves(cfg: ModelConfig, model: LM,
            tree: Mapping[str, Any]) -> Iterator[Tuple[str, torch.Tensor, Any]]:
    """(name, the port's parameter, the JAX tree's leaf) for every parameter
    of ``model``, the leaf taken from a tree shaped like the JAX params."""
    yield "embed", model.embed, tree["embed"]
    yield "final_norm", model.final_norm, tree["final_norm"]
    if model.head is not None:
        yield "head", model.head, tree["head"]
    n_pat = len(cfg.block_pattern)
    first = int(cfg.first_layer_dense)
    for i, blk in enumerate(model.blocks):
        if i < first:
            src, pick = tree["first"], (lambda leaf: leaf)
        else:
            g, j = divmod(i - first, n_pat)
            src, pick = tree["groups"][j], (lambda leaf, g=g: leaf[g])
        yield from _block_leaves(f"blocks.{i}", blk, src, pick)
    if model.vision_proj is not None:
        yield "vision_proj", model.vision_proj, tree["vision_proj"]
    if model.encoder is not None:
        enc, src = model.encoder, tree["encoder"]
        yield "encoder.pos_embed", enc.pos_embed, src["pos_embed"]
        yield "encoder.final_norm", enc.final_norm, src["final_norm"]
        for i, blk in enumerate(enc.blocks):
            yield from _block_leaves(f"encoder.blocks.{i}", blk, src["groups"][0],
                                     lambda leaf, i=i: leaf[i])


def _block_leaves(prefix: str, blk, src: Mapping[str, Any], pick):
    for name, p in blk.named_parameters():
        leaf = src
        for key in name.split("."):
            leaf = leaf[key]
        yield f"{prefix}.{name}", p, pick(leaf)


def params_from_jax(cfg: ModelConfig, tree: Mapping[str, Any], device=None,
                    trainable: bool = False) -> LM:
    """The port's model holding ``tree``'s values, on the card unless
    ``device`` names another; frozen unless ``trainable``."""
    model = init_params(cfg, seed=None, device=device)
    for name, p, leaf in _leaves(cfg, model, tree):
        _copy(p, leaf, name)
    return model.requires_grad_(trainable)


def opt_state_from_jax(cfg: ModelConfig, model: LM, state: Mapping[str, Any]) -> Dict:
    """The port's AdamW state (``train.optimizer``) holding the values of
    the JAX state ``state`` (numpy leaves), on ``model``'s device."""
    names = dict(model.named_parameters())
    device = model.embed.device
    out: Dict[str, Any] = {
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                             device=device)}
    for key in ("m", "v", "master"):
        if key not in state:
            continue
        out[key] = {}
        for name, p, leaf in _leaves(cfg, model, state[key]):
            assert names[name] is p
            t = tensor_from_numpy(leaf)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key} {name}: JAX {tuple(t.shape)} does not "
                                 f"fit the port's {tuple(p.shape)}")
            out[key][name] = t.to(device)
    return out


def jax_tree(cfg: ModelConfig, model: LM, leaf) -> Dict[str, Any]:
    """The reference's params layout of ``model``: each leaf ``leaf(names)``
    of the port's parameter name, or of the list of names whose layers the
    reference stacks in it (a pattern entry's layers, in order)."""
    def block(prefixes, blk) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, _ in blk.named_parameters():
            node = out
            *path, last = name.split(".")
            for key in path:
                node = node.setdefault(key, {})
            node[last] = leaf(f"{prefixes}.{name}" if isinstance(prefixes, str) else
                              [f"{p}.{name}" for p in prefixes])
        return out

    tree: Dict[str, Any] = {"embed": leaf("embed"), "final_norm": leaf("final_norm")}
    if model.head is not None:
        tree["head"] = leaf("head")
    if model.vision_proj is not None:
        tree["vision_proj"] = leaf("vision_proj")
    n_pat = len(cfg.block_pattern)
    first = int(cfg.first_layer_dense)
    n_groups, rest = divmod(len(model.blocks) - first, n_pat)
    if rest:
        raise ValueError(f"{cfg.name}: {len(model.blocks) - first} layers do not stack into "
                         f"whole groups of the {n_pat}-entry pattern the reference takes")
    if first:
        tree["first"] = block("blocks.0", model.blocks[0])
    tree["groups"] = tuple(
        block([f"blocks.{first + g * n_pat + j}" for g in range(n_groups)],
              model.blocks[first + j]) for j in range(n_pat))
    if model.encoder is not None:
        enc = model.encoder
        tree["encoder"] = {
            "pos_embed": leaf("encoder.pos_embed"),
            "groups": (block([f"encoder.blocks.{i}" for i in range(len(enc.blocks))],
                             enc.blocks[0]),),
            "final_norm": leaf("encoder.final_norm")}
    return tree


def _host_leaf(get, lazy: bool):
    """``leaf(names)`` for ``jax_tree``: ``get(name)`` on the host (a DTensor
    gathered from its chunks, ``tp.host_leaf``), a pattern entry's layers
    stacked; with ``lazy``, a callable that makes it."""
    def leaf(names):
        def make() -> torch.Tensor:
            if isinstance(names, str):
                return tp.host_leaf(get(names))
            return torch.stack([tp.host_leaf(get(name)) for name in names])
        return make if lazy else make()
    return leaf


def params_to_jax(cfg: ModelConfig, model: LM, lazy: bool = False,
                  mesh=None) -> Dict[str, Any]:
    """``model``'s parameters in the layout of ``repro.models.lm.init_params``
    (CPU tensors, or with ``lazy`` callables that make them): the inverse
    of ``params_from_jax``. A model split over 'model' on ``mesh`` (default
    the ambient mesh) is this rank's part: each split leaf is gathered
    whole from the ranks' slices (``tp.host_params``), a collective that
    every rank makes alike, leaf by leaf."""
    return jax_tree(cfg, model, _host_leaf(tp.host_params(cfg, model, mesh), lazy))


def opt_state_to_jax(cfg: ModelConfig, model: LM, state: Mapping[str, Any],
                     lazy: bool = False) -> Dict:
    """The port's AdamW state in the layout of the reference's
    ``adamw_init``: ``m``, ``v`` and (where the state has it) ``master``
    shaped like ``params_to_jax`` (``lazy`` as there), ``step`` an int32
    scalar. The inverse of ``opt_state_from_jax``. A ZeRO-1 state's
    DTensor leaves are gathered whole from their chunks (``tp.host_leaf``),
    as the reference writes a sharded array gathered."""
    out: Dict[str, Any] = {key: jax_tree(cfg, model, _host_leaf(state[key].__getitem__, lazy))
                           for key in ("m", "v", "master") if key in state}
    step = state["step"]
    step = step.to_local() if isinstance(step, DTensor) else step
    out["step"] = torch.tensor(int(step), dtype=torch.int32)
    return out
