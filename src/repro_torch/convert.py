"""Carry a JAX parameter tree into the port's model by a plain copy.

``params_from_jax(cfg, tree, device)`` takes the tree of
``repro.models.lm.init_params`` as numpy arrays (``jax.device_get``) and
returns the port's ``LM`` with the same values. The JAX tree stacks each
block-pattern entry ``j`` over ``n_groups``; layer ``g * len(pattern) + j`` of
the port is ``groups[j][g]``. Each block's parameters copy by name: ``ln1``,
``attn``, ``ln2`` and ``mlp`` for ``attn+mlp``; ``ln1`` and the mixer's
leaves (``x_up`` .. ``x_out``, ``s_gates`` .. ``s_out``) for ``mlstm`` and
``slstm``. bf16 arrays arrive through their ``uint16`` view, so this module
needs neither JAX nor ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models.config import ModelConfig
from .models.lm import LM, init_params


def tensor_from_numpy(arr: Any) -> torch.Tensor:
    """A numpy array (fp32, int or bf16 from ``ml_dtypes``) as a CPU tensor."""
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


def params_from_jax(cfg: ModelConfig, tree: Mapping[str, Any], device=None) -> LM:
    """The port's model holding ``tree``'s values, on the card unless
    ``device`` names another."""
    model = init_params(cfg, seed=None, device=device)
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_norm, tree["final_norm"], "final_norm")
    if model.head is not None:
        _copy(model.head, tree["head"], "head")
    n_pat = len(cfg.block_pattern)
    for i, blk in enumerate(model.blocks):
        g, j = divmod(i, n_pat)
        src = tree["groups"][j]
        for part, mod in blk.named_children():
            for name, p in mod.named_parameters():
                _copy(p, src[part][name][g], f"layer {i} {part}.{name}")
        for name, p in blk.named_parameters(recurse=False):
            _copy(p, src[name][g], f"layer {i} {name}")
    return model
