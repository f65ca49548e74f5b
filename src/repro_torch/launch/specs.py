"""Input specs and sharding assignments per (architecture × shape) dry-run
cell, on the meta device: no memory is allocated here.

Port of ``src/repro/launch/specs.py``. Shapes:
    train_4k     seq=4096,   global_batch=256   -> train_step
    prefill_32k  seq=32768,  global_batch=32    -> prefill (forward + caches)
    decode_32k   seq=32768,  global_batch=128   -> serve_step (1 new token)
    long_500k    seq=524288, global_batch=1     -> serve_step; sub-quadratic
                 archs only (jamba: 9 attention layers w/ seq-sharded cache +
                 O(1) mamba states; xlstm: O(1) states). Skipped for the 8
                 pure-full-attention archs.

The parameters and caches are the port's model and ``init_caches`` on
``torch.device("meta")``; a batch input is a ``TensorSpec`` (shape, dtype
and sharding, the counterpart of a ``ShapeDtypeStruct`` with a sharding).
The port's caches are one dict a layer where the reference stacks them; the
cache rules read dims from the end, so they give each layer the spec of the
reference's stacked leaf without its leading stack dim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..distributed.context import P
from ..distributed.sharding import Sharding
from ..launch.mesh import Mesh, describe
from ..models.config import ModelConfig
from ..models.lm import LM, init_caches, init_params

SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

SUBQUADRATIC = {"jamba-1.5-large-398b", "xlstm-1.3b"}

META = torch.device("meta")


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "long_500k needs sub-quadratic attention (full-attention arch)"
    return True, ""


@dataclass(frozen=True)
class TensorSpec:
    """An input's shape, dtype and sharding."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Sharding

    def meta(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=META)


# -------------------------------------------------------------------- helpers
def _batch_axes(mesh: Mesh, batch: int):
    """Largest prefix of ('pod','data') that divides `batch`."""
    sizes = describe(mesh).shape
    total = 1
    used = []
    for a in ("pod", "data"):
        if a in sizes and batch % (total * sizes[a]) == 0:
            used.append(a)
            total *= sizes[a]
    return tuple(used) if used else None


def abstract_params(cfg: ModelConfig, trainable: bool = False) -> LM:
    return init_params(cfg, seed=None, device=META, trainable=trainable)


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    return init_caches(cfg, batch, max_len, device=META)


def batch_specs(cfg: ModelConfig, mesh: Mesh, seq: int, batch: int,
                with_labels: bool, decode: bool = False) -> Dict[str, TensorSpec]:
    ba = _batch_axes(mesh, batch)
    out: Dict[str, TensorSpec] = {}
    s_text = seq
    if decode:
        # one new token; modality prefixes already live in the cache
        out["tokens"] = TensorSpec((batch, seq), torch.int32, Sharding(P(ba, None)))
        return out
    dt = getattr(torch, cfg.dtype)
    if cfg.vlm is not None:
        s_text = seq - cfg.vlm.n_patches
        out["vision_embeds"] = TensorSpec((batch, cfg.vlm.n_patches, cfg.d_model),
                                          dt, Sharding(P(ba, None, None)))
    if cfg.is_encdec:
        out["frames"] = TensorSpec((batch, cfg.encdec.enc_len, cfg.d_model),
                                   dt, Sharding(P(ba, None, None)))
    out["tokens"] = TensorSpec((batch, s_text), torch.int32, Sharding(P(ba, None)))
    if with_labels:
        out["labels"] = TensorSpec((batch, s_text), torch.int32, Sharding(P(ba, None)))
    return out


# --------------------------------------------------------- cache shardings
_CACHE_RANK = {"k": 4, "v": 4, "cross_k": 4, "cross_v": 4,
               "c_kv": 3, "k_rope": 3, "ssm": 3, "conv": 3,
               "C": 4, "n": 3, "m": 2,
               "sc": 3, "sn": 3, "sh": 3, "sm": 3}
# per-dim axes from the END of the array (after the batch dim)
_CACHE_TAIL = {"k": (None, "model", None), "v": (None, "model", None),
               "cross_k": (None, "model", None), "cross_v": (None, "model", None),
               "c_kv": ("model", None), "k_rope": ("model", None),
               "ssm": ("model", None), "conv": (None, "model"),
               "C": (None, None, "model"), "n": (None, None), "m": (None,),
               "sc": (None, None), "sn": (None, None),
               "sh": (None, None), "sm": (None, None)}


def _cache_spec(name: str, shape: Tuple[int, ...], mesh: Mesh, ba) -> P:
    rank = _CACHE_RANK.get(name)
    if rank is None:
        return P()
    sizes = describe(mesh).shape
    tail = _CACHE_TAIL[name]
    ndim = len(shape)
    axes: list = [None] * ndim
    axes[ndim - rank] = ba          # batch dim
    for i, a in enumerate(tail):
        dim = ndim - len(tail) + i
        if a is not None and a in sizes and shape[dim] % sizes[a] == 0:
            axes[dim] = a
    return P(*axes)


def cache_shardings(caches: Dict, mesh: Mesh, batch: int) -> Dict:
    """The caches' structure (``{"layers": [{name: tensor}, ...]}``) with a
    ``Sharding`` for each tensor, by its name."""
    ba = _batch_axes(mesh, batch)
    return {"layers": [{name: Sharding(_cache_spec(name, tuple(t.shape), mesh, ba))
                        for name, t in layer.items()}
                       for layer in caches["layers"]]}
