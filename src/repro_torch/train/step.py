"""Train-step builder: microbatch gradient accumulation, AdamW, low-precision grads.

Port of ``src/repro/train/step.py:22``. The batch splits into ``accum``
microbatches along its first axis; each microbatch's gradient is taken by
autograd (on the card the attention and mLSTM gradients are their backward
kernels), added to an accumulator in ``grad_dtype``, and the sum is scaled
by ``1 / accum`` in that dtype before ``adamw_update``. Activation memory is
one microbatch's, as the reference's ``lax.scan`` keeps it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.lm import LM, loss_fn
from .optimizer import AdamWConfig, adamw_update

# What two computations of one step are held to: this port against the
# reference, or the kernels against their plain versions. fp32: loss, grad
# norm and every updated parameter to 1e-5 (the sums' order only). bf16:
# activations and gradients round to bf16 at different places. Adam's first
# step moves each weight by about lr times the sign of its gradient, so where
# a gradient is near 0 the two can step opposite ways: each tensor's update
# must agree to within lr / 2 on most of its elements, and the updated
# parameters as a whole to a relative RMS of 1e-2; loss and grad norm to 1e-2.
STEP_TOL = 1e-5
BF16_STEP_TOL = {"loss": 1e-2, "grad_norm": 1e-2, "update_agree": 0.95,
                 "params_rel_rms": 1e-2}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, accum: int = 1,
                    grad_dtype: str = "bfloat16", attn_impl: Optional[str] = None,
                    mlstm_impl: Optional[str] = None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    {"loss", "grad_norm"})``, updating the model and state in place.
    ``attn_impl="plain"`` and ``mlstm_impl="plain"`` take attention and the
    mLSTM scan, and their gradients, through the kernels' plain versions."""
    gdt = getattr(torch, grad_dtype)

    def train_step(model: LM, opt_state: Dict, batch: Dict[str, torch.Tensor]):
        names, params = zip(*model.named_parameters())
        if accum == 1:
            loss, _ = loss_fn(cfg, model, batch, attn_impl=attn_impl,
                              mlstm_impl=mlstm_impl)
            grads = [g.to(gdt) for g in torch.autograd.grad(loss, params)]
            loss = loss.detach()
        else:
            b = next(iter(batch.values())).shape[0]
            mbs = {key: x.reshape((accum, b // accum) + x.shape[1:])
                   for key, x in batch.items()}
            grads = [torch.zeros(p.shape, dtype=gdt, device=p.device) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
            for i in range(accum):
                mb_loss, _ = loss_fn(cfg, model, {key: x[i] for key, x in mbs.items()},
                                     attn_impl=attn_impl, mlstm_impl=mlstm_impl)
                for acc, g in zip(grads, torch.autograd.grad(mb_loss, params)):
                    acc.add_(g.to(gdt))
                loss = loss + mb_loss.detach()
            inv = 1.0 / accum
            for g in grads:                       # in place: one set of grads
                g.mul_(torch.tensor(inv, dtype=gdt, device=g.device))
            loss = loss * inv
        model, opt_state, gnorm = adamw_update(model, dict(zip(names, grads)),
                                               opt_state, opt_cfg)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
