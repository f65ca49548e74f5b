"""GQA flash attention: the Hopper kernel's wrapper and its plain version.

``flash_attention`` is the port of the Pallas TPU kernel
``src/repro/kernels/flash_attention.py:25 _flash_kernel``. On a CUDA tensor it
launches the hand-written kernel of ``csrc/flash_attention.cu`` (built at
first use, see ``build.py``; in bf16 a TMA and ``wgmma`` kernel with a
producer warpgroup, in fp32 a CUDA-core one) or raises; on a CPU tensor, or with
``impl="plain"``, it computes ``flash_attention_plain``, the naive softmax
attention of ``src/repro/kernels/ref.py:9`` with the same masks. There is no
fallback from the kernel to the plain version.

The function, beyond the TPU kernel's: ``q_offset`` places query row i at
position ``q_offset + i`` under the causal mask; Sq and Sk are free (no
block-multiple assertion); Dh is 32, 64 or 128; inputs are bf16 or fp32 with
fp32 sums; the output has q's dtype. A row whose every score is masked is 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

SOURCES = ("flash_attention.cu",)
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, Dh); k, v: (B, KH, Sk, Dh) with H = KH * G; q head h
    reads kv head h // G. fp32 softmax attention, output in q's dtype."""
    B, H, Sq, Dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KH, H // KH, Sq, Dh).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * Dh ** -0.5
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        kv_pos = torch.arange(Sk, device=q.device)
        s = s.masked_fill(q_pos[:, None] < kv_pos[None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bksd->bkgqd", p / l, v.float())
    return out.reshape(B, H, Sq, Dh).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention", SOURCES)
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ptr, ptr, ptr, ptr,
                                        i32, i32, i32, i32, i32, i32,
                                        i32, i32, ctypes.c_float, i32, ptr]
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,Sq,Dh), k = v (B,KH,Sk,Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"share B and Dh with KH dividing H")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q: (B, H, Sq, Dh); k, v: (B, KH, Sk, Dh). Returns (B, H, Sq, Dh).

    A CUDA tensor launches the Hopper kernel on the current stream (counted
    in ``flash_attention.launches``); a CPU tensor, or ``impl="plain"``,
    takes ``flash_attention_plain``."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, q_offset)
    B, H, Sq, Dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KH, Sq, Sk, Dh, q_offset, int(causal), Dh ** -0.5,
            int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
