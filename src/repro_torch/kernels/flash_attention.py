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
block-multiple assertion); the key and value head dims (Dhk, Dhv) are those
of an instantiation in ``HEAD_DIMS``: (16, 16), (32, 32), (64, 64), (128,
128), or MLA's (192, 128) (a key of 128 + 64 rope dims, as the JAX model's
flash takes Dhk > Dhv), or any narrower pair, which the wrapper zero-pads to
the smallest instantiation that covers it (``instantiation``): 8 and 12 go to
(16, 16), MLA's (24, 16) to (32, 32). The padding is exact: zero columns add
nothing to q . k, and zero columns of v give zero output columns, which are
sliced away; the kernel takes the scale Dhk^-1/2 of the unpadded width. The
scores are scaled by Dhk^-1/2; inputs are bf16 or fp32 with fp32 sums; the
output, (B, H, Sq, Dhv), has q's dtype. A row whose every score is masked
is 0.

Its gradient: where q, k or v requires grad on a CUDA tensor,
``flash_attention`` runs ``FlashAttentionFunction``, whose forward is the
kernel with its row log-sum-exp output and whose backward is the
hand-written kernel of ``csrc/flash_attention_bwd.cu`` (counted in
``flash_attention.backward_launches``; in bf16 two deterministic TMA and
``wgmma`` passes, dK/dV and dQ, after a delta pass), the gradient the JAX
model takes by autodiff of its XLA scan (``src/repro/models/attention.py:70``). On a CPU
tensor, or with ``impl="plain"``, the gradient is autograd through
``flash_attention_plain``. Under ``no_grad`` the forward kernel writes no
log-sum-exp.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

SOURCES = ("flash_attention.cu",)
BWD_SOURCES = ("flash_attention_bwd.cu",)
# (Dhk, Dhv) of the kernels' instantiations, the smallest first
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))
DTYPES = (torch.bfloat16, torch.float32)
# The backward kernel against autograd through the plain version on the same
# inputs. fp32: 1e-4 of each gradient's max |value| (the sums' order only);
# bf16: relative RMS 2e-2 (P and dS round to bf16 before their products). A
# gradient that is 0 but for rounding (one key: softmax is constant, so
# dQ = dK = 0), its max or norm below ZERO_GRAD of dV's, is held against dV's
# scale instead.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ZERO_GRAD = 1e-3


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool, q_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, Dhk); k: (B, KH, Sk, Dhk); v: (B, KH, Sk, Dhv) with
    H = KH * G; q head h reads kv head h // G. fp32 softmax attention scaled
    by ``scale`` (default Dhk^-1/2), output (B, H, Sq, Dhv) in q's dtype."""
    B, H, Sq, Dh = q.shape
    KH, Sk, Dhv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q.reshape(B, KH, H // KH, Sq, Dh).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * (
        Dh ** -0.5 if scale is None else scale)
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        kv_pos = torch.arange(Sk, device=q.device)
        s = s.masked_fill(q_pos[:, None] < kv_pos[None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bksd->bkgqd", p / l, v.float())
    return out.reshape(B, H, Sq, Dhv).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention", SOURCES)
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, i32, i32, i32, i32,
                                        i32, i32, ctypes.c_float, i32, ptr]
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd", BWD_SOURCES)
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.flash_attention_bwd.argtypes = [ptr] * 10 + [i32] * 9 + [ctypes.c_float, i32, ptr]
    lib.flash_attention_bwd.restype = i32
    lib.flash_attention_bwd_error_string.argtypes = [i32]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def instantiation(Dhk: int, Dhv: int) -> tuple:
    """The smallest (Dhk', Dhv') of ``HEAD_DIMS`` with Dhk' >= Dhk and Dhv' >=
    Dhv: the widths the kernel runs the call at, zero-padded. Raises a
    ``ValueError`` naming the instantiations where none covers them."""
    for dims in HEAD_DIMS:
        if dims[0] >= Dhk >= 1 and dims[1] >= Dhv >= 1:
            return dims
    raise ValueError(f"head dims (Dhk, Dhv) = {(Dhk, Dhv)}: no instantiation of "
                     f"{HEAD_DIMS} covers them")


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``width`` (a new contiguous
    tensor), or ``t`` itself where it is that wide."""
    return t if t.shape[-1] == width else torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"want q (B,H,Sq,Dhk), k (B,KH,Sk,Dhk), v (B,KH,Sk,Dhv); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"share B and Dh with KH dividing H")
    instantiation(Dh, v.shape[3])
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


def _forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int, with_lse: bool):
    """Launch the forward kernel: (out, lse), lse (B, H, Sq) fp32 or None.
    Head dims between instantiations run zero-padded (``instantiation``)."""
    B, H, Sq, Dh = q.shape
    KH, Sk, Dhv = k.shape[1], k.shape[2], v.shape[3]
    dk, dv = instantiation(Dh, Dhv)
    q, k, v = _pad(q, dk), _pad(k, dk), _pad(v, dv)
    out = q.new_empty((B, H, Sq, dv))
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out[..., :Dhv], lse
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, KH, Sq, Sk, dk, dv, q_offset, int(causal), Dh ** -0.5,
            int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return (out if dv == Dhv else out[..., :Dhv].contiguous()), lse


def flash_attention_backward_plain(q, k, v, dout, *, causal: bool,
                                   q_offset: int = 0,
                                   scale: Optional[float] = None):
    """(dq, dk, dv): autograd through ``flash_attention_plain`` at ``scale``
    (default Dhk^-1/2)."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*qkv, causal=causal, q_offset=q_offset, scale=scale)
        return torch.autograd.grad(out, qkv, dout)


def backward_errors(got, ref) -> list:
    """For each of (dq, dk, dv) in ``got`` against ``ref``: (error, error /
    tolerance), the error and its tolerance as ``BWD_TOL`` says."""
    dtype = ref[0].dtype
    size = (lambda t: t.abs().max()) if dtype == torch.float32 else torch.linalg.norm
    dv = size(ref[2].float())
    out = []
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        scale = size(r) if size(r) > ZERO_GRAD * dv else dv
        e = (size(g - r) / scale.clamp_min(1e-30)).item()
        out.append((e, e / BWD_TOL[dtype]))
    return out


def _check_backward(q, k, v, o, dout, lse, q_offset: int) -> None:
    _check(q, k, v, q_offset)
    want = (*q.shape[:3], v.shape[3])                     # (B, H, Sq, Dhv)
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != want or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's (B, H, Sq) and v's Dhv: "
                             f"{tuple(t.shape)} {t.dtype} {t.device} against "
                             f"{want} {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous fp32 (B, H, Sq) tensor on "
                         f"q's device; got {tuple(lse.shape)} {lse.dtype}")


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, dout: torch.Tensor,
                             lse: torch.Tensor, *, causal: bool,
                             q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention`` given its output ``o``, the
    output's gradient ``dout`` and the forward's row log-sum-exp ``lse``
    (B, H, Sq) fp32. A CUDA tensor launches the Hopper backward kernel
    (counted in ``flash_attention.backward_launches``), with q, k, v, o and
    dout zero-padded to the instantiation as in the forward and dq, dk, dv
    sliced back (delta = rowsum(dout o o) does not change); a CPU tensor
    takes ``flash_attention_backward_plain``, which needs neither o nor
    lse."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                              q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_backward(q, k, v, o, dout, lse, q_offset)
    B, H, Sq, Dh = q.shape
    KH, Sk, Dhv = k.shape[1], k.shape[2], v.shape[3]
    wk, wv = instantiation(Dh, Dhv)
    q, k, v = _pad(q, wk), _pad(k, wk), _pad(v, wv)
    o, dout = _pad(o, wv), _pad(dout, wv)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, KH, Sq, Sk, wk, wv, q_offset,
            int(causal), Dh ** -0.5, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("flash_attention backward kernel launch failed: "
                           + lib.flash_attention_bwd_error_string(err).decode())
    flash_attention.backward_launches += 1
    if (wk, wv) == (Dh, Dhv):
        return dq, dk, dv
    return (dq[..., :Dh].contiguous(), dk[..., :Dh].contiguous(),
            dv[..., :Dhv].contiguous())


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel with its gradient: the forward kernel writes the row
    log-sum-exp, saved with q, k, v and the output; the backward is the
    backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        out, lse = _forward_kernel(q, k, v, causal, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q: (B, H, Sq, Dhk); k: (B, KH, Sk, Dhk); v: (B, KH, Sk, Dhv), (Dhk, Dhv)
    covered by an instantiation of ``HEAD_DIMS``. Returns (B, H, Sq, Dhv).

    A CUDA tensor launches the Hopper kernel on the current stream (counted
    in ``flash_attention.launches``), through ``FlashAttentionFunction``
    where grad is enabled and an input requires it; a CPU tensor, or
    ``impl="plain"``, takes ``flash_attention_plain``."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, q_offset)
    return _forward_kernel(q, k, v, causal, q_offset, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.backward_launches = 0
