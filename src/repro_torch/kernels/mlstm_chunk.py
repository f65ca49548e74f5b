"""Chunkwise mLSTM: the Hopper kernel's wrapper and its plain version.

``mlstm_chunk`` is the port of the Pallas TPU kernel
``src/repro/kernels/mlstm_chunk.py:22 _mlstm_kernel``. On a CUDA tensor it
launches the hand-written kernels of ``csrc/mlstm_chunk.cu`` (built at first
use, see ``build.py``) or raises; on a CPU tensor, or with ``impl="plain"``,
it computes ``mlstm_chunk_plain``, the model's chunk body
(``src/repro/models/xlstm.py:59 _mlstm_chunk_body``) looped over the chunks.
There is no fallback from the kernel to the plain version.

The function, beyond the TPU kernel's: it takes an initial state and returns
the final one, ``{"C": (B,H,Dh,Dh), "n": (B,H,Dh), "m": (B,H)}`` in the layout
of ``init_mlstm_state``, so a prefill hands its state to decode; and the last
chunk may be shorter than ``chunk`` (the reference asserts S % chunk == 0).
Inputs are fp32, k pre-scaled by Dh^-0.5; li is the raw input gate and lf the
log-sigmoid forget gate. The kernel takes Dh a multiple of 32 up to 1024 and
a chunk of at most 64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import build

SOURCES = ("mlstm_chunk.cu",)
MAX_CHUNK = 64          # rows of a chunk tile in the kernel
HEAD_ALIGN = 32         # Dh must be a multiple of this (the kernel's column slice)
MAX_HEAD_DIM = 1024     # C's column slice must fit one CTA's shared memory

State = Dict[str, torch.Tensor]


def init_state(B: int, H: int, Dh: int, device,
               dtype: torch.dtype = torch.float32) -> State:
    """The empty state: C = 0, n = 0 and the stabiliser m = -1e30."""
    return {"C": torch.zeros(B, H, Dh, Dh, dtype=dtype, device=device),
            "n": torch.zeros(B, H, Dh, dtype=dtype, device=device),
            "m": torch.full((B, H), -1e30, dtype=dtype, device=device)}


def _chunk_body(q, k, v, li, lf, C0, n0, m0):
    """One chunk of length L (the port of ``_mlstm_chunk_body``). q, k, v:
    (B,H,L,Dh); li, lf: (B,H,L); state C0 (B,H,Dh,Dh), n0 (B,H,Dh), m0 (B,H).
    Returns h and the state after the chunk."""
    L = q.shape[2]
    F = torch.cumsum(lf, dim=-1)                       # inclusive log-decay
    g = li - F
    run = torch.maximum(m0[..., None], torch.cummax(g, dim=-1).values)
    m = F + run                                        # stabiliser per t
    # intra-chunk: W[t,s] = exp(F_t - F_s + li_s - m_t), s <= t
    logw = (F - m)[..., :, None] + g[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    W = torch.where(mask, torch.exp(logw), torch.zeros((), device=q.device))
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * W
    h_num = torch.einsum("bhts,bhsd->bhtd", scores, v)
    n_intra = torch.einsum("bhts,bhsd->bhtd", W, k)
    # inter-chunk: the state's contribution
    w_state = torch.exp(F + m0[..., None] - m)
    h_num = h_num + w_state[..., None] * torch.einsum("bhtd,bhde->bhte", q, C0)
    n_t = n_intra + w_state[..., None] * n0[..., None, :]
    denom = torch.einsum("bhtd,bhtd->bht", q, n_t).abs()
    h = h_num / torch.maximum(denom, torch.exp(-m))[..., None]
    # next state
    m_L = m[..., -1]
    wk = torch.exp((F[..., -1:] - F) + li - m_L[..., None])
    decay = torch.exp(F[..., -1] + m0 - m_L)
    kw = k * wk[..., None]
    C = decay[..., None, None] * C0 + kw.transpose(-1, -2) @ v
    n = decay[..., None] * n0 + kw.sum(2)
    return h, (C, n, m_L)


def mlstm_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      li: torch.Tensor, lf: torch.Tensor, *, chunk: int = 64,
                      state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """The chunk body over chunks of ``min(chunk, S)``, in order; the last
    chunk may be shorter. Returns h (B,H,S,Dh) and the final state."""
    B, H, S, Dh = q.shape
    if state is None:
        state = init_state(B, H, Dh, q.device, q.dtype)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t0 in range(0, S, chunk):
        sl = slice(t0, t0 + chunk)
        h, (C, n, m) = _chunk_body(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                   li[:, :, sl], lf[:, :, sl], C, n, m)
        hs.append(h)
    return torch.cat(hs, dim=2), {"C": C.contiguous(), "n": n.contiguous(),
                                  "m": m.contiguous()}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("mlstm_chunk", SOURCES)
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.mlstm_chunk_fwd.argtypes = [ptr] * 14 + [i32, i32, i32, i32, ptr]
    lib.mlstm_chunk_fwd.restype = i32
    lib.mlstm_chunk_error_string.argtypes = [i32]
    lib.mlstm_chunk_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, li, lf, chunk: int, state: Optional[State]) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q = k = v (B,H,S,Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, Dh = q.shape
    if li.shape != (B, H, S) or lf.shape != (B, H, S):
        raise ValueError(f"want li = lf (B,H,S) = {(B, H, S)}; got "
                         f"{tuple(li.shape)}, {tuple(lf.shape)}")
    if S < 1:
        raise ValueError("the sequence is empty")
    if Dh % HEAD_ALIGN or Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} is not a multiple of {HEAD_ALIGN} "
                         f"up to {MAX_HEAD_DIM}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    named = [("q", q), ("k", k), ("v", v), ("li", li), ("lf", lf)]
    if state is not None:
        want = {"C": (B, H, Dh, Dh), "n": (B, H, Dh), "m": (B, H)}
        for key, shape in want.items():
            if tuple(state[key].shape) != shape:
                raise ValueError(f"state[{key!r}] is {tuple(state[key].shape)}, "
                                 f"want {shape}")
            named.append((f"state[{key!r}]", state[key]))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                li: torch.Tensor, lf: torch.Tensor, *, chunk: int = 64,
                state: Optional[State] = None,
                impl: Optional[str] = None) -> Tuple[torch.Tensor, State]:
    """q, k, v: (B,H,S,Dh) fp32 (k pre-scaled); li, lf: (B,H,S) fp32; an
    optional initial ``state``. Returns h (B,H,S,Dh) and the final state.

    A CUDA tensor launches the Hopper kernels on the current stream (counted
    in ``mlstm_chunk.launches``, once a call); a CPU tensor, or
    ``impl="plain"``, takes ``mlstm_chunk_plain``."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    chunk = min(chunk, q.shape[2])
    if impl == "plain" or q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, li, lf, chunk=chunk, state=state)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, li, lf, chunk, state)
    B, H, S, Dh = q.shape
    nc = -(-S // chunk)
    h = torch.empty_like(q)
    out = {"C": q.new_empty(B, H, Dh, Dh), "n": q.new_empty(B, H, Dh),
           "m": q.new_empty(B, H)}
    qk = q.new_empty(B * H, nc, MAX_CHUNK, MAX_CHUNK)   # pass 1: Q K^T per chunk
    nloc = torch.empty_like(q)                          # ... and n's intra-chunk part
    s0 = [0, 0, 0] if state is None else [state[key].data_ptr()
                                          for key in ("C", "n", "m")]
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mlstm_chunk_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
            lf.data_ptr(), *s0, h.data_ptr(), out["C"].data_ptr(),
            out["n"].data_ptr(), out["m"].data_ptr(), qk.data_ptr(),
            nloc.data_ptr(), B * H, S, Dh, chunk, stream)
    if err:
        raise RuntimeError("mlstm_chunk kernel launch failed: "
                           + lib.mlstm_chunk_error_string(err).decode())
    mlstm_chunk.launches += 1
    return h, out


mlstm_chunk.launches = 0
