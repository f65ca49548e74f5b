"""Chunkwise mLSTM: the Hopper kernel's wrapper and its plain version.

``mlstm_chunk`` is the port of the Pallas TPU kernel
``src/repro/kernels/mlstm_chunk.py:22 _mlstm_kernel``. On a CUDA tensor it
launches the hand-written kernels of ``csrc/mlstm_chunk.cu`` (built at first
use, see ``build.py``) or raises; on a CPU tensor, or with ``impl="plain"``,
it computes ``mlstm_chunk_plain``, the model's chunk body
(``src/repro/models/xlstm.py:59 _mlstm_chunk_body``) looped over the chunks.
There is no fallback from the kernel to the plain version.

The gradient: where grad is enabled and an input requires it, a CUDA call
goes through ``MLSTMChunkFunction``, whose backward is the hand-written
kernel of ``csrc/mlstm_chunk_bwd.cu`` (``mlstm_chunk_backward``). The JAX
package has no backward kernel: JAX differentiates its chunk scan
(``src/repro/models/xlstm.py:59-116``), so the backward is held against
autograd of ``mlstm_chunk_plain``, which is also its CPU route.

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
BWD_SOURCES = ("mlstm_chunk_bwd.cu",)
MAX_CHUNK = 64          # rows of a chunk tile in the kernel
HEAD_ALIGN = 32         # Dh must be a multiple of this (the kernel's column slice)
MAX_HEAD_DIM = 1024     # C's column slice must fit one CTA's shared memory

# The backward against autograd of the plain version, both fp32: each
# gradient's max abs difference over its max abs value. The kernel's sums
# run in another order than autograd's (measured 1e-7 to 2.2e-5 on the
# card's cases, chip_smoke.py phase 10a); 1e-4, as the flash backward's fp32. Where q . n nears 0 (near-cancelling
# denominators), h and its gradient are ill-conditioned: two fp32 orders of
# the sums disagree beyond that, so there both are held against an fp64
# plain autograd, the kernel to the larger of BWD_TOL and BWD_FLOOR_FACTOR
# times the fp32 plain version's own error.
BWD_TOL = 1e-4
BWD_FLOOR_FACTOR = 3.0
GRAD_NAMES = ("dq", "dk", "dv", "dli", "dlf", "dC0", "dn0", "dm0")

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
    # intra-chunk: W[t,s] = exp(F_t - F_s + li_s - m_t), s <= t. Masked
    # before the exp, which gives the reference's values; the reference's
    # where-after-exp has a NaN gradient where exp(logw) overflows above the
    # diagonal (forget gates summing below -88 within a chunk)
    logw = (F - m)[..., :, None] + g[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    W = torch.exp(torch.where(mask, logw, float("-inf")))
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
    lib.mlstm_chunk_fwd.argtypes = [ptr] * 13 + [i32] * 4 + [ptr]
    lib.mlstm_chunk_fwd.restype = i32
    lib.mlstm_chunk_scratch_bytes.argtypes = [i32] * 4
    lib.mlstm_chunk_scratch_bytes.restype = ctypes.c_size_t
    lib.mlstm_chunk_error_string.argtypes = [i32]
    lib.mlstm_chunk_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.load("mlstm_chunk_bwd", BWD_SOURCES)
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.mlstm_chunk_bwd.argtypes = [ptr] * 22 + [i32] * 4 + [ptr]
    lib.mlstm_chunk_bwd.restype = i32
    lib.mlstm_chunk_bwd_scratch_bytes.argtypes = [i32] * 4
    lib.mlstm_chunk_bwd_scratch_bytes.restype = ctypes.c_size_t
    lib.mlstm_chunk_bwd_error_string.argtypes = [i32]
    lib.mlstm_chunk_bwd_error_string.restype = ctypes.c_char_p
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 8:           # the kernel reads two values at a time
            raise ValueError(f"{name} must be 8-byte aligned")


def _forward_kernel(q, k, v, li, lf, chunk: int,
                    state: Optional[State]) -> Tuple[torch.Tensor, State]:
    """Launch the forward kernel (checked inputs): h and the final state."""
    B, H, S, Dh = q.shape
    h = torch.empty_like(q)
    out = {"C": q.new_empty(B, H, Dh, Dh), "n": q.new_empty(B, H, Dh),
           "m": q.new_empty(B, H)}
    s0 = [0, 0, 0] if state is None else [state[key].data_ptr()
                                          for key in ("C", "n", "m")]
    lib = _library()
    scratch = torch.empty(lib.mlstm_chunk_scratch_bytes(B * H, S, Dh, chunk),
                          dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mlstm_chunk_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
            lf.data_ptr(), *s0, h.data_ptr(), out["C"].data_ptr(),
            out["n"].data_ptr(), out["m"].data_ptr(), scratch.data_ptr(),
            B * H, S, Dh, chunk, stream)
    if err:
        raise RuntimeError("mlstm_chunk kernel launch failed: "
                           + lib.mlstm_chunk_error_string(err).decode())
    mlstm_chunk.launches += 1
    return h, out


def mlstm_chunk_backward_plain(q, k, v, li, lf, dh, *, chunk: int = 64,
                               state: Optional[State] = None, dC=None,
                               dn=None, dm=None) -> tuple:
    """Autograd of ``mlstm_chunk_plain``: (dq, dk, dv, dli, dlf, dC0, dn0,
    dm0), the last three None without a state. ``dC``, ``dn``, ``dm``, the
    final state's gradient, may be None (none)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v, li, lf)]
        st = None if state is None else {key: state[key].detach().requires_grad_()
                                         for key in ("C", "n", "m")}
        h, out = mlstm_chunk_plain(*ins, chunk=chunk, state=st)
        pairs = [(h, dh)] + [(out[key], g) for key, g in zip("Cnm", (dC, dn, dm))
                             if g is not None]
        wrt = ins + ([] if st is None else [st[key] for key in ("C", "n", "m")])
        grads = torch.autograd.grad([o for o, _ in pairs], wrt,
                                    [g for _, g in pairs])
    return tuple(grads) + ((None,) * 3 if state is None else ())


def _check_backward(q, h, dh, dstate) -> None:
    B, H, S, Dh = q.shape
    want = {"C": (B, H, Dh, Dh), "n": (B, H, Dh), "m": (B, H)}
    named = [("h", h, q.shape), ("dh", dh, q.shape)]
    named += [(f"d{key}", g, want[key]) for key, g in zip("Cnm", dstate)
              if g is not None]
    for name, t, shape in named:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(t.shape)}, want {tuple(shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mlstm_chunk_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         li: torch.Tensor, lf: torch.Tensor, h: torch.Tensor,
                         dh: torch.Tensor, *, chunk: int = 64,
                         state: Optional[State] = None, dC=None, dn=None,
                         dm=None) -> tuple:
    """The gradient of ``mlstm_chunk`` given its output ``h``, h's gradient
    ``dh`` and, where there is one, the final state's (``dC``, ``dn``,
    ``dm``; None: no gradient). Returns (dq, dk, dv, dli, dlf, dC0, dn0,
    dm0), the last three None without an initial ``state``.

    A CUDA tensor launches the Hopper backward kernel on the current stream
    (counted in ``mlstm_chunk.backward_launches``); a CPU tensor takes
    ``mlstm_chunk_backward_plain``, which needs no h."""
    chunk = min(chunk, q.shape[2])
    if q.device.type == "cpu":
        return mlstm_chunk_backward_plain(q, k, v, li, lf, dh, chunk=chunk,
                                          state=state, dC=dC, dn=dn, dm=dm)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, li, lf, chunk, state)
    _check_backward(q, h, dh, (dC, dn, dm))
    B, H, S, Dh = q.shape
    grads = [torch.empty_like(q) for _ in range(3)] + [torch.empty_like(li)
                                                       for _ in range(2)]
    dstate0 = ([None] * 3 if state is None else
               [torch.empty_like(state[key]) for key in ("C", "n", "m")])
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    s0 = [None] * 3 if state is None else [state[key] for key in ("C", "n", "m")]
    lib = _bwd_library()
    scratch = torch.empty(lib.mlstm_chunk_bwd_scratch_bytes(B * H, S, Dh, chunk),
                          dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mlstm_chunk_bwd(
            *map(ptr, (q, k, v, li, lf, *s0, h, dh, dC, dn, dm, *grads, *dstate0,
                       scratch)),
            B * H, S, Dh, chunk, stream)
    if err:
        raise RuntimeError("mlstm_chunk backward kernel launch failed: "
                           + lib.mlstm_chunk_bwd_error_string(err).decode())
    mlstm_chunk.backward_launches += 1
    return tuple(grads) + tuple(dstate0)


class MLSTMChunkFunction(torch.autograd.Function):
    """The chunkwise mLSTM with its gradient. Inputs q, k, v, li, lf and the
    initial state C0, n0, m0 (all None: the empty state); outputs h and the
    final C, n, m. The forward is the kernel (the plain version on CPU
    tensors) and saves its inputs and h; the backward is
    ``mlstm_chunk_backward`` of h's gradient and of the final state's where
    autograd passes them."""

    @staticmethod
    def forward(ctx, q, k, v, li, lf, C0, n0, m0, chunk: int):
        state = None if C0 is None else {"C": C0, "n": n0, "m": m0}
        if q.device.type == "cpu":
            h, out = mlstm_chunk_plain(q, k, v, li, lf, chunk=chunk, state=state)
        else:
            h, out = _forward_kernel(q, k, v, li, lf, chunk, state)
        ctx.save_for_backward(q, k, v, li, lf, C0, n0, m0, h)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return h, out["C"], out["n"], out["m"]

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, li, lf, C0, n0, m0, h = ctx.saved_tensors
        state = None if C0 is None else {"C": C0, "n": n0, "m": m0}
        dh = torch.zeros_like(h) if dh is None else dh.contiguous()
        dC, dn, dm = (None if g is None else g.contiguous() for g in (dC, dn, dm))
        grads = mlstm_chunk_backward(q, k, v, li, lf, h, dh, chunk=ctx.chunk,
                                     state=state, dC=dC, dn=dn, dm=dm)
        return (*grads, None)


def backward_errors(got, ref) -> dict:
    """{name: max |got - ref| / max |ref|} of each gradient that ``ref`` has
    (``GRAD_NAMES`` order, None where there is none)."""
    out = {}
    for name, g, r in zip(GRAD_NAMES, got, ref):
        if r is not None:
            g, r = g.double(), r.double()
            out[name] = ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
    return out


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                li: torch.Tensor, lf: torch.Tensor, *, chunk: int = 64,
                state: Optional[State] = None,
                impl: Optional[str] = None) -> Tuple[torch.Tensor, State]:
    """q, k, v: (B,H,S,Dh) fp32 (k pre-scaled); li, lf: (B,H,S) fp32; an
    optional initial ``state``. Returns h (B,H,S,Dh) and the final state.

    A CUDA tensor launches the Hopper kernels on the current stream (counted
    in ``mlstm_chunk.launches``, once a call), through ``MLSTMChunkFunction``
    where grad is enabled and an input requires it; a CPU tensor, or
    ``impl="plain"``, takes ``mlstm_chunk_plain``."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    chunk = min(chunk, q.shape[2])
    if impl == "plain" or q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, li, lf, chunk=chunk, state=state)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, li, lf, chunk, state)
    s0 = (None,) * 3 if state is None else tuple(state[key] for key in ("C", "n", "m"))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, li, lf, *s0)):
        h, C, n, m = MLSTMChunkFunction.apply(q, k, v, li, lf, *s0, chunk)
        return h, {"C": C, "n": n, "m": m}
    return _forward_kernel(q, k, v, li, lf, chunk, state)


mlstm_chunk.launches = 0
mlstm_chunk.backward_launches = 0
