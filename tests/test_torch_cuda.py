"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test marked ``cuda`` needs a CUDA card and skips without one: a CUDA
kernel has no CPU mode. The file imports no JAX, so it runs on a machine with
only PyTorch: ``python -m pytest -m cuda tests/test_torch_cuda.py``. The
wrapper's argument checks, which run before any launch, are tested here on
CPU tensors and carry no marker.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (_check, backward_errors,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.mlstm_chunk import _check as mlstm_check  # noqa: E402
from repro_torch.kernels.mlstm_chunk import mlstm_chunk  # noqa: E402

cuda = pytest.mark.cuda

# fp32: summation order only; bf16: the kernel rounds P to bf16 before P V
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,Sq,Sk,Dh,q_offset,causal", [
    (1, 2, 2, 128, 128, 64, 0, True),       # tests/test_kernels.py FLASH_CASES
    (2, 4, 2, 256, 256, 64, 0, True),
    (2, 8, 2, 256, 256, 128, 0, True),
    (1, 3, 1, 384, 384, 64, 0, True),
    (2, 4, 4, 256, 256, 64, 0, False),
    (1, 2, 1, 512, 512, 32, 0, True),
    (2, 4, 2, 100, 100, 64, 0, True),       # ragged S
    (1, 4, 2, 16, 48, 128, 32, True),       # q_offset
    (4, 32, 8, 32, 32, 128, 0, True),       # qwen3-8b serving prefill
])
def test_flash_kernel_matches_plain(B, H, KH, Sq, Sk, Dh, q_offset, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(Sq + Dh)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to("cuda", getattr(torch, dtype))
               for s in ((B, H, Sq, Dh), (B, KH, Sk, Dh), (B, KH, Sk, Dh)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention(q, k, v, causal=causal, q_offset=q_offset, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# The bf16 kernel's edges: its q and kv tiles are 128 rows, its TMA boxes
# overhang Sq and Sk (zero-filled), its consumers take 64 rows each, and a
# kv tile is masked only on a consumer's diagonal or past Sk
@cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,Dh,q_offset,causal", [
    *[(1, 4, 2, n, n, 128, 0, True) for n in (1, 63, 65, 127, 129, 4097)],
    *[(2, 4, 2, 129, n, 64, 0, False) for n in (1, 63, 65, 127, 4097)],
    (2, 8, 2, 129, 300, 128, 171, True),    # q_offset, Sq < Sk, B > 1, KH > 1
    (1, 8, 2, 63, 1000, 128, 937, True),    # the last 63 rows of a sequence
    (1, 8, 2, 65, 4097, 128, 100, True),    # keys past the last row unseen
    (2, 4, 4, 127, 129, 32, 2, True),       # G = 1, Dh = 32
    (1, 4, 2, 129, 4097, 32, 0, False),     # Dh = 32, long Sk
    (2, 16, 4, 129, 129, 64, 0, True),      # G = 4
    (2, 16, 2, 200, 200, 128, 0, True),     # G = 8
    (3, 8, 2, 65, 127, 128, 0, False),      # non-causal Sk != Sq, B = 3
    (1, 2, 1, 1, 129, 64, 128, True),       # one query at the end
])
def test_flash_kernel_bf16_edges(B, H, KH, Sq, Sk, Dh, q_offset, causal):
    test_flash_kernel_matches_plain(B, H, KH, Sq, Sk, Dh, q_offset, causal, "bfloat16")


def _qkv(Sq=8, Dh=64, dtype=torch.bfloat16, H=4, KH=2):
    return (torch.zeros(1, H, Sq, Dh, dtype=dtype), torch.zeros(1, KH, Sq, Dh, dtype=dtype),
            torch.zeros(1, KH, Sq, Dh, dtype=dtype))


def _misaligned():
    q, k, v = _qkv()
    buf = torch.zeros(q.numel() + 1, dtype=q.dtype)
    return buf[1:].view(q.shape), k, v                 # 2 bytes past 16-byte alignment


def _transposed():
    q, k, v = _qkv(dtype=torch.float32)
    return torch.zeros(1, 4, 64, 8).transpose(2, 3), k, v


# The wrapper's argument checks, on CPU tensors: what the kernels cannot
# take raises before a launch
@pytest.mark.parametrize("make,error,match", [
    (lambda: _qkv(), None, None),
    (lambda: _qkv(dtype=torch.float32, Dh=128), None, None),
    (lambda: _qkv(dtype=torch.float16), TypeError, "dtype"),
    (lambda: (*_qkv()[:2], _qkv()[2].float()), TypeError, "dtype"),
    (lambda: _qkv(Dh=96), ValueError, "head dim"),
    (lambda: (_qkv()[0][0], *_qkv()[1:]), ValueError, "want q"),
    (lambda: _qkv(H=4, KH=3), ValueError, "KH dividing H"),
    (lambda: (*_qkv()[:2], _qkv()[2].to("meta")), ValueError, "one device"),
    (_misaligned, ValueError, "16-byte aligned"),
    (_transposed, ValueError, "contiguous"),
], ids=["bf16", "fp32", "fp16", "mixed-dtype", "dh96", "q-3d", "kh-not-dividing",
        "two-devices", "misaligned", "non-contiguous"])
def test_flash_wrapper_checks(make, error, match):
    q, k, v = make()
    if error is None:
        _check(q, k, v, 0)
    else:
        with pytest.raises(error, match=match):
            _check(q, k, v, 0)


def test_flash_wrapper_rejects_negative_offset():
    with pytest.raises(ValueError, match="q_offset"):
        _check(*_qkv(), -1)



# mLSTM, fp32 in both: the kernel's scans and products sum in another order
# than the plain version's (tests/test_kernels.py's chunkwise tolerance)
MLSTM_TOL = 3e-4


def _mlstm_inputs(seed, B, H, S, Dh, device="cuda", kind=None):
    """Random inputs; kind "forget": small forget gates (F in the hundreds
    within a chunk); "cancel": keys along one direction u, queries nearly
    orthogonal to it, so q . n cancels (as chip_smoke.py's mlstm_inputs)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)  # noqa: E731
    q, k, v = f(B, H, S, Dh), f(B, H, S, Dh) * Dh ** -0.5, f(B, H, S, Dh)
    li, lf = f(B, H, S), torch.nn.functional.logsigmoid(f(B, H, S) + 2.0)
    if kind == "forget":
        lf = 2.0 * torch.nn.functional.logsigmoid(f(B, H, S) - 4.0)
    elif kind == "cancel":
        u = f(Dh)
        u /= u.norm()
        k = (u + 0.05 * f(B, H, S, Dh)) * 4 * Dh ** -0.5
        q = q - (q @ u)[..., None] * u + 0.05 * f(B, H, S, 1) * u
        li = li + 3.0
    return q, k, v, li, lf


# The last four: the kernel's stress inputs. Its exponents are differences
# of numbers in the hundreds, h is ill-conditioned where q . n cancels, and
# the state is carried through the 64 chunks of the xlstm-1.3b prefill
@cuda
@pytest.mark.parametrize("B,H,S,Dh,chunk,carry,kind", [
    (1, 2, 64, 32, 16, False, None),        # tests/test_kernels.py MLSTM_CASES
    (2, 3, 128, 64, 32, False, None),
    (1, 4, 128, 128, 64, False, None),
    (2, 2, 96, 32, 32, False, None),
    (2, 2, 128, 64, 32, True, None),        # a carried-in state
    (1, 2, 100, 64, 32, False, None),       # ragged S
    (1, 2, 70, 1024, 64, True, None),       # xlstm-1.3b's Dh, ragged, carried
    (4, 4, 256, 1024, 64, False, None),     # the served xlstm-1.3b prefill
    (1, 4, 256, 1024, 64, True, "forget"),  # F in the hundreds within a chunk
    (1, 4, 256, 1024, 64, True, "cancel"),  # q nearly orthogonal to n
    (2, 2, 128, 64, 32, True, "cancel"),
    (1, 4, 4096, 1024, 64, True, None),     # the prefill shape, carried state
])
def test_mlstm_kernel_matches_plain(B, H, S, Dh, chunk, carry, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert not torch.backends.cuda.matmul.allow_tf32   # the plain version in fp32
    q, k, v, li, lf = _mlstm_inputs(S + Dh, B, H, S, Dh, kind=kind)
    state = None
    if carry:
        _, state = mlstm_chunk(*_mlstm_inputs(1, B, H, 48, Dh, kind=kind), chunk=chunk,
                               impl="plain")
    before = mlstm_chunk.launches
    h, st = mlstm_chunk(q, k, v, li, lf, chunk=chunk, state=state)
    torch.cuda.synchronize()
    assert mlstm_chunk.launches == before + 1
    hp, stp = mlstm_chunk(q, k, v, li, lf, chunk=chunk, state=state, impl="plain")
    torch.testing.assert_close(h, hp, rtol=MLSTM_TOL, atol=MLSTM_TOL)
    for key in ("C", "n", "m"):
        torch.testing.assert_close(st[key], stp[key], rtol=MLSTM_TOL, atol=MLSTM_TOL)


# The kernel's passes hand partial sums to each other through scratch memory
# and its walk reads its tiles through a ring of TMA slots: a race among them
# would show as two calls on the same inputs that differ
@cuda
@pytest.mark.parametrize("B,H,S,Dh,chunk", [(1, 4, 4096, 1024, 64), (2, 2, 100, 96, 32)])
def test_mlstm_kernel_repeats_bit_for_bit(B, H, S, Dh, chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = _mlstm_inputs(7, B, H, S, Dh)
    h, st = mlstm_chunk(*args, chunk=chunk)
    h2, st2 = mlstm_chunk(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(h, h2)
    assert all(torch.equal(st[key], st2[key]) for key in ("C", "n", "m"))


def _mlstm_cpu(S=8, Dh=64, shift=None):
    q, k, v, li, lf = _mlstm_inputs(0, 1, 2, S, Dh, device="cpu")
    if shift is not None:                  # the same values 4 bytes past alignment
        buf = torch.zeros(q.numel() + 1)
        buf[1:] = q.flatten()
        q = buf[1:].view(q.shape)
    return q, k, v, li, lf


# The mLSTM wrapper's argument checks on CPU tensors, before any launch
@pytest.mark.parametrize("make,error,match", [
    (lambda: _mlstm_cpu(), None, None),
    (lambda: _mlstm_cpu(shift=1), ValueError, "8-byte aligned"),
    (lambda: _mlstm_cpu(Dh=48), ValueError, "head dim"),
], ids=["ok", "misaligned", "dh48"])
def test_mlstm_wrapper_checks(make, error, match):
    args = make()
    if error is None:
        mlstm_check(*args, 8, None)
    else:
        with pytest.raises(error, match=match):
            mlstm_check(*args, 8, None)


# ------------------------------------------------------- flash backward
# The backward kernel against autograd through the plain version on the
# same inputs, at the wrapper's BWD_TOL (see kernels/flash_attention.py).
def _grads_close(got, ref):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
    for name, (err, scaled) in zip(("dq", "dk", "dv"), backward_errors(got, ref)):
        assert scaled <= 1, (name, err)


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,Sq,Sk,Dh,q_offset,causal", [
    (1, 2, 2, 128, 128, 64, 0, True),       # tests/test_kernels.py FLASH_CASES
    (1, 3, 1, 384, 384, 64, 0, True),
    (2, 4, 4, 256, 256, 64, 0, False),
    (1, 2, 1, 512, 512, 32, 0, True),
    *[(1, 4, 2, n, n, 128, 0, True) for n in (1, 63, 65, 129)],
    (2, 8, 2, 129, 300, 128, 171, True),    # q_offset, Sq < Sk
    (2, 4, 2, 129, 63, 64, 0, False),       # non-causal Sk < Sq
    (2, 16, 2, 200, 200, 128, 0, True),     # G = 8
    (2, 16, 4, 129, 129, 64, 0, True),      # G = 4
    (4, 9, 3, 1024, 1024, 64, 0, True),     # smollm-135m training: G = 3, Dh = 64
])
def test_flash_backward_matches_plain(B, H, KH, Sq, Sk, Dh, q_offset, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain
    rng = np.random.default_rng(Sq + Sk + Dh)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to("cuda", getattr(torch, dtype))
                   for s in ((B, H, Sq, Dh), (B, KH, Sk, Dh), (B, KH, Sk, Dh), (B, H, Sq, Dh)))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = flash_attention.launches, flash_attention.backward_launches
    out = flash_attention(*qkv, causal=causal, q_offset=q_offset)
    got = torch.autograd.grad(out, qkv, do)
    again = torch.autograd.grad(flash_attention(*qkv, causal=causal, q_offset=q_offset),
                                qkv, do)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 2
    assert flash_attention.backward_launches == bwd + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # no atomics
    ref = flash_attention_backward_plain(q, k, v, do, causal=causal, q_offset=q_offset)
    _grads_close(got, ref)


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_lse_and_no_grad_path(dtype):
    """The forward's log-sum-exp against the plain one; under no_grad the
    kernel runs without it and gives the same output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import _forward_kernel
    rng = np.random.default_rng(3)
    B, H, KH, Sq, Sk, Dh = 2, 8, 2, 129, 300, 128
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to("cuda", getattr(torch, dtype))
               for s in ((B, H, Sq, Dh), (B, KH, Sk, Dh), (B, KH, Sk, Dh)))
    out, lse = _forward_kernel(q, k, v, True, 171, with_lse=True)
    with torch.no_grad():
        plain = flash_attention(q, k, v, causal=True, q_offset=171)
    assert torch.equal(out, plain)
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float().reshape(B, KH, H // KH, Sq, Dh),
                     k.float()) * Dh ** -0.5
    pos = torch.arange(Sq, device="cuda") + 171
    s = s.masked_fill(pos[:, None] < torch.arange(Sk, device="cuda")[None], float("-inf"))
    want = torch.logsumexp(s, -1).reshape(B, H, Sq)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
