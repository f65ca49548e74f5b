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
from repro_torch.kernels.mlstm_chunk import _check_backward as mlstm_check_backward  # noqa: E402
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
    (2, 12, 12, 1500, 1500, 64, 0, False),  # whisper's encoder: 1500 keys, no mask
    (2, 12, 12, 37, 1500, 64, 0, False),    # whisper's cross attention: Sq != Sk
    (1, 64, 8, 608, 608, 128, 0, True),     # llava: 576 patches + 32 tokens, G = 8
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
    (lambda: _qkv(Dh=96), None, None),                # zero-padded to (128, 128)
    (lambda: (_qkv(Dh=192)[0], _qkv(Dh=192)[1], _qkv(Dh=128)[2]), None, None),
    (lambda: (*_qkv(Dh=128)[:2], _qkv(Dh=64)[2]), None, None),   # v padded to 128
    (lambda: (*_qkv(Dh=192)[:2], _qkv(Dh=192)[2]), ValueError, "head dims"),
    (lambda: _qkv(Dh=256), ValueError, "no instantiation"),
    (lambda: _qkv(Dh=8), None, None),                 # zero-padded to (16, 16)
    (lambda: (*_qkv()[:2], _qkv(Sq=9)[2]), ValueError, "want q"),
    (lambda: (_qkv()[0][0], *_qkv()[1:]), ValueError, "want q"),
    (lambda: _qkv(H=4, KH=3), ValueError, "KH dividing H"),
    (lambda: (*_qkv()[:2], _qkv()[2].to("meta")), ValueError, "one device"),
    (_misaligned, ValueError, "16-byte aligned"),
    (_transposed, ValueError, "contiguous"),
], ids=["bf16", "fp32", "fp16", "mixed-dtype", "dh96", "mla-192-128", "dhv-differs-128-64",
        "mla-192-192", "dh256", "dh8", "v-length-differs", "q-3d", "kh-not-dividing", "two-devices", "misaligned",
        "non-contiguous"])
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
    within a chunk); "floor": small input gates, so exp(-m) is the
    denominator; "cancel": keys along one direction u, queries nearly
    orthogonal to it, so q . n cancels (as chip_smoke.py's mlstm_inputs)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)  # noqa: E731
    q, k, v = f(B, H, S, Dh), f(B, H, S, Dh) * Dh ** -0.5, f(B, H, S, Dh)
    li, lf = f(B, H, S), torch.nn.functional.logsigmoid(f(B, H, S) + 2.0)
    if kind == "forget":
        lf = 2.0 * torch.nn.functional.logsigmoid(f(B, H, S) - 4.0)
    elif kind == "floor":
        li = li - 8.0
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


# ------------------------------------------------------- mLSTM backward
# The backward kernel, through MLSTMChunkFunction, against autograd of the
# plain version at the wrapper's BWD_TOL; where q . n cancels, both against
# fp64, the kernel within BWD_FLOOR_FACTOR of the fp32 plain version's error
# (kernels/mlstm_chunk.py). Carried states get the final state's gradient.
MLSTM_BWD_CASES = [
    (1, 2, 64, 32, 16, False, None),        # tests/test_kernels.py MLSTM_CASES
    (2, 3, 128, 64, 32, False, None),
    (1, 4, 128, 128, 64, False, None),
    (2, 2, 96, 32, 32, False, None),
    (2, 2, 128, 64, 32, True, None),        # a carried-in state, dC, dn, dm in
    (1, 2, 100, 64, 32, False, None),       # ragged S
    (1, 2, 70, 1024, 64, True, None),       # xlstm-1.3b's Dh, ragged, carried
    (4, 4, 256, 1024, 64, False, None),
    (1, 4, 256, 1024, 64, True, "forget"),  # F in the hundreds within a chunk
    (1, 4, 256, 1024, 64, True, "cancel"),  # q nearly orthogonal to n
    (2, 2, 128, 64, 32, True, "cancel"),
    (1, 2, 128, 96, 64, True, "floor"),     # exp(-m) is the denominator
]


def _mlstm_function_grads(args, state, dh, dstate, chunk):
    ins = [t.clone().requires_grad_() for t in args]
    st = None if state is None else {key: t.clone().requires_grad_() for key, t in state.items()}
    h, out = mlstm_chunk(*ins, chunk=chunk, state=st)
    assert type(h.grad_fn).__name__ == "MLSTMChunkFunctionBackward"
    outs, grads = [h], [dh]
    if dstate is not None:
        outs += [out[key] for key in ("C", "n", "m")]
        grads += list(dstate)
    wrt = ins + ([] if st is None else [st[key] for key in ("C", "n", "m")])
    return tuple(torch.autograd.grad(outs, wrt, grads)) + ((None,) * 3 if st is None else ())


@cuda
@pytest.mark.parametrize("B,H,S,Dh,chunk,carry,kind", MLSTM_BWD_CASES)
def test_mlstm_backward_matches_plain(B, H, S, Dh, chunk, carry, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.mlstm_chunk import (BWD_FLOOR_FACTOR, BWD_TOL, backward_errors,
                                                 mlstm_chunk_backward_plain)
    args = _mlstm_inputs(S + Dh + 1, B, H, S, Dh, kind=kind)
    rng = np.random.default_rng(S + Dh + 2)
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()  # noqa: E731
    state = dstate = None
    if carry:
        _, state = mlstm_chunk(*_mlstm_inputs(2, B, H, 48, Dh, kind=kind), chunk=chunk,
                               impl="plain")
        dstate = (normal(B, H, Dh, Dh), normal(B, H, Dh), normal(B, H))
    dh = normal(B, H, S, Dh)
    before = mlstm_chunk.backward_launches
    got = _mlstm_function_grads(args, state, dh, dstate, chunk)
    again = _mlstm_function_grads(args, state, dh, dstate, chunk)
    torch.cuda.synchronize()
    assert mlstm_chunk.backward_launches == before + 2
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))   # no atomics
    ds = dict(zip(("dC", "dn", "dm"), dstate or (None,) * 3))
    ref = mlstm_chunk_backward_plain(*args, dh, chunk=chunk, state=state, **ds)
    if kind != "cancel":
        errs = backward_errors(got, ref)
        assert all(e <= BWD_TOL for e in errs.values()), errs
        return
    f64 = lambda t: None if t is None else t.double()  # noqa: E731
    ref64 = mlstm_chunk_backward_plain(
        *map(f64, args), f64(dh), chunk=chunk,
        state={key: f64(t) for key, t in state.items()}, **{k: f64(t) for k, t in ds.items()})
    errs, floor = backward_errors(got, ref64), backward_errors(ref, ref64)
    assert all(errs[k] <= max(BWD_TOL, BWD_FLOOR_FACTOR * floor[k]) for k in errs), (errs, floor)


@cuda
def test_mlstm_backward_repeats_bit_for_bit_at_training_shape():
    """xlstm-1.3b's training shape: two calls give the same bits (no
    atomics: exact resume needs it) and agree with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.mlstm_chunk import (BWD_TOL, backward_errors, mlstm_chunk_backward,
                                                 mlstm_chunk_backward_plain)
    B, H, S, Dh, chunk = 2, 4, 2048, 1024, 64
    args = _mlstm_inputs(17, B, H, S, Dh)
    dh = torch.from_numpy(np.random.default_rng(18).normal(size=(B, H, S, Dh))
                          .astype(np.float32)).cuda()
    h, _ = mlstm_chunk(*args, chunk=chunk)
    got = mlstm_chunk_backward(*args, h, dh, chunk=chunk)
    again = mlstm_chunk_backward(*args, h, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[:5], again[:5]))
    errs = backward_errors(got, mlstm_chunk_backward_plain(*args, dh, chunk=chunk))
    assert all(e <= BWD_TOL for e in errs.values()), errs


@cuda
def test_mlstm_function_only_under_grad():
    """On the card, h's grad_fn is MLSTMChunkFunction's where an input
    requires grad; under no_grad the forward kernel runs alone and h has
    no graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [t.requires_grad_() for t in _mlstm_inputs(19, 1, 2, 96, 64)]
    fwd, bwd = mlstm_chunk.launches, mlstm_chunk.backward_launches
    h, st = mlstm_chunk(*args, chunk=32)
    assert type(h.grad_fn).__name__ == "MLSTMChunkFunctionBackward"
    assert st["C"].grad_fn is not None and mlstm_chunk.launches == fwd + 1
    with torch.no_grad():
        h2, st2 = mlstm_chunk(*args, chunk=32)
    assert h2.grad_fn is None and st2["C"].grad_fn is None
    assert torch.equal(h.detach(), h2)
    assert mlstm_chunk.launches == fwd + 2 and mlstm_chunk.backward_launches == bwd


# The backward wrapper's own checks, on CPU tensors, before any launch
def _mlstm_bwd_args(dh=None, dC=None):
    q = torch.zeros(1, 2, 8, 64)
    return q, q.clone(), q.clone() if dh is None else dh, (dC, None, None)


@pytest.mark.parametrize("make,error,match", [
    (lambda: _mlstm_bwd_args(), None, None),
    (lambda: _mlstm_bwd_args(dh=torch.zeros(1, 2, 8, 64, dtype=torch.float64)), TypeError,
     "float32"),
    (lambda: _mlstm_bwd_args(dh=torch.zeros(1, 2, 9, 64)), ValueError, "want"),
    (lambda: _mlstm_bwd_args(dh=torch.zeros(1, 2, 64, 8).transpose(2, 3)), ValueError,
     "contiguous"),
    (lambda: _mlstm_bwd_args(dh=torch.zeros(1, 2, 8, 64, device="meta")), ValueError,
     "lies on"),
    (lambda: _mlstm_bwd_args(dC=torch.zeros(1, 2, 64, 32)), ValueError, "dC"),
], ids=["ok", "dtype", "shape", "contiguity", "device", "state"])
def test_mlstm_backward_wrapper_checks(make, error, match):
    q, h, dh, dstate = make()
    if error is None:
        mlstm_check_backward(q, h, dh, dstate)
    else:
        with pytest.raises(error, match=match):
            mlstm_check_backward(q, h, dh, dstate)


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
    # the bf16 passes' edges: 64-row query steps and 128-key tiles (dK/dV),
    # 128-row query tiles and 64-key steps (dQ), and their TMA boxes
    *[(1, 4, 2, n, n, 128, 0, True) for n in (64, 127, 128, 4097)],
    *[(1, 4, 2, 129, n, 128, 0, False) for n in (63, 64, 65, 127, 128, 4097)],
    *[(1, 4, 2, n, 129, 64, 0, False) for n in (63, 64, 65, 127, 128)],
    (1, 6, 2, 129, 129, 64, 0, True),       # G = 3, Dh = 64, ragged
    (2, 3, 1, 65, 200, 64, 7, True),        # G = 3, q_offset, Sq != Sk
    (2, 4, 4, 127, 129, 32, 2, True),       # Dh = 32, G = 1, q_offset
    (1, 4, 2, 129, 4097, 32, 0, False),     # Dh = 32, non-causal, long Sk
    (3, 8, 2, 65, 127, 128, 0, False),      # non-causal Sq != Sk, B = 3
    (1, 8, 2, 63, 1000, 128, 937, True),    # q_offset: the last 63 rows
    (1, 8, 2, 65, 4097, 128, 100, True),    # q_offset: keys past the last row unseen
    (1, 2, 1, 1, 129, 64, 128, True),       # one query at the end
    (2, 12, 12, 1500, 1500, 64, 0, False),  # whisper's encoder: 1500 keys, no mask
    (2, 12, 12, 37, 1500, 64, 0, False),    # whisper's cross attention: Sq != Sk
    (1, 64, 8, 608, 608, 128, 0, True),     # llava: 576 patches + 32 tokens, G = 8
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


# Head dims below 32: the (16, 16) instantiation (32-byte swizzle, m64n16k16
# products) and the widths the wrapper zero-pads to an instantiation: 8 and
# 12 to (16, 16), MLA's (24, 16) to (32, 32), at the smoke configs' and the
# serve example's shapes and on the edges of the tiles
SMALL_DIMS = [(16, 16), (8, 8), (12, 12), (24, 16)]
SMALL_CASES = [
    (4, 2, 1, 8, 8, 0, True),               # examples/serve_torch.py's draft: the engine's batch
    (1, 2, 1, 19, 19, 0, True),             # a verify prompt
    (2, 4, 2, 32, 32, 0, True),             # a smoke config's train batch
    (2, 7, 1, 129, 129, 0, True),           # llava-smoke's G = 7, ragged
    (1, 4, 2, 16, 48, 32, True),            # q_offset
    (2, 4, 4, 65, 300, 0, False),           # non-causal Sq != Sk
    (1, 4, 2, 4097, 4097, 0, True),         # long S
]


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", SMALL_DIMS, ids=lambda d: f"{d[0]}-{d[1]}")
@pytest.mark.parametrize("B,H,KH,Sq,Sk,q_offset,causal", SMALL_CASES)
def test_flash_small_head_dims_match_plain(B, H, KH, Sq, Sk, q_offset, causal, dims, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain
    Dhk, Dhv = dims
    rng = np.random.default_rng(Sq + Sk + Dhk)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to("cuda", getattr(torch, dtype))
                   for s in ((B, H, Sq, Dhk), (B, KH, Sk, Dhk), (B, KH, Sk, Dhv),
                             (B, H, Sq, Dhv)))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = flash_attention.launches, flash_attention.backward_launches
    out = flash_attention(*qkv, causal=causal, q_offset=q_offset)
    got = torch.autograd.grad(out, qkv, do)
    again = flash_attention(*qkv, causal=causal, q_offset=q_offset)
    got_again = torch.autograd.grad(again, qkv, do)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 2 and flash_attention.backward_launches == bwd + 2
    assert out.shape == (B, H, Sq, Dhv) and torch.equal(out, again)
    assert all(torch.equal(a, b) for a, b in zip(got, got_again))  # no atomics
    ref = flash_attention(q, k, v, causal=causal, q_offset=q_offset, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    _grads_close(got, flash_attention_backward_plain(q, k, v, do, causal=causal,
                                                     q_offset=q_offset))


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_without_keys(dtype, causal):
    """Sk = 0: no score, so dQ is 0 and dK, dV are empty (the plain version
    cannot take Sk = 0: its softmax has nothing to reduce)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    B, H, KH, Sq, Dh = 2, 4, 2, 65, 64
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to("cuda", getattr(torch, dtype))
                   for s in ((B, H, Sq, Dh), (B, KH, 0, Dh), (B, KH, 0, Dh), (B, H, Sq, Dh)))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*qkv, causal=causal)
    dq, dk, dv = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert not out.any() and not dq.any() and dq.shape == q.shape
    assert dk.shape == k.shape and dv.shape == v.shape


@cuda
def test_flash_backward_repeats_bit_for_bit_at_training_shape():
    """qwen3-8b's training shape in bf16: two calls give the same bits (no
    atomics: exact resume needs it) and agree with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import (_forward_kernel, flash_attention_backward,
                                                     flash_attention_backward_plain)
    rng = np.random.default_rng(16)
    B, H, KH, S, Dh = 1, 32, 8, 4096, 128
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to("cuda", torch.bfloat16)
                   for s in ((B, H, S, Dh), (B, KH, S, Dh), (B, KH, S, Dh), (B, H, S, Dh)))
    o, lse = _forward_kernel(q, k, v, True, 0, with_lse=True)
    got = flash_attention_backward(q, k, v, o, do, lse, causal=True)
    again = flash_attention_backward(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _grads_close(got, flash_attention_backward_plain(q, k, v, do, causal=True))


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


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_on_card_matches_cpu(dtype):
    """One ``attn+moe`` block of granite's geometry, narrowed (6 q heads
    padded to 8, 2 kv heads with kv_repeat 2, Dh 64; 10 experts padded to
    12, top 4, capacity factor 0.25 at 777 tokens, so about half the
    assignments drop): its forward (attention through the flash kernel) and
    backward (the flash backward kernel, the dispatch's gathers) on the card
    against the same block on the CPU (plain attention), and two calls on
    the card equal bit for bit. fp32 to 1e-4 of each tensor's max; bf16 to
    a relative RMS of 2e-2, with the (token, k) choices that differ shown."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import dataclasses
    from repro_torch import get_smoke_config, init_params
    from repro_torch.models import moe
    from repro_torch.models.lm import MoEBlock, _apply_block
    base = get_smoke_config("granite-moe-3b-a800m")
    cfg = base.with_(n_layers=1, d_model=256, n_heads=6, n_kv_heads=2, head_dim=64,
                     pad_heads_to=8, kv_repeat=2, pad_experts_to=12, dtype=dtype,
                     moe=dataclasses.replace(base.moe, n_experts=10, top_k=4,
                                             d_expert=128, capacity_factor=0.25))
    cpu = init_params(cfg, 21, device="cpu", trainable=True)
    card = init_params(cfg, None, device="cuda", trainable=True)
    with torch.no_grad():
        for p, q in zip(card.parameters(), cpu.parameters()):
            p.copy_(q)
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.normal(size=(1, 777, 256)).astype(np.float32)).to(
        getattr(torch, dtype))
    dy = torch.from_numpy(rng.normal(size=(1, 777, 256)).astype(np.float32)).to(x.dtype)
    choices = []
    route = moe._route

    def recording(*args):
        out = route(*args)
        choices.append(out[2].cpu())
        return out

    def run(model, device):
        blk = model.blocks[0]
        assert isinstance(blk, MoEBlock)
        xd = x.to(device).requires_grad_()
        y, aux, _ = _apply_block(blk, xd, cfg, causal=True)
        params = [xd, *blk.parameters()]
        grads = torch.autograd.grad((y.float() * dy.to(device).float()).sum() + aux, params)
        return [y.detach(), aux.detach(), *grads]

    moe._route = recording
    try:
        fwd, bwd = flash_attention.launches, flash_attention.backward_launches
        got, again = run(card, "cuda"), run(card, "cuda")
        torch.cuda.synchronize()
        assert (flash_attention.launches - fwd, flash_attention.backward_launches - bwd) == (2, 2)
        want = run(cpu, "cpu")
    finally:
        moe._route = route
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    flips = int((choices[0].sort(-1).values != choices[2].sort(-1).values).any(-1).sum())
    for name, a, b in zip(["y", "aux", "x", *(n for n, _ in card.blocks[0].named_parameters())],
                          got, want):
        a, b = a.cpu().float(), b.float()
        if dtype == "float32":
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item(),
                                       msg=f"{name}; {flips} tokens routed differently")
        else:
            rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            assert rel <= 2e-2, f"{name}: rel RMS {rel:.3e}; {flips} tokens routed differently"


# ----------------------------------------------------- MLA's head dims
# (Dhk, Dhv) = (192, 128), deepseek-v2-lite's: the forward's two-stage K/V
# ring and twelve k-steps of S = Q K^T over 128-row tiles; the backward's
# 32-row query steps of the dK/dV pass (dK += dS^T Q on m64n192k16) and the
# dQ pass's 128-row tiles and 64-key steps; their TMA boxes at either edge
MLA_DIMS = (192, 128)
MLA_CASES = [
    *[(1, 4, 4, n, n, 0, True) for n in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 4097)],
    *[(1, 4, 4, 129, n, 0, False) for n in (1, 63, 65, 127, 4097)],
    *[(1, 4, 4, n, 129, 0, False) for n in (31, 33, 63, 65, 128)],
    (2, 4, 4, 129, 300, 171, True),         # q_offset, Sq < Sk, B > 1
    (1, 8, 8, 63, 1000, 937, True),         # the last 63 rows of a sequence
    (2, 8, 4, 100, 100, 0, True),           # G = 2
    (1, 16, 16, 256, 256, 0, True),         # deepseek-v2-lite's 16 heads
]


def _mla_inputs(seed, B, H, KH, Sq, Sk, dtype):
    rng = np.random.default_rng(seed)
    Dhk, Dhv = MLA_DIMS
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to("cuda", getattr(torch, dtype))
            for s in ((B, H, Sq, Dhk), (B, KH, Sk, Dhk), (B, KH, Sk, Dhv), (B, H, Sq, Dhv))]


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,Sq,Sk,q_offset,causal", MLA_CASES)
def test_flash_mla_kernel_matches_plain(B, H, KH, Sq, Sk, q_offset, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, _ = _mla_inputs(Sq + 2 * Sk, B, H, KH, Sq, Sk, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    again = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert out.shape == (B, H, Sq, MLA_DIMS[1]) and torch.equal(out, again)
    ref = flash_attention(q, k, v, causal=causal, q_offset=q_offset, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,Sq,Sk,q_offset,causal", MLA_CASES)
def test_flash_mla_backward_matches_plain(B, H, KH, Sq, Sk, q_offset, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain
    q, k, v, do = _mla_inputs(3 * Sq + Sk, B, H, KH, Sq, Sk, dtype)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    bwd = flash_attention.backward_launches
    got = torch.autograd.grad(flash_attention(*qkv, causal=causal, q_offset=q_offset), qkv, do)
    again = torch.autograd.grad(flash_attention(*qkv, causal=causal, q_offset=q_offset),
                                qkv, do)
    torch.cuda.synchronize()
    assert flash_attention.backward_launches == bwd + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # no atomics
    _grads_close(got, flash_attention_backward_plain(q, k, v, do, causal=causal,
                                                     q_offset=q_offset))


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mla_lse(dtype):
    """The forward's log-sum-exp at (192, 128), scaled by Dhk^-1/2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import _forward_kernel
    B, H, KH, Sq, Sk = 2, 4, 4, 129, 300
    q, k, v, _ = _mla_inputs(4, B, H, KH, Sq, Sk, dtype)
    out, lse = _forward_kernel(q, k, v, True, 171, with_lse=True)
    with torch.no_grad():
        assert torch.equal(out, flash_attention(q, k, v, causal=True, q_offset=171))
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) * MLA_DIMS[0] ** -0.5
    pos = torch.arange(Sq, device="cuda") + 171
    s = s.masked_fill(pos[:, None] < torch.arange(Sk, device="cuda")[None], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5, atol=1e-5)


@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_block_on_card_matches_cpu(dtype):
    """One ``mla+moe`` block of deepseek-v2-lite's head geometry, narrowed
    (4 heads of Dh 128 + rope 64, so the flash kernels run at (192, 128);
    kv_lora_rank 64; 8 experts, top 2, a shared one): its forward and
    backward on the card (the flash forward and backward kernels, the rope
    key's gradient summed over the heads) against the same block on the
    CPU (plain attention), and two calls on the card equal bit for bit;
    then teacher-forced absorbed decode steps on the card against the CPU.
    fp32 to 1e-4 of each tensor's max; bf16 to a relative RMS of 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import dataclasses
    from repro_torch import get_smoke_config, init_params
    from repro_torch.models.attention import init_self_attn_cache
    from repro_torch.models.lm import MLAMoEBlock, _apply_block
    base = get_smoke_config("deepseek-v2-lite-16b")
    cfg = base.with_(n_layers=1, first_layer_dense=False, d_model=256, n_heads=4, n_kv_heads=4,
                     head_dim=128, dtype=dtype,
                     mla=dataclasses.replace(base.mla, kv_lora_rank=64, rope_head_dim=64),
                     moe=dataclasses.replace(base.moe, n_experts=8, top_k=2, d_expert=64))
    cpu = init_params(cfg, 23, device="cpu", trainable=True)
    card = init_params(cfg, None, device="cuda", trainable=True)
    with torch.no_grad():
        for p, q in zip(card.parameters(), cpu.parameters()):
            p.copy_(q)
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.normal(size=(2, 333, 256)).astype(np.float32)).to(
        getattr(torch, dtype))
    dy = torch.from_numpy(rng.normal(size=(2, 333, 256)).astype(np.float32)).to(x.dtype)

    def run(model, device):
        blk = model.blocks[0]
        assert isinstance(blk, MLAMoEBlock)
        xd = x.to(device).requires_grad_()
        y, aux, _ = _apply_block(blk, xd, cfg, causal=True)
        params = [xd, *blk.parameters()]
        grads = torch.autograd.grad((y.float() * dy.to(device).float()).sum() + aux, params)
        return [y.detach(), aux.detach(), *grads]

    def decode(model, device):
        blk, out = model.blocks[0], []
        cache = init_self_attn_cache(cfg, 2, 8, device)
        with torch.no_grad():
            for t in range(6):
                y, _, cache = _apply_block(blk, x[:, t:t + 1].to(device), cfg,
                                           positions=torch.tensor([t], device=device),
                                           cache=cache, cache_pos=t)
                out.append(y)
        return [torch.cat(out, 1)]

    fwd, bwd = flash_attention.launches, flash_attention.backward_launches
    got, again = run(card, "cuda"), run(card, "cuda")
    torch.cuda.synchronize()
    assert (flash_attention.launches - fwd, flash_attention.backward_launches - bwd) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    names = ["y", "aux", "x", *(n for n, _ in card.blocks[0].named_parameters()), "decode"]
    for name, a, b in zip(names, got + decode(card, "cuda"), run(cpu, "cpu") + decode(cpu, "cpu")):
        a, b = a.cpu().float(), b.float()
        if dtype == "float32":
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item(),
                                       msg=name)
        else:
            rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            assert rel <= 2e-2, f"{name}: rel RMS {rel:.3e}"


# ------------------------------------------------------ jamba's G = 8
# 64 q heads over 8 kv heads at Dh 128 (jamba-1.5-large's attention layer):
# a grouping no earlier model ran; the served 4 x 32 prefill and longer S
@cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(4, 32), (1, 200), (1, 1024)])
def test_flash_kernel_g8_matches_plain(B, S, dtype):
    test_flash_kernel_matches_plain(B, 64, 8, S, S, 128, 0, True, dtype)


@cuda
def test_mamba_on_card_matches_cpu():
    """jamba-smoke's Mamba mixer (fp32): the log-depth scan's prefill with
    its final state, then 3 decode steps from it, on the card against the
    CPU, to 1e-5 of each tensor's largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import get_smoke_config
    from repro_torch.models import ssm
    cfg = get_smoke_config("jamba-1.5-large-398b").with_(dtype="float32")
    cpu = ssm.init_mamba(torch.Generator().manual_seed(25), cfg, "cpu")
    card = ssm.init_mamba(None, cfg, "cuda")
    with torch.no_grad():
        for p, q in zip(card.parameters(), cpu.parameters()):
            p.copy_(q)
    rng = np.random.default_rng(26)
    x = torch.from_numpy(rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32))
    steps = torch.from_numpy(rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32))

    def run(p, device):
        with torch.no_grad():
            y, st = ssm.apply_mamba(p, x.to(device), cfg, want_state=True)
            out = [y, st["ssm"].clone(), st["conv"].clone()]
            for t in range(steps.shape[1]):
                out.append(ssm.apply_mamba(p, steps[:, t:t + 1].to(device), cfg, state=st)[0])
            return out + [st["ssm"], st["conv"]]

    for i, (a, b) in enumerate(zip(run(card, "cuda"), run(cpu, "cpu"))):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5 * b.abs().max().item(),
                                   msg=f"output {i}")


@cuda
@pytest.mark.parametrize("shape,std,dtype", [
    ((16, 512, 384), 0.02, torch.bfloat16),
    ((300, 77), 0.1, torch.float32),
    ((2, 64, 24576), 0.02 / 10 ** 0.5, torch.bfloat16),
])
def test_dense_init_on_card_bit_for_bit(shape, std, dtype):
    """``dense_init``'s in-place draw on the card gives the bits of
    ``(randn(fp32) * std).to(dtype)`` from the same CUDA generator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models.layers import dense_init
    gen = torch.Generator(device="cuda").manual_seed(3)
    old = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(2):
        got = dense_init(gen, shape, std=std, dtype=dtype, device="cuda")
        want = (torch.randn(shape, generator=old, dtype=torch.float32, device="cuda")
                * std).to(dtype)
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
