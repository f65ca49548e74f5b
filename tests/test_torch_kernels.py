"""The flash-attention kernel module of the PyTorch port against JAX.

On the CPU the wrapper takes the kernel's plain version; it is held against
the Pallas kernel (interpret mode) on the cases of ``test_kernels.py`` and
against the JAX model's XLA flash on the cases the model needs beyond them:
a query offset, a sequence no block divides, G = 3, G = 4 reached through
``kv_repeat``, and MLA's key head wider than its value head (Dhk, Dhv) at
deepseek-v2-lite-smoke's (24, 16) and deepseek-v2-lite's (192, 128). The CUDA
kernel itself is held against the plain version on
the card (``test_torch_cuda.py`` and ``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models.attention import flash_attention as xla_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (_check, _check_backward,  # noqa: E402
                                                 flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_backward_plain,
                                                 flash_attention_plain, instantiation)

# fp32: the two differ only in summation order (tests/test_kernels.py's
# tolerance); bf16: the frameworks round at different places
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# tests/test_kernels.py FLASH_CASES: (B, H, KH, S, Dh, dtype, causal, bq, bk)
FLASH_CASES = [
    (1, 2, 2, 128, 64, "float32", True, 64, 64),
    (2, 4, 2, 256, 64, "float32", True, 128, 128),
    (2, 8, 2, 256, 128, "bfloat16", True, 128, 64),
    (1, 3, 1, 384, 64, "float32", True, 128, 128),   # GQA G=3
    (2, 4, 4, 256, 64, "float32", False, 128, 128),  # non-causal (encoder)
    (1, 2, 1, 512, 32, "bfloat16", True, 128, 128),
]


def _qkv(seed, B, H, KH, Sq, Sk, Dh, Dhv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, Dh)).astype(np.float32),
            rng.normal(size=(B, KH, Sk, Dh)).astype(np.float32),
            rng.normal(size=(B, KH, Sk, Dhv or Dh)).astype(np.float32))


def _both(arrs, dtype):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, th


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.slow
@pytest.mark.parametrize("B,H,KH,S,Dh,dtype,causal,bq,bk", FLASH_CASES)
def test_plain_matches_pallas_kernel(B, H, KH, S, Dh, dtype, causal, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S + H, B, H, KH, S, S, Dh), dtype)
    ref = pallas_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                       interpret=True)
    out = flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(ref, out, TOL[dtype])


# (B, H, KH, Sq, Sk, Dh, q_offset, kv_repeat, dtype, causal); Dh is one head
# dim, or MLA's pair (Dhk, Dhv)
XLA_CASES = [
    (1, 4, 2, 16, 48, 64, 32, 1, "float32", True),    # q_offset: a later chunk
    (2, 4, 2, 100, 100, 64, 0, 1, "float32", True),   # S no block divides
    (1, 6, 2, 100, 100, 32, 0, 1, "float32", True),   # G = 3, ragged
    (2, 8, 2, 64, 64, 64, 0, 2, "float32", True),     # G = 4 via kv_repeat=2
    (2, 8, 2, 100, 100, 128, 0, 2, "bfloat16", True),
    (1, 4, 4, 100, 100, 64, 0, 1, "float32", False),
    (1, 4, 4, 32, 32, (24, 16), 0, 1, "float32", True),       # deepseek-v2-lite-smoke
    (2, 4, 4, 37, 37, (24, 16), 0, 1, "float32", True),       # ragged
    (1, 4, 4, 16, 48, (24, 16), 32, 1, "float32", True),      # q_offset
    (2, 4, 4, 20, 33, (24, 16), 0, 1, "float32", False),      # non-causal Sq != Sk
    (1, 2, 2, 32, 32, (192, 128), 0, 1, "float32", True),     # deepseek-v2-lite
    (1, 2, 2, 45, 45, (192, 128), 0, 1, "float32", True),     # ragged
    (1, 2, 2, 13, 40, (192, 128), 27, 1, "float32", True),    # q_offset
    (1, 4, 4, 40, 40, (192, 128), 0, 1, "bfloat16", True),
]


@pytest.mark.slow
@pytest.mark.parametrize("B,H,KH,Sq,Sk,Dh,q_offset,rep,dtype,causal", XLA_CASES)
def test_plain_matches_model_flash(B, H, KH, Sq, Sk, Dh, q_offset, rep, dtype,
                                   causal):
    Dh, Dhv = Dh if isinstance(Dh, tuple) else (Dh, Dh)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(Sq + Dh, B, H, KH, Sq, Sk, Dh, Dhv), dtype)
    # the reference model repeats kv heads before its flash; the port's
    # kernel takes the original heads with G = H / KH
    ref = xla_flash(jq, jnp.repeat(jk, rep, axis=1), jnp.repeat(jv, rep, axis=1),
                    causal=causal, chunk=32, q_offset=q_offset)
    out = flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    assert out.shape == (B, H, Sq, Dhv)
    _close(ref, out, TOL[dtype])


def test_wrapper_dispatch_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4, 2, 24, 24, 64))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, causal=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True, impl="plain"), out, rtol=0, atol=0)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, causal=True, impl="fast")


def _bwd_args(**change):
    q, k, v = (torch.zeros(s, dtype=torch.bfloat16) for s in ((1, 4, 8, 64), (1, 2, 8, 64),
                                                              (1, 2, 8, 64)))
    args = {"q": q, "k": k, "v": v, "o": torch.zeros_like(q), "dout": torch.zeros_like(q),
            "lse": torch.zeros(q.shape[:3])}
    args.update({key: fn(args) for key, fn in change.items()})
    return args


# The backward wrapper's argument checks, on CPU tensors
@pytest.mark.parametrize("change,match", [
    ({}, None),
    ({"o": lambda a: a["o"][:, :, :4].contiguous()}, "o must match q"),
    ({"dout": lambda a: a["dout"].float()}, "dout must match q"),
    ({"dout": lambda a: torch.zeros(1, 4, 64, 8, dtype=torch.bfloat16).transpose(2, 3)},
     "dout must be contiguous"),
    ({"lse": lambda a: a["lse"].double()}, "lse must be"),
    ({"lse": lambda a: a["lse"][..., :3]}, "lse must be"),
    ({"q": lambda a: a["q"].half()}, "dtype"),
], ids=["ok", "o-shape", "dout-dtype", "dout-non-contiguous", "lse-dtype", "lse-shape",
        "fp16"])
def test_flash_backward_wrapper_checks(change, match):
    a = _bwd_args(**change)
    args = (a["q"], a["k"], a["v"], a["o"], a["dout"], a["lse"], 0)
    if match is None:
        _check_backward(*args)
    else:
        with pytest.raises((ValueError, TypeError), match=match):
            _check_backward(*args)


def test_backward_wrapper_on_cpu_is_the_plain_gradient():
    """A CPU tensor takes autograd through the plain version (o and lse are
    not read) and launches nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 4, 2, 24, 40, 32))
    do = torch.from_numpy(_qkv(7, 1, 4, 2, 24, 24, 32)[0])
    before = flash_attention.backward_launches
    got = flash_attention_backward(q, k, v, None, do, None, causal=True, q_offset=16)
    assert flash_attention.backward_launches == before
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*qkv, causal=True, q_offset=16)
    for g, r in zip(got, torch.autograd.grad(out, qkv, do)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


# Head dims between the kernel's instantiations: the wrapper zero-pads q, k,
# v (and o, dO in the backward) to the smallest instantiation that covers
# them and passes the kernel the scale of the unpadded width. The identity
# that makes it exact, on the plain versions: padded inputs at the unpadded
# scale, sliced, equal the originals' results. Dh 8 (llava-smoke), 12
# (deepseek-67b-smoke), 16 (six smoke configs and the serve example's
# draft) and MLA's (24, 16) (deepseek-v2-lite-smoke)
PAD_DIMS = {8: (16, 16), 12: (16, 16), 16: (16, 16), (24, 16): (32, 32)}


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 7), (False, 0)],
                         ids=["causal", "q_offset", "full"])
@pytest.mark.parametrize("dims", list(PAD_DIMS), ids=lambda d: str(d).replace(", ", "-"))
def test_zero_padding_is_exact(dims, causal, q_offset):
    Dhk, Dhv = dims if isinstance(dims, tuple) else (dims, dims)
    wk, wv = instantiation(Dhk, Dhv)
    assert (wk, wv) == PAD_DIMS[dims]
    B, H, KH, Sq = 2, 4, 2, 19
    Sk = Sq + q_offset if causal else 23
    q, k, v = (torch.from_numpy(a) for a in _qkv(Dhk + Sk, B, H, KH, Sq, Sk, Dhk, Dhv))
    do = torch.from_numpy(_qkv(Dhv, B, H, KH, Sq, Sq, Dhv)[0])
    pad = lambda t, w: torch.nn.functional.pad(t, (0, w - t.shape[-1]))  # noqa: E731
    kw = dict(causal=causal, q_offset=q_offset)
    out = flash_attention_plain(q, k, v, **kw)
    padded = flash_attention_plain(pad(q, wk), pad(k, wk), pad(v, wv), scale=Dhk ** -0.5, **kw)
    assert padded.shape == (B, H, Sq, wv) and not padded[..., Dhv:].any()
    torch.testing.assert_close(padded[..., :Dhv], out, rtol=1e-6, atol=1e-6)
    grads = flash_attention_backward_plain(q, k, v, do, **kw)
    pgrads = flash_attention_backward_plain(pad(q, wk), pad(k, wk), pad(v, wv), pad(do, wv),
                                            scale=Dhk ** -0.5, **kw)
    for g, p in zip(grads, pgrads):
        assert not p[..., g.shape[-1]:].any()
        torch.testing.assert_close(p[..., :g.shape[-1]], g, rtol=1e-6, atol=1e-6)
    # at the padded width's own scale the scores differ: the scale matters
    assert wk == Dhk or not torch.allclose(flash_attention_plain(pad(q, wk), pad(k, wk), pad(v, wv), **kw)
                              [..., :Dhv], out, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dims,want", [
    ((16, 16), (16, 16)), ((32, 32), (32, 32)), ((64, 64), (64, 64)), ((96, 96), (128, 128)),
    ((128, 64), (128, 128)), ((192, 128), (192, 128)), ((130, 100), (192, 128)),
    ((1, 1), (16, 16)), ((17, 16), (32, 32)),
])
def test_instantiation_is_the_smallest_cover(dims, want):
    assert instantiation(*dims) == want


@pytest.mark.parametrize("dims", [(256, 256), (192, 192), (64, 129), (193, 128), (0, 16)])
def test_uncovered_head_dims_raise(dims):
    """A width that no instantiation covers raises, naming the instantiations,
    before any launch."""
    Dhk, Dhv = dims
    q, k = torch.zeros(1, 2, 4, Dhk), torch.zeros(1, 2, 4, Dhk)
    v = torch.zeros(1, 2, 4, Dhv)
    with pytest.raises(ValueError, match=r"no instantiation of \(\(16, 16\)"):
        instantiation(Dhk, Dhv)
    with pytest.raises(ValueError, match="head dims"):
        _check(q, k, v, 0)
