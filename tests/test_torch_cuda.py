"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on a
machine with only PyTorch: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mlstm_chunk import mlstm_chunk  # noqa: E402

pytestmark = pytest.mark.cuda

# fp32: summation order only; bf16: the kernel rounds P to bf16 before P V
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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


# mLSTM, fp32 in both: the kernel's scans and products sum in another order
# than the plain version's (tests/test_kernels.py's chunkwise tolerance)
MLSTM_TOL = 3e-4


def _mlstm_inputs(seed, B, H, S, Dh, device="cuda"):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)  # noqa: E731
    q, k, v = f(B, H, S, Dh), f(B, H, S, Dh) * Dh ** -0.5, f(B, H, S, Dh)
    li, lf = f(B, H, S), torch.nn.functional.logsigmoid(f(B, H, S) + 2.0)
    return q, k, v, li, lf


@pytest.mark.parametrize("B,H,S,Dh,chunk,carry", [
    (1, 2, 64, 32, 16, False),        # tests/test_kernels.py MLSTM_CASES
    (2, 3, 128, 64, 32, False),
    (1, 4, 128, 128, 64, False),
    (2, 2, 96, 32, 32, False),
    (2, 2, 128, 64, 32, True),        # a carried-in state
    (1, 2, 100, 64, 32, False),       # ragged S
    (1, 2, 70, 1024, 64, True),       # xlstm-1.3b's Dh, ragged, carried
    (4, 4, 256, 1024, 64, False),     # the served xlstm-1.3b prefill
])
def test_mlstm_kernel_matches_plain(B, H, S, Dh, chunk, carry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert not torch.backends.cuda.matmul.allow_tf32   # the plain version in fp32
    q, k, v, li, lf = _mlstm_inputs(S + Dh, B, H, S, Dh)
    state = None
    if carry:
        _, state = mlstm_chunk(*_mlstm_inputs(1, B, H, 48, Dh), chunk=chunk,
                               impl="plain")
    before = mlstm_chunk.launches
    h, st = mlstm_chunk(q, k, v, li, lf, chunk=chunk, state=state)
    torch.cuda.synchronize()
    assert mlstm_chunk.launches == before + 1
    hp, stp = mlstm_chunk(q, k, v, li, lf, chunk=chunk, state=state, impl="plain")
    torch.testing.assert_close(h, hp, rtol=MLSTM_TOL, atol=MLSTM_TOL)
    for key in ("C", "n", "m"):
        torch.testing.assert_close(st[key], stp[key], rtol=MLSTM_TOL, atol=MLSTM_TOL)
