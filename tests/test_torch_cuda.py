"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on a
machine with only PyTorch: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

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
