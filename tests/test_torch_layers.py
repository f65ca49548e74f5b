"""Layers and the GQA attention block of the PyTorch port against JAX, on
inputs made with numpy from a seed and weights converted from JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(arr, dtype):
    return (jnp.asarray(arr, getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(arr, np.float32)).to(getattr(torch, dtype)))


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_mlp(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(2, 3, 10, 16)), dtype)
    js, ts = _pair(rng.normal(size=(16,)) * 0.1, dtype)
    _close(jlayers.rms_norm(jx, js, 1e-6), tlayers.rms_norm(tx, ts, 1e-6),
           TOL[dtype])
    pos = np.arange(7, 17)
    _close(jlayers.apply_rope(jx, jnp.asarray(pos), 1_000_000.0),
           tlayers.apply_rope(tx, torch.from_numpy(pos), 1_000_000.0), TOL[dtype])
    for gated in (True, False):   # SwiGLU, then starcoder2's GELU MLP
        cfg = get_smoke_config("qwen3-8b").with_(dtype=dtype, mlp_gated=gated)
        jp = jax.device_get(jlayers.init_mlp(jax.random.key(1), cfg))
        tp = tlayers.init_mlp(None, cfg, "cpu")
        for name, p in tp.named_parameters():
            p.copy_(tensor_from_numpy(jp[name]))
        jx2, tx2 = _pair(rng.normal(size=(2, 5, cfg.d_model)), dtype)
        _close(jlayers.apply_mlp(jp, jx2), tlayers.apply_mlp(tp, tx2),
               TOL[dtype] * 5)


def _attn_pair(arch, dtype, seed=0):
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    tree = jax.device_get(jax_init_params(cfg, jax.random.key(seed)))
    jp = jax.tree.map(lambda a: a[0], tree["groups"][0]["attn"])   # layer 0
    tp = params_from_jax(cfg, tree, device="cpu").blocks[0].attn
    return cfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-8b"])
def test_attention_block_full_sequence(arch, dtype):
    cfg, jp, tp = _attn_pair(arch, dtype)
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(2, 12, cfg.d_model)), dtype)
    jy, _ = jattn.attention_block(jp, jx, cfg)
    ty, cache = tattn.attention_block(tp, tx, cfg, want_cache=True, max_len=16)
    _close(jy, ty, TOL[dtype])
    assert cache["k"].shape == (2, cfg.n_kv_heads, 16, cfg.head_dim_)
    assert bool((cache["k"][:, :, 12:] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-8b"])
def test_attention_block_decode_with_cache(arch, dtype):
    cfg, jp, tp = _attn_pair(arch, dtype, seed=1)
    rng = np.random.default_rng(2)
    L, pos = 12, 5
    shp = (2, cfg.n_kv_heads, L, cfg.head_dim_)
    jk, tk = _pair(rng.normal(size=shp), dtype)
    jv, tv = _pair(rng.normal(size=shp), dtype)
    jx, tx = _pair(rng.normal(size=(2, 1, cfg.d_model)), dtype)
    jy, jc = jattn.attention_block(
        jp, jx, cfg, positions=jnp.asarray([pos]), cache={"k": jk, "v": jv},
        cache_pos=jnp.asarray(pos, jnp.int32))
    tcache = {"k": tk, "v": tv}
    ty, tc = tattn.attention_block(tp, tx, cfg, positions=torch.tensor([pos]),
                                   cache=tcache, cache_pos=pos)
    assert tc is tcache                      # updated in place
    _close(jy, ty, TOL[dtype])
    _close(jc["k"], tc["k"], TOL[dtype])
    _close(jc["v"], tc["v"], TOL[dtype])


@pytest.mark.parametrize("n_shards", [1, 3])
def test_decode_attention_shards(n_shards):
    """The LSE combine over cache shards, with a length no shard count divides."""
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.normal(size=(2, 4, 1, 16)), "float32")
    jk, tk = _pair(rng.normal(size=(2, 2, 10, 16)), "float32")
    jv, tv = _pair(rng.normal(size=(2, 2, 10, 16)), "float32")
    _close(jattn.decode_attention(jq, jk, jv, jnp.asarray(7), n_shards),
           tattn.decode_attention(tq, tk, tv, 7, n_shards), TOL["float32"])


# (shape, std, dtype): a norm-sized vector, an MLP matrix, MLA's (192, 128)
# sized leaf, a small expert stack, Mamba's m_dt scale, an fp32 router
DENSE_INIT_CASES = [
    ((64,), 0.02, torch.bfloat16),
    ((96, 160), 0.02, torch.bfloat16),
    ((3, 192, 128), 0.02 / 10 ** 0.5, torch.bfloat16),
    ((4, 64, 33), 0.1, torch.float32),
    ((4, 2, 128), 4 ** -0.5, torch.bfloat16),
    ((64, 16), 0.006, torch.float32),
]


@pytest.mark.parametrize("shape,std,dtype", DENSE_INIT_CASES)
def test_dense_init_bit_for_bit(shape, std, dtype):
    """``dense_init`` draws and scales in place, and gives bit for bit what
    ``(randn(fp32) * std).to(dtype)`` from the same generator gave, so every
    seeded model keeps its weights; two draws in a row as well."""
    gen, old = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for _ in range(2):
        got = tlayers.dense_init(gen, shape, std=std, dtype=dtype)
        want = (torch.randn(shape, generator=old, dtype=torch.float32) * std).to(dtype)
        assert got.dtype == dtype and not got.requires_grad
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
