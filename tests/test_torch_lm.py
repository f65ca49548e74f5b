"""The PyTorch port's LM (forward, loss, decode) against JAX on the smoke
configs of the main path, with weights converted from JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch as rt  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

# fp32: matmul summation order differs between XLA's CPU and torch;
# bf16: the frameworks round at different places (test_arch_smoke.py:94)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.15}


def _models(arch, dtype, seed=0):
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    jp = jlm.init_params(cfg, jax.random.key(seed))
    tm = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    return cfg, jp, tm


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-8b"])
def test_forward_and_loss_match_jax(arch, dtype):
    cfg, jp, tm = _models(arch, dtype)
    toks, labels = _tokens(cfg, 2, 24, 1), _tokens(cfg, 2, 24, 2)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    jl, _, _, _ = jlm.forward(cfg, jp, jb)
    tl, aux, _, n_prefix = rt.forward(cfg, tm, tb)
    assert tl.shape == (2, 24, cfg.padded_vocab) and tl.dtype == tm.embed.dtype
    assert n_prefix == 0 and float(aux) == 0.0
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=tol, atol=tol)
    jloss, jm = jlm.loss_fn(cfg, jp, jb)
    tloss, tmet = rt.loss_fn(cfg, tm, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(tmet["nll"]), float(jm["nll"]),
                               rtol=tol, atol=tol)


def test_forward_kv_repeat_matches_jax():
    """qwen3-8b's kv_repeat=2: the port never repeats kv and agrees."""
    cfg = get_smoke_config("qwen3-8b").with_(dtype="float32", kv_repeat=2)
    jp = jlm.init_params(cfg, jax.random.key(4))
    tm = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    toks = _tokens(cfg, 2, 20, 5)
    jl, _, _, _ = jlm.forward(cfg, jp, {"tokens": jnp.asarray(toks)})
    tl, _, _, _ = rt.forward(cfg, tm, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_decode_matches_forward_smollm():
    """Teacher-forced decode == full forward (KV-cache correctness); the port
    of test_arch_smoke.py::test_decode_matches_forward_smollm."""
    cfg = get_smoke_config("smollm-135m")
    tm = rt.init_params(cfg, 3, device="cpu")
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(cfg, B, S, 9)).long()
    full_logits, _, _, _ = rt.forward(cfg, tm, {"tokens": toks})
    caches = rt.init_caches(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, caches = rt.decode_step(cfg, tm, caches, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    dec_logits = torch.stack(outs, dim=1)
    np.testing.assert_allclose(full_logits.float().numpy(),
                               dec_logits.float().numpy(), rtol=0.15, atol=0.15)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-8b"])
def test_prefill_then_decode_matches_teacher_forced(arch):
    """forward(want_caches=True) then decode_step gives the next-token logits
    that teacher-forcing the whole prefix through decode_step gives (fp32)."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    tm = rt.init_params(cfg, 6, device="cpu")
    B, P, extra = 2, 10, 3
    toks = torch.from_numpy(_tokens(cfg, B, P + extra, 7)).long()
    _, _, caches, _ = rt.forward(cfg, tm, {"tokens": toks[:, :P]},
                                 want_caches=True, max_len=P + extra)
    tf = rt.init_caches(cfg, B, P + extra, device="cpu")
    for t in range(P):
        _, tf = rt.decode_step(cfg, tm, tf, toks[:, t:t + 1], t)
    for t in range(P, P + extra):
        a, caches = rt.decode_step(cfg, tm, caches, toks[:, t:t + 1], t)
        b, tf = rt.decode_step(cfg, tm, tf, toks[:, t:t + 1], t)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_decode_step_matches_jax():
    """One cached decode step after a teacher-forced prefix, against JAX."""
    cfg, jp, tm = _models("qwen3-8b", "float32", seed=8)
    B, S = 2, 6
    toks = _tokens(cfg, B, S, 10)
    jc = jlm.init_caches(cfg, B, S)
    tc = rt.init_caches(cfg, B, S, device="cpu")
    for t in range(S):
        jl, jc = jlm.decode_step(cfg, jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(t, jnp.int32))
        tl, tc = rt.decode_step(cfg, tm, tc,
                                torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for i, layer in enumerate(tc["layers"]):
        np.testing.assert_allclose(layer["k"].numpy(),
                                   np.asarray(jc["groups"][0]["k"][i]),
                                   rtol=1e-5, atol=1e-5)


def test_unported_mixers_raise():
    for arch in ("granite-moe-3b-a800m", "deepseek-v2-lite-16b",
                 "jamba-1.5-large-398b", "whisper-small"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rt.init_params(rt.get_smoke_config(arch), 0, device="cpu")
