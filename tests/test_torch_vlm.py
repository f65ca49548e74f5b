"""The PyTorch port's VLM wrapper (llava) against JAX on llava-next-34b-smoke.

Inputs are made with numpy from a seed; weights are converted from JAX by
``params_from_jax``. The smoke config keeps llava's shape in small: 7 q heads
padded to 8 over one kv head (the padded slot is the last of the kv head's
superblock, its ``wo`` rows zero), a 16-patch vision prefix projected by
``vision_proj``. Held against JAX, in fp32: ``embed_inputs``, the forward
over prefix and text with ``n_prefix`` (also at the full config's
kv_repeat=2), ``loss_fn`` with the prefix's logits dropped and every
gradient (``vision_proj``'s among them), one ``make_train_step``, and decode
after the prefix at ``pos = n_prefix + S``; in bf16, the forward and the
loss at the tolerance every other model is held to. The served streams of text
requests are in ``test_torch_serve.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import apply_rope as jax_apply_rope  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.convert import _leaves  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import AdamWConfig, adamw_init, make_train_step  # noqa: E402
from repro_torch.train.step import STEP_TOL  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

ARCH = "llava-next-34b"
VARIANTS = {"smoke": {}, "kv-repeat": {"kv_repeat": 2}}
# fp32, the sums' order only: embeddings and decode relative to each
# tensor's largest entry; logits as tests/test_torch_lm.py holds them;
# gradients 1e-5 of each tensor's max
EMBED_TOL = 1e-6
LOGIT_TOL = 1e-4
DECODE_TOL = 1e-5
GRAD_TOL = 1e-5
# bf16: tests/test_torch_lm.py's LOGIT_TOL["bfloat16"], absolute and relative
BF16_TOL = 0.15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products only; one torch thread under six test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, tol, err_msg=""):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out.detach().float() if torch.is_tensor(out) else out, np.float32)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=err_msg)


@functools.cache
def _jax(variant, seed=0):
    cfg = get_smoke_config(ARCH).with_(dtype="float32", **VARIANTS[variant])
    return cfg, jlm.init_params(cfg, jax.random.key(seed))


def _models(variant="smoke", trainable=False):
    cfg, jp = _jax(variant)
    return cfg, jp, rt.params_from_jax(cfg, jax.device_get(jp), device="cpu",
                                       trainable=trainable)


def _batch(cfg, B, S, seed, prefix=True):
    """(JAX batch, port batch): tokens, labels and the patch embeddings
    (B, n_patches, D) of the vision prefix."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if prefix:
        arrays["vision_embeds"] = rng.normal(
            size=(B, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    jb = {key: jnp.asarray(a) for key, a in arrays.items()}
    tb = {key: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
          for key, a in arrays.items()}
    return jb, tb


@pytest.mark.parametrize("prefix", [True, False])
def test_embed_inputs_matches_jax(prefix):
    """The projected prefix (not scaled by sqrt(D)) before the scaled token
    embeddings, and ``n_prefix``; without ``vision_embeds`` the tokens alone."""
    cfg, jp, tm = _models()
    jb, tb = _batch(cfg, 2, 5, 1, prefix)
    jx, jn = jlm.embed_inputs(cfg, jp, jb)
    tx, n = tlm.embed_inputs(cfg, tm, tb)
    assert n == jn == (cfg.vlm.n_patches if prefix else 0)
    assert tx.shape == (2, n + 5, cfg.d_model) and tx.dtype == torch.float32
    _close(tx, jx, EMBED_TOL)
    if prefix:       # the prefix is the projection alone, unscaled
        _close(tx[:, :n], tb["vision_embeds"] @ tm.vision_proj, EMBED_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_with_prefix_matches_jax(variant):
    """Logits over the prefix and the text under one causal mask, and
    ``n_prefix``; the text's logits depend on the prefix."""
    cfg, jp, tm = _models(variant)
    B, S = 2, 11
    jb, tb = _batch(cfg, B, S, 2)
    jl, _, _, jn = jlm.forward(cfg, jp, jb)
    tl, aux, _, n_prefix = rt.forward(cfg, tm, tb)
    P = cfg.vlm.n_patches
    assert n_prefix == jn == P and float(aux) == 0.0
    assert tl.shape == (B, P + S, cfg.padded_vocab)
    _close(tl, jl, LOGIT_TOL)
    text, _, _, n0 = rt.forward(cfg, tm, {"tokens": tb["tokens"]})
    assert n0 == 0 and (text - tl[:, P:]).abs().max() > 1e-3


def test_loss_and_grads_match_jax():
    """``loss_fn`` drops the prefix's logits; the gradient of every
    parameter at 1e-5 of its max, ``vision_proj``'s nonzero."""
    cfg, jp, tm = _models(trainable=True)
    jb, tb = _batch(cfg, 2, 9, 3)
    (jloss, jm), jg = jax.value_and_grad(lambda p: jlm.loss_fn(cfg, p, jb), has_aux=True)(jp)
    loss, met = rt.loss_fn(cfg, tm, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(met["nll"].detach()), float(jm["nll"]), rtol=GRAD_TOL)
    # the loss of the text's logits alone, from the forward over both
    logits = rt.forward(cfg, tm, tb)[0][:, cfg.vlm.n_patches:].detach().float()
    logits[..., cfg.vocab_size:] = -1e30
    nll = torch.nn.functional.cross_entropy(logits.reshape(-1, cfg.padded_vocab),
                                            tb["labels"].reshape(-1))
    np.testing.assert_allclose(float(nll), float(met["nll"].detach()), rtol=1e-6)
    names = [name for name, _ in tm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    seen = set()
    for name, _, want in _leaves(cfg, tm, jax.device_get(jg)):
        _close(grads[name], want, GRAD_TOL, name)
        seen.add(name)
    assert seen == set(names) and "vision_proj" in seen
    assert grads["vision_proj"].abs().max() > 0


def test_train_step_with_prefix_matches_jax():
    """One ``make_train_step`` (AdamW, fp32 grads, 2 microbatches) on text
    with a vision prefix: loss, grad norm and every updated parameter at
    STEP_TOL; the patch embeddings split into microbatches with the tokens."""
    cfg, jp = _jax("smoke")
    jb, tb = _batch(cfg, 4, 8, 4)
    jcfg, tcfg = (JaxAdamWConfig(lr=1e-3, weight_decay=0.01),
                  AdamWConfig(lr=1e-3, weight_decay=0.01))
    jstep = jax.jit(jax_make_train_step(cfg, jcfg, accum=2, grad_dtype="float32"))
    jparams, _, jm = jstep(jp, jax_adamw_init(jp, jcfg), jb)
    model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu", trainable=True)
    model, state, tm = make_train_step(cfg, tcfg, accum=2, grad_dtype="float32")(
        model, adamw_init(model, tcfg), tb)
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
    want = rt.params_from_jax(cfg, jax.device_get(jparams), device="cpu")
    for (name, p), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=name)


def _jax_caches_after_prefill(cfg, jp, jb, max_len):
    """JAX's caches after a forward over prefix and text: its forward
    returns the keys before RoPE (quirk 1), so they are roped here at their
    positions, as its decode writes them, and padded to ``max_len``."""
    _, _, jc, _ = jlm.forward(cfg, jp, jb, want_caches=True)
    k, v = jc["groups"][0]["k"], jc["groups"][0]["v"]
    L = k.shape[3]
    k = jax_apply_rope(k, jnp.arange(L), cfg.rope_theta)
    pad = ((0, 0), (0, 0), (0, 0), (0, max_len - L), (0, 0))
    return {"groups": ({"k": jnp.pad(k, pad), "v": jnp.pad(v, pad)},), "first": None}


def test_decode_after_prefix_matches_jax():
    """The port's prefill over prefix and text (``forward(want_caches)``),
    then decode steps at ``pos = n_prefix + S`` onward: against JAX's
    ``decode_step`` over the same cache, and against JAX's forward over the
    prefix and the longer text (1e-5 of the logits' max)."""
    cfg, jp, tm = _models()
    B, S, k = 2, 6, 3
    P = cfg.vlm.n_patches
    jb, tb = _batch(cfg, B, S + k, 5)
    head = {key: a[:, :S] if key == "tokens" else a for key, a in tb.items()
            if key != "labels"}
    _, _, caches, n_prefix = rt.forward(cfg, tm, head, want_caches=True, max_len=P + S + k)
    assert n_prefix == P
    jhead = {"tokens": jb["tokens"][:, :S], "vision_embeds": jb["vision_embeds"]}
    jc = _jax_caches_after_prefill(cfg, jp, jhead, P + S + k)
    for i, layer in enumerate(caches["layers"]):
        _close(layer["k"], jc["groups"][0]["k"][i], DECODE_TOL, f"{i} k")
    full, _, _, _ = jlm.forward(cfg, jp, {"tokens": jb["tokens"],
                                          "vision_embeds": jb["vision_embeds"]})
    toks = np.asarray(jb["tokens"])
    for t in range(S, S + k):
        pos = P + t
        jl, jc = jlm.decode_step(cfg, jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos, jnp.int32))
        tl, caches = rt.decode_step(cfg, tm, caches, tb["tokens"][:, t:t + 1], pos)
        _close(tl, jl, DECODE_TOL, f"decode at {pos}")
        _close(tl[:, 0], np.asarray(full)[:, pos], DECODE_TOL, f"forward at {pos}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_loss_bf16_match_jax(variant):
    """In bf16, the logits over prefix and text, the loss and the nll at
    tests/test_torch_lm.py's bf16 tolerance: the frameworks round at
    different places."""
    cfg = get_smoke_config(ARCH).with_(dtype="bfloat16", **VARIANTS[variant])
    jp = jlm.init_params(cfg, jax.random.key(0))
    tm = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    B, S = 2, 11
    jb, tb = _batch(cfg, B, S, 2)
    jl, _, _, jn = jlm.forward(cfg, jp, jb)
    tl, aux, _, n_prefix = rt.forward(cfg, tm, tb)
    assert n_prefix == jn == cfg.vlm.n_patches and float(aux) == 0.0
    assert tl.shape == (B, n_prefix + S, cfg.padded_vocab) and tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    jloss, jm = jlm.loss_fn(cfg, jp, jb)
    tloss, tmet = rt.loss_fn(cfg, tm, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(float(tmet["nll"]), float(jm["nll"]), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_full_config_sizes():
    """llava-next-34b at full width and depth on the meta device: 60
    layers of 64 q-head slots (56 real) over 8 kv heads, Dh 128. The
    config's count, 34.388 B, takes the 56 real heads; the model holds the
    8 padded slots' ``wq`` and (zero) ``wo`` too, as the reference's
    ``init_attention`` makes them, and ``vision_proj`` and the 121 RMSNorm
    scales: 35.321 B parameters, 65.79 GiB in bf16."""
    cfg = rt.get_config(ARCH)
    model = rt.init_params(cfg, seed=None, device="meta")
    n = sum(p.numel() for p in model.parameters())
    D, Dh, pad = cfg.d_model, cfg.head_dim_, cfg.n_heads_padded - cfg.n_heads
    assert round(cfg.count_params()[0] / 1e9, 3) == 34.388
    assert n == (cfg.count_params()[0] + 2 * pad * Dh * D * cfg.n_layers + D * D
                 + (2 * cfg.n_layers + 1) * D)
    assert round(n / 1e9, 3) == 35.321 and round(2 * n / 2 ** 30, 2) == 65.79
    assert len(model.blocks) == 60 and model.vision_proj.shape == (D, D)
    assert model.blocks[0].attn.wq.shape == (D, 64, 128) and cfg.n_kv_heads == 8
