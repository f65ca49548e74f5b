"""The PyTorch port's encoder-decoder (whisper) against JAX on whisper-smoke.

Inputs are made with numpy from a seed, the frames in the config's dtype;
weights are converted from JAX by ``params_from_jax``. Held against JAX, in
fp32: the encoder, the forward's logits and caches, teacher-forced
``decode_step`` over the forward's cross caches, ``loss_fn`` and every
gradient (encoder, cross attention, ``ln_c``), one ``make_train_step``;
both at the smoke config (SwiGLU, untied) and at the full config's MLP and
tying (2-matrix GELU, tied). A checkpoint of the model and its AdamW state
on the port's log restores bit for bit. In bf16, the forward and the loss
at the tolerance every other model is held to. The reference's decode ropes where
its forward does not (quirk 14), pinned in both packages.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.convert import _leaves  # noqa: E402
from repro_torch.core import BoltSystem  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import (AdamWConfig, CheckpointManager, adamw_init,  # noqa: E402
                               make_train_step)
from repro_torch.train.step import STEP_TOL  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

ARCH = "whisper-small"
# the smoke config (SwiGLU, untied) and the full config's MLP and tying
VARIANTS = {"smoke": {}, "ungated-tied": {"mlp_gated": False, "tie_embeddings": True}}
# fp32, the sums' order only: the encoder's output, the cross caches and
# decode, relative to each tensor's largest entry; the logits as
# tests/test_torch_lm.py holds them; gradients 1e-5 of each tensor's max
ENC_TOL = 1e-5
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
def _jax(variant, remat="full", seed=0):
    cfg = get_smoke_config(ARCH).with_(dtype="float32", remat=remat, **VARIANTS[variant])
    return cfg, jlm.init_params(cfg, jax.random.key(seed))


def _models(variant, remat="full", trainable=False):
    cfg, jp = _jax(variant, remat)
    return cfg, jp, rt.params_from_jax(cfg, jax.device_get(jp), device="cpu",
                                       trainable=trainable)


def _batch(cfg, B, S, seed, T=None):
    """(JAX batch, port batch): tokens, labels and frames (B, T, D)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = rng.normal(size=(B, T or cfg.encdec.enc_len, cfg.d_model)).astype(np.float32)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}
    jb = {key: jnp.asarray(a) for key, a in arrays.items()}
    tb = {key: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
          for key, a in arrays.items()}
    return jb, tb


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("T", [None, 17])
def test_encode_matches_jax(T):
    """The encoder over enc_len frames, and over fewer (``pos_embed[:T]``)."""
    cfg, jp, tm = _models("smoke")
    jb, tb = _batch(cfg, 2, 4, 1, T)
    want = jlm._encode(cfg, jp, jb["frames"])
    got = tlm._encode(cfg, tm, tb["frames"])
    assert got.shape == (2, T or cfg.encdec.enc_len, cfg.d_model) and got.dtype == torch.float32
    _close(got, want, ENC_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_caches_match_jax(variant):
    """Logits at 1e-4; the cross caches (the encoder's k and v of each
    decoder layer, T positions) and the self caches at 1e-5: the reference's
    forward runs self attention without RoPE, so its pre-RoPE keys (quirk 1)
    are the keys the port's cache holds."""
    cfg, jp, tm = _models(variant)
    B, S = 2, 9
    jb, tb = _batch(cfg, B, S, 2)
    jl, jaux, jc, jn = jlm.forward(cfg, jp, jb, want_caches=True)
    tl, aux, tc, n_prefix = rt.forward(cfg, tm, tb, want_caches=True, max_len=S + 3)
    assert n_prefix == jn == 0 and float(aux) == 0.0
    assert tl.shape == (B, S, cfg.padded_vocab)
    _close(tl, jl, LOGIT_TOL)
    for i, layer in enumerate(tc["layers"]):
        assert set(layer) == {"k", "v", "cross_k", "cross_v"}
        assert layer["cross_k"].shape == (B, cfg.n_kv_heads, cfg.encdec.enc_len, cfg.head_dim_)
        assert layer["k"].shape[2] == S + 3 and not layer["k"][:, :, S:].any()
        for key, jkey in (("cross_k", "cross_k"), ("cross_v", "cross_v"), ("k", "k"),
                          ("v", "v")):
            want = np.asarray(jc["groups"][0][jkey][i])
            _close(layer[key][:, :, :want.shape[2]], want, ENC_TOL, f"{i} {key}")
    no_cache = rt.forward(cfg, tm, tb)
    assert no_cache[2] is None
    torch.testing.assert_close(no_cache[0], tl, rtol=0, atol=0)


def _jax_caches(cfg, jp, jb, B, max_len):
    """JAX's ``init_caches`` with the cross caches of its forward."""
    _, _, jc, _ = jlm.forward(cfg, jp, jb, want_caches=True)
    caches = jlm.init_caches(cfg, B, max_len)
    group = dict(caches["groups"][0], cross_k=jc["groups"][0]["cross_k"],
                 cross_v=jc["groups"][0]["cross_v"])
    return {"groups": (group,), "first": None}


def _port_caches(cfg, tm, tb, B, max_len):
    """The port's ``init_caches`` with the cross caches of its forward."""
    _, _, tc, _ = rt.forward(cfg, tm, tb, want_caches=True)
    caches = rt.init_caches(cfg, B, max_len, device="cpu")
    for layer, pre in zip(caches["layers"], tc["layers"]):
        layer["cross_k"].copy_(pre["cross_k"])
        layer["cross_v"].copy_(pre["cross_v"])
    return caches


def _teacher_forced(decode_step, caches, toks):
    steps = []
    for t in range(toks.shape[1]):
        logits, caches = decode_step(caches, toks[:, t:t + 1], t)
        steps.append(np.asarray(logits, np.float32)[:, 0])
    return np.stack(steps, axis=1), caches


def _decode_both(cfg, jp, tm, jb, tb, B, S):
    toks = np.asarray(jb["tokens"])
    jdec, jc = _teacher_forced(
        lambda c, t, pos: jlm.decode_step(cfg, jp, c, jnp.asarray(t),
                                          jnp.asarray(pos, jnp.int32)),
        _jax_caches(cfg, jp, jb, B, S), toks)
    tdec, tc = _teacher_forced(
        lambda c, t, pos: rt.decode_step(cfg, tm, c, torch.tensor(t).long(), pos),
        _port_caches(cfg, tm, tb, B, S), toks)
    return jdec, jc, tdec, tc


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_matches_jax(variant):
    """Teacher-forced ``decode_step`` from the forward's cross caches, in
    both packages: logits and the self caches at 1e-5, the cross caches
    read and never written."""
    cfg, jp, tm = _models(variant)
    B, S = 2, 7
    jb, tb = _batch(cfg, B, S, 3)
    jdec, jc, tdec, tc = _decode_both(cfg, jp, tm, jb, tb, B, S)
    _close(tdec, jdec, DECODE_TOL)
    _, _, pre, _ = rt.forward(cfg, tm, tb, want_caches=True)
    for i, layer in enumerate(tc["layers"]):
        for key in ("k", "v"):
            _close(layer[key], np.asarray(jc["groups"][0][key][i]), DECODE_TOL, f"{i} {key}")
        torch.testing.assert_close(layer["cross_k"], pre["layers"][i]["cross_k"], rtol=0,
                                   atol=0)


def test_decode_over_zero_cross_caches_matches_jax():
    """From ``init_caches`` alone, as the reference's engine decodes: the
    cross attention over all-zero k and v, in both packages."""
    cfg, jp, tm = _models("smoke")
    B, S = 2, 5
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jdec, _ = _teacher_forced(
        lambda c, t, pos: jlm.decode_step(cfg, jp, c, jnp.asarray(t),
                                          jnp.asarray(pos, jnp.int32)),
        jlm.init_caches(cfg, B, S), toks)
    caches = rt.init_caches(cfg, B, S, device="cpu")
    assert all(not layer["cross_k"].any() for layer in caches["layers"])
    tdec, _ = _teacher_forced(
        lambda c, t, pos: rt.decode_step(cfg, tm, c, torch.tensor(t).long(), pos),
        caches, toks)
    _close(tdec, jdec, DECODE_TOL)


def test_decode_rope_quirk_of_the_reference():
    """The reference's ``forward`` runs whisper's decoder without RoPE
    (``use_rope=not cfg.is_encdec``), its ``decode_step`` with it (the
    default ``use_rope=True``): teacher-forced decode over the forward's
    cross caches differs from the forward by ~3e-4 in both packages, and by
    the same amount to 1e-6; at position 0, where RoPE is the identity,
    the two agree to 1e-6 (quirk 14, carried over)."""
    cfg, jp, tm = _models("smoke")
    B, S = 2, 8
    jb, tb = _batch(cfg, B, S, 0)
    jdec, _, tdec, _ = _decode_both(cfg, jp, tm, jb, tb, B, S)
    jgap = jdec - np.asarray(jlm.forward(cfg, jp, jb)[0], np.float32)
    tgap = tdec - rt.forward(cfg, tm, tb)[0].numpy()
    assert 5e-5 < np.abs(jgap).max() < 2e-3, np.abs(jgap).max()   # ~3e-4: the quirk
    assert 5e-5 < np.abs(tgap).max() < 2e-3, np.abs(tgap).max()   # carried over
    np.testing.assert_allclose(tgap, jgap, rtol=0, atol=1e-6)
    assert np.abs(jgap[:, 0]).max() < 1e-6 and np.abs(tgap[:, 0]).max() < 1e-6


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("remat,variant", [("none", "smoke"), ("full", "smoke"),
                                           ("full", "ungated-tied")])
def test_loss_and_grads_match_jax(remat, variant):
    """``loss_fn`` and the gradient of every parameter (the encoder's, the
    cross attention's and ``ln_c`` among them), each at 1e-5 of its max;
    under remat full the encoder's output enters each decoder block's
    rematerialised function as an argument, so its gradient flows."""
    cfg, jp, tm = _models(variant, remat, trainable=True)
    jb, tb = _batch(cfg, 2, 8, 5)
    (jloss, jm), jg = jax.value_and_grad(lambda p: jlm.loss_fn(cfg, p, jb), has_aux=True)(jp)
    loss, met = rt.loss_fn(cfg, tm, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(met["nll"].detach()), float(jm["nll"]), rtol=GRAD_TOL)
    names = [name for name, _ in tm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    seen = set()
    for name, _, want in _leaves(cfg, tm, jax.device_get(jg)):
        assert grads[name].abs().max() > 0 or not np.abs(want).max(), name
        _close(grads[name], want, GRAD_TOL, name)
        seen.add(name)
    assert seen == set(names)
    for part in ("encoder.pos_embed", "encoder.blocks.1.attn.wq", "encoder.final_norm",
                 "blocks.0.ln_c", "blocks.1.cross.wk", "blocks.0.cross.wo"):
        assert part in seen and grads[part].abs().max() > 0, part


def _near_zero(cfg, jp, jb, accum):
    """Per parameter, the elements whose reference step gradient (the
    microbatches' mean) is not 0 but within GRAD_TOL of the tensor's largest
    entry: the gradients agree only to that (``test_loss_and_grads_match_jax``),
    so rounding may set such an element's size or sign, and Adam's first
    update g / (|g| + eps) may move it by up to 2 lr either way."""
    def grad(i):
        mb = {key: a.reshape((accum, -1) + a.shape[1:])[i] for key, a in jb.items()}
        return jax.grad(lambda p: jlm.loss_fn(cfg, p, mb)[0])(jp)
    g = jax.device_get(functools.reduce(lambda a, b: jax.tree.map(jnp.add, a, b),
                                        [grad(i) for i in range(accum)]))
    model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    out = {}
    for name, _, leaf in _leaves(cfg, model, g):
        a = np.abs(np.asarray(leaf))
        out[name] = (a > 0) & (a <= GRAD_TOL * a.max())
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """One ``make_train_step`` (AdamW, fp32 grads) on tokens and frames:
    loss, grad norm and every updated parameter at STEP_TOL, but for the
    elements of a gradient within the gradient tolerance of 0 (``_near_zero``,
    103 of 0.33 M at this seed, at most 1e-3 of them allowed), which are
    held within 2 lr: with 2 microbatches one of them (|g| = 2.2e-9, 0.2 of
    Adam's eps) steps 1.2e-5 apart. The frames split into microbatches with
    the tokens."""
    cfg, jp = _jax("smoke")
    jb, tb = _batch(cfg, 4, 8, 6)
    jcfg, tcfg = (JaxAdamWConfig(lr=1e-3, weight_decay=0.01),
                  AdamWConfig(lr=1e-3, weight_decay=0.01))
    jstep = jax.jit(jax_make_train_step(cfg, jcfg, accum=accum, grad_dtype="float32"))
    jparams, _, jm = jstep(jp, jax_adamw_init(jp, jcfg), jb)
    model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu", trainable=True)
    step = make_train_step(cfg, tcfg, accum=accum, grad_dtype="float32")
    model, state, tm = step(model, adamw_init(model, tcfg), tb)
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
    want = rt.params_from_jax(cfg, jax.device_get(jparams), device="cpu")
    near_zero = _near_zero(cfg, jp, jb, accum)
    n_all = sum(m.size for m in near_zero.values())
    assert sum(int(m.sum()) for m in near_zero.values()) <= 1e-3 * n_all
    for (name, p), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        p, w, free = p.detach().numpy(), w.numpy(), near_zero[name]
        np.testing.assert_allclose(p[~free], w[~free], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)
        assert np.all(np.abs(p - w)[free] <= 2 * tcfg.lr), name


def test_checkpoint_roundtrip_is_exact():
    """A trained whisper-smoke model and its AdamW state saved to the port's
    log (in the reference's record, so with its config) come back bit for
    bit, the encoder's and the cross attention's leaves named; the
    converter's AdamW state walks the same leaves."""
    cfg, jp, model = _models("smoke", trainable=True)
    opt_cfg = AdamWConfig(lr=1e-3)
    _, tb = _batch(cfg, 2, 6, 7)
    model, state, _ = make_train_step(cfg, opt_cfg, grad_dtype="float32")(
        model, adamw_init(model, opt_cfg), tb)
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, chunk_bytes=4096)
    ckpt.save(1, model, state, extra={"cursor": [1]}, cfg=cfg)
    step, params, opt, extra = ckpt.restore(device="cpu", cfg=cfg)
    assert step == 1 and extra == {"cursor": [1]}
    named = dict(model.named_parameters())
    assert set(params) == set(named) and "encoder.blocks.0.mlp.w_in" in params
    for name, p in named.items():
        assert torch.equal(params[name], p.detach()), name
    for key in ("m", "v", "master"):
        for name, t in state[key].items():
            assert torch.equal(opt[key][name], t), (key, name)
    jstate = jax.device_get(jax_adamw_init(jp, JaxAdamWConfig()))
    conv = rt.opt_state_from_jax(cfg, model, jstate)
    assert set(conv["m"]) == set(named) == set(conv["master"])


# ------------------------------------------------------------------ bf16
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_loss_bf16_match_jax(variant):
    """In bf16 (the frames in bf16 too, rounded from the same fp32 draws),
    the logits, loss and nll at tests/test_torch_lm.py's bf16 tolerance: the
    frameworks round at different places."""
    cfg = get_smoke_config(ARCH).with_(dtype="bfloat16", **VARIANTS[variant])
    jp = jlm.init_params(cfg, jax.random.key(0))
    tm = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    jb, tb = _batch(cfg, 2, 9, 2)
    jb["frames"], tb["frames"] = jb["frames"].astype(jnp.bfloat16), tb["frames"].bfloat16()
    jl, _, _, _ = jlm.forward(cfg, jp, jb)
    tl, aux, _, n_prefix = rt.forward(cfg, tm, tb)
    assert tl.shape == (2, 9, cfg.padded_vocab) and tl.dtype == torch.bfloat16
    assert n_prefix == 0 and float(aux) == 0.0
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    jloss, jm = jlm.loss_fn(cfg, jp, jb)
    tloss, tmet = rt.loss_fn(cfg, tm, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(float(tmet["nll"]), float(jm["nll"]), rtol=BF16_TOL,
                               atol=BF16_TOL)


# ------------------------------------------------------------------ sizes
def test_full_config_sizes():
    """whisper-small at full size, made on the meta device: the config's
    count (0.238 B with the tied head) and what it leaves out, the encoder's
    ``pos_embed`` (enc_len, D) and the 62 RMSNorm scales (ln1, ln_c, ln2 of
    12 decoder layers, ln1, ln2 of 12 encoder layers, two final norms):
    0.239 B; the cross caches of enc_len positions."""
    cfg = rt.get_config(ARCH)
    model = rt.init_params(cfg, seed=None, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.count_params()[0] + (1500 + 3 * 12 + 2 * 12 + 2) * cfg.d_model
    assert round(cfg.count_params()[0] / 1e9, 3) == 0.238 and round(n / 1e9, 3) == 0.239
    assert len(model.encoder.blocks) == cfg.encdec.enc_layers == 12
    assert all(isinstance(b, tlm.CrossBlock) for b in model.blocks)
    caches = rt.init_caches(cfg, 2, 16, device="meta")
    assert caches["layers"][0]["cross_k"].shape == (2, 12, 1500, 64)
