"""The PyTorch port's training path against the JAX package, on the CPU.

Inputs come from numpy seeds; parameters and optimizer state cross through
``params_from_jax`` / ``opt_state_from_jax``. Held against JAX:

* the gradient of ``flash_attention`` (on the CPU autograd through its plain
  version; on the card ``FlashAttentionFunction``, whose backward kernel
  ``test_torch_cuda.py`` and ``chip_smoke.py`` hold against this same
  gradient) against ``jax.grad`` of the model's XLA flash;
* one ``adamw_update`` from a non-trivial state;
* one whole ``make_train_step`` (loss, grad norm, every updated parameter)
  on the dense, MoE and MLA smoke configs, for every remat mode and 1 or 2
  microbatches, and on jamba's (Mamba) under remat full;
* and that serving still builds no graph.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.attention import flash_attention as xla_flash  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.optimizer import adamw_update as jax_adamw_update  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,  # noqa: E402
                               make_train_step, opt_state_shardings)
from repro_torch.train.step import BF16_STEP_TOL, STEP_TOL  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

# fp32: the frameworks sum in different orders (XLA's CPU against torch's)
GRAD_TOL = 1e-5
ADAM_RTOL = 1e-6
# A whole step: STEP_TOL and BF16_STEP_TOL of train/step.py. Measured here
# in bf16: the updated parameters 3e-3 relative RMS apart, 1 of 64 updates of
# a norm scale beyond lr / 2, loss and grad norm 1e-6 and 5e-5 apart


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products only, but under six test workers torch's thread pool
    spins on every core; one thread keeps the file fast and its sums fixed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------- flash attention grad
# (B, H, KH, Sq, Sk, Dh, q_offset, causal): G = 1, 2, 4, ragged S, an offset;
# Dh is one head dim, or MLA's pair (Dhk, Dhv)
GRAD_CASES = [
    (1, 2, 2, 37, 37, 16, 0, True),
    (2, 4, 2, 50, 50, 32, 0, True),
    (1, 8, 2, 33, 33, 16, 0, True),
    (1, 4, 2, 19, 45, 16, 26, True),
    (2, 4, 1, 40, 24, 32, 0, False),
    (1, 4, 4, 17, 31, 16, 0, False),
    (2, 4, 4, 29, 29, (24, 16), 0, True),      # deepseek-v2-lite-smoke
    (1, 4, 4, 11, 30, (24, 16), 19, True),
    (1, 2, 2, 21, 21, (192, 128), 0, True),    # deepseek-v2-lite
    (1, 2, 2, 9, 26, (192, 128), 17, True),
    (1, 2, 2, 14, 23, (192, 128), 0, False),
]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,Dh,q_offset,causal", GRAD_CASES)
def test_flash_grad_matches_jax(B, H, KH, Sq, Sk, Dh, q_offset, causal):
    Dh, Dhv = Dh if isinstance(Dh, tuple) else (Dh, Dh)
    rng = np.random.default_rng(Sq * 3 + Sk + H)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, Sq, Dh), (B, KH, Sk, Dh), (B, KH, Sk, Dhv)))
    do = rng.normal(size=(B, H, Sq, Dhv)).astype(np.float32)
    G = H // KH

    def jax_loss(q, k, v):
        # the JAX model repeats kv heads to H before its flash; the port's
        # kernel reads kv head h // G of the original heads
        out = xla_flash(q, jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1),
                        causal=causal, chunk=16, q_offset=q_offset)
        return jnp.sum(out * do)

    ref = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = flash_attention.backward_launches
    out = flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert flash_attention.backward_launches == before      # the CPU runs plain
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


# ------------------------------------------------------------------ AdamW
def _jax_tree_like(tree, rng, fn):
    return jax.tree.map(lambda x: fn(rng, np.shape(x)), tree)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moments):
    """Step 3 (bias correction live) from a random state, with clipping
    active; every parameter, moment and master weight and the grad norm."""
    cfg = get_smoke_config("qwen3-8b").with_(dtype="float32")
    jp = jax.device_get(jlm.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(7)
    normal = lambda r, s: r.normal(size=s).astype(np.float32)  # noqa: E731
    grads = _jax_tree_like(jp, rng, lambda r, s: 0.5 * normal(r, s))
    jcfg = JaxAdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0,
                          moments_dtype=moments)
    mdt = jnp.dtype(moments)
    jstate = {"m": _jax_tree_like(jp, rng, lambda r, s: jnp.asarray(0.1 * normal(r, s), mdt)),
              "v": _jax_tree_like(jp, rng, lambda r, s: jnp.asarray(
                  0.01 * np.abs(normal(r, s)), mdt)),
              "master": jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
              "step": jnp.asarray(2, jnp.int32)}
    jparams, jnew, jnorm = jax.jit(lambda p, g, s: jax_adamw_update(p, g, s, jcfg))(
        jp, grads, jstate)
    assert float(jnorm) > 10 * jcfg.clip_norm                # clipping is live

    model = rt.params_from_jax(cfg, jp, device="cpu", trainable=True)
    state = rt.opt_state_from_jax(cfg, model, jax.device_get(jstate))
    tgrads = dict(rt.params_from_jax(cfg, grads, device="cpu").named_parameters())
    tcfg = AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0, moments_dtype=moments)
    model, state, norm = adamw_update(model, tgrads, state, tcfg)
    assert int(state["step"]) == 3
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=ADAM_RTOL)
    want = rt.params_from_jax(cfg, jax.device_get(jparams), device="cpu")
    for (name, p), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=ADAM_RTOL,
                                   atol=ADAM_RTOL, err_msg=name)
    jnew = rt.opt_state_from_jax(cfg, model, jax.device_get(jnew))
    for key in ("m", "v", "master"):
        for name, t in state[key].items():
            assert t.dtype == jnew[key][name].dtype
            np.testing.assert_allclose(t.float().numpy(), jnew[key][name].float().numpy(),
                                       rtol=ADAM_RTOL, atol=ADAM_RTOL,
                                       err_msg=f"{key} {name}")


def test_adamw_init_and_unported_sharding():
    cfg = get_smoke_config("smollm-135m")
    model = rt.init_params(cfg, 0, device="cpu", trainable=True)
    state = adamw_init(model, AdamWConfig(moments_dtype="bfloat16"))
    names = [n for n, _ in model.named_parameters()]
    assert list(state["m"]) == names and list(state["master"]) == names
    assert all(t.dtype == torch.bfloat16 and not t.any() for t in state["v"].values())
    assert all(state["master"][n].dtype == torch.float32
               and torch.equal(state["master"][n], p.float())
               for n, p in model.named_parameters())
    assert int(state["step"]) == 0
    # ZeRO-1: the param's spec extended over 'data' (and 'pod'), step replicated
    from repro_torch.distributed import P
    from repro_torch.launch.mesh import MeshShape
    mesh = MeshShape(("data", "model"), (2, 2))
    shard = opt_state_shardings(cfg, model, mesh, AdamWConfig(moments_dtype="bfloat16"))
    assert set(shard) == {"m", "v", "master", "step"} and shard["step"].spec == P()
    assert list(shard["m"]) == names and shard["m"] is shard["v"] is shard["master"]
    w_in = shard["m"]["blocks.0.mlp.w_in"]                  # (64, 128) of 4 layers
    assert (w_in.spec, w_in.stack, w_in.n_stack) == (P("data", "model"), None, 4)
    assert shard["m"]["embed"].spec == P("model", "data")    # (512, 64)
    assert "master" not in opt_state_shardings(cfg, model, mesh,
                                               AdamWConfig(master_weights=False))


# -------------------------------------------------------------- train step
# granite's MoE smoke config with a dense first layer, a shared expert and
# padded experts (8 -> 12): every MoE leaf and the first block take a step
_GRANITE = get_smoke_config("granite-moe-3b-a800m")
VARIANTS = {"granite-moe-dense-first": ("granite-moe-3b-a800m", {
    "first_layer_dense": True, "n_layers": 3, "pad_experts_to": 12,
    "moe": dataclasses.replace(_GRANITE.moe, n_shared=1)})}


def _step_inputs(arch, dtype, remat, seed=0, B=4, S=16):
    arch, overrides = VARIANTS.get(arch, (arch, {}))
    cfg = get_smoke_config(arch).with_(dtype=dtype, remat=remat, **overrides)
    jp = jlm.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return cfg, jp, toks


def _run_both(cfg, jp, toks, accum, grad_dtype):
    jcfg, tcfg = (JaxAdamWConfig(lr=1e-3, weight_decay=0.01),
                  AdamWConfig(lr=1e-3, weight_decay=0.01))
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    jstep = jax.jit(jax_make_train_step(cfg, jcfg, accum=accum, grad_dtype=grad_dtype))
    jparams, _, jm = jstep(jp, jax_adamw_init(jp, jcfg), jbatch)

    model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu", trainable=True)
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
              "labels": torch.from_numpy(toks[:, 1:]).long()}
    step = make_train_step(cfg, tcfg, accum=accum, grad_dtype=grad_dtype)
    model, state, tm = step(model, adamw_init(model, tcfg), tbatch)
    want = rt.params_from_jax(cfg, jax.device_get(jparams), device="cpu")
    return jm, tm, model, want, state


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "smollm-135m", "granite-moe-3b-a800m",
                                  "granite-moe-dense-first", "deepseek-v2-lite-16b"])
def test_train_step_matches_jax(arch, remat, accum):
    cfg, jp, toks = _step_inputs(arch, "float32", remat)
    jm, tm, model, want, state = _run_both(cfg, jp, toks, accum, "float32")
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=STEP_TOL)
    for (name, p), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=name)


def test_train_step_jamba_matches_jax():
    """One step of jamba-smoke (Mamba, attention, MoE and MLP layers; the
    Mamba gradient by autograd through the log-depth scan) under remat full,
    every updated parameter at STEP_TOL."""
    cfg, jp, toks = _step_inputs("jamba-1.5-large-398b", "float32", "full")
    jm, tm, model, want, state = _run_both(cfg, jp, toks, 1, "float32")
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=STEP_TOL)
    names = [name for name, _ in model.named_parameters()]
    assert sum(".mamba." in name for name in names) == 7 * 8
    for (name, p), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b"])
def test_train_step_bf16_matches_jax(arch):
    cfg, jp, toks = _step_inputs(arch, "bfloat16", "full")
    old = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    jm, tm, model, want, _ = _run_both(cfg, jp, toks, 2, "bfloat16")
    tol, lr = BF16_STEP_TOL, 1e-3
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=tol["loss"])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=tol["grad_norm"])
    d2 = w2 = 0.0
    for (name, p), (_, w), (_, o) in zip(model.named_parameters(), want.named_parameters(),
                                         old.named_parameters()):
        # bf16 but for the fp32 MoE router, as the reference keeps it
        assert p.dtype == w.dtype == (torch.float32 if name.endswith(".router")
                                      else torch.bfloat16), name
        p, w, o = p.detach().float(), w.float(), o.float()
        agree = ((p - o) - (w - o)).abs().le(lr / 2).float().mean().item()
        assert agree >= tol["update_agree"], (name, agree)
        d2 += (p - w).square().sum().item()
        w2 += w.square().sum().item()
    assert (d2 / w2) ** 0.5 <= tol["params_rel_rms"]


def test_train_step_reduces_loss():
    cfg, jp, toks = _step_inputs("smollm-135m", "float32", "none")
    model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu", trainable=True)
    tcfg = AdamWConfig(lr=3e-3, weight_decay=0.0)
    state = adamw_init(model, tcfg)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()}
    step = make_train_step(cfg, tcfg, accum=2, grad_dtype="float32")
    losses = [float(step(model, state, batch)[2]["loss"]) for _ in range(5)]
    assert losses[-1] < losses[0] - 0.1, losses


# ------------------------------------------------------------------ serving
def test_serving_stays_frozen_and_builds_no_graph():
    from repro_torch.core import BoltSystem
    from repro_torch.serve import ServeEngine, decode_response
    from repro_torch.streams import Producer, Topic
    cfg = get_smoke_config("smollm-135m").with_(dtype="float32")
    model = rt.init_params(cfg, 0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    logits, _, _, _ = rt.forward(cfg, model, {"tokens": tokens})
    assert logits.grad_fn is None and not logits.requires_grad
    trained = rt.init_params(cfg, 0, device="cpu", trainable=True)
    assert all(p.requires_grad for p in trained.parameters())
    assert rt.forward(cfg, trained, {"tokens": tokens})[0].grad_fn is not None
    seen = []
    real = rt.models.lm.forward

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((torch.is_grad_enabled(), out[0].grad_fn))
        return out

    system = BoltSystem(n_brokers=2)
    req, resp = Topic.create(system, "req"), Topic.create(system, "resp")
    prod = Producer(req)
    prod.produce({"id": "a", "prompt": [3, 4, 5]})
    prod.flush()
    import repro_torch.serve.engine as engine
    engine.forward = spy
    try:                                     # a trainable model, served
        assert ServeEngine(cfg, trained, req, resp).poll_and_serve(gen_tokens=3) == 1
    finally:
        engine.forward = real
    assert seen and all(not grad and fn is None for grad, fn in seen)
    assert len(decode_response(resp.log.read(0, resp.log.visible_tail))["a"]) == 3


def test_xlstm_trains_under_grad():
    """A trainable xLSTM model builds a graph under grad: every parameter,
    those of the mLSTM blocks (whose gradient on the card is the mLSTM
    backward kernel) and of the sLSTM block included, gets a nonzero
    gradient; serving is unaffected."""
    cfg = get_smoke_config("xlstm-1.3b").with_(dtype="float32")
    model = rt.init_params(cfg, 0, device="cpu", trainable=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 8))
    loss, _ = rt.loss_fn(cfg, model, {"tokens": tokens, "labels": tokens})
    assert loss.grad_fn is not None
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    mlstm = [n for n in names if ".mlstm." in n]
    assert len(mlstm) == 6 * 7 and any(".slstm." in n for n in names)
    for name, g in grads.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
    with torch.no_grad():                    # serving is unaffected
        assert rt.forward(cfg, model, {"tokens": tokens})[0].shape[:2] == (1, 8)
