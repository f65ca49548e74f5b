"""Training xLSTM in the PyTorch port against the JAX package, on the CPU.

Inputs come from numpy seeds; parameters and optimizer state cross through
``params_from_jax`` / ``opt_state_from_jax``. Held against JAX:

* autograd of ``mlstm_chunk_plain`` against ``jax.grad`` of the model's
  chunk scan (``repro.models.xlstm.mlstm_sequence``), a carried state's
  gradient included; on the card the gradient is the backward kernel, which
  ``test_torch_cuda.py`` and ``chip_smoke.py`` hold against this same
  autograd of the plain version;
* ``MLSTMChunkFunction``'s wiring on the CPU (its plain forward, and
  ``mlstm_chunk_backward``'s CPU route) against autograd of the plain
  version, under ``torch.utils.checkpoint`` too;
* the mLSTM and sLSTM layers' gradients;
* one whole ``make_train_step`` on ``xlstm-smoke`` for every remat mode and
  1 or 2 microbatches, fp32 and bf16; AdamW's state through
  ``opt_state_from_jax`` and checkpoints; a crash and resume of the launcher.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.optimizer import adamw_update as jax_adamw_update  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import BoltSystem  # noqa: E402
from repro_torch.kernels.mlstm_chunk import (BWD_TOL, MLSTMChunkFunction,  # noqa: E402
                                             backward_errors, mlstm_chunk,
                                             mlstm_chunk_backward,
                                             mlstm_chunk_backward_plain,
                                             mlstm_chunk_plain)
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.train import (AdamWConfig, CheckpointManager, adamw_init,  # noqa: E402
                               adamw_update, make_train_step)
from repro_torch.train.step import BF16_STEP_TOL, STEP_TOL  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

ARCH = "xlstm-1.3b"
# Gradients against JAX's, fp32 in both: each gradient's max abs difference
# over its max abs value; the frameworks sum in different orders (XLA's CPU
# against torch's), measured below 3e-6 here
GRAD_TOL = 1e-5
ADAM_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products only, but under six test workers torch's thread pool
    spins on every core; one thread keeps the file fast and its sums fixed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlstm_inputs(seed, B, H, S, Dh, kind=None):
    """Random mLSTM inputs, fp32 numpy; kind "floor": small input gates, so
    the floor exp(-m) is h's denominator on most rows; "forget": small
    forget gates (F in the hundreds within a chunk)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, H, S, Dh), f(B, H, S, Dh) * np.float32(Dh ** -0.5), f(B, H, S, Dh)
    li = f(B, H, S) - (8.0 if kind == "floor" else 0.0)
    lf = np.asarray(jax.nn.log_sigmoid(f(B, H, S) + 2.0), np.float32)
    if kind == "forget":
        lf = np.asarray(2.0 * jax.nn.log_sigmoid(f(B, H, S) - 4.0), np.float32)
    return [a.astype(np.float32) for a in (q, k, v, li, lf)]


def _state_and_grads(seed, B, H, Dh, chunk):
    """A carried-in state (the plain scan over 48 steps) and the final
    state's gradient (dC, dn, dm), fp32 numpy."""
    _, st = mlstm_chunk_plain(*(torch.from_numpy(a) for a in
                                _mlstm_inputs(seed, B, H, 48, Dh)), chunk=chunk)
    rng = np.random.default_rng(seed + 1)
    ds = [rng.normal(size=s).astype(np.float32) for s in ((B, H, Dh, Dh), (B, H, Dh), (B, H))]
    return {key: t.numpy() for key, t in st.items()}, ds


def _grad_close(got, ref, tol=GRAD_TOL):
    errs = backward_errors(got, ref)
    assert errs and all(e <= tol for e in errs.values()), errs


# ------------------------------------------------------- the mLSTM gradient
# (B, H, S, Dh, chunk, carried state, inputs): S a multiple of the chunk, as
# the reference asserts; several chunks; a carried state with the final
# state's gradient; the floor exp(-m) winning
GRAD_CASES = [
    (1, 2, 128, 32, 32, False, None),
    (2, 3, 64, 32, 16, False, None),
    (2, 2, 128, 64, 64, True, None),
    (1, 2, 96, 32, 32, True, "floor"),
]


@pytest.mark.parametrize("B,H,S,Dh,chunk,carry,kind", GRAD_CASES)
def test_plain_grad_matches_jax(B, H, S, Dh, chunk, carry, kind):
    arrs = _mlstm_inputs(S + Dh, B, H, S, Dh, kind)
    dh = np.random.default_rng(3).normal(size=(B, H, S, Dh)).astype(np.float32)
    state, ds = _state_and_grads(5, B, H, Dh, chunk) if carry else (None, None)

    def jax_loss(q, k, v, li, lf, st):
        h, out = jx.mlstm_sequence(q, k, v, li, lf, st, chunk=chunk)
        loss = jnp.sum(h * dh)
        if carry:
            loss += sum(jnp.sum(out[key] * g) for key, g in zip("Cnm", ds))
        return loss

    jst = None if state is None else {key: jnp.asarray(a) for key, a in state.items()}
    argnums = (0, 1, 2, 3, 4, 5) if carry else (0, 1, 2, 3, 4)
    ref = jax.jit(jax.grad(jax_loss, argnums=argnums))(
        *(jnp.asarray(a) for a in arrs), jst)
    ref = [torch.from_numpy(np.array(r)) for r in ref[:5]] + (
        [torch.from_numpy(np.array(ref[5][key])) for key in "Cnm"] if carry else [None] * 3)
    tst = None if state is None else {key: torch.from_numpy(a) for key, a in state.items()}
    tds = dict(zip(("dC", "dn", "dm"), (torch.from_numpy(g) for g in ds))) if carry else {}
    got = mlstm_chunk_backward_plain(*(torch.from_numpy(a) for a in arrs),
                                     torch.from_numpy(dh), chunk=chunk, state=tst, **tds)
    assert (got[5] is None) == (not carry)
    _grad_close(got, ref)


def test_plain_grad_finite_where_reference_overflows():
    """Forget gates that sum below -88 within a chunk: exp(logw) overflows
    above the diagonal, and the reference's where-after-exp gives NaN
    gradients (0 * inf); the port masks before the exp, so its fp32 gradient
    is finite and agrees with its fp64 one (ROADMAP Queue 3, quirk 6)."""
    B, H, S, Dh, chunk = 1, 2, 128, 32, 64
    arrs = _mlstm_inputs(9, B, H, S, Dh, "forget")
    dh = np.random.default_rng(4).normal(size=(B, H, S, Dh)).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jx.mlstm_sequence(*a, chunk=chunk)[0] * dh),
                  argnums=(3, 4))(*(jnp.asarray(a) for a in arrs))
    assert all(np.isnan(np.asarray(g)).any() for g in jg)
    t = [torch.from_numpy(a) for a in arrs]
    got = mlstm_chunk_backward_plain(*t, torch.from_numpy(dh), chunk=chunk)
    assert all(torch.isfinite(g).all() for g in got[:5])
    ref = mlstm_chunk_backward_plain(*(a.double() for a in t), torch.from_numpy(dh).double(),
                                     chunk=chunk)
    _grad_close(got, ref, BWD_TOL)


# (state given, the outputs whose gradient comes in, under checkpoint)
FUNCTION_CASES = [
    (False, "h", False),
    (True, "h", False),
    (True, "state", False),
    (True, "all", False),
    (True, "all", True),
]


@pytest.mark.parametrize("with_state,outputs,remat", FUNCTION_CASES)
def test_function_matches_plain_autograd(with_state, outputs, remat):
    """MLSTMChunkFunction on CPU tensors (the plain forward; the backward by
    mlstm_chunk_backward's CPU route): its saved tensors, None gradients for
    outputs not used, state in and out, and use under torch.utils.checkpoint,
    against autograd through mlstm_chunk_plain itself."""
    B, H, S, Dh, chunk = 2, 2, 80, 32, 32                     # a ragged last chunk
    arrs = _mlstm_inputs(21, B, H, S, Dh)
    state, ds = _state_and_grads(22, B, H, Dh, chunk)
    dh = torch.from_numpy(np.random.default_rng(23).normal(size=(B, H, S, Dh))
                          .astype(np.float32))

    def grads(fn):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
        st = ([torch.from_numpy(state[key]).requires_grad_() for key in "Cnm"]
              if with_state else [None] * 3)
        h, C, n, m = fn(*ins, *st)
        pairs = []
        if outputs in ("h", "all"):
            pairs.append((h, dh))
        if outputs in ("state", "all"):
            pairs += [(o, torch.from_numpy(g)) for o, g in zip((C, n, m), ds)]
        wrt = ins + (st if with_state else [])
        # q reaches h alone: with only the state's gradient, its own is 0
        return h, torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                      allow_unused=True, materialize_grads=True)

    def function(*args):
        if remat:
            return torch.utils.checkpoint.checkpoint(
                lambda *a: MLSTMChunkFunction.apply(*a, chunk), *args, use_reentrant=False)
        return MLSTMChunkFunction.apply(*args, chunk)

    def plain(q, k, v, li, lf, C0, n0, m0):
        st = None if C0 is None else {"C": C0, "n": n0, "m": m0}
        h, out = mlstm_chunk_plain(q, k, v, li, lf, chunk=chunk, state=st)
        return h, out["C"], out["n"], out["m"]

    before = mlstm_chunk.backward_launches
    h, got = grads(function)
    assert mlstm_chunk.backward_launches == before        # the CPU runs plain
    assert type(h.grad_fn).__name__ == "MLSTMChunkFunctionBackward" or remat
    _, ref = grads(plain)
    assert len(got) == len(ref) == (8 if with_state else 5)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)


def test_backward_wrapper_cpu_route():
    """mlstm_chunk_backward on CPU tensors is autograd of the plain version:
    no h needed, (dq, dk, dv, dli, dlf) and None for a state not given."""
    arrs = [torch.from_numpy(a) for a in _mlstm_inputs(31, 1, 2, 40, 32)]
    dh = torch.ones(1, 2, 40, 32)
    got = mlstm_chunk_backward(*arrs, None, dh, chunk=16)
    assert len(got) == 8 and got[5:] == (None, None, None)
    ins = [a.clone().requires_grad_() for a in arrs]
    ref = torch.autograd.grad(mlstm_chunk_plain(*ins, chunk=16)[0], ins, dh)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


# ------------------------------------------------------------------ layers
def _jax_tree(dtype, seed=0):
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    return cfg, jax.device_get(jlm.init_params(cfg, jax.random.key(seed)))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_grads_match_jax(kind):
    """The layer's gradient, input and every parameter, in fp32: the mLSTM
    through the plain chunk scan, the sLSTM through its step loop."""
    cfg, tree = _jax_tree("float32")
    j = 0 if kind == "mlstm" else 7                       # the 7:1 pattern
    jp = jax.tree.map(lambda a: a[0], tree["groups"][j][kind])
    tp = getattr(rt.params_from_jax(cfg, tree, device="cpu", trainable=True).blocks[j], kind)
    rng = np.random.default_rng(41)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    japply = jx.apply_mlstm if kind == "mlstm" else jx.apply_slstm
    tapply = tx.apply_mlstm if kind == "mlstm" else tx.apply_slstm
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(japply(p, x, cfg)[0] * dy),
                        argnums=(0, 1))(jp, jnp.asarray(x))
    tx_ = torch.from_numpy(x).requires_grad_()
    names, params = zip(*tp.named_parameters())
    got = torch.autograd.grad(tapply(tp, tx_, cfg)[0], (tx_, *params), torch.from_numpy(dy))
    ref = [torch.from_numpy(np.array(jgx))] + [torch.from_numpy(np.array(jgp[n]))
                                               for n in names]
    for name, g, r in zip(("x",) + names, got, ref):
        err = ((g - r).abs().max() / r.abs().max()).item()
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_state_under_graph_raises(kind):
    """A given state is updated in place, so a block refuses one while a
    graph is built; without a graph it keeps updating it in place."""
    cfg, tree = _jax_tree("float32")
    j = 0 if kind == "mlstm" else 7
    init = tx.init_mlstm_state if kind == "mlstm" else tx.init_slstm_state
    apply = tx.apply_mlstm if kind == "mlstm" else tx.apply_slstm
    frozen = getattr(rt.params_from_jax(cfg, tree, device="cpu").blocks[j], kind)
    trained = getattr(rt.params_from_jax(cfg, tree, device="cpu",
                                         trainable=True).blocks[j], kind)
    x = torch.from_numpy(np.random.default_rng(43).normal(size=(2, 8, cfg.d_model))
                         .astype(np.float32))
    state = init(cfg, 2, "cpu")
    with pytest.raises(ValueError, match="in place"):
        apply(trained, x, cfg, state=state)
    with pytest.raises(ValueError, match="in place"):
        apply(frozen, x.clone().requires_grad_(), cfg, state=state)
    with torch.no_grad():
        assert apply(trained, x, cfg, state=state)[1] is state
    assert apply(frozen, x, cfg, state=state)[1] is state
    _, new = apply(trained, x.clone().requires_grad_(), cfg, want_state=True)
    assert all(t.requires_grad for t in new.values())    # the final state, with its graph


@pytest.mark.parametrize("tied", [True, False])
def test_initial_loss_matches_jax_at_full_width(tied):
    """xlstm-1.3b at full width, depth cut to one pattern (the reference
    stacks whole patterns), fp32: the initial loss equals JAX's. Its
    embeddings are tied, and at the initial weights the residual stream
    still holds the input token's embedding, whose logit is ~|e| sqrt(d):
    tied, both start more than 20 above ln V; untied, within 1 of it.
    (chip_smoke.py phase 10b holds the card's first loss against the plain
    version's on the same weights for this reason.)"""
    cfg = get_config(ARCH).with_(n_layers=8, dtype="float32", tie_embeddings=tied)
    jp = jlm.init_params(cfg, jax.random.key(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 65)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    jloss = float(jlm.loss_fn(cfg, jp, jb)[0])
    model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    tloss = float(rt.loss_fn(cfg, model, {key: torch.from_numpy(np.array(v)).long()
                                          for key, v in jb.items()})[0])
    np.testing.assert_allclose(tloss, jloss, rtol=STEP_TOL)
    ln_v = math.log(cfg.vocab_size)
    assert (jloss > ln_v + 20) if tied else (abs(jloss - ln_v) < 1)


# -------------------------------------------------------------- train step
def _step_inputs(dtype, remat, seed=0, B=4, S=128):
    cfg = get_smoke_config(ARCH).with_(dtype=dtype, remat=remat)
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
def test_xlstm_train_step_matches_jax(remat, accum):
    """xlstm-smoke (7 mLSTM + 1 sLSTM), S = 128 (two chunks), fp32: loss,
    grad norm and every updated parameter at STEP_TOL (the port remats block
    by block, the reference the whole pattern: the same numbers)."""
    cfg, jp, toks = _step_inputs("float32", remat)
    jm, tm, model, want, state = _run_both(cfg, jp, toks, accum, "float32")
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=STEP_TOL)
    for (name, p), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=name)


def test_xlstm_train_step_bf16_matches_jax():
    cfg, jp, toks = _step_inputs("bfloat16", "full")
    old = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    jm, tm, model, want, _ = _run_both(cfg, jp, toks, 2, "bfloat16")
    tol, lr = BF16_STEP_TOL, 1e-3
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=tol["loss"])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=tol["grad_norm"])
    d2 = w2 = 0.0
    for (name, p), (_, w), (_, o) in zip(model.named_parameters(), want.named_parameters(),
                                         old.named_parameters()):
        p, w, o = p.detach().float(), w.float(), o.float()
        agree = ((p - o) - (w - o)).abs().le(lr / 2).float().mean().item()
        assert agree >= tol["update_agree"], (name, agree)
        d2 += (p - w).square().sum().item()
        w2 += w.square().sum().item()
    assert (d2 / w2) ** 0.5 <= tol["params_rel_rms"]


# ------------------------------------------------ optimizer and checkpoints
def test_xlstm_adamw_update_matches_jax():
    """xLSTM's parameters and AdamW state through opt_state_from_jax: one
    update from a random state at step 3, against JAX's."""
    cfg, jp = _jax_tree("float32", 1)
    rng = np.random.default_rng(51)
    normal = lambda s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    like = lambda fn: jax.tree.map(lambda x: fn(np.shape(x)), jp)  # noqa: E731
    grads = like(lambda s: 0.5 * normal(s))
    jcfg = JaxAdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    jstate = {"m": like(lambda s: 0.1 * normal(s)),
              "v": like(lambda s: 0.01 * np.abs(normal(s))),
              "master": jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
              "step": jnp.asarray(2, jnp.int32)}
    jparams, jnew, jnorm = jax.jit(lambda p, g, s: jax_adamw_update(p, g, s, jcfg))(
        jp, grads, jstate)
    model = rt.params_from_jax(cfg, jp, device="cpu", trainable=True)
    state = rt.opt_state_from_jax(cfg, model, jax.device_get(jstate))
    assert set(state["m"]) == {n for n, _ in model.named_parameters()}
    tgrads = dict(rt.params_from_jax(cfg, grads, device="cpu").named_parameters())
    model, state, norm = adamw_update(model, tgrads, state,
                                      AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0))
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=ADAM_RTOL)
    want = rt.params_from_jax(cfg, jax.device_get(jparams), device="cpu")
    for (name, p), (_, w) in zip(model.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=ADAM_RTOL,
                                   atol=ADAM_RTOL, err_msg=name)
    jnew = rt.opt_state_from_jax(cfg, model, jax.device_get(jnew))
    for key in ("m", "v", "master"):
        for name, t in state[key].items():
            np.testing.assert_allclose(t.numpy(), jnew[key][name].numpy(), rtol=ADAM_RTOL,
                                       atol=ADAM_RTOL, err_msg=f"{key} {name}")


def test_xlstm_checkpoint_roundtrip():
    """xLSTM's parameters (bf16 and fp32 leaves) and AdamW state go through a
    checkpoint fork (in the reference's record, so with the config) and come
    back bit for bit, into a model that trains on."""
    cfg = rt.get_smoke_config(ARCH)
    model = rt.init_params(cfg, 3, device="cpu", trainable=True)
    state = adamw_init(model, AdamWConfig())
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, chunk_bytes=4096)
    ckpt.save(2, model, state, extra={"cursor": [1, 2]}, cfg=cfg)
    step, params, opt, extra = ckpt.restore(device="cpu", cfg=cfg)
    assert step == 2 and extra == {"cursor": [1, 2]}
    names = [n for n, _ in model.named_parameters()]
    assert list(params) == names and "blocks.7.slstm.s_rec" in names
    for name, p in model.named_parameters():
        assert params[name].dtype == p.dtype and torch.equal(params[name], p.detach())
    for key in ("m", "v", "master"):
        assert all(torch.equal(opt[key][n], state[key][n]) for n in names)
    restored = rt.init_params(cfg, None, device="cpu", trainable=True)
    with torch.no_grad():
        for name, p in restored.named_parameters():
            p.copy_(params[name])
    toks = torch.randint(0, cfg.vocab_size, (2, 17))
    step_fn = make_train_step(cfg, AdamWConfig(), grad_dtype="float32")
    _, _, m = step_fn(restored, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"])) and int(opt["step"]) == 1


def test_xlstm_crash_resume_bit_for_bit():
    """The launcher trains xlstm-smoke on the log; a run checkpointed at step
    3 and resumed by a fresh run(resume=True) on the same system gives the
    uninterrupted run's losses bit for bit."""
    from repro_torch.launch.train import run
    cfg = rt.get_smoke_config(ARCH).with_(dtype="float32")
    kw = dict(config=cfg, n_layers=8, batch=2, seq=128, log_every=100, device="cpu")
    straight, _, _, _ = run(steps=6, system=BoltSystem(n_brokers=2), ckpt_every=100, **kw)
    system = BoltSystem(n_brokers=2)
    first, _, _, _ = run(steps=3, system=system, ckpt_every=3, **kw)
    resumed, model, _, _ = run(steps=6, system=system, ckpt_every=100, resume=True, **kw)
    assert first == straight[:3] and resumed == straight[3:]
    assert all(np.isfinite(straight)) and CheckpointManager(system).steps() == [3]
    assert all(p.requires_grad for p in model.parameters())
