"""The PyTorch port's xLSTM against JAX: the mLSTM kernel module, the mLSTM
and sLSTM layers, the LM on ``xlstm-smoke`` and the serving engine.

Inputs are made with numpy from a seed; weights are converted from JAX by
``params_from_jax``. On the CPU the kernel's wrapper takes its plain version;
the CUDA kernel itself is held against the plain version on the card
(``test_torch_cuda.py`` and ``chip_smoke.py``)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import BoltSystem as JaxBoltSystem  # noqa: E402
from repro.kernels.mlstm_chunk import mlstm_chunk as pallas_mlstm  # noqa: E402
from repro.kernels.ref import mlstm_ref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.streams import Producer as JaxProducer  # noqa: E402
from repro.streams import Topic as JaxTopic  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import BoltSystem  # noqa: E402
from repro_torch.kernels.mlstm_chunk import (_check, mlstm_chunk,  # noqa: E402
                                             mlstm_chunk_plain)
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.serve import ServeEngine, decode_response  # noqa: E402
from repro_torch.streams import Producer, Topic  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

# The kernel module: tests/test_kernels.py's tolerance for the chunkwise form
# against the recurrence; the cumsum, cummax and products sum in another
# order than XLA's.
MLSTM_TOL = 3e-4
# Layers: fp32 differs by summation order only; bf16 rounds the projections
# at other places in the two frameworks.
LAYER_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Logits: as tests/test_torch_lm.py (bf16: tests/test_arch_smoke.py:94).
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.15}
ARCH = "xlstm-1.3b"

# tests/test_kernels.py MLSTM_CASES: (B, H, S, Dh, chunk)
MLSTM_CASES = [
    (1, 2, 64, 32, 16),
    (2, 3, 128, 64, 32),
    (1, 4, 128, 128, 64),
    (2, 2, 96, 32, 32),
]


def _mlstm_inputs(seed, B, H, S, Dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, Dh)).astype(np.float32)
    k = (rng.normal(size=(B, H, S, Dh)) * Dh ** -0.5).astype(np.float32)
    v = rng.normal(size=(B, H, S, Dh)).astype(np.float32)
    li = rng.normal(size=(B, H, S)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(rng.normal(size=(B, H, S)) + 2.0),
                    np.float32)
    return q, k, v, li, lf


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _close(ref, out, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def _state_close(ref, out, tol=MLSTM_TOL):
    for key in ("C", "n", "m"):
        _close(ref[key], out[key].numpy(), tol)


# ------------------------------------------------------------ kernel module
@pytest.mark.parametrize("B,H,S,Dh,chunk", MLSTM_CASES)
def test_plain_matches_pallas_kernel_and_state(B, H, S, Dh, chunk):
    arrs = _mlstm_inputs(S + Dh, B, H, S, Dh)
    ref = pallas_mlstm(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                       interpret=True)
    h, st = mlstm_chunk(*_t(arrs), chunk=chunk)
    assert h.shape == (B, H, S, Dh) and h.dtype == torch.float32
    _close(ref, h.numpy(), MLSTM_TOL)
    # the Pallas kernel drops its state: hold it against the recurrence and
    # the model's scan, which return theirs
    _, (C, n, m) = mlstm_ref(*(jnp.asarray(a) for a in arrs))
    _state_close({"C": C, "n": n, "m": m}, st)
    _, jst = jx.mlstm_sequence(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    _state_close(jst, st)


def test_carried_state_matches_model_scan():
    """An initial state: the second half of a sequence continued from the
    first half's state equals the JAX scan given that state, and the whole
    sequence in one call."""
    B, H, S, Dh, chunk = 2, 2, 128, 64, 32
    arrs = _mlstm_inputs(11, B, H, S, Dh)
    first = [a[:, :, :S // 2] for a in arrs]
    second = [a[:, :, S // 2:] for a in arrs]
    _, st1 = mlstm_chunk(*_t(first), chunk=chunk)
    h2, st2 = mlstm_chunk(*_t(second), chunk=chunk, state=st1)
    jst1 = {key: jnp.asarray(t.numpy()) for key, t in st1.items()}
    jh2, jst2 = jx.mlstm_sequence(*(jnp.asarray(a) for a in second),
                                  state=jst1, chunk=chunk)
    _close(jh2, h2.numpy(), MLSTM_TOL)
    _state_close(jst2, st2)
    h, st = mlstm_chunk(*_t(arrs), chunk=chunk)
    _close(h[:, :, S // 2:].numpy(), h2.numpy(), MLSTM_TOL)
    _state_close({key: t.numpy() for key, t in st.items()}, st2)


@pytest.mark.parametrize("S,chunk", [(100, 32), (70, 64), (5, 64)])
def test_ragged_last_chunk_matches_recurrence(S, chunk):
    """S no chunk divides: the reference's scan asserts S % chunk == 0, the
    recurrence takes any S."""
    B, H, Dh = 1, 2, 32
    arrs = _mlstm_inputs(S, B, H, S, Dh)
    jh, (C, n, m) = mlstm_ref(*(jnp.asarray(a) for a in arrs))
    h, st = mlstm_chunk(*_t(arrs), chunk=chunk)
    _close(jh, h.numpy(), MLSTM_TOL)
    _state_close({"C": C, "n": n, "m": m}, st)


def test_wrapper_dispatch_and_checks_on_cpu():
    """A CPU tensor takes the plain version and launches nothing; the checks
    a CUDA tensor must pass raise on what the kernel does not take."""
    q, k, v, li, lf = _t(_mlstm_inputs(3, 1, 2, 40, 32))
    before = mlstm_chunk.launches
    h, st = mlstm_chunk(q, k, v, li, lf, chunk=16)
    assert mlstm_chunk.launches == before
    hp, stp = mlstm_chunk_plain(q, k, v, li, lf, chunk=16)
    torch.testing.assert_close(h, hp, rtol=0, atol=0)
    torch.testing.assert_close(mlstm_chunk(q, k, v, li, lf, chunk=16,
                                              impl="plain")[0], h, rtol=0, atol=0)
    with pytest.raises(ValueError):
        mlstm_chunk(q, k, v, li, lf, impl="fast")
    _check(q, k, v, li, lf, 16, st)                  # what the kernel takes
    bad = [
        (ValueError, lambda: _check(q, k, v, li, lf, 65, None)),
        (ValueError, lambda: _check(q[..., :24].contiguous(), k[..., :24].contiguous(),
                                       v[..., :24].contiguous(), li, lf, 16, None)),
        (TypeError, lambda: _check(q.double(), k, v, li, lf, 16, None)),
        (ValueError, lambda: _check(q.transpose(2, 3).contiguous().transpose(2, 3),
                                       k, v, li, lf, 16, None)),
        (ValueError, lambda: _check(q, k, v, li, lf, 16,
                                       {**st, "m": st["m"][:, :1]})),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()


# ------------------------------------------------------------------ layers
@functools.cache
def _jax_tree(dtype, seed):
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    return cfg, jax.device_get(jlm.init_params(cfg, jax.random.key(seed)))


def _layer_pair(kind, dtype, seed=0):
    cfg, tree = _jax_tree(dtype, seed)
    j = 0 if kind == "mlstm" else 7                       # the 7:1 pattern
    jp = jax.tree.map(lambda a: a[0], tree["groups"][j][kind])
    tp = getattr(rt.params_from_jax(cfg, tree, device="cpu").blocks[j], kind)
    return cfg, jp, tp


def _x(cfg, dtype, B, S, seed):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_matches_jax_with_and_without_state(kind, dtype):
    cfg, jp, tp = _layer_pair(kind, dtype)
    japply = jx.apply_mlstm if kind == "mlstm" else jx.apply_slstm
    tapply = tx.apply_mlstm if kind == "mlstm" else tx.apply_slstm
    jx1, tx1 = _x(cfg, dtype, 2, 16, 1)
    jy, jst = japply(jp, jx1, cfg, want_state=True)
    ty, tst = tapply(tp, tx1, cfg, want_state=True)
    assert ty.dtype == tx1.dtype and ty.shape == tx1.shape
    _close(jy, ty.float().numpy(), LAYER_TOL[dtype])
    for key in jst:
        _close(jst[key], tst[key].numpy(), LAYER_TOL[dtype])
    # no state wanted, none returned
    assert tapply(tp, tx1, cfg)[1] is None
    # one decode step from that state, updated in place
    jx2, tx2 = _x(cfg, dtype, 2, 1, 2)
    jy2, jst2 = japply(jp, jx2, cfg, state=jst)
    ty2, tst2 = tapply(tp, tx2, cfg, state=tst)
    assert tst2 is tst
    _close(jy2, ty2.float().numpy(), LAYER_TOL[dtype])
    for key in jst2:
        _close(jst2[key], tst[key].numpy(), LAYER_TOL[dtype])


def test_mlstm_layer_state_layout_and_init():
    cfg = get_smoke_config(ARCH)
    Di, Dh = tx._dims(cfg)
    st = tx.init_mlstm_state(cfg, 3, "cpu")
    jst = jx.init_mlstm_state(cfg, 3)
    for key in ("C", "n", "m"):
        assert tuple(st[key].shape) == jst[key].shape
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]))
    sst, jsst = tx.init_slstm_state(cfg, 3, "cpu"), jx.init_slstm_state(cfg, 3)
    for key in ("sc", "sn", "sh", "sm"):
        np.testing.assert_array_equal(sst[key].numpy(), np.asarray(jsst[key]))
    assert Dh == 2 * cfg.d_model // cfg.n_heads


# ---------------------------------------------------------------------- LM
def _models(dtype, seed=0):
    cfg, jp = _jax_tree(dtype, seed)
    return cfg, jp, rt.params_from_jax(cfg, jp, device="cpu")


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_jax(dtype):
    cfg, jp, tm = _models(dtype)
    toks, labels = _tokens(cfg, 2, 32, 1), _tokens(cfg, 2, 32, 2)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    jl, _, _, _ = jlm.forward(cfg, jp, jb)
    tl, aux, _, _ = rt.forward(cfg, tm, tb)
    assert tl.shape == (2, 32, cfg.padded_vocab) and float(aux) == 0.0
    tol = LOGIT_TOL[dtype]
    _close(jl, tl.float().numpy(), tol)
    jloss, _ = jlm.loss_fn(cfg, jp, jb)
    tloss, _ = rt.loss_fn(cfg, tm, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol, atol=tol)


def test_prefill_then_decode_matches_teacher_forced():
    """forward(want_caches=True) then decode_step gives the logits that
    teacher-forcing the whole prefix through decode_step gives (fp32); the
    prefill's states equal the teacher-forced ones."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    tm = rt.init_params(cfg, 6, device="cpu")
    B, P, extra = 2, 10, 3
    toks = torch.from_numpy(_tokens(cfg, B, P + extra, 7)).long()
    _, _, caches, _ = rt.forward(cfg, tm, {"tokens": toks[:, :P]},
                                 want_caches=True, max_len=P + extra)
    tf = rt.init_caches(cfg, B, P + extra, device="cpu")
    for t in range(P):
        _, tf = rt.decode_step(cfg, tm, tf, toks[:, t:t + 1], t)
    for a, b in zip(caches["layers"], tf["layers"]):
        assert a.keys() == b.keys()
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=1e-4, atol=1e-4)
    for t in range(P, P + extra):
        a, caches = rt.decode_step(cfg, tm, caches, toks[:, t:t + 1], t)
        b, tf = rt.decode_step(cfg, tm, tf, toks[:, t:t + 1], t)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_decode_step_matches_jax():
    """Teacher-forced decode steps against JAX's: logits and every state."""
    cfg, jp, tm = _models("float32", seed=8)
    B, S = 2, 6
    toks = _tokens(cfg, B, S, 10)
    jc = jlm.init_caches(cfg, B, S)
    tc = rt.init_caches(cfg, B, S, device="cpu")
    jstep = jax.jit(lambda p, c, tok, pos: jlm.decode_step(cfg, p, c, tok, pos))
    for t in range(S):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                       jnp.asarray(t, jnp.int32))
        tl, tc2 = rt.decode_step(cfg, tm, tc,
                                 torch.from_numpy(toks[:, t:t + 1]).long(), t)
        assert tc2 is tc
        _close(jl, tl.numpy(), LOGIT_TOL["float32"])
    n_pat = len(cfg.block_pattern)
    for i, layer in enumerate(tc["layers"]):
        g, j = divmod(i, n_pat)
        for key, val in layer.items():
            _close(jc["groups"][j][key][g], val.numpy(), 1e-5)


# ------------------------------------------------------------------ engine
def _serve(system, topic_cls, producer_cls, engine_cls, cfg, params, reqs):
    req, resp = topic_cls.create(system, "req"), topic_cls.create(system, "resp")
    prod = producer_cls(req)
    for r in reqs:
        prod.produce(r)
    prod.flush()
    eng = engine_cls(cfg, params, req, resp, batch_size=4)
    assert eng.poll_and_serve(gen_tokens=6) == len(reqs)
    return req, resp


def test_serve_engine_streams_match_jax():
    """xlstm-smoke in fp32: the port's greedy streams equal the JAX engine's
    token for token; the port prefills through the mLSTM scan, JAX
    teacher-forces the prompt through its decode step."""
    cfg, jp, tm = _models("float32", seed=3)
    rng = np.random.default_rng(4)
    reqs = [{"id": f"r{i}", "prompt": [int(t) for t in rng.integers(2, cfg.vocab_size, n)]}
            for i, n in enumerate((3, 9, 16))]
    system = BoltSystem(n_brokers=3)
    req, resp = _serve(system, Topic, Producer, ServeEngine, cfg, tm, reqs)
    out = decode_response(resp.log.read(0, resp.log.visible_tail))
    assert sorted(out) == ["r0", "r1", "r2"]
    assert ServeEngine(cfg, tm, req, resp, batch_size=4).poll_and_serve() == 0
    jsystem = JaxBoltSystem(n_brokers=3)
    _, jresp = _serve(jsystem, JaxTopic, JaxProducer, JaxServeEngine, cfg,
                      jp, reqs)
    assert out == decode_response(jresp.log.read(0, jresp.log.visible_tail))
