"""The PyTorch port's Mamba mixer against JAX on ``jamba-smoke``: the causal
conv, the log-depth scan against the recurrence, ``apply_mamba``'s prefill,
decode and gradients, and the full-width leaves' shapes and dtypes.

Inputs are made with numpy from a seed; weights are converted from JAX by
``params_from_jax``. The model-level checks (logits, caches, serving, a
train step) are in ``test_torch_lm.py``, ``test_torch_serve.py`` and
``test_torch_train.py``."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

ARCH = "jamba-1.5-large-398b"
# The conv: fp32 differs by the order of nothing (the same products summed
# in the same order), so only by the frameworks' fp32 multiply-add; bf16
# rounds each product and partial sum, where XLA may keep a fused sum wider.
CONV_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
# The scan against the recurrence: the same combine, another order of
# products (a log-depth tree against a chain), in fp32.
SCAN_RTOL = 1e-5
# apply_mamba against JAX, relative to each tensor's largest entry (the
# smoke widths' random weights make y ~3e-4 and the state ~1e-5): fp32
# summation order in the projections; bf16 rounds the projections at other
# places in the two frameworks.
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# decode against JAX, and prefill against teacher-forced decode, fp32,
# relative to each tensor's largest entry
DECODE_TOL = 1e-5
# gradients: 1e-5 of each tensor's largest entry (fp32)
GRAD_TOL = 1e-5


def _close(ref, out, tol, scale=False):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out.detach().float() if torch.is_tensor(out) else out, np.float32)
    atol = tol * max(np.abs(ref).max(), 1e-30) if scale else tol
    np.testing.assert_allclose(out, ref, rtol=tol, atol=atol)


def _pair(arr, dtype):
    return (jnp.asarray(arr, getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(arr, np.float32)).to(getattr(torch, dtype)))


@functools.cache
def _jax_tree(dtype, seed=0):
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    return cfg, jax.device_get(jlm.init_params(cfg, jax.random.key(seed)))


def _layer_pair(dtype, trainable=False, j=0):
    """Layer ``j`` of the pattern (0: ``mamba+moe``, 1: ``mamba+mlp``)."""
    cfg, tree = _jax_tree(dtype)
    jp = jax.tree.map(lambda a: a[0], tree["groups"][j]["mamba"])
    tp = rt.params_from_jax(cfg, tree, device="cpu", trainable=trainable).blocks[j].mamba
    return cfg, jp, tp


def _x(cfg, dtype, B, S, seed):
    return _pair(np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)), dtype)


# ------------------------------------------------------------------ conv
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype, with_state):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.normal(size=(2, 7, 128)), dtype)
    jw, tw = _pair(rng.normal(size=(4, 128)) * 0.1, dtype)
    js, ts = _pair(rng.normal(size=(2, 3, 128)), dtype) if with_state else (None, None)
    jout, jnew = jssm._causal_conv(jx, jw, js)
    tout, tnew = tssm._causal_conv(tx, tw, ts)
    assert tout.dtype == tx.dtype and tnew.shape == (2, 3, 128)
    _close(jout, tout, CONV_TOL[dtype])
    _close(jnew, tnew, CONV_TOL[dtype])


def test_causal_conv_short_prompt_keeps_state():
    """A prompt shorter than W - 1 keeps the given state's last rows."""
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.normal(size=(1, 2, 16)), "float32")
    jw, tw = _pair(rng.normal(size=(4, 16)), "float32")
    js, ts = _pair(rng.normal(size=(1, 3, 16)), "float32")
    _, jnew = jssm._causal_conv(jx, jw, js)
    _, tnew = tssm._causal_conv(tx, tw, ts)
    torch.testing.assert_close(tnew[:, 0], ts[:, 2], rtol=0, atol=0)
    _close(jnew, tnew, CONV_TOL["float32"])


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("S", [1, 3, 7, 37, 64])
def test_scan_matches_recurrence(S):
    rng = np.random.default_rng(S)
    dA = torch.from_numpy(rng.uniform(0.3, 1.0, size=(2, S, 8, 4)).astype(np.float32))
    dBx = torch.from_numpy(rng.normal(size=(2, S, 8, 4)).astype(np.float32))
    h = tssm.selective_scan(dA, dBx)
    ref = tssm.ssm_recurrence(dA, dBx, torch.zeros(2, 8, 4))
    assert h.shape == ref.shape == (2, S, 8, 4)
    _close(ref.numpy(), h, SCAN_RTOL, scale=True)


# ------------------------------------------------------------- the layer
@pytest.mark.parametrize("j", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype, j):
    cfg, jp, tp = _layer_pair(dtype, j=j)
    jx, tx = _x(cfg, dtype, 2, 16, 1)
    jy, jst = jssm.apply_mamba(jp, jx, cfg, want_state=True)
    ty, tst = tssm.apply_mamba(tp, tx, cfg, want_state=True)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert tst["ssm"].dtype == torch.float32 and tst["conv"].dtype == tx.dtype
    _close(jy, ty, LAYER_TOL[dtype], scale=True)
    for key in ("ssm", "conv"):
        _close(jst[key], tst[key], LAYER_TOL[dtype], scale=True)
    assert tssm.apply_mamba(tp, tx, cfg)[1] is None      # no state wanted, none returned


def test_decode_steps_from_jax_state_match_jax():
    """k decode steps from JAX's prefill state, each updating the port's
    state in place, against JAX's steps (fp32)."""
    cfg, jp, tp = _layer_pair("float32")
    jx, _ = _x(cfg, "float32", 2, 9, 5)
    _, jst = jssm.apply_mamba(jp, jx, cfg, want_state=True)
    tst = {key: torch.from_numpy(np.array(a)) for key, a in jst.items()}
    for step in range(3):
        jx1, tx1 = _x(cfg, "float32", 2, 1, 10 + step)
        jy, jst = jssm.apply_mamba(jp, jx1, cfg, state=jst)
        ty, out = tssm.apply_mamba(tp, tx1, cfg, state=tst)
        assert out is tst
        _close(jy, ty, DECODE_TOL, scale=True)
        for key in ("ssm", "conv"):
            _close(jst[key], tst[key], DECODE_TOL, scale=True)


@pytest.mark.parametrize("S", [1, 2, 9])
def test_prefill_matches_teacher_forced_decode(S):
    """The port alone: the scan's prefill of S tokens (output and final
    state) against S decode steps of the recurrence from a zero state."""
    cfg, _, tp = _layer_pair("float32")
    _, tx = _x(cfg, "float32", 2, S, 20 + S)
    y, st = tssm.apply_mamba(tp, tx, cfg, want_state=True)
    state = tssm.init_mamba_state(cfg, 2, "cpu")
    steps = [tssm.apply_mamba(tp, tx[:, t:t + 1], cfg, state=state)[0] for t in range(S)]
    _close(y.numpy(), torch.cat(steps, 1), DECODE_TOL, scale=True)
    for key in ("ssm", "conv"):
        _close(st[key].numpy(), state[key], DECODE_TOL, scale=True)


def test_grads_match_jax():
    """The gradient in x and in all eight leaves, against jax.grad (fp32)."""
    cfg, jp, tp = _layer_pair("float32", trainable=True)
    jx, tx = _x(cfg, "float32", 2, 13, 7)
    dy = np.random.default_rng(8).normal(size=(2, 13, cfg.d_model)).astype(np.float32)

    def jloss(params, x):
        return jnp.sum(jssm.apply_mamba(params, x, cfg)[0] * dy)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tx = tx.requires_grad_()
    names, params = zip(*tp.named_parameters())
    assert sorted(names) == sorted(jgp)
    y, _ = tssm.apply_mamba(tp, tx, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), (tx, *params))
    _close(jgx, grads[0], GRAD_TOL, scale=True)
    for name, g in zip(names, grads[1:]):
        assert g.dtype == getattr(tp, name).dtype, name
        _close(jgp[name], g, GRAD_TOL, scale=True)


def test_state_under_graph_raises():
    """A given state is updated in place, so the mixer refuses one while a
    graph is built; without a graph it keeps updating it in place."""
    cfg, _, trained = _layer_pair("float32", trainable=True)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 1, cfg.d_model))
                         .astype(np.float32))
    state = tssm.init_mamba_state(cfg, 2, "cpu")
    with pytest.raises(ValueError, match="in place"):
        tssm.apply_mamba(trained, x, cfg, state=state)
    with torch.no_grad():
        assert tssm.apply_mamba(trained, x, cfg, state=state)[1] is state
    _, new = tssm.apply_mamba(trained, x.clone().requires_grad_(), cfg, want_state=True)
    assert new["ssm"].requires_grad


def test_init_matches_reference_shapes_and_constants():
    """At full width (on the meta device, nothing allocated) the leaves have
    the reference's shapes and dtypes, m_alog fp32 in a bf16 model; at the
    smoke widths the constants are the reference's values."""
    cfg = get_config(ARCH)
    want = jax.eval_shape(lambda k: jssm.init_mamba(k, cfg), jax.random.key(0))
    p = tssm.init_mamba(None, rt.get_config(ARCH), "meta")
    got = dict(p.named_parameters())
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype)[6:] == str(leaf.dtype), name
    assert got["m_alog"].dtype == torch.float32 and got["m_in"].dtype == torch.bfloat16
    assert tuple(got["m_in"].shape) == (8192, 2, 16384)
    assert tuple(got["m_xproj"].shape) == (16384, 512 + 2 * 16)

    _, tree = _jax_tree("bfloat16")
    gen = torch.Generator().manual_seed(0)
    tp = tssm.init_mamba(gen, rt.get_smoke_config(ARCH), "cpu")
    jp = jax.tree.map(lambda a: a[0], tree["groups"][0]["mamba"])
    for name in ("m_dtb", "m_d"):
        _close(jp[name], getattr(tp, name), 0.0)
    _close(jp["m_alog"], tp.m_alog, 1e-6)


@pytest.mark.parametrize("n_layers,params,gib", [
    (1, 11_157_889_024, 20.78), (4, 23_290_650_624, 43.38),
    (5, 33_105_469_440, 61.67), (8, 45_238_231_040, 84.27)])
def test_jamba_depth_cut_sizes(n_layers, params, gib):
    """jamba-1.5-large-398b at full width on the meta device (nothing
    allocated): its parameters and bytes at the depths PERF.md weighs. The
    card serves 5 layers, the least that reaches its attention layer
    (pattern index 4); one pattern period (8 layers) is over 80 GB."""
    cfg = rt.get_config(ARCH).with_(n_layers=n_layers)
    model = rt.init_params(cfg, None, device="meta")
    kinds = rt.models.lm.layer_kinds(cfg)
    assert kinds == list(cfg.block_pattern[:n_layers])
    assert ("attn+moe" in kinds) == (n_layers >= 5)
    assert sum(p.numel() for p in model.parameters()) == params
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert round(nbytes / 2 ** 30, 2) == gib
