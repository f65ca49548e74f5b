"""The PyTorch port's MoE (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

Inputs come from numpy seeds and parameters cross from JAX by copy. Held
against JAX: ``apply_moe`` (gather dispatch at G = 16, 4 and 1, with and
without drops, padded experts and a shared expert), the scatter ablation,
the aux loss, and the gradients of x, the router and the experts. Pinned
as the reference has them: capacity counts the padded experts; which tokens
drop depends on the batch's shape; left-padded prompt tokens are routed and
take slots; the padded q-head slots' zero ``wo`` rows take gradient and
leave zero after one AdamW step. And the converter's walk of the MoE leaves
and the ``first`` block.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.convert import _leaves, tensor_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.train import AdamWConfig, adamw_init, make_train_step  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

# fp32: the frameworks' matrix products sum in different orders, so each
# output (and gradient) is held to 1e-5 of its largest element; bf16: each
# framework rounds the expert products' operands and outputs, so the output
# as a whole to a relative RMS of 1e-2 (train/step.py's params_rel_rms)
TOL = 1e-5
BF16_REL_RMS = 1e-2
SMOKE = get_smoke_config("granite-moe-3b-a800m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products only; one torch thread keeps the file fast under six
    test workers and its sums fixed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(dtype="float32", **moe_kw):
    base = SMOKE.with_(dtype=dtype)
    pad = moe_kw.pop("pad_experts_to", 0)
    return base.with_(moe=dataclasses.replace(base.moe, **moe_kw), pad_experts_to=pad)


def _params(cfg, seed):
    """The JAX MoE parameters and the port's ``MoE`` holding their values."""
    jp = jax.device_get(jmoe.init_moe(jax.random.key(seed), cfg))
    mod = tmoe.init_moe(None, cfg, "cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(tensor_from_numpy(leaf))
    return jp, mod


def _x(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _both(cfg, jp, mod, x):
    """(JAX out, aux), (port out, aux) as numpy fp32, on the same x."""
    dt = jnp.dtype(cfg.dtype)
    jo, ja = jax.jit(lambda p, x: jmoe.apply_moe(p, x, cfg))(jp, jnp.asarray(x, dt))
    with torch.no_grad():
        to, ta = tmoe.apply_moe(mod, torch.from_numpy(x).to(getattr(torch, cfg.dtype)), cfg)
    return ((np.asarray(jo, np.float32), float(ja)),
            (to.float().numpy(), float(ta)))


def _assert_close(got, want, tol=TOL, msg=""):
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=msg)


def _drops(cfg, mod, x):
    """How many (token, k) assignments the port's gather dispatch drops."""
    B, S, D = x.shape
    T, K = B * S, cfg.moe.top_k
    G = tmoe._groups(T)
    C = tmoe._capacity(T // G, cfg)
    with torch.no_grad():
        _, _, eidx = tmoe._route(torch.from_numpy(x).reshape(G, T // G, D), mod, cfg)
    counts = torch.nn.functional.one_hot(eidx.reshape(G, -1), cfg.n_experts_padded).sum(1)
    return int((counts - C).clamp_min(0).sum()), T * K


# ------------------------------------------------------------------ forward
# (B, S, G, moe overrides): T = 32 gives G = 16, T = 12 G = 4, T = 7 G = 1;
# capacity_factor 0.25 at T = 1001 (G = 1): C = 128 slots against ~250
# assignments an expert, so about half of them drop
CASES = {
    "G16": (2, 16, 16, {}),
    "G4": (2, 6, 4, {}),
    "G1": (1, 7, 1, {}),
    "drops": (7, 143, 1, {"capacity_factor": 0.25}),
    "padded-shared": (2, 16, 16, {"pad_experts_to": 12, "n_shared": 1}),
    "padded-shared-drops": (7, 143, 1, {"pad_experts_to": 12, "n_shared": 1,
                                        "capacity_factor": 0.25}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(case, dtype):
    B, S, G, kw = CASES[case]
    cfg = _cfg(dtype, **kw)
    jp, mod = _params(cfg, 0)
    x = _x(cfg, B, S, 1)
    if dtype == "bfloat16":     # both frameworks see the same bf16 input
        x = torch.from_numpy(x).bfloat16().float().numpy()
    (jo, ja), (to, ta) = _both(cfg, jp, mod, x)
    assert tmoe._groups(B * S) == G
    dropped, total = _drops(cfg, mod, x)
    if "drops" in case:
        assert 0.3 * total < dropped < 0.7 * total, (dropped, total)
    else:
        assert dropped == 0
    np.testing.assert_allclose(ta, ja, rtol=TOL)
    if dtype == "float32":
        # every token's output: an assignment kept on one side and dropped
        # on the other would move that token by O(1) of its value
        _assert_close(to, jo, msg=f"{dropped} of {total} assignments dropped")
    else:
        rel = np.linalg.norm(to - jo) / np.linalg.norm(jo)
        tok = np.abs(to - jo).max(-1) / np.abs(jo).max()
        assert rel <= BF16_REL_RMS, (
            f"bf16 relative RMS {rel:.3e}; worst tokens (a routing flip moves a "
            f"token by O(1)): {np.sort(tok.ravel())[-5:]}")


@pytest.mark.parametrize("case", ["G16", "drops", "padded-shared-drops"])
def test_scatter_dispatch_matches_jax(case):
    """The reference's ablation: one global capacity, a scatter dispatch and
    a scatter-add combine. With drops at T = 1008 the scatter's one capacity
    (128 slots for ~250 assignments an expert) drops where the gather's 16
    groups of 63 tokens drop nothing."""
    _, _, _, kw = CASES[case]
    B, S = (2, 16) if case == "G16" else (7, 144)
    cfg = _cfg(**kw).with_(moe_dispatch="scatter")
    jp, mod = _params(cfg, 2)
    x = _x(cfg, B, S, 3)
    (jo, ja), (to, ta) = _both(cfg, jp, mod, x)
    np.testing.assert_allclose(ta, ja, rtol=TOL)
    _assert_close(to, jo)
    if "drops" in case:
        (gj, _), (gt, _) = _both(cfg.with_(moe_dispatch="gather"), jp, mod, x)
        _assert_close(gt, gj)
        assert _drops(cfg, mod, x)[0] == 0
        assert np.abs(gj - jo).max() > 1e-2 * np.abs(jo).max()


@pytest.mark.parametrize("padded", [False, True])
def test_aux_loss_matches_jax(padded):
    """The load-balancing loss on its own: density of the first choice times
    the mean router probability, scaled by E and the coefficient."""
    cfg = _cfg(pad_experts_to=12 if padded else 0)
    jp, mod = _params(cfg, 4)
    x = _x(cfg, 4, 25, 5)
    jprobs, _, jeidx = jmoe._route(jnp.asarray(x.reshape(-1, cfg.d_model)), jp, cfg)
    want = float(jmoe._aux_loss(jprobs, jeidx, cfg))
    with torch.no_grad():
        probs, _, eidx = tmoe._route(torch.from_numpy(x.reshape(-1, cfg.d_model)), mod, cfg)
        got = float(tmoe._aux_loss(probs, eidx, cfg))
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert torch.equal(eidx, torch.from_numpy(np.array(jeidx)).long())
    if padded:                # no probability on the padded experts
        assert float(probs[:, cfg.moe.n_experts:].abs().max()) == 0.0


# -------------------------------------------------------------- gradients
@pytest.mark.parametrize("case", ["G16", "G1", "drops", "padded-shared-drops"])
def test_moe_grads_match_jax(case):
    """d/d(x, router, e_in, e_gate, e_out, shared) of <out, dout> + 3 aux
    against jax.grad, fp32; with drops the dropped assignments take no
    gradient on either side."""
    B, S, _, kw = CASES[case]
    cfg = _cfg(**kw)
    jp, mod = _params(cfg, 6)
    x = _x(cfg, B, S, 7)
    dout = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.apply_moe(p, x, cfg)
        return jnp.sum(out * dout) + 3.0 * aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    mod.requires_grad_(True)
    out, aux = tmoe.apply_moe(mod, tx, cfg)
    names, params = zip(*mod.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum() + 3.0 * aux,
                                (tx, *params))
    _assert_close(grads[0].numpy(), np.asarray(jgx), msg="x")
    for name, g in zip(names, grads[1:]):
        want = jgp
        for key in name.split("."):
            want = want[key]
        _assert_close(g.numpy(), np.asarray(want), msg=name)
    if cfg.n_experts_padded > cfg.moe.n_experts:       # no token reaches them
        for name in ("e_in", "e_gate", "e_out"):
            g = grads[1 + names.index(name)]
            assert float(g[cfg.moe.n_experts:].abs().max()) == 0.0, name


# ------------------------------------------------------ reference quirks
def test_capacity_counts_padded_experts():
    """granite-moe-3b-a800m pads 40 experts to 48, and the capacity divides
    by 48: 896 slots an expert for a 4096-token group, where 40 would give
    1024 (src/repro/models/moe.py:45-48)."""
    cfg = get_config("granite-moe-3b-a800m")
    assert cfg.n_experts_padded == 48 and cfg.moe.n_experts == 40
    for tl in (8, 256, 4096):
        assert tmoe._capacity(tl, cfg) == jmoe._capacity(tl, cfg)
    assert tmoe._capacity(4096, cfg) == 896
    assert tmoe._capacity(4096, cfg.with_(pad_experts_to=0)) == 1024
    # the served 4 x 32 prefill: 8 tokens a group, 128 slots an expert
    assert tmoe._groups(4 * 32) == 16 and tmoe._capacity(8, cfg) == 128


def test_drops_depend_on_the_batch_shape():
    """Which tokens drop depends on the group count, so on T: 1001 tokens in
    one call (G = 1) drop about half their assignments, the same tokens one
    position at a time (T = 7 a call) drop none. Both sides agree in both
    shapes (src/repro/models/moe.py:75-79)."""
    cfg = _cfg(capacity_factor=0.25)
    jp, mod = _params(cfg, 9)
    x = _x(cfg, 7, 143, 10)
    (jo, _), (to, _) = _both(cfg, jp, mod, x)
    _assert_close(to, jo)
    step_j, step_t = [], []
    for s in range(0, 143, 13):           # 11 calls of 7 x 13 = 91 tokens (G = 1)
        (a, _), (b, _) = _both(cfg, jp, mod, x[:, s:s + 13])
        step_j.append(a)
        step_t.append(b)
    step_j, step_t = np.concatenate(step_j, 1), np.concatenate(step_t, 1)
    _assert_close(step_t, step_j)
    assert _drops(cfg, mod, x)[0] > 0 and _drops(cfg, mod, x[:, :13])[0] == 0
    moved = np.abs(to - step_t).max(-1) > 1e-3 * np.abs(step_t).max()
    assert 0.2 < moved.mean() < 0.95, moved.mean()


def test_left_padding_takes_capacity():
    """Left-padded prompt positions are routed like tokens: 500 identical pad
    rows (the same hidden state, as pad tokens have at layer 0) before 501
    real rows all choose the same K experts, and being first in the stable
    sort they fill those experts' slots, so more real assignments drop than
    without the pads. JAX does the same."""
    cfg = _cfg(capacity_factor=0.25)
    jp, mod = _params(cfg, 11)
    real = _x(cfg, 1, 501, 12)
    pad = np.repeat(_x(cfg, 1, 1, 13), 500, axis=1)
    x = np.concatenate([pad, real], axis=1)                    # T = 1001, G = 1
    (jo, _), (to, _) = _both(cfg, jp, mod, x)
    _assert_close(to, jo)
    (jr, _), (tr, _) = _both(cfg, jp, mod, real)                # T = 501, G = 1
    _assert_close(tr, jr)
    with torch.no_grad():
        _, _, eidx = tmoe._route(torch.from_numpy(pad[0]), mod, cfg)
    assert (eidx == eidx[0]).all()                              # one expert set
    assert np.abs(to[0, :500]).max() > 0                        # pads are served
    assert _drops(cfg, mod, x)[0] > _drops(cfg, mod, real)[0]
    assert not np.allclose(to[:, 500:], tr, rtol=1e-3, atol=1e-6)


def test_padded_head_slots_take_gradient():
    """granite pads 24 q heads to 32 with zero wo rows for the padded slots;
    the rows take gradient (the slots' attention outputs are not zero), so
    one AdamW step makes them nonzero, in JAX and in the port alike."""
    cfg = _cfg().with_(pad_heads_to=6, n_layers=2)            # 4 heads -> 6, KH = 2
    jp = jlm.init_params(cfg, jax.random.key(14))
    sb, real = cfg.n_heads_padded // cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    pad = np.arange(cfg.n_heads_padded) % sb >= real
    wo = np.asarray(jp["groups"][0]["attn"]["wo"])            # (layers, H, Dh, D)
    assert pad.sum() == 2 and not wo[:, pad].any() and wo[:, ~pad].all()
    toks = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    jcfg = JaxAdamWConfig(lr=1e-3, weight_decay=0.01)
    jparams, _, _ = jax.jit(jax_make_train_step(cfg, jcfg, accum=1, grad_dtype="float32"))(
        jp, jax_adamw_init(jp, jcfg),
        {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})
    model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu", trainable=True)
    tcfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    model, _, _ = make_train_step(cfg, tcfg, accum=1, grad_dtype="float32")(
        model, adamw_init(model, tcfg),
        {"tokens": torch.from_numpy(toks[:, :-1]).long(),
         "labels": torch.from_numpy(toks[:, 1:]).long()})
    jwo = np.asarray(jparams["groups"][0]["attn"]["wo"])
    for i, blk in enumerate(model.blocks):
        two = blk.attn.wo.detach().numpy()
        assert np.abs(jwo[i][pad]).min() > 0 and np.abs(two[pad]).min() > 0
        _assert_close(two, jwo[i], msg=f"layer {i} wo")


# -------------------------------------------------------------- converter
def test_convert_walks_moe_leaves_and_first_block():
    """Every MoE leaf (padded experts and the shared expert included) and the
    unstacked ``first`` block land on the port's parameter of that name:
    layer 0 is ``first``, layer i >= 1 is group layer i - 1."""
    cfg = _cfg(pad_experts_to=12, n_shared=1).with_(first_layer_dense=True, n_layers=3)
    jp = jax.device_get(jlm.init_params(cfg, jax.random.key(16)))
    model = rt.params_from_jax(cfg, jp, device="cpu")
    assert isinstance(model.blocks[0], rt.models.lm.Block)
    assert all(isinstance(b, rt.models.lm.MoEBlock) for b in model.blocks[1:])
    names = [n for n, _ in model.named_parameters()]
    seen = [n for n, _, _ in _leaves(cfg, model, jp)]
    assert sorted(seen) == sorted(names) and len(seen) == len(set(seen))
    assert "blocks.1.moe.shared.w_gate" in names and "blocks.0.mlp.w_in" in names
    np.testing.assert_array_equal(model.blocks[0].mlp.w_in.float().numpy(),
                                  np.asarray(jp["first"]["mlp"]["w_in"], np.float32))
    for i in (1, 2):
        moe = model.blocks[i].moe
        assert moe.e_in.shape[0] == 12
        np.testing.assert_array_equal(moe.router.numpy(),
                                      np.asarray(jp["groups"][0]["moe"]["router"][i - 1]))
        np.testing.assert_array_equal(
            moe.shared.w_out.float().numpy(),
            np.asarray(jp["groups"][0]["moe"]["shared"]["w_out"][i - 1], np.float32))
