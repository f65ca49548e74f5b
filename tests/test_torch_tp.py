"""Tensor parallelism over 'model' (``repro_torch.distributed.tp``) against
the JAX package, on the CPU.

The split runs in gloo ranks (rendezvous through a ``FileStore``), started
in a subprocess, one launch a mesh, so that no process group starts inside
a test worker. The parent computes the JAX side with ``repro`` and the
port's one-rank step, and hands the ranks the weights and inputs as numpy
files. On the (1, 2), (2, 2) and (1, 4) ``(data, model)`` meshes, for
qwen3-8b-smoke (qk-norm; at (1, 4) ``wq`` splits over its 4 heads and
``wk``/``wv`` over 2 kv heads do not), smollm-135m-smoke (tied embeddings),
starcoder2-15b-smoke with the full config's 2-matrix GELU MLP (at (1, 4)
its 6 heads stay whole on every rank, its MLP and vocabulary split),
granite-moe-smoke (its 8 experts split over 'model') and
deepseek-v2-lite-smoke (MLA's 4 heads and the 4 experts split, a dense
first layer, a shared expert), each rank holds in fp32, against the JAX
package on the same weights:

* ``forward``'s logits (made whole by ``gather_vocab``) at the tolerance
  of ``tests/test_torch_lm.py``, and ``loss_fn``;
* a greedy stream from the split prefill and ``decode_step`` (``tp.greedy``
  over the vocabulary slices), token for token;
* one ``make_zero1_train_step``: loss, grad norm and every updated
  parameter (``gather_model``) at ``STEP_TOL``, against JAX's
  ``make_train_step`` and against the port's one-rank step;

and bf16 cases (qwen3-8b-smoke and deepseek-v2-lite-smoke on (1, 2)) at
``BF16_STEP_TOL``. A rank's parameter bytes equal the rules'
``bytes_per_device``. For the MoE and MLA cases every rank routes every
token alike (equal expert choices), and each gradient of the split
``loss_fn`` (the router's, ``w_dkv``'s, a split leaf's slice) equals the
one-rank port's: a replicated weight's gradient is summed over 'model'
exactly where its users are split, never m times. A deepseek variant
whose ``d_ff`` divides by 4 and whose shared experts' width does not runs
on (1, 4). On a mesh with 'data' > 1 the JAX side sees the mesh's sizes
(``repro.models.moe.axis_size`` patched), so its MoE groups the tokens
by data shard; the port's one-rank side runs under a ``MeshShape`` of
the same sizes. On the (2, 1) data mesh, granite-moe-smoke steps 512
tokens a rank with assignments dropped (capacity factor 0.25) and with a
raised router aux coefficient: the token groups and the aux loss are the
global batch's. On the (1, m) meshes the ranks replace every
``all_gather*``, ``reduce_scatter*`` and ``all_to_all*`` with a function
that raises, so only ``all_reduce`` and ``broadcast`` run: what gloo does
with a CUDA tensor is enough.

The recurrent blocks and the wrappers run under their own keys of
``MESHES``, on the same three meshes and to the same checks, gradients
included: jamba-smoke (Mamba's channels, its MoE's experts, one attention
layer), xlstm-smoke (the mLSTM's channels; its 2 heads a rank each on
(1, 2) and (2, 2), gathered whole on (1, 4), where every rank runs both;
the sLSTM whole), whisper-small-smoke (the encoder, the decoder's self and
cross attention on heads; the greedy stream from ``forward`` with frames,
then ``decode_step`` over the rank's cross cache) and llava-next-34b-smoke
(its 16-patch prefix before the vocab-parallel embedding, ``vision_proj``
whole), and xlstm-smoke in bf16 on (1, 2). The only split still refused
is one whose ranks would straddle kv groups or the mLSTM's qkv blocks,
with an error that names ROADMAP item 7d.
"""

import contextlib
import dataclasses
import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import apply_rope as jax_apply_rope  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.distributed import tp, use_mesh  # noqa: E402
from repro_torch.launch.dryrun import param_bytes  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.lm import layer_kinds  # noqa: E402
from repro_torch.train import AdamWConfig, adamw_init, make_train_step  # noqa: E402
from repro_torch.train.step import BF16_STEP_TOL, STEP_TOL  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4                      # tests/test_torch_lm.py's fp32 tolerance
LR = 1e-3
# AdamW's eps for the step, as chip_smoke.py's STEP_EPS: Adam's first step
# moves a weight by lr * g / (|g| + eps), which at the default eps of 1e-8
# turns a 1e-10 difference of a near-zero gradient into 1e-5 of update (this
# file's seeds meet one such element whole, the one-rank port against JAX);
# at 1e-6 a step is held to STEP_TOL on every parameter
EPS = 1e-6
B, S, P, N_NEW = 4, 12, 6, 5          # batch, sequence; prompt and new tokens
CASES = {
    "qwen3": ("qwen3-8b", {}, "float32"),
    "smollm": ("smollm-135m", {}, "float32"),
    "starcoder2-ungated": ("starcoder2-15b", {"mlp_gated": False}, "float32"),
    "qwen3-bf16": ("qwen3-8b", {}, "bfloat16"),
    "granite": ("granite-moe-3b-a800m", {}, "float32"),
    "deepseek": ("deepseek-v2-lite-16b", {}, "float32"),
    "deepseek-bf16": ("deepseek-v2-lite-16b", {}, "bfloat16"),
    # d_ff 128 divides by 4 and the shared experts' width 30 does not: the
    # dense first layer's MLP splits over 'model', the shared MLP stays whole
    "deepseek-odd-shared": ("deepseek-v2-lite-16b", {"moe": {"d_expert": 30}}, "float32"),
    # the (2, 1) data mesh: 512 tokens a rank, one group each (the reference's
    # G = 'pod' x 'data' = 2), C = 128 slots an expert against ~128 assignments,
    # so about half the experts overflow; and the router's aux loss raised
    "granite-drops": ("granite-moe-3b-a800m", {"moe": {"capacity_factor": 0.25}}, "float32"),
    "granite-aux": ("granite-moe-3b-a800m", {"moe": {"router_aux_coef": 1.0}}, "float32"),
    "jamba": ("jamba-1.5-large-398b", {}, "float32"),
    "xlstm": ("xlstm-1.3b", {}, "float32"),
    "xlstm-bf16": ("xlstm-1.3b", {}, "bfloat16"),
    "whisper": ("whisper-small", {}, "float32"),
    "llava": ("llava-next-34b", {}, "float32"),
}
SHAPES = {"granite-drops": (4, 256), "granite-aux": (4, 32)}    # (B, S); else (B, S) above
MESHES = {"1x2": ((1, 2), ["qwen3", "smollm", "starcoder2-ungated", "qwen3-bf16", "granite",
                           "deepseek", "deepseek-bf16"]),
          "2x2": ((2, 2), ["qwen3", "smollm", "starcoder2-ungated", "granite", "deepseek"]),
          "1x4": ((1, 4), ["qwen3", "smollm", "starcoder2-ungated", "granite", "deepseek",
                           "deepseek-odd-shared"]),
          "1x2-recurrent": ((1, 2), ["jamba", "xlstm"]),
          "1x2-recurrent-bf16": ((1, 2), ["xlstm-bf16"]),
          "2x2-recurrent": ((2, 2), ["jamba", "xlstm"]),
          "1x4-recurrent": ((1, 4), ["jamba", "xlstm"]),
          "1x2-wrappers": ((1, 2), ["whisper", "llava"]),
          "2x2-wrappers": ((2, 2), ["whisper", "llava"]),
          "1x4-wrappers": ((1, 4), ["whisper", "llava"])}
DATA_MESH = (2, 1)
# on (1, 2): 3 q heads a rank, kv groups of 2, wk/wv whole (3 kv heads)
STRADDLED = [("qwen3-8b", {"n_heads": 6, "n_kv_heads": 3, "d_model": 96, "head_dim": 16})]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _shared_refs(tmp_path_factory):
    """Where ``_reference`` leaves each case's references for the other
    test processes of the run (pytest-xdist's workers share the parent of
    their base temp directories)."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    _SHARED[0] = root / "torch_tp_refs"
    _SHARED[0].mkdir(exist_ok=True)
    yield


def _cfg(tag, get=rt.get_smoke_config):
    arch, overrides, dtype = CASES[tag]
    kw = dict(overrides)
    moe = kw.pop("moe", None)
    cfg = get(arch).with_(dtype=dtype, **kw)
    return cfg if moe is None else cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))


def _names(cfg, tree):
    """A JAX parameter tree as the port's ``{name: fp32 array}``."""
    model = rt.params_from_jax(cfg, jax.device_get(tree), device="cpu")
    return {n: p.detach().float().numpy() for n, p in model.named_parameters()}


def _held_grads(cfg):
    """Whether the ranks' gradients are held against the one-rank port's:
    every fp32 model but the plain ``attn+mlp`` decoders."""
    plain = set(layer_kinds(cfg)) == {"attn+mlp"} and not (cfg.is_encdec or cfg.vlm)
    return cfg.dtype == "float32" and not plain


def _extras(cfg, b):
    """The batch's inputs besides the tokens, seeded: an encoder-decoder's
    frames (B, enc_len, D), a VLM's patch embeddings (B, n_patches, D)."""
    rng = np.random.default_rng(6)
    out = {}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((b, cfg.encdec.enc_len, cfg.d_model), np.float32)
    if cfg.vlm is not None:
        out["vision_embeds"] = rng.standard_normal((b, cfg.vlm.n_patches, cfg.d_model),
                                                   np.float32)
    return out


def _jax_prefill(cfg, jcfg, jp, jb, max_len):
    """JAX's forward over the prompt (and a VLM's prefix, an
    encoder-decoder's frames) with its caches, made what its decode reads:
    the self-attention keys roped at their positions where its forward
    leaves them unroped (llava; whisper's forward and cache have no RoPE),
    and padded to ``max_len``. Returns (logits, caches, n_prefix)."""
    logits, _, jc, n_prefix = jax.jit(
        lambda p, b: jlm.forward(jcfg, p, b, want_caches=True))(jp, jb)
    groups = []
    for g in jc["groups"]:
        g = dict(g)
        L = g["k"].shape[3]
        if not cfg.is_encdec:
            g["k"] = jax_apply_rope(g["k"], jnp.arange(L), cfg.rope_theta)
        pad = ((0, 0), (0, 0), (0, 0), (0, max_len - L), (0, 0))
        g["k"], g["v"] = jnp.pad(g["k"], pad), jnp.pad(g["v"], pad)
        groups.append(g)
    return logits, {"groups": tuple(groups), "first": jc["first"]}, n_prefix


@contextlib.contextmanager
def _jax_sees(dp):
    """The JAX MoE's ``axis_size`` reads a mesh of ``dp`` 'data' ranks, the one
    place of its arithmetic that reads the mesh (``moe.py:77``)."""
    if dp == 1:
        yield
        return
    sizes = {"data": dp}
    with mock.patch.object(jmoe, "axis_size", lambda name: sizes.get(name, 1)):
        yield


def _jax_logits(tag, dp):
    cfg, jcfg = _cfg(tag), _cfg(tag, jget_smoke_config)
    toks = _tokens(cfg, tag)
    with _jax_sees(dp):
        return np.asarray(jlm.forward(jcfg, _jax_params(jcfg),
                                      {"tokens": jnp.asarray(toks[:, :-1])})[0], np.float32)


def _tokens(cfg, tag):
    b, s = SHAPES.get(tag, (B, S))
    return np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)


_REFS = {}
_SHARED = [None]
REF_WAIT = 600                        # seconds to wait for another process's reference


def _shared(key, make):
    """``make()`` once a run: the first process to ask for ``key`` makes it
    and leaves it in ``_SHARED``; the others wait for it there (or make it
    themselves where the maker failed, or REF_WAIT passes)."""
    if key in _REFS:
        return _REFS[key]
    if _SHARED[0] is None:
        _REFS[key] = make()
        return _REFS[key]
    name = "-".join(map(str, key))
    done, lock, failed = (_SHARED[0] / f"{name}.{ext}" for ext in ("pkl", "lock", "failed"))
    try:
        os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        deadline = time.monotonic() + REF_WAIT
        while not (done.exists() or failed.exists()) and time.monotonic() < deadline:
            time.sleep(0.2)
        out = pickle.loads(done.read_bytes()) if done.exists() else make()
    else:
        try:
            out = make()
        except BaseException:
            failed.touch()
            raise
        part = done.with_suffix(".part")
        part.write_bytes(pickle.dumps(out))
        part.replace(done)
    _REFS[key] = out
    return out


def _jax_params(jcfg):
    """The JAX model's weights (seed 3), made by one compiled call."""
    return jax.jit(lambda key: jlm.init_params(jcfg, key))(jax.random.key(3))


def _reference(tag, dp=1):
    """The JAX side and the port's one-rank step for case ``tag`` on a mesh
    of ``dp`` 'data' ranks: JAX's MoE sees ``dp`` and the port's one-rank
    side runs under a ``MeshShape`` of (dp, 1), whole rows on one rank."""
    cfg = _cfg(tag)
    dp = dp if cfg.moe is not None else 1        # only the MoE reads the mesh
    return _shared((tag, dp), lambda: _make_reference(tag, dp))


def _make_reference(tag, dp):
    cfg, jcfg = _cfg(tag), _cfg(tag, jget_smoke_config)
    jp = _jax_params(jcfg)
    toks = _tokens(cfg, tag)
    extras = _extras(cfg, toks.shape[0])
    jx = {k: jnp.asarray(a) for k, a in extras.items()}
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]), **jx}
    out = {"params": _names(cfg, jp), "tokens": toks, "extras": extras}
    with _jax_sees(dp):
        # each traced anew under this mesh's sizes (a fresh function, no shared cache)
        jdecode = jax.jit(lambda *a: jlm.decode_step(jcfg, *a))
        if cfg.dtype == "float32":
            out["logits"] = np.asarray(jax.jit(lambda *a: jlm.forward(jcfg, *a))(jp, jb)[0],
                                       np.float32)
            loss, metrics = jax.jit(lambda *a: jlm.loss_fn(jcfg, *a))(jp, jb)
            out["loss"], out["aux"] = float(loss), float(metrics["aux"])
            b = toks.shape[0]
            n_prefix = 0
            if extras:                        # the wrappers: the prompt's prefill
                n = cfg.vlm.n_patches if cfg.vlm is not None else 0
                logits, caches, n_prefix = _jax_prefill(
                    cfg, jcfg, jp, {"tokens": jnp.asarray(toks[:, :P]), **jx}, n + P + N_NEW)
            else:
                caches = jlm.init_caches(jcfg, b, P + N_NEW)
                for t in range(P):            # the prompt, teacher-forced
                    logits, caches = jdecode(jp, caches, jnp.asarray(toks[:, t:t + 1]),
                                             jnp.asarray(t, jnp.int32))
            stream = []
            for t in range(N_NEW):
                stream.append(np.asarray(logits[:, -1, :cfg.vocab_size].argmax(-1)))
                if t + 1 < N_NEW:
                    logits, caches = jdecode(jp, caches,
                                             jnp.asarray(stream[-1][:, None], jnp.int32),
                                             jnp.asarray(n_prefix + P + t, jnp.int32))
            out["stream"] = np.stack(stream, 1)
        jopt = JaxAdamWConfig(lr=LR, weight_decay=0.01, eps=EPS)
        jstep = jax.jit(jax_make_train_step(jcfg, jopt, grad_dtype=cfg.dtype))
        jparams, _, jm = jstep(jp, jax_adamw_init(jp, jopt), jb)
    out["jax_step"] = (float(jm["loss"]), float(jm["grad_norm"]), _names(cfg, jparams))
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long(),
          **{k: torch.from_numpy(a) for k, a in extras.items()}}
    with use_mesh(MeshShape(("data", "model"), (dp, 1))):
        if _held_grads(cfg):
            model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu", trainable=True)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(rt.loss_fn(cfg, model, tb)[0], params)
            out["grads"] = {n: g.numpy() for n, g in zip(names, grads)}
        model = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu", trainable=True)
        opt = AdamWConfig(lr=LR, weight_decay=0.01, eps=EPS)
        _, _, m = make_train_step(cfg, opt, grad_dtype=cfg.dtype)(model, adamw_init(model, opt),
                                                                 tb)
    out["one_rank_step"] = (float(m["loss"]), float(m["grad_norm"]),
                            {n: p.detach().float().numpy() for n, p in model.named_parameters()})
    return out


WORKER = r'''
import dataclasses, datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4], json.loads(open(sys.argv[5]).read()))
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from repro_torch import decode_step, forward, get_smoke_config, init_params, loss_fn
from repro_torch.distributed import tp, use_mesh
from repro_torch.launch.dryrun import param_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.train import (AdamWConfig, adamw_init, distribute_opt_state, local_batch,
                               make_zero1_train_step, opt_state_shardings)

mesh = make_mesh(tuple(spec["shape"]), ("data", "model"), device="cpu")
calls = {"all_reduce": 0, "broadcast": 0}
for name in calls:                           # counted where tp and the step look them up
    def counted(*a, _f=getattr(dist, name), _n=name, **k):
        calls[_n] += 1
        return _f(*a, **k)
    setattr(dist, name, counted)
if spec["shape"][0] == 1:                    # (1, m): all_reduce and broadcast only
    import torch.distributed._functional_collectives as funcol

    def refuse(name):
        def f(*a, **k):
            raise RuntimeError(f"{name} ran on a (1, m) mesh")
        return f
    for mod in (dist, dist.distributed_c10d, funcol):
        for name in dir(mod):
            if name.startswith(("all_gather", "reduce_scatter", "all_to_all")):
                setattr(mod, name, refuse(name))


def load(cfg, arrays, trainable=False):
    model = init_params(cfg, None, device="cpu", trainable=trainable)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(arrays["param " + n]))
    return model


routes = []
route = tmoe._route


def recorded(*args):
    out = route(*args)
    routes.append(out[2].reshape(-1, out[2].shape[-1]))
    return out


report = {}
for tag, case in spec["cases"].items():
    arch, overrides, dtype = case
    kw = dict(overrides)
    moe = kw.pop("moe", None)
    cfg = get_smoke_config(arch).with_(dtype=dtype, **kw)
    if moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))
    arrays = np.load(f"{out}/{tag}.npz")
    toks = torch.from_numpy(arrays["tokens"]).long()
    extras = {k[6:]: torch.from_numpy(arrays[k]) for k in arrays.files if k.startswith("extra ")}
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous(), **extras}
    res, rep = {}, {}
    mg = tp.vocab_group
    model = tp.split_model(cfg, load(cfg, arrays), mesh)
    rep["bytes"] = [sum(p.numel() * p.element_size() for p in model.parameters()),
                    param_bytes(cfg, mesh)]
    with use_mesh(mesh), torch.no_grad():
        routes.clear()
        tmoe._route = recorded
        logits, _, _, _ = forward(cfg, model, {"tokens": batch["tokens"], **extras})
        tmoe._route = route
        if routes:                           # the expert choices of every MoE layer
            res["eidx"] = torch.cat(routes).numpy()
        res["logits"] = tp.gather_vocab(logits, mg(cfg)).float().numpy()
        rep["local_vocab"] = logits.shape[-1]
        rep["loss"] = float(loss_fn(cfg, model, batch)[0])
        P, n_new = spec["prompt"], spec["new"]
        n = cfg.vlm.n_patches if cfg.vlm is not None else 0
        logits, _, caches, n_prefix = forward(cfg, model,
                                              {"tokens": batch["tokens"][:, :P], **extras},
                                              want_caches=True, max_len=n + P + n_new)
        rep["cache"] = {k: list(v.shape) for k, v in caches["layers"][0].items()}
        stream = []
        for t in range(n_new):
            stream.append(tp.greedy(logits[:, -1], cfg.vocab_size, mg(cfg)))
            if t + 1 < n_new:
                logits, caches = decode_step(cfg, model, caches, stream[-1][:, None],
                                             n_prefix + P + t)
        res["stream"] = torch.stack(stream, 1).numpy()
    if tag in spec["grads"]:                 # the split loss_fn's gradients
        model = tp.split_model(cfg, load(cfg, arrays, trainable=True), mesh)
        names, params = zip(*model.named_parameters())
        with use_mesh(mesh):
            grads = torch.autograd.grad(loss_fn(cfg, model, batch)[0], params)
        for n, g in zip(names, grads):
            res["grad " + n] = g.numpy()
    whole = load(cfg, arrays, trainable=True)
    opt = AdamWConfig(lr=spec["lr"], weight_decay=0.01, eps=spec["eps"])
    osh = opt_state_shardings(cfg, whole, mesh, opt)
    state = distribute_opt_state(adamw_init(whole, opt), osh, mesh)
    model = tp.split_model(cfg, whole, mesh)
    step = make_zero1_train_step(cfg, opt, mesh, osh, grad_dtype=dtype)
    _, state, m = step(model, state, local_batch(batch, mesh))
    rep["step"] = [float(m["loss"]), float(m["grad_norm"])]
    for n, p in tp.gather_model(cfg, model, mesh).named_parameters():
        res["param " + n] = p.detach().float().numpy()
    np.savez(f"{out}/{tag}_rank{rank}.npz", **res)
    report[tag] = rep
if spec["refused"]:
    refused = {}
    for arch, overrides in spec["refused"]:
        cfg = get_smoke_config(arch).with_(dtype="float32", **overrides)
        model = init_params(cfg, 0, device="cpu")
        said = []
        try:
            tp.split_model(cfg, model, mesh)
        except NotImplementedError as e:
            said.append(str(e))
        with use_mesh(mesh):
            try:
                forward(cfg, model, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
            except NotImplementedError as e:
                said.append(str(e))
        refused[arch] = said
    report["refused"] = refused
    # serving a split model: the engine and the speculative adapters refuse
    from repro_torch.core import BoltSystem
    from repro_torch.serve import ModelDraft, ModelTarget, ServeEngine
    from repro_torch.streams import Topic
    cfg = get_smoke_config("qwen3-8b").with_(dtype="float32")
    model = tp.split_model(cfg, init_params(cfg, 0, device="cpu"), mesh)
    system = BoltSystem(n_brokers=2)
    req, resp = Topic.create(system, "req"), Topic.create(system, "resp")
    target = ModelTarget(cfg, model)             # made with no mesh: refused where it runs
    said = []
    with use_mesh(mesh):
        for serve in (lambda: ServeEngine(cfg, model, req, resp),
                      lambda: ModelDraft(cfg, model), lambda: target.verify([1, 2], [3])):
            try:
                serve()
            except NotImplementedError as e:
                said.append(str(e))
    report["serve_refused"] = said
report["calls"] = calls
json.dump(report, open(f"{out}/rank{rank}.json", "w"))
dist.destroy_process_group()
'''

LAUNCHER = r'''
import subprocess, sys, time
worker, world, store, out, spec = sys.argv[1:6]
procs = [subprocess.Popen([sys.executable, worker, str(r), world, store, out, spec])
         for r in range(int(world))]
deadline = time.time() + 150
rcs = []
for p in procs:
    try:
        rcs.append(p.wait(timeout=max(1.0, deadline - time.time())))
    except subprocess.TimeoutExpired:
        rcs.append("timeout")
for p in procs:
    if p.poll() is None:
        p.kill()
sys.exit(0 if all(rc == 0 for rc in rcs) else f"ranks: {rcs}")
'''


def _run_ranks(tmp_path, shape, tags, refused=()):
    world = shape[0] * shape[1]
    for tag in tags:
        ref = _reference(tag, shape[0])
        np.savez(tmp_path / f"{tag}.npz", tokens=ref["tokens"],
                 **{"param " + n: a for n, a in ref["params"].items()},
                 **{"extra " + k: a for k, a in ref["extras"].items()})
    spec = {"shape": list(shape), "cases": {t: CASES[t] for t in tags}, "lr": LR, "eps": EPS,
            "prompt": P, "new": N_NEW, "refused": list(refused),
            "grads": [t for t in tags if _held_grads(_cfg(t))]}
    (tmp_path / "worker.py").write_text(WORKER)
    (tmp_path / "launch.py").write_text(LAUNCHER)
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "launch.py"), str(tmp_path / "worker.py"),
         str(world), str(tmp_path / "store"), str(tmp_path), str(tmp_path / "spec.json")],
        env=env, cwd=tmp_path, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail("the ranks did not finish in 180 s:\n" + out[-4000:])
    assert proc.returncode == 0, out[-4000:]
    return ([json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)],
            [{tag: np.load(tmp_path / f"{tag}_rank{r}.npz") for tag in tags}
             for r in range(world)])


def _local_heads(cfg, shape, rank):
    """The kv heads rank ``rank`` of a (data, model) mesh of ``shape`` keeps
    in its cache, by ``tp.head_split`` on that mesh's rules."""
    m = shape[1]
    with mock.patch.object(tp, "get_mesh", lambda: MeshShape(("data", "model"), shape)), \
            mock.patch.object(tp, "model_group", lambda: tp.ModelGroup(None, m, rank % m)):
        return tp.cache_kv_heads(cfg)


def _held_bf16(tag, rep, params):
    """One bf16 split step against the port's one-rank step and JAX's, in
    the terms of BF16_STEP_TOL."""
    ref = _reference(tag)
    old = ref["params"]
    for loss, gnorm, want in (ref["one_rank_step"], ref["jax_step"]):
        tol = BF16_STEP_TOL
        assert abs(rep["step"][0] - loss) <= tol["loss"]
        assert abs(rep["step"][1] - gnorm) <= tol["grad_norm"] * abs(gnorm)
        d2 = w2 = 0.0
        for n, w in want.items():
            p = params["param " + n]
            agree = np.mean(np.abs((p - old[n]) - (w - old[n])) <= LR / 2)
            assert agree >= tol["update_agree"], (tag, n, agree)
            d2 += float(np.sum((p - w) ** 2))
            w2 += float(np.sum(w ** 2))
        assert (d2 / w2) ** 0.5 <= tol["params_rel_rms"]


def _held(mesh, shape, tags, reports, arrays):
    """Each rank's results for ``tags`` against JAX and the one-rank port."""
    mshape = MeshShape(("data", "model"), shape)
    m = shape[1]
    for r, (rep, res) in enumerate(zip(reports, arrays)):
        # the split ran on all_reduce (and on (2, 2), the data axis's own
        # collectives); on (1, m) anything else raised
        assert rep["calls"]["all_reduce"] > 0, (mesh, r)
        for tag in tags:
            cfg = _cfg(tag)
            ref, got, out = _reference(tag, shape[0]), rep[tag], res[tag]
            assert got["bytes"][0] == got["bytes"][1] == param_bytes(cfg, mshape), tag
            split = tp.split_dims(cfg, mshape)
            assert got["local_vocab"] == cfg.padded_vocab // (m if "embed" in split else 1)
            cache, kind = got["cache"], layer_kinds(cfg)[0]
            if cfg.mla is not None:          # the latent cache, whole on every rank
                assert cache["c_kv"][1:] == [P + N_NEW, cfg.mla.kv_lora_rank], (tag, r)
            elif kind.startswith("mamba"):   # the rank's channels
                cut = m if "blocks.0.mamba.m_in" in split else 1
                assert cache["ssm"][1] == cache["conv"][2] == 2 * cfg.d_model // cut, (tag, r)
            elif kind == "mlstm":            # the rank's heads, or all where m does not divide H
                cut = m if "blocks.0.mlstm.x_up" in split and cfg.n_heads % m == 0 else 1
                assert cache["C"][1] == cfg.n_heads // cut, (tag, r)
            else:
                assert cache["k"][1] == _local_heads(cfg, shape, r), (tag, r)
                if cfg.is_encdec:            # the cross cache: the same kv heads
                    assert cache["cross_k"][1] == cache["k"][1], (tag, r)
            if cfg.moe is not None:          # every rank routes every token alike
                np.testing.assert_array_equal(out["eidx"], arrays[0][tag]["eidx"])
            if _held_grads(cfg):
                for n, want in ref["grads"].items():
                    if n in split:
                        dim, _ = split[n]
                        want = np.split(want, m, axis=dim)[r % m]
                    np.testing.assert_allclose(out["grad " + n], want, rtol=STEP_TOL,
                                               atol=STEP_TOL * float(np.abs(want).max()),
                                               err_msg=f"{mesh} {tag} rank {r} grad {n}")
            if cfg.dtype == "bfloat16":
                _held_bf16(tag, got, out)
                continue
            np.testing.assert_allclose(out["logits"], ref["logits"], rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL, err_msg=f"{mesh} {tag} rank {r}")
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
            np.testing.assert_array_equal(out["stream"], ref["stream"],
                                          err_msg=f"{mesh} {tag} rank {r}")
            for loss, gnorm, want in (ref["jax_step"], ref["one_rank_step"]):
                np.testing.assert_allclose(got["step"][0], loss, rtol=STEP_TOL)
                np.testing.assert_allclose(got["step"][1], gnorm, rtol=STEP_TOL)
                assert set(want) == {k[6:] for k in out.files if k.startswith("param ")}
                for n, w in want.items():
                    np.testing.assert_allclose(out["param " + n], w, rtol=STEP_TOL,
                                               atol=STEP_TOL, err_msg=f"{mesh} {tag} {n}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_split_matches_jax(mesh, tmp_path):
    shape, tags = MESHES[mesh]
    reports, arrays = _run_ranks(tmp_path, shape, tags,
                                 refused=STRADDLED if mesh == "1x2" else ())
    _held(mesh, shape, tags, reports, arrays)
    if mesh == "1x2":
        for rep in reports:
            assert set(rep["refused"]) == {arch for arch, _ in STRADDLED}
            for arch, said in rep["refused"].items():
                assert len(said) == 2 and all(tp.ROADMAP_ITEM in s and "straddle" in s
                                              for s in said), arch
            said = rep["serve_refused"]
            assert len(said) == 3 and all(tp.ROADMAP_ITEM in s for s in said), said


@pytest.mark.parametrize("tag", ["granite-drops", "granite-aux"])
def test_moe_on_a_data_mesh_matches_jax(tag, tmp_path):
    """granite-moe-smoke on the (2, 1) data mesh, each rank stepping its own
    512 (``granite-drops``) or 64 (``granite-aux``) tokens, against JAX whose
    MoE sees 2 'data' ranks. The reference cuts the global batch into one
    token group a data shard (``src/repro/models/moe.py:76-81``), and takes
    the router's aux loss over the global batch (``:134``): the port's rank
    makes its rows one group, and sums the aux term's density and proxy over
    the data ranks. ``granite-drops`` drops about half of the overfull
    experts' assignments, which 16 groups of 32 tokens a rank would not
    (JAX's own logits part by ten times LOGIT_TOL between the two groupings);
    ``granite-aux`` raises the aux coefficient to 1, whose term a mean of
    per-rank products would miss."""
    reports, arrays = _run_ranks(tmp_path, DATA_MESH, [tag])
    _held("2x1", DATA_MESH, [tag], reports, arrays)
    ref = _reference(tag, DATA_MESH[0])
    if tag == "granite-drops":
        assert np.abs(_jax_logits(tag, 1) - ref["logits"]).max() > 10 * LOGIT_TOL
    else:
        assert ref["aux"] > 0.5


def test_layouts_of_the_split():
    """What the rules split on each mesh: the vocabulary where 'model'
    divides it, ``wq`` where it divides the heads, each split dim evenly."""
    for tag, shape, vocab in (("qwen3", (1, 2), 256), ("qwen3", (1, 4), 128),
                              ("starcoder2-ungated", (1, 4), 128),
                              ("starcoder2-ungated", (1, 3), 512)):
        cfg = _cfg(tag)
        mshape = MeshShape(("data", "model"), shape)
        dims = tp.split_dims(cfg, mshape)
        assert ("embed" in dims) == (vocab < cfg.padded_vocab)
        heads_whole = cfg.n_heads_padded % shape[1] != 0
        assert ("blocks.0.attn.wq" in dims) != heads_whole
        assert all(dims[n][1] % shape[1] == 0 for n in dims)


@pytest.mark.parametrize("tag,m,experts,heads,shared", [
    ("granite", 2, True, True, False), ("granite", 4, True, True, False),
    ("deepseek", 2, True, True, True), ("deepseek", 4, True, True, True),
    ("deepseek-odd-shared", 2, True, True, True), ("deepseek-odd-shared", 4, True, True, False),
    ("deepseek", 3, False, False, False),
])
def test_moe_and_mla_split_leaf_by_leaf(tag, m, experts, heads, shared, monkeypatch):
    """Under a 'model' group of m the experts split where m divides E, MLA's
    heads where it divides H, the shared experts where it divides their own
    width ``n_shared * d_expert``, whatever ``d_ff`` does: each helper agrees
    with the rules' split of its leaves."""
    cfg = _cfg(tag)
    mshape = MeshShape(("data", "model"), (1, m))
    monkeypatch.setattr(tp, "get_mesh", lambda: mshape)
    monkeypatch.setattr(tp, "model_group", lambda: tp.ModelGroup(None, m, 0))
    dims = tp.split_dims(cfg, mshape)
    moe_layer = next(i for i, kind in enumerate(layer_kinds(cfg)) if kind.endswith("+moe"))
    assert (tp.expert_group(cfg) is not None) == experts == (
        f"blocks.{moe_layer}.moe.e_in" in dims)
    if cfg.mla is not None:
        assert (tp.mla_group(cfg) is not None) == heads == ("blocks.0.mla.w_uk" in dims)
        assert (tp.shared_group(cfg) is not None) == shared == (
            f"blocks.{moe_layer}.moe.shared.w_in" in dims)
        assert (tp.ff_group(cfg) is not None) == (cfg.d_ff % m == 0)


def test_scatter_dispatch_is_refused_where_it_would_depart(monkeypatch):
    """The scatter ablation's one capacity is the global batch's: it is
    refused on a rank holding its own rows of a data mesh, and under a
    'model' group (ROADMAP item 7d); with whole rows it runs as before."""
    from repro_torch.models import moe as tmoe
    cfg = _cfg("granite").with_(moe_dispatch="scatter")
    model = rt.init_params(cfg, 0, device="cpu")
    x = torch.randn(2, 8, cfg.d_model)
    data = MeshShape(("data", "model"), (2, 1))
    with use_mesh(data):
        out, _ = tmoe.apply_moe(model.blocks[0].moe, x, cfg)
    assert out.shape == x.shape
    with use_mesh(data, local_rows=True), pytest.raises(NotImplementedError, match="own rows"):
        tmoe.apply_moe(model.blocks[0].moe, x, cfg)
    monkeypatch.setattr(tp, "model_group", lambda mesh=None: tp.ModelGroup(None, 2, 0))
    with pytest.raises(NotImplementedError, match=tp.ROADMAP_ITEM):
        tmoe.apply_moe(model.blocks[0].moe, x, cfg)


@pytest.mark.parametrize("H,KH,m,want", [
    (4, 2, 2, [((0,), 1), ((1,), 1)]),                   # split wk: kv None below
    (4, 2, 4, [((0,), 1), ((0,), 1), ((1,), 1), ((1,), 1)]),
    (8, 2, 4, [((0,), 1), ((0,), 1), ((1,), 1), ((1,), 1)]),
    (16, 4, 8, [((h // 2,), 1) for h in range(8)]),
])
def test_head_split_maps_q_heads_to_their_kv_heads(H, KH, m, want, monkeypatch):
    """Each rank's kv heads of a replicated ``wk``: the one kv head its q
    heads share (q head h reads h // (H / KH))."""
    cfg = rt.get_smoke_config("qwen3-8b").with_(n_heads=H, n_kv_heads=KH, d_model=H * 16,
                                                head_dim=16)
    monkeypatch.setattr(tp, "get_mesh", lambda: MeshShape(("data", "model"), (1, m)))
    for rank, (kv, n_kv) in enumerate(want):
        monkeypatch.setattr(tp, "model_group", lambda rank=rank: tp.ModelGroup(None, m, rank))
        sp = tp.head_split(cfg)
        if KH % m == 0:
            assert sp.kv0 is None and sp.n_kv == KH // m
            continue
        assert tuple(range(sp.kv0, sp.kv0 + sp.n_kv)) == kv and sp.n_kv == n_kv, rank
        G = H // KH
        q_heads = range(rank * H // m, (rank + 1) * H // m)
        # local q head j reads local kv head j // (Hl / n_kv): the kernel's map
        Hl = H // m
        assert [sp.kv0 + j // (Hl // sp.n_kv) for j in range(Hl)] == [h // G for h in q_heads]


@pytest.mark.parametrize("arch,H,KH,m", [
    ("starcoder2-15b", 6, 2, 3),                # its smoke config on (1, 3)
    ("qwen3-8b", 12, 4, 3),
])
def test_straddled_kv_groups_are_refused(arch, H, KH, m, monkeypatch):
    """Where a rank's q heads would straddle kv groups (H/m does not divide
    G = H/KH) and ``wk`` stays whole, the split is refused naming ROADMAP
    item 7d, by the check and by ``head_split``."""
    cfg = rt.get_smoke_config(arch).with_(n_heads=H, n_kv_heads=KH, d_model=H * 16,
                                          head_dim=16)
    mshape = MeshShape(("data", "model"), (1, m))
    with pytest.raises(NotImplementedError, match=tp.ROADMAP_ITEM):
        tp.check_split(cfg, mshape)
    monkeypatch.setattr(tp, "get_mesh", lambda: mshape)
    monkeypatch.setattr(tp, "model_group", lambda: tp.ModelGroup(None, m, 0))
    with pytest.raises(NotImplementedError, match="straddle"):
        tp.head_split(cfg)


def test_serving_a_split_model_is_refused(monkeypatch):
    """Under a 'model' group of 2 the engine and the speculative adapters
    refuse the model, where they are made and where they run, naming ROADMAP
    item 7d: their argmax over a rank's vocabulary slice would give local
    ids. With no group they serve as before."""
    from repro_torch.core import BoltSystem
    from repro_torch.serve import ModelDraft, ModelTarget, ServeEngine
    from repro_torch.streams import Producer, Topic
    cfg = rt.get_smoke_config("qwen3-8b").with_(dtype="float32")
    model = rt.init_params(cfg, 0, device="cpu")
    system = BoltSystem(n_brokers=2)
    req, resp = Topic.create(system, "req"), Topic.create(system, "resp")
    prod = Producer(req)
    prod.produce({"id": "r0", "prompt": [3, 4, 5]})
    prod.flush()
    engine, target, draft = (ServeEngine(cfg, model, req, resp), ModelTarget(cfg, model),
                             ModelDraft(cfg, model))
    monkeypatch.setattr(tp, "model_group", lambda mesh=None: tp.ModelGroup(None, 2, 0))
    for serve in (lambda: ServeEngine(cfg, model, req, resp), lambda: ModelTarget(cfg, model),
                  lambda: ModelDraft(cfg, model), lambda: engine.poll_and_serve(gen_tokens=2),
                  lambda: target.verify([1, 2], [3]), lambda: draft.propose([1, 2], 2)):
        with pytest.raises(NotImplementedError, match=tp.ROADMAP_ITEM):
            serve()
    monkeypatch.undo()
    assert engine.poll_and_serve(gen_tokens=2) == 1


@pytest.mark.parametrize("arch", rt.ARCHS)
def test_every_registered_config_splits(arch):
    """Every registered config's smoke config passes the check on (1, 2),
    (1, 4) and (2, 2, 4): no block kind or wrapper is refused, and neither
    is the full config on the reference's production 'model' axis of 16."""
    cfg = rt.get_smoke_config(arch)
    tp.check_split(cfg, MeshShape(("data", "model"), (2, 1)))
    for shape in ((1, 2), (1, 4)):
        tp.check_split(cfg, MeshShape(("data", "model"), shape))
    tp.check_split(cfg, MeshShape(("pod", "data", "model"), (2, 2, 4)))
    tp.check_split(rt.get_config(arch), MeshShape(("data", "model"), (16, 16)))


@pytest.mark.parametrize("arch,overrides,m,what", [
    (*STRADDLED[0], 2, "kv groups"),
    # 12 mLSTM channels split over 2 ranks, its 3 qkv blocks of 4 do not
    ("xlstm-1.3b", {"d_model": 6}, 2, "qkv blocks"),
])
def test_straddling_splits_are_still_refused(arch, overrides, m, what):
    """The splits still refused, naming ROADMAP item 7d: ranks whose q heads
    straddle kv groups, and ranks whose mLSTM channels straddle its qkv
    blocks of four."""
    cfg = rt.get_smoke_config(arch).with_(**overrides)
    with pytest.raises(NotImplementedError, match=f"{tp.ROADMAP_ITEM}") as e:
        tp.check_split(cfg, MeshShape(("data", "model"), (1, m)))
    assert "straddle" in str(e.value) and what in str(e.value)


@pytest.mark.parametrize("tag,m,channels,heads", [
    ("jamba", 2, True, None), ("jamba", 4, True, None), ("jamba", 3, False, None),
    ("xlstm", 2, True, 1), ("xlstm", 4, True, 2), ("xlstm", 3, False, 2),
])
def test_mamba_and_xlstm_split_leaf_by_leaf(tag, m, channels, heads, monkeypatch):
    """Under a 'model' group of m, Mamba's every ``m_*`` leaf splits on its
    inner channels (``m_xproj`` and ``m_out`` by rows) where m divides Di,
    and ``tp.channel_group`` of ``m_in`` says so; the mLSTM's ``x_up``,
    ``x_q``/``x_k``/``x_v``, ``x_if`` and ``x_out`` where m divides Di (its
    ``channel_group`` of ``x_up``),
    the sLSTM whole. A rank's decode state holds its channels (Mamba) or
    the heads it runs (the mLSTM: H/m where m divides H, else all H)."""
    from repro_torch.models.ssm import init_mamba_state
    from repro_torch.models.xlstm import init_mlstm_state
    cfg = _cfg(tag)
    mshape = MeshShape(("data", "model"), (1, m))
    monkeypatch.setattr(tp, "get_mesh", lambda: mshape)
    monkeypatch.setattr(tp, "model_group", lambda: tp.ModelGroup(None, m, 0))
    dims = tp.split_dims(cfg, mshape)
    kinds = layer_kinds(cfg)
    Di = 2 * cfg.d_model
    if tag == "jamba":
        layer = kinds.index("mamba+mlp")
        names = ("m_in", "m_conv", "m_xproj", "m_dt", "m_dtb", "m_alog", "m_d", "m_out")
        assert (tp.channel_group("m_in", (cfg.d_model, 2, Di)) is not None) == channels
        state = init_mamba_state(cfg, 2, "cpu")
        assert state["ssm"].shape[1] == state["conv"].shape[2] == Di // (m if channels else 1)
        prefix = f"blocks.{layer}.mamba."
    else:
        layer = kinds.index("mlstm")
        names = ("x_up", "x_q", "x_k", "x_v", "x_if", "x_out")
        assert (tp.channel_group("x_up", (cfg.d_model, 2, Di)) is not None) == channels
        assert init_mlstm_state(cfg, 2, "cpu")["C"].shape[1] == heads
        prefix = f"blocks.{layer}.mlstm."
        slstm = kinds.index("slstm")
        assert not any(n.startswith(f"blocks.{slstm}.") for n in dims)
    for name in names:
        assert (prefix + name in dims) == channels, name
        if channels:
            dim, whole = dims[prefix + name]
            assert whole in (Di, Di // 4) and dim == (2 if name in ("m_in", "x_up") else
                                                      1 if name in ("m_conv", "m_dt") else 0)
