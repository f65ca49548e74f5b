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
with a CUDA tensor is enough. Mamba, xLSTM, the encoder-decoder and the VLM
prefix are refused under 'model' > 1 with an error that names ROADMAP item
7d, and so is a split whose ranks' q heads would straddle kv groups.
"""

import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
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
}
SHAPES = {"granite-drops": (4, 256), "granite-aux": (4, 32)}    # (B, S); else (B, S) above
MESHES = {"1x2": ((1, 2), ["qwen3", "smollm", "starcoder2-ungated", "qwen3-bf16", "granite",
                           "deepseek", "deepseek-bf16"]),
          "2x2": ((2, 2), ["qwen3", "smollm", "starcoder2-ungated", "granite", "deepseek"]),
          "1x4": ((1, 4), ["qwen3", "smollm", "starcoder2-ungated", "granite", "deepseek",
                           "deepseek-odd-shared"])}
DATA_MESH = (2, 1)
REFUSED = [a for a in rt.ARCHS if a not in ("qwen3-8b", "smollm-135m", "starcoder2-15b",
                                            "deepseek-67b", "granite-moe-3b-a800m",
                                            "deepseek-v2-lite-16b")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """Whether the ranks' gradients are held against the one-rank port's."""
    return cfg.dtype == "float32" and (cfg.moe is not None or cfg.mla is not None)


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
        return np.asarray(jlm.forward(jcfg, jlm.init_params(jcfg, jax.random.key(3)),
                                      {"tokens": jnp.asarray(toks[:, :-1])})[0], np.float32)


def _tokens(cfg, tag):
    b, s = SHAPES.get(tag, (B, S))
    return np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)


_REFS = {}


def _reference(tag, dp=1):
    """The JAX side and the port's one-rank step for case ``tag`` on a mesh
    of ``dp`` 'data' ranks: JAX's MoE sees ``dp`` and the port's one-rank
    side runs under a ``MeshShape`` of (dp, 1), whole rows on one rank."""
    cfg, jcfg = _cfg(tag), _cfg(tag, jget_smoke_config)
    dp = dp if cfg.moe is not None else 1        # only the MoE reads the mesh
    if (tag, dp) in _REFS:
        return _REFS[tag, dp]
    jp = jlm.init_params(jcfg, jax.random.key(3))
    toks = _tokens(cfg, tag)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    out = {"params": _names(cfg, jp), "tokens": toks}
    with _jax_sees(dp):
        if cfg.dtype == "float32":
            out["logits"] = np.asarray(jlm.forward(jcfg, jp, jb)[0], np.float32)
            loss, metrics = jlm.loss_fn(jcfg, jp, jb)
            out["loss"], out["aux"] = float(loss), float(metrics["aux"])
            b = toks.shape[0]
            caches = jlm.init_caches(jcfg, b, P + N_NEW)
            for t in range(P):                # the prompt, teacher-forced
                logits, caches = jlm.decode_step(jcfg, jp, caches,
                                                 jnp.asarray(toks[:, t:t + 1]),
                                                 jnp.asarray(t, jnp.int32))
            stream = []
            for t in range(N_NEW):
                stream.append(np.asarray(logits[:, -1, :cfg.vocab_size].argmax(-1)))
                if t + 1 < N_NEW:
                    logits, caches = jlm.decode_step(
                        jcfg, jp, caches, jnp.asarray(stream[-1][:, None], jnp.int32),
                        jnp.asarray(P + t, jnp.int32))
            out["stream"] = np.stack(stream, 1)
        jopt = JaxAdamWConfig(lr=LR, weight_decay=0.01, eps=EPS)
        jstep = jax.jit(jax_make_train_step(jcfg, jopt, grad_dtype=cfg.dtype))
        jparams, _, jm = jstep(jp, jax_adamw_init(jp, jopt), jb)
    out["jax_step"] = (float(jm["loss"]), float(jm["grad_norm"]), _names(cfg, jparams))
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
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
    _REFS[tag, dp] = out
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
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    res, rep = {}, {}
    mg = tp.vocab_group
    model = tp.split_model(cfg, load(cfg, arrays), mesh)
    rep["bytes"] = [sum(p.numel() * p.element_size() for p in model.parameters()),
                    param_bytes(cfg, mesh)]
    with use_mesh(mesh), torch.no_grad():
        routes.clear()
        tmoe._route = recorded
        logits, _, _, _ = forward(cfg, model, {"tokens": batch["tokens"]})
        tmoe._route = route
        if routes:                           # the expert choices of every MoE layer
            res["eidx"] = torch.cat(routes).numpy()
        res["logits"] = tp.gather_vocab(logits, mg(cfg)).float().numpy()
        rep["local_vocab"] = logits.shape[-1]
        rep["loss"] = float(loss_fn(cfg, model, batch)[0])
        P, n_new = spec["prompt"], spec["new"]
        logits, _, caches, _ = forward(cfg, model, {"tokens": batch["tokens"][:, :P]},
                                       want_caches=True, max_len=P + n_new)
        rep["cache"] = {k: list(v.shape) for k, v in caches["layers"][0].items()}
        stream = []
        for t in range(n_new):
            stream.append(tp.greedy(logits[:, -1], cfg.vocab_size, mg(cfg)))
            if t + 1 < n_new:
                logits, caches = decode_step(cfg, model, caches, stream[-1][:, None], P + t)
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
    for arch in spec["refused"]:
        cfg = get_smoke_config(arch).with_(dtype="float32")
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
                 **{"param " + n: a for n, a in ref["params"].items()})
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
            if cfg.mla is not None:          # the latent cache, whole on every rank
                assert got["cache"]["c_kv"][1:] == [P + N_NEW, cfg.mla.kv_lora_rank], (tag, r)
            else:
                assert got["cache"]["k"][1] == _local_heads(cfg, shape, r), (tag, r)
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
                                 refused=REFUSED if mesh == "1x2" else ())
    _held(mesh, shape, tags, reports, arrays)
    if mesh == "1x2":
        for rep in reports:
            assert set(rep["refused"]) == set(REFUSED)
            for arch, said in rep["refused"].items():
                assert len(said) == 2 and all(tp.ROADMAP_ITEM in s for s in said), arch
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


def test_every_other_block_kind_is_refused():
    """Under 'model' > 1 the check refuses every smoke config with Mamba,
    xLSTM, an encoder-decoder or a VLM prefix, naming ROADMAP item 7d, and
    splits the attn/MLA + MLP/MoE decoders; a 'model' of 1 refuses none."""
    for arch in rt.ARCHS:
        cfg = rt.get_smoke_config(arch)
        tp.check_split(cfg, MeshShape(("data", "model"), (2, 1)))
        if arch in REFUSED:
            with pytest.raises(NotImplementedError, match=tp.ROADMAP_ITEM):
                tp.check_split(cfg, MeshShape(("data", "model"), (1, 2)))
        else:
            tp.check_split(cfg, MeshShape(("pod", "data", "model"), (2, 2, 4)))
