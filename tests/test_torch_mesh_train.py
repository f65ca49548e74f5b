"""Training a model on a mesh through a whole run, against the JAX package,
on the CPU: the ZeRO-1 state made in a rank's chunks, the ZeRO-1 step's
microbatches, and checkpoints of ZeRO-1 and split state saved and restored
on a mesh.

The ranks are gloo processes (``tests/_gloo.py``), one launch a test; the
parent computes the JAX side. On the ``(data, model)`` meshes (2, 1), (1,
2) and (2, 2):

* ``zero1_adamw_init`` makes each rank's chunks alone: its DTensors equal
  ``distribute_opt_state(adamw_init(...))``'s bit for bit (local shape,
  placements, values), no tensor it allocates exceeds the rank's largest
  chunk (a ``TorchDispatchMode`` records every new storage; ``adamw_init``
  of the whole model exceeds it, the power check), and a step from either
  state is the same bit for bit, and so is the state saved and restored
  on the mesh. A config of 18 layers puts 'data' on the reference's stack
  dim, where a layer lives on one coordinate's ranks;
* ``make_zero1_train_step(accum=2)`` on (2, 1) and (2, 2) equals JAX's
  ``make_train_step(accum=2)`` within ``STEP_TOL`` for qwen3-8b-smoke and
  for granite-moe-smoke with drops, the JAX MoE seeing 2 data ranks: each
  rank's microbatch i holds the reference's rows of it
  (``local_batch(..., accum)``), so its token groups, and the drops, are
  the reference's. Fed contiguous rows instead, the granite step misses;
* a save of a ZeRO-1 state on (2, 1) writes, byte for byte, the record one
  process writes of the gathered model and state (the save raised on the
  DTensor leaves before); a save and restore resumes bit for bit on (2, 1)
  and (1, 2); a record saved on (2, 1) restores onto (1, 2) and one rank,
  one saved on (1, 2) onto (2, 1), and one the JAX package wrote onto
  (1, 2): each saved again there writes its record byte for byte, and
  steps within ``STEP_TOL`` of the step on one rank (of the JAX step, for
  the JAX record).
"""

import contextlib
import dataclasses
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _gloo import RECORDS, dump_record, run_ranks  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.train.step import STEP_TOL  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

LR, WD, EPS = 1e-3, 0.01, 1e-6      # as tests/test_torch_tp.py: Adam's first step held at STEP_TOL
ACCUM = 2
CASES = {"qwen3": ("qwen3-8b", {}, "float32", (4, 12)),
         # 256 tokens a rank's microbatch, one token group, C = 64 slots an expert
         # against ~64 assignments: about half the experts overflow
         "granite-drops": ("granite-moe-3b-a800m", {"moe": {"capacity_factor": 0.25}},
                           "float32", (4, 256))}
# 18 layers, the largest dim of each stacked leaf: ZeRO-1 puts 'data' on the
# stack dim, and each layer lives whole on one 'data' coordinate's ranks
STACKED = dict(name="stacked", n_layers=18, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
               vocab_size=64, tie_embeddings=True, dtype="float32")

WORKER = RECORDS + r'''
import dataclasses
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import get_smoke_config, init_params
from repro_torch.distributed import tp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.train import (AdamWConfig, adamw_init, distribute_opt_state, local_batch,
                               make_train_step, make_zero1_train_step, opt_state_shardings)


def config(case):
    if isinstance(case, dict):
        return ModelConfig(**case)
    arch, overrides, dtype = case[:3]
    kw = dict(overrides)
    moe = kw.pop("moe", None)
    cfg = get_smoke_config(arch).with_(dtype=dtype, **kw)
    return cfg if moe is None else cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))


def mesh_of(shape):
    return make_mesh(tuple(shape), ("data", "model"), device="cpu")


OPT = AdamWConfig(lr=spec["lr"], weight_decay=spec["wd"], eps=spec["eps"])
ACCUM = spec["accum"]


def made(cfg, mesh, seed=0):
    """(this rank's part of the model, the ZeRO-1 shardings, its chunked state)."""
    from repro_torch.train import zero1_adamw_init
    whole = init_params(cfg, seed, device="cpu", trainable=True)
    osh = opt_state_shardings(cfg, whole, mesh, OPT)
    model = tp.split_model(cfg, whole, mesh)
    return model, osh, zero1_adamw_init(cfg, model, OPT, osh, mesh)


def made_state(cfg, model, osh, mesh):
    from repro_torch.train import zero1_adamw_init
    return zero1_adamw_init(cfg, model, OPT, osh, mesh)


def batch_of(cfg, shape, seed=0):
    b, s = shape
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)))
    return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}


def same_state(a, b):
    """Two ZeRO-1 states equal bit for bit: each DTensor's mesh, placements,
    global shape, local shape, dtype and bits."""
    ok = torch.equal(a["step"].to_local(), b["step"].to_local())
    for key in ("m", "v", "master"):
        for n, x in a[key].items():
            y = b[key][n]
            ok &= (x.device_mesh == y.device_mesh and x.placements == y.placements
                   and x.shape == y.shape and x.to_local().dtype == y.to_local().dtype
                   and x.to_local().shape == y.to_local().shape
                   and torch.equal(x.to_local(), y.to_local()))
    return bool(ok)


def same_params(a, b):
    return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def whole_params(cfg, model, mesh):
    """{name: fp32 numpy} of the whole model from this rank's part."""
    get = tp.host_params(cfg, model, mesh)
    return {n: get(n).float().numpy() for n, _ in model.named_parameters()}


def gathered(cfg, model, state, mesh):
    """The model and the state made whole (one process's view of them)."""
    get = tp.host_params(cfg, model, mesh)
    whole = init_params(cfg, None, device="cpu", trainable=True)
    with torch.no_grad():
        for n, p in whole.named_parameters():
            p.copy_(get(n))
    plain = {k: {n: tp.host_leaf(d) for n, d in state[k].items()}
             for k in ("m", "v", "master") if k in state}
    plain["step"] = state["step"].to_local().clone()
    return whole, plain


def fresh_from(cfg, mesh, params):
    """A fresh split model (other weights) holding restored ``params``."""
    model = tp.split_model(cfg, init_params(cfg, 9, device="cpu", trainable=True), mesh)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    return model


def diffs(a, b, keys=None):
    """The largest |a - b| of two {name: numpy} dicts."""
    return max(float(np.abs(a[n] - b[n]).max()) for n in (keys or a))


class Allocs(TorchDispatchMode):
    """The largest storage an op makes anew (an output sharing no input's)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves(
            (args, kwargs)) if isinstance(t, torch.Tensor) and not isinstance(t, DTensor)}
        for t in pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and not isinstance(t, DTensor)
                    and t.untyped_storage().data_ptr() not in seen):
                self.most = max(self.most, t.untyped_storage().nbytes())
        return out


def chunked(cfg, mesh):
    """(b) for one config on one mesh."""
    from repro_torch.train import zero1_adamw_init
    whole = init_params(cfg, 0, device="cpu", trainable=True)
    osh = opt_state_shardings(cfg, whole, mesh, OPT)
    with Allocs() as whole_allocs:
        full = adamw_init(whole, OPT)
    ref = distribute_opt_state(full, osh, mesh)
    del full
    model = tp.split_model(cfg, whole, mesh)
    with Allocs() as allocs:
        state = zero1_adamw_init(cfg, model, OPT, osh, mesh)
    largest = max(d.to_local().numel() * d.to_local().element_size()
                  for k in ("m", "v", "master") for d in state[k].values())
    rep = {"equal": same_state(state, ref), "allocated": allocs.most, "largest": largest,
           "whole_allocated": whole_allocs.most,
           "empty": sum(d.device_mesh.get_coordinate() is None for d in state["m"].values())}
    other = tp.split_model(cfg, init_params(cfg, 0, device="cpu", trainable=True), mesh)
    step = make_zero1_train_step(cfg, OPT, mesh, osh, grad_dtype=cfg.dtype, accum=ACCUM)
    batch = local_batch(batch_of(cfg, (4, 8)), mesh, ACCUM)
    _, state, m = step(model, state, batch)
    _, ref, n = step(other, ref, batch)
    rep["step_equal"] = (same_state(state, ref) and same_params(model, other)
                         and float(m["loss"]) == float(n["loss"]))
    # saved and restored on the mesh: the one-process record, the same chunks
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, chunk_bytes=4096)
    log_id = ckpt.save(1, model, state, cfg=cfg, mesh=mesh)
    whole, plain = gathered(cfg, model, state, mesh)
    _, params, back, _ = ckpt.restore(1, cfg=cfg, mesh=mesh)
    rep["restored"] = (same_state(back, state)
                       and all(torch.equal(params[n], p) for n, p in model.named_parameters()))
    if rank == 0:
        one = BoltSystem(n_brokers=2)
        mine = CheckpointManager(one, chunk_bytes=4096).save(1, whole, plain, cfg=cfg)
        rep["record"] = record(system, log_id) == record(one, mine)
    return rep


report = {}
task = spec["task"]
if task == "chunked":
    mesh = mesh_of(spec["shape"])
    report = {tag: chunked(config(case), mesh) for tag, case in spec["cases"].items()}

if task == "microbatches":
    mesh = mesh_of(spec["shape"])
    for tag, case in spec["cases"].items():
        cfg = config(case)
        arrays = np.load(f"{out}/{tag}.npz")
        whole = init_params(cfg, None, device="cpu", trainable=True)
        with torch.no_grad():
            for n, p in whole.named_parameters():
                p.copy_(torch.from_numpy(arrays["param " + n]))
        toks = torch.from_numpy(arrays["tokens"]).long()
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
        rep = {}
        for rows, accum_rows in (("own", ACCUM), ("contiguous", 1)):
            if rows == "contiguous" and not spec["contiguous"].get(tag):
                continue
            model = init_params(cfg, None, device="cpu", trainable=True)
            model.load_state_dict(whole.state_dict())
            osh = opt_state_shardings(cfg, model, mesh, OPT)
            model = tp.split_model(cfg, model, mesh)
            state = made_state(cfg, model, osh, mesh)
            step = make_zero1_train_step(cfg, OPT, mesh, osh, grad_dtype=cfg.dtype,
                                         accum=ACCUM)
            _, state, m = step(model, state, local_batch(batch, mesh, accum_rows))
            rep[rows] = [float(m["loss"]), float(m["grad_norm"])]
            got = whole_params(cfg, model, mesh)
            if rank == 0:
                np.savez(f"{out}/{tag}_{rows}.npz", **got)
        report[tag] = rep

if task == "zero1_save":
    # (a): the ZeRO-1 state's DTensor leaves, saved with no mesh named and none
    # ambient (their own mesh), under use_mesh and with mesh=: all the record
    # one process writes of the gathered model and state
    from repro_torch.distributed import use_mesh
    mesh = mesh_of(spec["shape"])
    cfg = config(spec["case"])
    model = init_params(cfg, 0, device="cpu", trainable=True)
    osh = opt_state_shardings(cfg, model, mesh, OPT)
    state = distribute_opt_state(adamw_init(model, OPT), osh, mesh)    # the state made whole
    step = make_zero1_train_step(cfg, OPT, mesh, osh, grad_dtype="bfloat16")
    _, state, _ = step(model, state, local_batch(batch_of(cfg, (4, 8)), mesh))
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, chunk_bytes=4096)
    ids = [ckpt.save(1, model, state, extra={"cursor": [1, 0]}, cfg=cfg)]
    with use_mesh(mesh):
        ids.append(ckpt.save(2, model, state, extra={"cursor": [1, 0]}, cfg=cfg))
    ids.append(ckpt.save(3, model, state, extra={"cursor": [1, 0]}, cfg=cfg, mesh=mesh))
    whole, plain = gathered(cfg, model, state, mesh)
    report["ids"] = ids
    if rank == 0:
        one = BoltSystem(n_brokers=2)
        lone = CheckpointManager(one, chunk_bytes=4096)
        recs = [record(system, i) for i in ids]
        for s in (1, 2, 3):
            mine = record(one, lone.save(s, whole, plain, extra={"cursor": [1, 0]}, cfg=cfg))
            report[f"equal {s}"] = recs[s - 1] == mine
        report["chunks"] = len(recs[0][1])
        report["ids_are_rank0s"] = ids == [ckpt._replay()[s]["data_log"] for s in (1, 2, 3)]

if task == "resume":
    cfg = config(spec["case"])
    batches = [batch_of(cfg, (4, 8), seed) for seed in (1, 2)]
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, keep=0, chunk_bytes=4096)      # keep every save
    one_step = make_train_step(cfg, OPT, accum=ACCUM, grad_dtype=cfg.dtype)
    saved = {}
    for shape in spec["meshes"]:
        key = "x".join(map(str, shape))
        mesh = mesh_of(shape)
        model, osh, state = made(cfg, mesh)
        step = make_zero1_train_step(cfg, OPT, mesh, osh, grad_dtype=cfg.dtype, accum=ACCUM)
        _, state, _ = step(model, state, local_batch(batches[0], mesh, ACCUM))
        saved[key] = ckpt.save(len(saved) + 1, model, state, extra={"mesh": key}, cfg=cfg,
                               mesh=mesh)
        _, state, m = step(model, state, local_batch(batches[1], mesh, ACCUM))
        s, params, restored, extra = ckpt.restore(len(saved), cfg=cfg, mesh=mesh)
        again = fresh_from(cfg, mesh, params)
        _, restored, rm = step(again, restored, local_batch(batches[1], mesh, ACCUM))
        report[f"resume {key}"] = (s == len(saved) and extra == {"mesh": key}
                                   and float(m["loss"]) == float(rm["loss"])
                                   and float(m["grad_norm"]) == float(rm["grad_norm"])
                                   and same_params(model, again)
                                   and same_state(state, restored))
    # each record restored onto the other mesh, and on one rank: saved again
    # there, the same bytes; one more step, against the one-rank step
    for src, dst in spec["cross"]:
        shape = [int(x) for x in dst.split("x")] if dst != "one" else None
        s = list(saved).index(src) + 1
        if dst == "one":
            if rank != 0:
                continue
            _, params, state, _ = ckpt.restore(s, cfg=cfg, device="cpu")
            model = init_params(cfg, None, device="cpu", trainable=True)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(params[n])
            again = ckpt.save(10 + s, model, state, extra={"mesh": src}, cfg=cfg)
            _, state, m = one_step(model, state, batches[1])
            got = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        else:
            mesh = mesh_of(shape)
            _, params, state, _ = ckpt.restore(s, cfg=cfg, mesh=mesh)
            model = fresh_from(cfg, mesh, params)
            again = ckpt.save(10 + s, model, state, extra={"mesh": src}, cfg=cfg, mesh=mesh)
            osh = opt_state_shardings(cfg, init_params(cfg, None, device="meta"), mesh, OPT)
            step = make_zero1_train_step(cfg, OPT, mesh, osh, grad_dtype=cfg.dtype,
                                         accum=ACCUM)
            _, state, m = step(model, state, local_batch(batches[1], mesh, ACCUM))
            got = whole_params(cfg, model, mesh)
        if rank == 0:
            rec, rec2 = record(system, saved[src]), record(system, again)
            report[f"{src} on {dst}: bytes"] = rec[0]["step"] + 10 == rec2[0]["step"] and (
                {k: v for k, v in rec[0].items() if k != "step"}
                == {k: v for k, v in rec2[0].items() if k != "step"} and rec[1] == rec2[1])
            _, params, st, _ = ckpt.restore(s, cfg=cfg, device="cpu")
            one = init_params(cfg, None, device="cpu", trainable=True)
            with torch.no_grad():
                for n, p in one.named_parameters():
                    p.copy_(params[n])
            _, _, om = one_step(one, st, batches[1])
            want = {n: p.detach().numpy() for n, p in one.named_parameters()}
            report[f"{src} on {dst}: step"] = [
                abs(float(m["loss"]) - float(om["loss"])) / abs(float(om["loss"])),
                abs(float(m["grad_norm"]) - float(om["grad_norm"])) / float(om["grad_norm"]),
                diffs(got, want)]
    # the JAX package's record onto (1, 2): saved again, its bytes; one step
    if spec.get("jax"):
        mesh = mesh_of([1, 2])
        lid = load_record(system, f"{out}/jax.pkl") if rank == 0 else None
        s = spec["jax"]["step"]
        _, params, state, extra = ckpt.restore(s, cfg=cfg, mesh=mesh)
        model = fresh_from(cfg, mesh, params)
        again = ckpt.save(100, model, state, extra=extra, cfg=cfg, mesh=mesh)
        if rank == 0:
            rec, rec2 = record(system, lid), record(system, again)
            report["jax on 1x2: bytes"] = (rec[1] == rec2[1] and {**rec[0], "step": 100}
                                           == rec2[0])
        osh = opt_state_shardings(cfg, init_params(cfg, None, device="meta"), mesh, OPT)
        step = make_zero1_train_step(cfg, OPT, mesh, osh, grad_dtype=cfg.dtype)
        arrays = np.load(f"{out}/jax_batch.npz")
        toks = torch.from_numpy(arrays["tokens"]).long()
        _, state, m = step(model, state, {"tokens": toks[:, :-1].contiguous(),
                                          "labels": toks[:, 1:].contiguous()})
        got = whole_params(cfg, model, mesh)
        report["jax on 1x2: step"] = [float(m["loss"]), float(m["grad_norm"]),
                                      int(state["step"].to_local())]
        if rank == 0:
            np.savez(f"{out}/jax_next.npz", **got)

json.dump(report, open(f"{out}/rank{rank}.json", "w"))
dist.destroy_process_group()
'''


def _cfg(tag, get=rt.get_smoke_config):
    arch, overrides, dtype, _ = CASES[tag]
    kw = dict(overrides)
    moe = kw.pop("moe", None)
    cfg = get(arch).with_(dtype=dtype, **kw)
    return cfg if moe is None else cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))


@contextlib.contextmanager
def _jax_sees(dp):
    """The JAX MoE's ``axis_size`` reads a mesh of ``dp`` 'data' ranks
    (``src/repro/models/moe.py:77``), as ``tests/test_torch_tp.py`` sees it."""
    with mock.patch.object(jmoe, "axis_size", lambda name: {"data": dp}.get(name, 1)):
        yield


def _names(cfg, tree):
    model = rt.params_from_jax(cfg, jax.device_get(tree), device="cpu")
    return {n: p.detach().float().numpy() for n, p in model.named_parameters()}


def _jax_accum_step(tag, dp, out: Path):
    """JAX's ``make_train_step(accum=2)`` of case ``tag`` on its seeded
    weights and batch, its MoE seeing ``dp`` data ranks: (loss, grad norm,
    {name: updated parameter}); the weights and tokens written for the ranks."""
    cfg, jcfg = _cfg(tag), _cfg(tag, jget_smoke_config)
    b, s = CASES[tag][3]
    jp = jax.jit(lambda key: jlm.init_params(jcfg, key))(jax.random.key(3))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    np.savez(out / f"{tag}.npz", tokens=toks, **{"param " + n: a
                                                 for n, a in _names(cfg, jp).items()})
    jopt = JaxAdamWConfig(lr=LR, weight_decay=WD, eps=EPS)
    with _jax_sees(dp):
        jstep = jax.jit(jax_make_train_step(jcfg, jopt, accum=ACCUM, grad_dtype="float32"))
        jparams, _, jm = jstep(jp, jax_adamw_init(jp, jopt),
                               {"tokens": jnp.asarray(toks[:, :-1]),
                                "labels": jnp.asarray(toks[:, 1:])})
    return float(jm["loss"]), float(jm["grad_norm"]), _names(cfg, jparams)


def _spec(task, **kw):
    return {"task": task, "lr": LR, "wd": WD, "eps": EPS, "accum": ACCUM, **kw}


MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_chunked_state_equals_the_state_made_whole(mesh, tmp_path):
    """(b): ``zero1_adamw_init`` against ``distribute_opt_state(adamw_init)``
    on qwen3-8b-smoke in bf16 and the 18-layer config (module docstring)."""
    shape = MESHES[mesh]
    cases = {"qwen3-bf16": ["qwen3-8b", {}, "bfloat16"], "stacked": STACKED}
    reports = run_ranks(tmp_path, shape[0] * shape[1], WORKER,
                        _spec("chunked", shape=list(shape), cases=cases))
    for r, rep in enumerate(reports):
        for tag, got in rep.items():
            assert got["equal"] and got["step_equal"] and got["restored"], (mesh, r, tag)
            assert got.get("record", r > 0), (mesh, r, tag)
            assert got["allocated"] <= got["largest"] < got["whole_allocated"], (mesh, r, tag, got)
            # on a data axis of 2 each layer of the stacked config lives on one
            # coordinate's ranks, so a rank holds no chunk of half of them
            assert (got["empty"] > 0) == (tag == "stacked" and shape[0] == 2), (mesh, r, tag)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_microbatches_match_jax(mesh, tmp_path):
    """(c): ``make_zero1_train_step(accum=2)`` against JAX's
    ``make_train_step(accum=2)`` within STEP_TOL, each rank holding the
    reference's rows of each microbatch; granite-moe-smoke with drops,
    stepped on contiguous rows, misses (its token groups differ)."""
    shape = MESHES[mesh]
    refs = {tag: _jax_accum_step(tag, shape[0], tmp_path) for tag in CASES}
    reports = run_ranks(tmp_path, shape[0] * shape[1], WORKER,
                        _spec("microbatches", shape=list(shape),
                              cases={tag: list(c[:3]) for tag, c in CASES.items()},
                              contiguous={"granite-drops": True}))
    for tag, (loss, gnorm, want) in refs.items():
        for r, rep in enumerate(reports):
            np.testing.assert_allclose(rep[tag]["own"], [loss, gnorm], rtol=STEP_TOL,
                                       err_msg=f"{mesh} {tag} rank {r}")
        got = np.load(tmp_path / f"{tag}_own.npz")
        assert set(got.files) == set(want)
        for n, w in want.items():
            np.testing.assert_allclose(got[n], w, rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{mesh} {tag} {n}")
    loss, gnorm, want = refs["granite-drops"]
    got = np.load(tmp_path / "granite-drops_contiguous.npz")
    miss = max(abs(reports[0]["granite-drops"]["contiguous"][0] - loss) / abs(loss),
               max(float(np.abs(got[n] - w).max()) for n, w in want.items()))
    assert miss > 10 * STEP_TOL, miss


def test_zero1_save_writes_the_one_rank_record(tmp_path):
    """(a): on (2, 1) a bf16 qwen3-8b-smoke ZeRO-1 state (``distribute_opt_state``
    of the whole state, the DTensors on which the save raised), after one
    step, is saved by both ranks: with no mesh named (the DTensors' own), under
    ``use_mesh`` and with ``mesh=``. Each record equals byte for byte the
    one a single process writes of the gathered model and state, and every
    rank returns rank 0's data fork id."""
    reports = run_ranks(tmp_path, 2, WORKER,
                        _spec("zero1_save", shape=[2, 1], case=["qwen3-8b", {}, "bfloat16"]))
    rep = reports[0]
    assert rep["equal 1"] and rep["equal 2"] and rep["equal 3"], rep
    assert rep["chunks"] > len(rep["ids"]) and rep["ids_are_rank0s"]
    assert reports[1]["ids"] == rep["ids"]


def _jax_record(tmp_path):
    """The JAX package trains qwen3-8b-smoke (fp32) one step and saves its
    state; returns (the record's step, JAX's next step)."""
    from repro.core import BoltSystem as JaxBoltSystem
    from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
    jcfg = jget_smoke_config("qwen3-8b").with_(dtype="float32")
    cfg = rt.get_smoke_config("qwen3-8b").with_(dtype="float32")
    jopt = JaxAdamWConfig(lr=LR, weight_decay=WD, eps=EPS)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, grad_dtype="float32"))
    rng = np.random.default_rng(11)
    toks = [rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32) for _ in range(2)]
    params = jlm.init_params(jcfg, jax.random.key(5))
    opt = jax_adamw_init(params, jopt)
    batch = [{"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])} for t in toks]
    params, opt, _ = jstep(params, opt, batch[0])
    jsystem = JaxBoltSystem(n_brokers=2)
    ckpt = JaxCheckpointManager(jsystem, chunk_bytes=4096)
    ckpt.save(7, params, opt, extra={"cursor": [1, 0]})
    dump_record(ckpt, 7, tmp_path / "jax.pkl")
    np.savez(tmp_path / "jax_batch.npz", tokens=toks[1])
    nxt, _, jm = jstep(params, opt, batch[1])
    return float(jm["loss"]), float(jm["grad_norm"]), _names(cfg, nxt)


def test_resume_is_exact_and_records_restore_across_meshes(tmp_path):
    """(e): on (2, 1) and (1, 2), qwen3-8b-smoke in fp32 steps with 2
    microbatches, saves, steps again; restored onto fresh split objects, it
    takes that second step bit for bit (loss, grad norm, parameters, every
    chunk of the state). The (2, 1) record restores onto (1, 2) and one
    rank, the (1, 2) record onto (2, 1), and the JAX package's onto (1, 2):
    saved again there, each writes its record byte for byte, and one step
    lies within STEP_TOL of the one-rank port's step (JAX's, for JAX's)."""
    jloss, jgnorm, jwant = _jax_record(tmp_path)
    cross = [["2x1", "1x2"], ["2x1", "one"], ["1x2", "2x1"]]
    reports = run_ranks(tmp_path, 2, WORKER,
                        _spec("resume", case=["qwen3-8b", {}, "float32"],
                              meshes=[[2, 1], [1, 2]], cross=cross, jax={"step": 7}))
    rep = reports[0]
    for r, got in enumerate(reports):
        assert got["resume 2x1"] and got["resume 1x2"], r
    for src, dst in cross:
        assert rep[f"{src} on {dst}: bytes"], (src, dst)
        assert max(rep[f"{src} on {dst}: step"]) < STEP_TOL, (src, dst, rep)
    assert rep["jax on 1x2: bytes"]
    loss, gnorm, step = rep["jax on 1x2: step"]
    assert step == 2
    np.testing.assert_allclose([loss, gnorm], [jloss, jgnorm], rtol=STEP_TOL)
    got = np.load(tmp_path / "jax_next.npz")
    for n, w in jwant.items():
        np.testing.assert_allclose(got[n], w, rtol=STEP_TOL, atol=STEP_TOL, err_msg=n)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [True, False])
def test_adamw_in_blocks_is_the_whole_update_bit_for_bit(moments, master, monkeypatch):
    """AdamW updates a tensor ``_BLOCK`` elements at a time, which bounds its
    fp32 temporaries; its arithmetic is elementwise, so blocks of 1000
    elements (every smoke tensor cut, most unevenly) give the update of one
    block a tensor bit for bit: parameters, m, v and master, two steps of a
    bf16 qwen3-8b-smoke."""
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train import optimizer
    cfg = rt.get_smoke_config("qwen3-8b")
    opt = AdamWConfig(moments_dtype=moments, master_weights=master)
    runs = []
    for block in (1 << 24, 1000):
        monkeypatch.setattr(optimizer, "_BLOCK", block)
        model = rt.init_params(cfg, 0, device="cpu", trainable=True)
        state = adamw_init(model, opt)
        gen = torch.Generator().manual_seed(1)
        for _ in range(2):
            grads = {n: torch.randn(p.shape, generator=gen).to(p.dtype)
                     for n, p in model.named_parameters()}
            adamw_update(model, grads, state, opt)
        runs.append((model, state))
    assert max(p.numel() for p in runs[0][0].parameters()) > 1000
    (a, sa), (b, sb) = runs
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        for key in ("m", "v", "master") if master else ("m", "v"):
            assert torch.equal(sa[key][n], sb[key][n]), (key, n)
