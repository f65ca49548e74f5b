"""The port's distribution layer against the JAX package's, on the CPU.

Held leaf for leaf against the reference, with JAX on an ``AbstractMesh``
(no devices) and the port on a ``MeshShape`` (no process group), for every
registered config at full size on the (16, 16) and (2, 16, 16) production
meshes and a (2, 2, 2) mesh:

* the sharding tables (``_RULES``, ``_CACHE_RANK``, ``_CACHE_TAIL``);
* each parameter's spec, and each ZeRO-1 ``m``/``v``/``master`` spec, with
  the reference's stack dim: a port layer is paired with the reference's
  stacked leaf through the converter's walk (``convert._leaves``), and its
  ``Sharding`` with the stack axis put first must equal the leaf's spec;
* the bytes a device holds of the parameters and the optimizer state;
* the cache specs at decode_32k and the batch specs of every cell shape;
* ``_filter_axes`` (the data widening, an unknown axis, the suffix rule).

The layer stack is pinned: on (2, 16, 16) ZeRO-1 puts 'pod' on the stack dim
of 81 of the reference's 290 ``m`` leaves, on (16, 16) on none.

Two checks run in a subprocess, so that no process group starts inside a
test worker: 4 gloo ranks (rendezvous through a ``FileStore``) place a smoke
model's parameters and ZeRO-1 state as DTensors on a (2, 2) and a (2, 1, 2)
mesh and take a ZeRO-1 step, the model split over 'model' (tensor
parallelism, ``distributed/tp.py``) and gathered whole again; and one rank
takes a ZeRO-1 step on the (1, 1) host mesh, equal bit for bit to the step
without a mesh.
"""

import json
import math
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import context as jctx  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import _leaves  # noqa: E402
from repro_torch.distributed import context as ctx  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.context import P  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_production_mesh  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,  # noqa: E402
                                         opt_state_shardings)

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}


def _meshes(tag):
    names, sizes = MESHES[tag]
    return MeshShape(names, sizes), AbstractMesh(sizes, names)


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries, each None or a tuple of axes."""
    parts = [None if e is None else ((e,) if isinstance(e, str) else tuple(e)) or None
             for e in spec]
    return tuple(parts + [None] * (ndim - len(parts)))


class _Whole:
    """A reference leaf (spec, shape, itemsize) that indexing leaves whole, so
    that ``convert._leaves`` pairs each port layer with its stacked leaf."""

    def __init__(self, spec, shape, itemsize):
        self.spec, self.shape, self.itemsize = spec, tuple(shape), itemsize

    def __getitem__(self, i):
        return self


def _paired(cfg, model, shardings, shapes):
    tree = jax.tree.map(lambda s, x: _Whole(s.spec, x.shape, x.dtype.itemsize),
                        shardings, shapes)
    return {name: w for name, _, w in _leaves(cfg, model, tree)}


def _reference_spec(sh):
    """A port ``Sharding`` as the spec of the reference's leaf: the stack
    dim first where the reference stacks the layer."""
    return P(sh.stack, *sh.spec) if sh.n_stack else sh.spec


def _ref_bytes(paired, amesh):
    """Bytes a device holds of the reference's leaves (each stacked leaf once)."""
    leaves = {id(w): w for w in paired.values()}.values()
    return sum(math.prod(NamedSharding(amesh, w.spec).shard_shape(w.shape)) * w.itemsize
               for w in leaves)


_OPT = AdamWConfig()
_JOPT = jopt.AdamWConfig()


# ------------------------------------------------------------------ tables
def test_rule_tables_equal_the_reference():
    assert sharding._RULES == jsharding._RULES
    assert specs._CACHE_RANK == jspecs._CACHE_RANK
    assert specs._CACHE_TAIL == jspecs._CACHE_TAIL
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.SUBQUADRATIC == jspecs.SUBQUADRATIC
    for arch in ARCHS:
        for shape in specs.SHAPES:
            assert specs.cell_supported(arch, shape) == jspecs.cell_supported(arch, shape)


def test_production_meshes():
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    mp = make_production_mesh(multi_pod=True)
    assert (mp.axis_names, mp.axis_sizes, mp.size, mp.tag) == (
        ("pod", "data", "model"), (2, 16, 16), 512, "2x16x16")


# ------------------------------------------- parameters and ZeRO-1, per leaf
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_jax(arch, tag):
    mesh, amesh = _meshes(tag)
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    model = specs.abstract_params(cfg)
    p_shapes = jspecs.abstract_params(jcfg)
    jp = _paired(cfg, model, jsharding.param_shardings(p_shapes, amesh), p_shapes)
    jo_sh = jopt.opt_state_shardings(p_shapes, amesh, _JOPT)
    jo_shapes = jax.eval_shape(lambda p: jopt.adamw_init(p, _JOPT), p_shapes)
    ps = sharding.param_shardings(cfg, model, mesh)
    os_ = opt_state_shardings(cfg, model, mesh, _OPT)
    state = adamw_init(model, _OPT)
    params = dict(model.named_parameters())
    assert set(jp) == set(params)
    assert set(os_) == set(jo_sh) == {"m", "v", "master", "step"}
    assert _norm(os_["step"].spec, 0) == _norm(jo_sh["step"].spec, 0) == ()
    for name, p in params.items():
        w, sh = jp[name], ps[name]
        assert w.shape == ((sh.n_stack,) if sh.n_stack else ()) + tuple(p.shape), name
        assert _norm(_reference_spec(sh), len(w.shape)) == _norm(w.spec, len(w.shape)), name
    for key in ("m", "v", "master"):
        jz = _paired(cfg, model, jo_sh[key], jo_shapes[key])
        for name in params:
            w, sh = jz[name], os_[key][name]
            assert _norm(_reference_spec(sh), len(w.shape)) == _norm(w.spec, len(w.shape)), \
                (key, name)
        # bytes a device holds: the port's layers against the reference's leaves
        port = sum(os_[key][n].bytes_per_device(tuple(t.shape), t.element_size(), mesh)
                   for n, t in state[key].items())
        assert port == pytest.approx(_ref_bytes(jz, amesh), rel=1e-12)
    port = sum(ps[n].bytes_per_device(tuple(p.shape), p.element_size(), mesh)
               for n, p in params.items())
    assert port == pytest.approx(_ref_bytes(jp, amesh), rel=1e-12)


# The layers whose ZeRO-1 state ('m', 'v', 'master') the reference shards
# over 'pod' on the stack dim on (2, 16, 16), by their name within a layer
# ("encoder:" for whisper's encoder layers). On (16, 16) there are none.
STACK_POD_LEAVES = {
    "smollm-135m": {"ln1", "ln2", "mlp.w_gate", "mlp.w_in", "mlp.w_out"},
    "deepseek-67b": set(),
    "starcoder2-15b": {"ln1", "ln2", "mlp.w_in", "mlp.w_out"},
    "qwen3-8b": {"attn.k_norm", "attn.q_norm", "ln1", "ln2", "mlp.w_gate", "mlp.w_in",
                 "mlp.w_out"},
    "llava-next-34b": {"ln1", "ln2", "mlp.w_gate", "mlp.w_in", "mlp.w_out"},
    "jamba-1.5-large-398b": set(),
    "whisper-small": {"encoder:ln1", "encoder:ln2", "encoder:mlp.w_in", "encoder:mlp.w_out",
                      "ln1", "ln2", "ln_c", "mlp.w_in", "mlp.w_out"},
    "granite-moe-3b-a800m": {"ln1", "ln2"},
    "deepseek-v2-lite-16b": {"ln1", "ln2", "mla.kv_norm", "moe.shared.w_gate",
                             "moe.shared.w_in", "moe.shared.w_out"},
    "xlstm-1.3b": {"ln1", "mlstm.x_k", "mlstm.x_out", "mlstm.x_q", "mlstm.x_up",
                   "mlstm.x_v"},
}


def test_stack_dim_leaves_are_pinned():
    """ZeRO-1's ``zero_extend`` takes the largest free divisible dim of the
    reference's stacked leaf: on (2, 16, 16) that is the stack dim for 'pod'
    in 81 of the 290 ``m`` leaves of the ten configs (``STACK_POD_LEAVES``);
    on (16, 16) in none. The port gives each layer of such a leaf whole to
    one 'pod' coordinate, the one whose block of layers holds it."""
    counts = {}
    for tag in ("16x16", "2x16x16"):
        mesh, amesh = _meshes(tag)
        n_ref = n_port = total = 0
        for arch in ARCHS:
            cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
            model = specs.abstract_params(cfg)
            p_shapes = jspecs.abstract_params(jcfg)
            m_sh = jopt.opt_state_shardings(p_shapes, amesh, _JOPT)["m"]
            for path, s in jax.tree_util.tree_leaves_with_path(m_sh):
                total += 1
                stacked = any(getattr(k, "key", None) == "groups" for k in path)
                n_ref += bool(stacked and s.spec and s.spec[0] is not None)
            jz = _paired(cfg, model, m_sh, p_shapes)
            leaves, named = set(), set()
            for name, sh in opt_state_shardings(cfg, model, mesh, _OPT)["m"].items():
                if sh.stack is None:
                    continue
                assert sh.stack == "pod" and jz[name].spec[0] == "pod", name
                assert sh.owner(mesh) == sh.layer // (sh.n_stack // 2)
                leaves.add(id(jz[name]))          # one reference leaf, all its layers
                named.add(name.split(".", 2)[2] if name.startswith("blocks.")
                          else "encoder:" + name.split(".", 3)[3])
            assert named == (STACK_POD_LEAVES[arch] if tag == "2x16x16" else set()), arch
            n_port += len(leaves)
        counts[tag] = (n_ref, n_port, total)
    assert counts == {"16x16": (0, 0, 290), "2x16x16": (81, 81, 290)}


# ---------------------------------------------------------- caches and batch
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_jax(arch, tag):
    mesh, amesh = _meshes(tag)
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    seq, batch, _ = specs.SHAPES["decode_32k"]
    caches = specs.abstract_caches(cfg, batch, seq)
    jc = jspecs.abstract_caches(jcfg, batch, seq)
    port = specs.cache_shardings(caches, mesh, batch)["layers"]
    ref = jspecs.cache_shardings(jc, amesh, batch)
    first, n_pat = int(cfg.first_layer_dense), len(cfg.block_pattern)
    nbytes = 0.0
    for i, (layer, sh) in enumerate(zip(caches["layers"], port)):
        if i < first:
            jl, js, lead = jc["first"], ref["first"], 0
        else:
            g, j = divmod(i - first, n_pat)
            jl, js, lead = jc["groups"][j], ref["groups"][j], 1
        assert set(layer) == set(jl), (i, set(layer), set(jl))
        for name, t in layer.items():
            shape = tuple(jl[name].shape)
            assert shape[lead:] == tuple(t.shape), (i, name)
            want = _norm(js[name].spec, len(shape))
            assert want[:lead] == (None,) * lead
            assert _norm(sh[name].spec, t.ndim) == want[lead:], (i, name)
            nbytes += sh[name].bytes_per_device(tuple(t.shape), t.element_size(), mesh)
    ref_bytes = sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                    for s, x in zip(jax.tree.leaves(ref), jax.tree.leaves(jc)))
    assert nbytes == pytest.approx(ref_bytes, rel=1e-12)

    for shape_name, (seq, batch, kind) in specs.SHAPES.items():
        decode = kind == "decode"
        args = (1 if decode else seq, batch, kind == "train")
        got = specs.batch_specs(cfg, mesh, *args, decode=decode)
        want = jspecs.batch_specs(jcfg, amesh, *args, decode=decode)
        assert set(got) == set(want), shape_name
        for k, s in got.items():
            w = want[k]
            assert s.shape == tuple(w.shape) and str(s.dtype).split(".")[1] == str(w.dtype)
            assert _norm(s.sharding.spec, len(s.shape)) == _norm(w.sharding.spec,
                                                                  len(s.shape)), (shape_name, k)


# ---------------------------------------------------------------- context
AXES_CASES = [
    (("data", None), (16, 8)),            # widened to (pod, data) where pod exists
    (("data", None), (64, 8)),
    (("data", None), (2, 8)),             # nothing divides: replicated
    ((("data",), "model"), (32, 32)),
    ((("pod", "data"), None), (16, 4)),   # the suffix: data alone
    (("model", "unknown"), (16, 3)),      # an axis not on the mesh drops
    (("unknown", "model"), (4, 48)),
    ((None, ("data", "model")), (4, 512)),
    (("data", "model"), None),            # pspec: no shape, no divisibility
]


@pytest.mark.parametrize("tag", list(MESHES))
def test_filter_axes_matches_the_reference(tag, monkeypatch):
    mesh, amesh = _meshes(tag)
    monkeypatch.setattr(jctx, "_ACTIVE_MESH", amesh)
    with ctx.use_mesh(mesh):
        assert ctx.get_mesh() is mesh
        for axes, shape in AXES_CASES:
            got, want = ctx._filter_axes(axes, shape), jctx._filter_axes(axes, shape)
            assert _norm(got, len(axes)) == _norm(want, len(axes)), (axes, shape)
        assert ctx.axis_size("model") == mesh.shape["model"]
        assert ctx.axis_size("unknown") == 1
        assert _norm(ctx.pspec("data", None), 2) == _norm(jctx.pspec("data", None), 2)
        x = torch.ones(16, 8)
        assert ctx.shard(x, "data", None) is x    # a plain tensor is a rank's own data
    assert ctx.get_mesh() is None and ctx._filter_axes(("data",)) is None
    assert ctx.pspec("data") == P() and ctx.axis_size("model") == 1


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert sharding.placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert sharding.placements(P(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    assert sharding.placements(P(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(P(("data", "pod")), mesh)


# --------------------------------------------------- process groups, isolated
# A tiny fp32 config whose layer count is the largest dim of its stacked
# leaves, so ZeRO-1 puts 'pod' on the stack dim of every one of them.
STACK_POD = dict(name="stack-pod", n_layers=18, d_model=16, n_heads=2, n_kv_heads=1,
                 d_ff=32, vocab_size=64, tie_embeddings=True, dtype="float32")
CASES = {"2x2": {"shape": [2, 2], "axes": ["data", "model"], "config": "smollm-135m"},
         "2x1x2": {"shape": [2, 1, 2], "axes": ["pod", "data", "model"],
                   "config": STACK_POD}}

WORKER = r'''
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out, cases = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4], json.loads(open(sys.argv[5]).read()))
torch.set_num_threads(1)
if world > 1:
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.context import shard, use_mesh
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import distribute, param_shardings
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import init_params
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, distribute_opt_state,
                                         opt_state_shardings)
from repro_torch.train.step import local_batch, make_train_step, make_zero1_train_step

report = {}
for tag, case in cases.items():
    c = case["config"]
    cfg = (get_smoke_config(c) if isinstance(c, str) else ModelConfig(**c)).with_(
        dtype=case.get("dtype", "float32"))
    gdt = "float32" if cfg.dtype == "float32" else "bfloat16"
    mesh = (make_host_mesh(device="cpu") if case["shape"] == "host"
            else make_mesh(tuple(case["shape"]), tuple(case["axes"]), device="cpu"))
    model = init_params(cfg, 0, device="cpu", trainable=True)
    opt_cfg = AdamWConfig()
    state = adamw_init(model, opt_cfg)
    psh = param_shardings(cfg, model, mesh)
    osh = opt_state_shardings(cfg, model, mesh, opt_cfg)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    rep = {"coord": mesh.get_coordinate(), "local": {}, "whole": True}
    for n, p in params.items():
        d = distribute(p, psh[n], mesh)
        rep["local"]["param " + n] = list(d.to_local().shape)
        f = d.full_tensor()
        rep["whole"] &= f.numel() == 0 or torch.equal(f, p)
    # shard(): the embedding's rows over ('pod', 'data') under the mesh
    with use_mesh(mesh):
        s = shard(distribute(params["embed"], psh["embed"], mesh), "data", None)
    rep["shard"] = [str(x) for x in s.placements]
    rep["whole"] &= torch.equal(s.full_tensor(), params["embed"])
    dstate = distribute_opt_state(state, osh, mesh)
    for key in ("m", "v", "master"):
        for n, d in dstate[key].items():
            rep["local"][key + " " + n] = list(d.to_local().shape)
            f = d.full_tensor()
            rep["whole"] &= f.numel() == 0 or torch.equal(f, state[key][n])
    # one ZeRO-1 step against the step without a mesh, on the same whole batch
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 9)))
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    ref = init_params(cfg, 0, device="cpu", trainable=True)
    ref_state = adamw_init(ref, opt_cfg)
    _, _, rm = make_train_step(cfg, opt_cfg, grad_dtype=gdt)(ref, ref_state, batch)
    step = make_zero1_train_step(cfg, opt_cfg, mesh, osh, grad_dtype=gdt)
    # the step splits the model over 'model' (tensor parallelism), so it takes
    # this rank's part; gathered whole again to be held against the reference
    tp.split_model(cfg, model, mesh)
    _, dstate, zm = step(model, dstate, local_batch(batch, mesh))
    tp.gather_model(cfg, model, mesh)
    errs = {"loss": abs(float(zm["loss"]) - float(rm["loss"])),
            "grad_norm": abs(float(zm["grad_norm"]) - float(rm["grad_norm"]))}
    exact = float(zm["loss"]) == float(rm["loss"])
    for (n, p), q in zip(model.named_parameters(), ref.parameters()):
        errs["param " + n] = float((p - q).abs().max())
        exact &= torch.equal(p, q)
        for key in ("m", "v", "master"):
            f = dstate[key][n].full_tensor()
            if f.numel():
                errs[key + " " + n] = float((f.float() - ref_state[key][n].float()).abs().max())
                exact &= torch.equal(f, ref_state[key][n])
    rep["errs"], rep["exact"] = errs, bool(exact)
    report[tag] = rep
json.dump(report, open(f"{out}/rank{rank}.json", "w"))
if world > 1:
    dist.destroy_process_group()
'''

LAUNCHER = r'''
import subprocess, sys, time
worker, world, store, out, cases = sys.argv[1:6]
procs = [subprocess.Popen([sys.executable, worker, str(r), world, store, out, cases])
         for r in range(int(world))]
deadline = time.time() + 100
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


def _run_ranks(tmp_path, world, cases):
    (tmp_path / "worker.py").write_text(WORKER)
    (tmp_path / "launch.py").write_text(LAUNCHER)
    (tmp_path / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "launch.py"), str(tmp_path / "worker.py"),
         str(world), str(tmp_path / "store"), str(tmp_path), str(tmp_path / "cases.json")],
        env=env, cwd=tmp_path, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail("the ranks did not finish in 120 s:\n" + out[-4000:])
    assert proc.returncode == 0, out[-4000:]
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)]


def _jax_config(c):
    from repro.models.config import ModelConfig as JaxModelConfig
    return jconfigs.get_smoke_config(c) if isinstance(c, str) else JaxModelConfig(**c)


def test_four_gloo_ranks_place_and_step_zero1(tmp_path):
    """Each rank's local shapes against JAX's ``shard_shape`` of the same
    leaf; ``full_tensor()`` the original; the ZeRO-1 step within STEP_TOL of
    the step without a mesh (fp32, the data-parallel mean taken in another
    order)."""
    from repro_torch.train.step import STEP_TOL
    reports = _run_ranks(tmp_path, 4, CASES)
    for tag, case in CASES.items():
        names, sizes = tuple(case["axes"]), tuple(case["shape"])
        mesh, amesh = MeshShape(names, sizes), AbstractMesh(sizes, names)
        c = case["config"]
        cfg = (get_smoke_config(c) if isinstance(c, str) else ModelConfig(**c)).with_(
            dtype="float32")
        jcfg = _jax_config(c).with_(dtype="float32")
        model = specs.abstract_params(cfg)
        p_shapes = jspecs.abstract_params(jcfg)
        jo = jopt.opt_state_shardings(p_shapes, amesh, _JOPT)
        jo_shapes = jax.eval_shape(lambda p: jopt.adamw_init(p, _JOPT), p_shapes)
        trees = {"param": _paired(cfg, model, jsharding.param_shardings(p_shapes, amesh),
                                  p_shapes)}
        for key in ("m", "v", "master"):
            trees[key] = _paired(cfg, model, jo[key], jo_shapes[key])
        ours = {"param": sharding.param_shardings(cfg, model, mesh),
                **opt_state_shardings(cfg, model, mesh, _OPT)}
        held = {}                     # (key, reference leaf, rank) -> layers held
        stacked_pod = 0
        from torch.distributed.tensor import Replicate, Shard
        rows = [str(Shard(0)) if a in ("pod", "data") else str(Replicate())
                for a in names]
        for r, rep in enumerate(reports):
            rep = rep[tag]
            assert rep["whole"], (tag, r)
            assert rep["shard"] == rows, (tag, r, rep["shard"])
            for key, tree in trees.items():
                for name, w in tree.items():
                    sh = ours[key][name]
                    want = NamedSharding(amesh, w.spec).shard_shape(w.shape)
                    local = tuple(rep["local"][f"{key} {name}"])
                    if not sh.n_stack:
                        assert local == want, (tag, r, key, name)
                        continue
                    # the reference's block of layers on this coordinate of the axis
                    if sh.stack is not None and rep["coord"][names.index(sh.stack)] != \
                            sh.layer // want[0]:
                        assert local == (0,), (tag, r, key, name)
                        continue
                    assert local == want[1:], (tag, r, key, name)
                    leaf = (key, id(w))
                    held[leaf + (r,)] = held.get(leaf + (r,), 0) + 1
                    held.setdefault(leaf, want[0])
                    stacked_pod += sh.stack == "pod"
            errs = rep["errs"]
            assert max(errs.values()) < STEP_TOL, (tag, r, max(errs.items(), key=lambda e: e[1]))
        for k, n in held.items():
            if len(k) == 3:               # a rank holds the reference's shard of layers
                assert n == held[k[:2]], (tag, k)
        if tag == "2x1x2":
            assert stacked_pod > 0        # the stack dim carries 'pod' here


def test_one_rank_zero1_step_is_the_plain_step_bit_for_bit(tmp_path):
    """The (1, 1) host mesh of one rank (a HashStore rendezvous): every shard
    is the whole tensor and the ZeRO-1 step equals the plain one exactly, in
    bf16 as the card runs it."""
    cases = {"host": {"shape": "host", "config": "smollm-135m", "dtype": "bfloat16"}}
    rep = _run_ranks(tmp_path, 1, cases)[0]["host"]
    assert rep["coord"] == [0, 0] and rep["whole"]
    assert rep["exact"], rep["errs"]
