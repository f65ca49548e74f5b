"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX package's.

* ``SHAPES``, ``default_accum`` and ``model_flops`` equal the reference's for
  every config and cell shape.
* The FLOPs ``FlopCounterMode`` counts for a meta-device step equal the
  reference's trip-count-aware count (``repro.launch.hlo_cost.analyze`` on
  the step compiled for one CPU device) on two smoke configs, a dense and an
  MoE one: the prefill exactly, and the train step exactly once one gap is
  added, the reference's second Q K^T a layer (its flash scan body is
  itself rematerialised, ``src/repro/models/attention.py:120``, inside the
  layer's remat; the port recomputes each layer once, ``remat="full"``).
* A cell's per-device bytes (parameters, optimizer state, batch, caches)
  equal the sum of JAX's ``shard_shape`` bytes of the same inputs.
* The CLI prints one JSON line a cell, a skip with the reference's reason,
  and runs with JAX and the JAX package blocked.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.hlo_cost import analyze  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro.distributed.sharding import param_shardings as jparam_shardings  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import use_mesh  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.lm import forward  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'

ROOT = Path(__file__).resolve().parents[1]


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without its ``XLA_FLAGS`` (512 host
    devices) reaching this process's JAX."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return jdryrun


def test_accum_and_model_flops_equal_the_reference():
    jdryrun = _reference_dryrun()
    for arch in ARCHS:
        assert dryrun.default_accum(arch) == jdryrun.default_accum(arch)
        for shape in specs.SHAPES:
            assert dryrun.model_flops(get_config(arch), shape) == \
                jdryrun.model_flops(jget_config(arch), shape), (arch, shape)


# ------------------------------------------------------------ counted FLOPs
B, S, ACCUM = 4, 64, 2


def _jax_batch(cfg, labels):
    out = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if labels:
        out["labels"] = jax.ShapeDtypeStruct((B, S), jnp.int32)
    return out


def _meta(batch):
    return {k: torch.zeros(v.shape, dtype=torch.int32, device="meta")
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-3b-a800m"])
def test_counted_train_flops_match_hlo_cost(arch):
    jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
    p = jspecs.abstract_params(jcfg)
    o = jax.eval_shape(lambda p: jopt.adamw_init(p, jopt.AdamWConfig()), p)
    batch = _jax_batch(jcfg, labels=True)
    step = jax.jit(jmake_train_step(jcfg, jopt.AdamWConfig(), accum=ACCUM))
    ref = analyze(step.lower(p, o, batch).compile().as_text()).flops
    model = specs.abstract_params(cfg, trainable=True)
    state = adamw_init(model, AdamWConfig())
    with FlopCounterMode(display=False) as counter:
        make_train_step(cfg, AdamWConfig(), accum=ACCUM, attn_impl="plain",
                        mlstm_impl="plain")(model, state, _meta(batch))
    # the reference's flash scan recomputes Q K^T once more in its backward
    second_qk = 2 * B * cfg.n_heads_padded * S * S * cfg.head_dim_ * cfg.n_layers
    assert cfg.remat == "full"
    assert counter.get_total_flops() + second_qk == ref
    assert 0.97 < counter.get_total_flops() / ref < 1.0


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-3b-a800m"])
def test_counted_prefill_flops_match_hlo_cost(arch):
    jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
    p = jspecs.abstract_params(jcfg)
    batch = _jax_batch(jcfg, labels=False)
    fn = jax.jit(lambda p, b: jlm.forward(jcfg, p, b, want_caches=True)[0])
    ref = analyze(fn.lower(p, batch).compile().as_text()).flops
    model = specs.abstract_params(cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        forward(cfg, model, _meta(batch), want_caches=True, attn_impl="plain")
    assert counter.get_total_flops() == ref


# ------------------------------------------------------------ per-device bytes
def _ref_bytes(shardings, shapes):
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for s, x in zip(jax.tree.leaves(shardings), jax.tree.leaves(shapes)))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_cell_bytes_match_jax_shard_shapes(shape, multi_pod):
    arch = "qwen3-8b"
    mesh = make_production_mesh(multi_pod=multi_pod)
    amesh = AbstractMesh(mesh.axis_sizes, mesh.axis_names)
    cfg, jcfg = get_config(arch), jget_config(arch)
    seq, batch, kind = specs.SHAPES[shape]
    got = dryrun.cell_bytes(cfg, shape, mesh)
    p = jspecs.abstract_params(jcfg)
    want = {"params": _ref_bytes(jparam_shardings(p, amesh), p)}
    if kind == "train":
        opt = jopt.AdamWConfig()
        o = jax.eval_shape(lambda p: jopt.adamw_init(p, opt), p)
        want["opt_state"] = _ref_bytes(jopt.opt_state_shardings(p, amesh, opt), o)
        b = jspecs.batch_specs(jcfg, amesh, seq, batch, with_labels=True)
    else:
        c = jspecs.abstract_caches(jcfg, batch, seq)
        want["caches"] = _ref_bytes(jspecs.cache_shardings(c, amesh, batch), c)
        b = jspecs.batch_specs(jcfg, amesh, 1, batch, with_labels=False, decode=True)
    want["batch"] = sum(math.prod(x.sharding.shard_shape(x.shape)) * x.dtype.itemsize
                        for x in b.values())
    assert set(got) == set(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


# --------------------------------------------------------------------- CLI
def test_cli_prints_a_line_a_cell(capsys):
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--both-meshes"])
    dryrun.main(["--arch", "qwen3-8b", "--shape", "long_500k"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in lines] == [
        ("smollm-135m", "decode_32k", "16x16", "ok"),
        ("smollm-135m", "decode_32k", "2x16x16", "ok"),
        ("qwen3-8b", "long_500k", "16x16", "skip")]
    assert lines[2]["reason"] == jspecs.cell_supported("qwen3-8b", "long_500k")[1]
    one, two = lines[:2]
    assert one["flops_per_device"] == 2 * two["flops_per_device"] > 0
    assert one["devices"] == 256 and two["devices"] == 512
    cfg = get_config("smollm-135m").with_(decode_seq_shards=16)
    assert one["model_flops_per_device"] == dryrun.model_flops(cfg, "decode_32k") / 256
    assert one["useful_flops_ratio"] == pytest.approx(
        one["model_flops_per_device"] / one["flops_per_device"])
    assert one["roofline"]["compute_s"] == one["flops_per_device"] / 989e12
    for key in ("temp_bytes", "collectives", "raw_cpu_hlo"):
        assert key in one["nulls"] and one["nulls"][key]
    assert one["memory"]["temp_bytes"] is None and one["collectives"] is None
    assert one["roofline"]["collective_s"] is None
    assert one["port_step"] is None and one["nulls"]["port_step"] and one["layout"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_port_step_of_a_train_cell(multi_pod):
    """A dense attn+mlp train cell's ``port_step``: the port splits the model
    over 'model' (``distributed/tp.py``), so its parameters, optimizer state
    and batch are laid out as the rules lay them (the reference's plan,
    equal to JAX's shard shapes by ``test_cell_bytes_match_jax_shard_shapes``)
    and its FLOPs split over every device."""
    r = dryrun.run_cell("smollm-135m", "train_4k", multi_pod)
    port, nbytes = r["port_step"], r["memory"]["bytes_per_device"]
    whole = sum(p.numel() * p.element_size()
                for p in specs.abstract_params(get_config("smollm-135m")).parameters())
    assert port["bytes_per_device"] == nbytes
    assert nbytes["params"] < whole
    assert port["flops_per_device"] == r["flops_per_device"]
    assert port["compute_s"] == port["flops_per_device"] / 989e12
    assert port["layout"].startswith("split over 'model'")
    assert "port_step" not in r["nulls"]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-lite-16b"])
def test_port_step_of_a_split_moe_or_mla_train_cell(arch, multi_pod):
    """An MoE (granite, attn+moe) or MLA + MoE (deepseek-v2-lite, with its
    dense mla+mlp first layer) train cell's ``port_step``: the port splits
    the experts and MLA's heads over 'model', so the cell is laid out as the
    rules lay it, like the dense one's, and its FLOPs, counted with the
    mesh's 'pod' x 'data' token groups, split over every device."""
    r = dryrun.run_cell(arch, "train_4k", multi_pod)
    port, nbytes = r["port_step"], r["memory"]["bytes_per_device"]
    whole = sum(p.numel() * p.element_size()
                for p in specs.abstract_params(get_config(arch)).parameters())
    assert port["bytes_per_device"] == nbytes and nbytes["params"] < whole / 8
    assert port["flops_per_device"] == r["flops_per_device"]
    assert port["layout"].startswith("split over 'model'")
    mesh = make_production_mesh(multi_pod=multi_pod)
    with use_mesh(mesh):
        flops, _ = dryrun.count_flops(get_config(arch).with_(decode_seq_shards=16), "train_4k",
                                      dryrun.default_accum(arch))
    assert r["flops_per_device"] == flops / mesh.size


def test_port_step_of_a_train_cell_the_port_does_not_split():
    """A train cell whose split ``tp.check_split`` refuses (qwen3-8b with 48
    q heads over 12 kv heads: 3 q heads a rank on 16 'model' ranks straddle
    the kv groups of 4, ROADMAP item 7d) gets the step the port can run:
    its data-parallel step on the same 256 devices with 'model' folded into
    'data' (16x16 -> 256x1): parameters whole on each rank, the optimizer
    state and batch as the rules lay them out on that mesh, and its FLOPs
    split over every device."""
    cfg = get_config("qwen3-8b").with_(n_heads=48, n_kv_heads=12)
    mesh = make_production_mesh(multi_pod=False)
    with use_mesh(mesh):
        nbytes = dryrun.cell_bytes(cfg, "train_4k", mesh)
    port = dryrun.port_step(cfg, "train_4k", mesh, nbytes, 1e18)
    whole = sum(p.numel() * p.element_size() for p in specs.abstract_params(cfg).parameters())
    fold = dryrun.folded(mesh)
    assert fold.shape == {"data": 256, "model": 1}
    with use_mesh(fold):
        assert port["bytes_per_device"] == dryrun.cell_bytes(cfg, "train_4k", fold)
    assert port["bytes_per_device"]["params"] == whole > nbytes["params"]
    # the state goes ZeRO-1 over all 256 ranks, not 16 'data' ranks of a split
    assert port["bytes_per_device"]["opt_state"] < nbytes["opt_state"]
    assert port["flops_per_device"] == 1e18 / 256
    assert port["compute_s"] == port["flops_per_device"] / 989e12
    assert "ROADMAP item 7d" in port["layout"] and "straddle" in port["layout"]
    assert "256x1" in port["layout"]


def test_port_step_of_an_encoder_decoder_train_cell():
    """whisper-small's train cell: the port splits the encoder-decoder over
    'model' now, so its ``port_step`` is the rules' plan, the dense cell's
    layout. Its 12 heads stay whole on 16 'model' ranks (every rank computes
    them all), its MLP and vocabulary split."""
    r = dryrun.run_cell("whisper-small", "train_4k", False)
    port, nbytes = r["port_step"], r["memory"]["bytes_per_device"]
    whole = sum(p.numel() * p.element_size()
                for p in specs.abstract_params(get_config("whisper-small")).parameters())
    assert port["bytes_per_device"] == nbytes and nbytes["params"] < whole
    assert port["flops_per_device"] == r["flops_per_device"]
    assert port["layout"].startswith("split over 'model'")


def test_cli_runs_without_jax(tmp_path):
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.launch.dryrun import main\n"
        "main(['--arch', 'whisper-small', '--shape', 'decode_32k', '--out', sys.argv[1]])\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout)
    assert line["status"] == "ok" and line["memory"]["bytes_per_device"]["caches"] > 0
    saved = tmp_path / "whisper-small__decode_32k__16x16.json"
    assert json.loads(saved.read_text()) == line
