"""Dry run: every (architecture × shape) cell at full size on the meta device.

Port of ``src/repro/launch/dryrun.py``. Each cell builds its step at full
size on ``torch.device("meta")``, where a tensor has a shape and a dtype and
no memory, lays its inputs out by the sharding rules on the 16x16 single-pod
mesh or the 2x16x16 multi-pod mesh (``MeshShape``s: no process group, no
device), and runs the step once:

    train    make_train_step (AdamW, ``default_accum`` microbatches)
    prefill  forward(want_caches=True)
    decode   decode_step, with decode_seq_shards = the mesh's 'model' size

Attention and the mLSTM scan run through their kernels' plain versions
(``impl="plain"``): the kernels launch only on the card. The matrix-product
FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``, which sees
every trip of every loop, the job ``hlo_cost.py`` does for XLA's scan bodies
in the reference. torch makes no HLO, so ``hlo_cost.py`` has no twin here,
and what only XLA's compiled artifact gives is ``null`` with a reason: the
temporaries, the collectives and the raw CPU-HLO figures. Per-device bytes
of the parameters, optimizer state, batch and caches come from the rules'
shard shapes. Roofline terms use an H100 SXM's datasheet figures (989e12
dense bf16 FLOP/s, 3.35e12 B/s of HBM), with the counted FLOPs split evenly
over the mesh's devices. The step is the global one on either mesh, so
a process counts each (config, shape) once for both.

Those bytes and FLOPs follow the reference's plan, which splits the
parameters over 'model' (tensor parallelism). A train cell's line also
carries ``port_step``, the port's own ZeRO-1 step on the mesh: split over
'model' as the rules lay it out (``distributed/tp.py``), every block kind
and wrapper, so its bytes are the plan's and its FLOPs are split over every
device. Only a split that ``tp.check_split`` refuses (ranks straddling kv
groups or the mLSTM's qkv blocks, ROADMAP item 7d; no registered config on
these meshes) would be reported as the data-parallel step the port runs on
the same devices with 'model' folded into 'data': parameters whole on each
rank, the optimizer state and batch over every rank, FLOPs split over every
device. An MoE cuts its tokens into the mesh's 'pod' x 'data' groups, as
the reference's does, so its FLOPs are counted for each mesh.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes --out results/
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..distributed import tp
from ..distributed.context import axis_size, use_mesh
from ..distributed.sharding import param_shardings
from ..models.lm import decode_step, forward
from ..train.optimizer import AdamWConfig, adamw_init, opt_state_shardings
from ..train.step import make_train_step
from .h100 import HBM_BW, PEAK_FLOPS   # H100 SXM datasheet figures
from .mesh import MeshShape, make_production_mesh
from .specs import (SHAPES, abstract_caches, abstract_params, batch_specs,
                    cache_shardings, cell_supported)

_NO_HLO = "torch compiles no HLO for a meta-device step"
NULLS = {
    "temp_bytes": _NO_HLO + ": the temporaries are XLA's buffer assignment",
    "collectives": _NO_HLO + ": the collectives are what XLA's SPMD partitioner "
                   "inserts; the port runs no partitioner",
    "raw_cpu_hlo": _NO_HLO,
}
_NO_PORT_MESH = ("port_step reckons train cells only: the port's split prefill and "
                 "decode hold the cache by kv heads (attention) or whole (MLA's latent) "
                 "where the reference splits it on the sequence, and are not laid out here")
LAYOUT = ("memory.bytes_per_device, flops_per_device and roofline follow the "
          "reference's plan: parameters split over 'model' by the rules (tensor "
          "parallelism) and the step's FLOPs split over every device. For a train "
          "cell, port_step gives the port's own ZeRO-1 step: the same plan, which the "
          "port splits over 'model' for every block kind and wrapper; for a split it "
          "refuses (ranks straddling kv groups or the mLSTM's qkv blocks), the "
          "data-parallel step it runs on the same devices with 'model' folded into "
          "'data'")
_SPLIT = ("split over 'model' as the rules lay it out (distributed/tp.py): the plan's "
          "bytes, FLOPs split evenly over every device (a leaf the rules leave whole, "
          "such as heads 'model' does not divide, MLA's w_dkv or the MoE's router, "
          "repeats its products on each 'model' rank, which this even split does not "
          "count)")


def model_flops(cfg, shape_name: str) -> float:
    """6*N_active*D for training, 2*N_active*D for inference (per step)."""
    seq, batch, kind = SHAPES[shape_name]
    _total, active = cfg.count_params()
    if kind == "train":
        tokens = seq * batch
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = seq * batch
        return 2.0 * active * tokens
    return 2.0 * active * batch  # decode: one token per sequence


def default_accum(arch: str) -> int:
    big = {"deepseek-67b": 8, "jamba-1.5-large-398b": 8,
           "llava-next-34b": 8, "starcoder2-15b": 8, "qwen3-8b": 4,
           "deepseek-v2-lite-16b": 4}
    return big.get(arch, 1)


def _bytes(tensors: Dict[str, torch.Tensor], shardings: Dict, mesh) -> float:
    return sum(shardings[n].bytes_per_device(tuple(t.shape), t.element_size(), mesh)
               for n, t in tensors.items())


def _opt_cfg(cfg) -> AdamWConfig:
    return AdamWConfig(
        moments_dtype="bfloat16" if cfg.count_params()[0] > 2e11 else "float32")


def param_bytes(cfg, mesh) -> float:
    """The parameters' bytes a device on ``mesh`` (a ``MeshShape`` or a
    ``DeviceMesh``), from the rules' shard shapes: what a rank of the
    port's split over 'model' holds."""
    model = abstract_params(cfg)
    return _bytes(dict(model.named_parameters()), param_shardings(cfg, model, mesh), mesh)


def cell_bytes(cfg, shape_name: str, mesh: MeshShape) -> Dict[str, float]:
    """Per-device bytes of the cell's inputs by kind, from the shard shapes
    of the rules: parameters, the optimizer state (train), the batch, and
    the caches (decode's input, prefill's output)."""
    seq, batch, kind = SHAPES[shape_name]
    model = abstract_params(cfg)
    out = {"params": param_bytes(cfg, mesh)}
    if kind == "train":
        opt_cfg = _opt_cfg(cfg)
        state = adamw_init(model, opt_cfg)
        shard = opt_state_shardings(cfg, model, mesh, opt_cfg)
        out["opt_state"] = sum(_bytes(state[k], shard[k], mesh)
                               for k in ("m", "v", "master") if k in state
                               ) + state["step"].element_size()
    else:
        caches = abstract_caches(cfg, batch, seq)
        shard = cache_shardings(caches, mesh, batch)["layers"]
        out["caches"] = sum(_bytes(c, sh, mesh) for c, sh in zip(caches["layers"], shard))
    specs = batch_specs(cfg, mesh, 1 if kind == "decode" else seq, batch,
                        with_labels=kind == "train", decode=kind == "decode")
    out["batch"] = sum(s.sharding.bytes_per_device(s.shape, s.dtype.itemsize, mesh)
                       for s in specs.values())
    return out


def build_cell(cfg, shape_name: str, accum: int):
    """``run()``: the cell's step, once, at full size on the meta device.
    The step is the global one, whatever the mesh: the mesh lays out its
    inputs and splits its FLOPs."""
    seq, batch, kind = SHAPES[shape_name]
    model = abstract_params(cfg, trainable=kind == "train")
    any_mesh = make_production_mesh()     # the batch's shapes are any mesh's
    if kind == "train":
        opt_cfg = _opt_cfg(cfg)
        state = adamw_init(model, opt_cfg)
        specs = batch_specs(cfg, any_mesh, seq, batch, with_labels=True)
        step = make_train_step(cfg, opt_cfg, accum=accum, attn_impl="plain",
                               mlstm_impl="plain")
        return lambda: step(model, state, {k: s.meta() for k, s in specs.items()})
    if kind == "prefill":
        specs = batch_specs(cfg, any_mesh, seq, batch, with_labels=False)

        @torch.no_grad()
        def prefill():
            return forward(cfg, model, {k: s.meta() for k, s in specs.items()},
                           want_caches=True, attn_impl="plain", mlstm_impl="plain")
        return prefill
    caches = abstract_caches(cfg, batch, seq)
    tok = batch_specs(cfg, any_mesh, 1, batch, with_labels=False, decode=True)["tokens"]
    return lambda: decode_step(cfg, model, caches, tok.meta(), seq - 1)


_COUNTS: Dict[tuple, Tuple[float, float]] = {}


def count_flops(cfg, shape_name: str, accum: int) -> Tuple[float, float]:
    """``(FLOPs, seconds)`` of the cell's step under the ambient mesh,
    counted once a process for each (config, shape, accum): both meshes
    share the count, but for an MoE, whose token groups are the mesh's
    'pod' x 'data' (``moe._groups``)."""
    groups = axis_size("pod") * axis_size("data") if cfg.moe is not None else 1
    key = (cfg, shape_name, accum, groups)
    if key not in _COUNTS:
        t0 = time.time()
        run = build_cell(cfg, shape_name, accum)
        with FlopCounterMode(display=False) as counter:
            run()
        _COUNTS[key] = (float(counter.get_total_flops()), time.time() - t0)
    return _COUNTS[key]


def folded(mesh: MeshShape) -> MeshShape:
    """``mesh`` with its 'model' ranks folded into 'data': the mesh on which
    the port runs, data-parallel, a model it does not split over 'model'."""
    sizes = mesh.shape
    return MeshShape(mesh.axis_names, tuple(
        sizes["data"] * sizes["model"] if a == "data" else 1 if a == "model" else n
        for a, n in sizes.items()))


def port_step(cfg, shape_name: str, mesh: MeshShape, nbytes: Dict[str, float],
              flops: float):
    """The port's own layout of a train cell, beside the reference's plan.
    ``make_zero1_train_step`` splits the model over 'model' as the rules
    do, so its bytes are ``nbytes`` and its FLOPs are split over every
    device. A split ``tp.check_split`` refuses (ranks straddling kv groups
    or the mLSTM's qkv blocks, ROADMAP item 7d) raises on ``mesh``: its
    figures are then those of the step the port runs on the same devices
    with 'model' folded into 'data' (``folded``), the rules' layout on that
    mesh: parameters whole on each rank, the optimizer state ZeRO-1 over
    every rank, the batch split over every rank, FLOPs split over every
    device. ``layout`` says which. ``None`` for prefill and decode
    (``_NO_PORT_MESH``)."""
    if SHAPES[shape_name][2] != "train":
        return None
    flops_dev = flops / mesh.size
    try:
        tp.check_split(cfg, mesh)
    except NotImplementedError as e:
        fold = folded(mesh)
        with use_mesh(fold):
            fbytes = cell_bytes(cfg, shape_name, fold)
        return {"bytes_per_device": fbytes,
                "flops_per_device": flops_dev, "compute_s": flops_dev / PEAK_FLOPS,
                "layout": f"not split: {e}. The figures are the port's data-parallel "
                          f"step on the {fold.tag} mesh, 'model' folded into 'data': "
                          "parameters whole on each rank, the optimizer state and the "
                          "batch as the rules lay them out there, FLOPs split over "
                          "every device"}
    return {"bytes_per_device": dict(nbytes), "flops_per_device": flops_dev,
            "compute_s": flops_dev / PEAK_FLOPS, "layout": _SPLIT}


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    ok, why = cell_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh.tag,
                "status": "skip", "reason": why}
    cfg = get_config(arch).with_(decode_seq_shards=mesh.shape["model"])
    accum = default_accum(arch)
    with use_mesh(mesh):
        nbytes = cell_bytes(cfg, shape_name, mesh)
        flops, count_s = count_flops(cfg, shape_name, accum)
    flops_dev = flops / mesh.size
    arg_bytes = sum(nbytes.values())
    mf = model_flops(cfg, shape_name)
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": arg_bytes / HBM_BW,
             "collective_s": None}
    port = port_step(cfg, shape_name, mesh, nbytes, flops)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh.tag,
        "status": "ok",
        "accum": accum,
        "remat": cfg.remat,
        "attn_chunk": cfg.attn_chunk,
        "count_s": count_s,
        "devices": mesh.size,
        "layout": LAYOUT,
        "memory": {"bytes_per_device": nbytes,
                   "argument_bytes_per_device": arg_bytes,
                   "temp_bytes": None},
        "flops_per_device": flops_dev,
        "flops_counted_by": "torch.utils.flop_counter.FlopCounterMode: the "
                            "matrix products of the global step, split evenly "
                            "over the devices",
        "collectives": None,
        "raw_cpu_hlo": None,
        "nulls": dict(NULLS, port_step=_NO_PORT_MESH) if port is None else NULLS,
        "roofline": terms,
        "roofline_basis": {"peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                           "card": "H100 SXM datasheet",
                           "memory_s": "argument bytes per device, read once"},
        "port_step": port,
        "model_flops_per_device": mf / mesh.size,
        "useful_flops_ratio": (mf / mesh.size) / flops_dev if flops_dev else 0.0,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                res = run_cell(arch, shape, mp)
                line = json.dumps(res)
                print(line, flush=True)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = f"{args.out}/{arch}__{shape}__{res['mesh']}.json"
                    with open(fn, "w") as f:
                        f.write(line)


if __name__ == "__main__":
    main()
