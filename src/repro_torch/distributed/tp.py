"""Tensor parallelism over the mesh's 'model' axis, Megatron style.

The reference splits the weights over 'model' by the rules of
``distributed/sharding.py`` and pins its activations to that axis with
``shard()``; XLA's partitioner then writes the collectives. torch runs no
partitioner, so the port writes them at the reference's ``shard()`` sites,
on plain local tensors and four autograd functions:

* ``copy_to_model`` (identity forward, all-reduce backward) where a
  replicated activation enters a column-parallel product: q, k and v on the
  rank's heads (``src/repro/models/attention.py:202``, ``:239-240``; a
  cross attention's k and v of the encoder's output too), MLA's q, k and v
  on the rank's heads (``:290-291``), the MLP's ``w_in``/``w_gate`` on its
  ``d_ff`` slice (``layers.py:67``), the tokens and gates of the MoE's
  dispatch and combine on the rank's experts (``moe.py:108``), Mamba's
  ``m_in`` and xLSTM's ``x_up`` on the rank's inner channels
  (``ssm.py:70``, ``xlstm.py:112``), the head on its vocabulary slice
  (``lm.py:289``);
* ``reduce_from_model`` (all-reduce forward, identity backward) where a
  row-parallel product's partial sums come back replicated: after ``wo``
  (``attention.py:245``, ``:296``), ``w_out`` (``lm.py:153``), Mamba's
  ``m_out`` and xLSTM's ``x_out`` (``ssm.py:107``, ``xlstm.py:137``), the
  MoE's combine (the reference gathers the expert outputs over 'model'
  instead, ``moe.py:115``: G·E·C·D numbers where this moves T·D), and after
  the vocab-parallel embedding lookup (``lm.py:242``, ``:264``);
* ``reduce_to_model``, both at once (all-reduce forward and backward),
  where a row-parallel product's sum is then read only in part by each
  rank: Mamba's ``dt_in``/B/C from ``m_xproj`` feed the rank's channels
  alone, and the mLSTM's gates from ``x_if`` the rank's heads or channels.
  Without the backward's sum, the gradient of the weights before it would
  be one rank's share. ``gather_channels`` makes a channel-split tensor
  whole the same way (its backward an all-reduce, then the rank's
  channels), for the mLSTM whose heads 'model' does not divide.

The only collectives on the 'model' group are ``all_reduce`` and
``broadcast``, so one program runs on NCCL across cards and on gloo ranks
sharing one card. Sums cross ranks in fp32. A checkpoint gathers a split
leaf, or a ZeRO-1 chunk, by ``broadcast`` alone (``gather_to_host``: each
distinct chunk from the first rank that holds it), which keeps its bits.

A dim splits leaf by leaf, exactly as the rules decide it: only where
'model' divides it. So a split can be mixed. Where ``wq`` splits and
``wk``/``wv`` do not ('model' divides H but not KH), each rank's H/m q
heads lie in one kv group of G = H/KH that several ranks share, and the
rank takes that kv head (q head h reads kv head h // G, the flash kernel's
mapping). Where a rank's q heads would straddle kv groups instead (H/m does
not divide G), ``check_split`` refuses the split (ROADMAP item 7d); no
registered configuration meets that on the meshes the repo names. The replicated
weights those heads read (``wk``, ``wv``, the qk-norm scales; MLA's
``w_dkv`` and ``kv_norm``) pass through ``copy_to_model`` too, so their
partial gradients are summed over 'model'. Where ``wq`` stays whole (whisper's
12 heads on 16 ranks), every rank computes every head. The MoE splits its
experts (``e_in``, ``e_gate``, ``e_out`` on E) and keeps the router whole:
every rank routes every token alike, and runs only its own experts' slots.
Its shared experts split on their own width (``shared_group``).

Mamba (``channel_group`` of ``m_in``) splits ``m_in``, ``m_conv``, ``m_dt``, ``m_dtb``,
``m_alog`` and ``m_d`` on its inner channels Di, and ``m_xproj`` and
``m_out`` row-parallel: the conv, the scan and the decode state run on the
rank's channels. xLSTM (``channel_group`` of ``x_up``) splits ``x_up`` on Di, the
block-diagonal ``x_q``/``x_k``/``x_v`` on their blocks, and ``x_if`` and
``x_out`` row-parallel. Where 'model' divides the heads, a rank's channels
are its heads and the mLSTM runs them alone; where it does not (xlstm-1.3b's
4 heads on 16 ranks), q, k and v are gathered whole and every rank runs
every head, keeping its own channels of h, as the reference keeps its heads
replicated. Where 'model' divides Di but not its Di/4 qkv blocks, a rank's
channels would straddle a block, and ``check_split`` refuses the split
(ROADMAP item 7d; no registered configuration meets it). The sLSTM stays
whole, every rank computing it alike. The encoder-decoder's encoder and
cross attention split as attention does, its ``pos_embed`` whole; a VLM's
``vision_proj`` stays whole and its prefix enters before the
vocab-parallel embedding's rows with no collective.

A split runs where the ambient mesh (``use_mesh``) is a ``DeviceMesh`` whose
'model' axis has more than one rank, for every block kind and wrapper the
port has. A ``MeshShape``, such as the dry run's production meshes, has no
process group and runs no split.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..launch.mesh import Mesh, MeshShape, describe
from ..models.config import ModelConfig
from .context import get_mesh
from .sharding import _spec_for, box_index, chunk_box, param_shardings

ROADMAP_ITEM = "ROADMAP item 7d"


@dataclass(frozen=True)
class ModelGroup:
    """The 'model' process group of a mesh, its size and this rank's
    coordinate on it."""
    group: dist.ProcessGroup
    size: int
    rank: int


def model_group(mesh: Optional[Mesh] = None) -> Optional[ModelGroup]:
    """The 'model' group of ``mesh`` (default the ambient mesh) where it is a
    ``DeviceMesh`` with more than one rank on 'model'; else None."""
    mesh = get_mesh() if mesh is None else mesh
    if not isinstance(mesh, DeviceMesh) or "model" not in (mesh.mesh_dim_names or ()):
        return None
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    if size == 1:
        return None
    return ModelGroup(mesh.get_group("model"), size, mesh.get_local_rank("model"))


# ------------------------------------------------------------ collectives
def _summed_over(t: torch.Tensor, groups: list) -> torch.Tensor:
    acc = torch.empty(t.shape, dtype=torch.float32, device=t.device).copy_(t)
    for g in groups:
        dist.all_reduce(acc, group=g)
    return acc.to(t.dtype)


def summed(t: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """``t`` summed over the 'model' group in fp32, in ``t``'s dtype; ``t``
    itself is left as it was."""
    return _summed_over(t, [mg.group])


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return summed(grad, ctx.mg), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return summed(x, mg)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        n = x.shape[-1]
        full = x.new_zeros(x.shape[:-1] + (n * mg.size,))
        full[..., mg.rank * n:(mg.rank + 1) * n] = x
        return summed(full, mg)

    @staticmethod
    def backward(ctx, grad):
        mg = ctx.mg
        n = grad.shape[-1] // mg.size
        return summed(grad, mg).narrow(-1, mg.rank * n, n), None


def copy_to_model(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """Identity forward, gradient summed over 'model': a replicated tensor
    entering this rank's part of a product. ``mg`` None: ``x``."""
    return x if mg is None else _CopyToModel.apply(x, mg)


def reduce_from_model(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """Partial sums summed over 'model', gradient passed through: a
    row-parallel product made replicated. ``mg`` None: ``x``."""
    return x if mg is None else _ReduceFromModel.apply(x, mg)


def reduce_to_model(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """Partial sums summed over 'model', and the gradient summed too: a
    row-parallel product made replicated that each rank then reads only in
    part (its channels or heads), so each rank's gradient of the sum is a
    share. ``mg`` None: ``x``."""
    return copy_to_model(reduce_from_model(x, mg), mg)


def gather_channels(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """The whole last dim (..., m n) from this rank's contiguous slice
    (..., n), by an all-reduce of a zero-filled whole buffer; its gradient
    summed over 'model', then narrowed to the rank's slice (every rank's
    loss reads the whole tensor in its own part). ``mg`` None: ``x``."""
    return x if mg is None else _GatherChannels.apply(x, mg)


# ------------------------------------------------------------ the split plan
def _split_dim(name: str, shape: Tuple[int, ...],
               mesh: Optional[Mesh] = None) -> Optional[int]:
    """The dim of leaf ``name`` (its whole ``shape``) that the rules split
    over 'model' on ``mesh`` (default the ambient mesh), or None."""
    spec = _spec_for(name, shape, get_mesh() if mesh is None else mesh)
    return next((i for i, a in enumerate(spec) if a == "model"), None)


def _kv_group_run(cfg: ModelConfig, mesh: Mesh) -> Optional[Tuple[int, int]]:
    """``(H/m, G)`` where the rules split ``wq`` over 'model' on ``mesh``
    and keep ``wk``/``wv`` whole, so each rank reads its q heads' kv head
    of the replicated ones; else None."""
    D, H, KH, Dh = cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads, cfg.head_dim_
    if (_split_dim("wq", (D, H, Dh), mesh) is None
            or _split_dim("wk", (D, KH, Dh), mesh) is not None):
        return None
    return H // describe(mesh).shape["model"], H // KH


@dataclass(frozen=True)
class HeadSplit:
    """This rank's attention heads: q heads ``rank * H/m`` on, and the
    ``n_kv`` kv heads they read, those in its cache. ``kv0`` None: ``wk``/
    ``wv`` split by the rules and the rank holds its own KH/m; else the one
    kv head (``n_kv`` 1) this rank's q heads share, taken of the replicated
    ``wk``/``wv``."""
    mg: ModelGroup
    kv0: Optional[int]
    n_kv: int

    def local_kv(self, w: torch.Tensor) -> torch.Tensor:
        """The rank's kv heads of ``wk`` or ``wv`` (D, KH, Dh)."""
        if self.kv0 is None:
            return w
        return copy_to_model(w, self.mg).narrow(1, self.kv0, self.n_kv)


def head_split(cfg: ModelConfig) -> Optional[HeadSplit]:
    """The split of attention on the ambient mesh; None where there is no
    'model' group or the rules keep ``wq`` whole (every rank then computes
    all heads)."""
    mg = model_group()
    if mg is None:
        return None
    H, KH = cfg.n_heads_padded, cfg.n_kv_heads
    if _split_dim("wq", (cfg.d_model, H, cfg.head_dim_)) is None:
        return None
    run = _kv_group_run(cfg, get_mesh())
    if run is None:
        return HeadSplit(mg, None, KH // mg.size)
    Hl, G = run
    if G % Hl:
        check_split(cfg)                          # raises
    return HeadSplit(mg, mg.rank * Hl // G, 1)


def cache_kv_heads(cfg: ModelConfig) -> int:
    """The kv heads of this rank's self-attention cache."""
    sp = head_split(cfg)
    return cfg.n_kv_heads if sp is None else sp.n_kv


def ff_group(cfg: ModelConfig, d_ff: int = 0) -> Optional[ModelGroup]:
    """The 'model' group where the rules split an MLP of width ``d_ff``
    (default ``cfg.d_ff``); else None."""
    mg = model_group()
    if mg is None or _split_dim("w_in", (cfg.d_model, d_ff or cfg.d_ff)) is None:
        return None
    return mg


def shared_group(cfg: ModelConfig) -> Optional[ModelGroup]:
    """The 'model' group where the rules split the MoE's shared experts, an
    MLP of width ``n_shared * d_expert`` (not ``cfg.d_ff``); else None."""
    m = cfg.moe
    return ff_group(cfg, m.n_shared * m.d_expert) if m.n_shared else None


def expert_group(cfg: ModelConfig) -> Optional[ModelGroup]:
    """The 'model' group where the rules split the experts over E (``e_in``,
    ``e_gate``, ``e_out``); else None (every rank holds them all)."""
    mg = model_group()
    E = cfg.n_experts_padded
    if mg is None or _split_dim("e_in", (E, cfg.d_model, cfg.moe.d_expert)) is None:
        return None
    return mg


def mla_group(cfg: ModelConfig) -> Optional[ModelGroup]:
    """The 'model' group where the rules split MLA's heads (``wq``, ``w_uk``,
    ``w_uv``, ``wo`` on H); else None."""
    mg = model_group()
    H, Dq = cfg.n_heads_padded, cfg.head_dim_ + cfg.mla.rope_head_dim
    if mg is None or _split_dim("wq", (cfg.d_model, H, Dq)) is None:
        return None
    return mg


def vocab_group(cfg: ModelConfig) -> Optional[ModelGroup]:
    """The 'model' group where the rules split the vocabulary (``embed``
    and ``head`` alike); else None."""
    mg = model_group()
    if mg is None or _split_dim("embed", (cfg.padded_vocab, cfg.d_model)) is None:
        return None
    return mg


def channel_group(leaf: str, shape: Tuple[int, ...]) -> Optional[ModelGroup]:
    """The 'model' group where the rules split a recurrent block's inner
    channels Di, read off its input projection ``leaf`` of whole ``shape``:
    Mamba's ``m_in`` (every ``m_*`` leaf with a Di dim splits with it) or the
    mLSTM's ``x_up`` (with ``x_if``, ``x_out``, and ``x_q``/``x_k``/``x_v`` on
    their blocks of four); else None."""
    mg = model_group()
    if mg is None or _split_dim(leaf, shape) is None:
        return None
    return mg


def check_split(cfg: ModelConfig, mesh: Optional[Mesh] = None) -> None:
    """Refuse a split over 'model' whose ranks' q heads would straddle kv
    groups, or whose ranks' mLSTM channels would straddle its qkv blocks of
    four (see the module's docstring); every block kind and wrapper splits.
    ``mesh`` defaults to the ambient mesh where it is a ``DeviceMesh`` (a
    ``MeshShape`` runs no split)."""
    if mesh is None:
        mg = model_group()
        size = 1 if mg is None else mg.size
    else:
        size = describe(mesh).shape.get("model", 1)
    if size == 1:
        return
    mesh = get_mesh() if mesh is None else mesh
    D = cfg.d_model
    if ("mlstm" in cfg.block_pattern and _split_dim("x_up", (D, 2, 2 * D), mesh) is not None
            and _split_dim("x_q", (D // 2, 4, 4), mesh) is None):
        raise NotImplementedError(
            f"{cfg.name}: the mLSTM's {2 * D} channels over 'model' ({size} ranks) "
            f"straddle its qkv blocks of 4 while x_q stays whole; that split is a "
            f"later part of {ROADMAP_ITEM}")
    if cfg.mla is not None:                     # MLA reads no wk/wv
        return
    run = _kv_group_run(cfg, mesh)
    if run is not None and run[1] % run[0]:
        raise NotImplementedError(
            f"{cfg.name}: {run[0]} q heads a rank over 'model' ({size} ranks) straddle "
            f"the kv groups of {run[1]} while wk/wv stay whole; that split "
            f"is a later part of {ROADMAP_ITEM}")


@functools.lru_cache(maxsize=64)
def split_dims(cfg: ModelConfig, shape: MeshShape) -> Dict[str, Tuple[int, int]]:
    """``{name: (dim, whole size)}`` of each parameter the rules split over
    'model', from the whole model on the meta device."""
    from ..models.lm import init_params        # lm reaches this module at run time
    whole = init_params(cfg, None, device="meta")
    shardings = param_shardings(cfg, whole, shape)
    out = {}
    for name, p in whole.named_parameters():
        dim = next((i for i, a in enumerate(shardings[name].spec) if a == "model"), None)
        if dim is not None:
            out[name] = (dim, p.shape[dim])
    return out


def check_model(cfg: ModelConfig, model: torch.nn.Module) -> None:
    """Under a split, refuse a model that is not this rank's part (a whole
    model would read its slices as wrong heads and rows)."""
    mg = model_group()
    if mg is None:
        return
    params = dict(model.named_parameters())
    for name, (dim, whole) in split_dims(cfg, describe(get_mesh())).items():
        if params[name].shape[dim] * mg.size != whole:
            raise ValueError(f"{name} has {params[name].shape[dim]} of {whole} along "
                             f"dim {dim} under a 'model' axis of {mg.size}: pass the "
                             "model through split_model first")


# ------------------------------------------------------------ whole and split
@torch.no_grad()
def split_model(cfg: ModelConfig, model: torch.nn.Module,
                mesh: Optional[DeviceMesh] = None) -> torch.nn.Module:
    """This rank's part of the whole ``model`` (from ``init_params`` or
    ``convert.params_from_jax``) on ``mesh`` (default the ambient mesh):
    each leaf cut in place to this rank's chunk where ``param_shardings``
    lays it out on 'model', the rest left whole. Returns ``model``."""
    mesh = get_mesh() if mesh is None else mesh
    check_split(cfg, mesh)
    mg = model_group(mesh)
    if mg is None:
        return model
    for name, p in model.named_parameters():
        dim_whole = split_dims(cfg, describe(mesh)).get(name)
        if dim_whole is None:
            continue
        dim, whole = dim_whole
        if p.shape[dim] != whole:
            raise ValueError(f"{name} is not whole: {tuple(p.shape)}")
        p.data = p.data.chunk(mg.size, dim)[mg.rank].clone(
            memory_format=torch.contiguous_format)
    return model


def _model_places(mesh: DeviceMesh, dim: int) -> list:
    """DTensor placements of a leaf split over 'model' on ``dim``."""
    return [Shard(dim) if n == "model" else Replicate() for n in mesh.mesh_dim_names]


@torch.no_grad()
def gather_to_host(local: torch.Tensor, mesh: DeviceMesh, places, shape) -> torch.Tensor:
    """The whole tensor of ``shape`` on the host, on every rank, from the
    chunks that ``mesh``'s ranks hold of it laid out by DTensor ``places``
    (``local``, this rank's; empty on a rank outside ``mesh``). Each
    distinct chunk is broadcast over the default group from the first rank
    that holds it, so every rank of the process group calls this alike; a
    tensor every rank holds whole is copied, with no communication. The
    bits are the chunks' own (no sum), and a rank's device holds one
    chunk beyond its own at a time."""
    shape = tuple(shape)
    grid = mesh.mesh
    chunks: Dict[tuple, int] = {}
    for coord in itertools.product(*map(range, grid.shape)):
        chunks.setdefault(chunk_box(shape, mesh, places, coord), int(grid[coord]))
    whole = ((0,) * len(shape), shape)
    if list(chunks) == [whole] and grid.numel() == dist.get_world_size():
        return local.detach().cpu()
    out = torch.empty(shape, dtype=local.dtype)
    me = dist.get_rank()
    for box, src in chunks.items():
        buf = (local.detach().contiguous() if src == me else
               torch.empty(box[1], dtype=local.dtype, device=local.device))
        dist.broadcast(buf, src=src)
        out[box_index(box)].copy_(buf)
        del buf
    return out


def host_leaf(t: torch.Tensor) -> torch.Tensor:
    """A tensor of the model or its state as the whole leaf on the host: a
    DTensor gathered from its chunks (``gather_to_host``, a collective), a
    plain tensor copied."""
    if isinstance(t, DTensor):
        return gather_to_host(t.to_local(), t.device_mesh, t.placements, t.shape)
    return t.detach().cpu()


def host_params(cfg: ModelConfig, model: torch.nn.Module, mesh: Optional[DeviceMesh] = None):
    """``name -> the whole parameter on the host`` of ``model``, this rank's
    part on ``mesh`` (default the ambient mesh): a leaf split over 'model'
    gathered from the ranks' slices (``gather_to_host``; every rank asks
    for the same leaves in the same order), any other copied."""
    mesh = get_mesh() if mesh is None else mesh
    params = dict(model.named_parameters())
    if model_group(mesh) is None:
        return lambda name: params[name].detach().cpu()
    dims = split_dims(cfg, describe(mesh))

    def whole(name: str) -> torch.Tensor:
        p = params[name]
        if name not in dims:
            return p.detach().cpu()
        dim, n = dims[name]
        shape = p.shape[:dim] + (n,) + p.shape[dim + 1:]
        return gather_to_host(p, mesh, _model_places(mesh, dim), shape)
    return whole


@torch.no_grad()
def gather_model(cfg: ModelConfig, model: torch.nn.Module,
                 mesh: Optional[DeviceMesh] = None) -> torch.nn.Module:
    """The reverse of ``split_model``, in place, by all-reduce only: each
    split leaf made whole on every rank. Returns ``model``."""
    mesh = get_mesh() if mesh is None else mesh
    mg = model_group(mesh)
    if mg is None:
        return model
    for name, p in model.named_parameters():
        dim_whole = split_dims(cfg, describe(mesh)).get(name)
        if dim_whole is None:
            continue
        dim, whole = dim_whole
        full = p.new_zeros(p.shape[:dim] + (whole,) + p.shape[dim + 1:])
        full.narrow(dim, mg.rank * p.shape[dim], p.shape[dim]).copy_(p)
        p.data = summed(full, mg)
    return model


# ------------------------------------------------------------ the data axes
def _data_groups() -> list:
    mesh = get_mesh()
    if not isinstance(mesh, DeviceMesh):
        raise ValueError("a rank's own rows need a DeviceMesh to sum over 'pod' and 'data'")
    names = mesh.mesh_dim_names
    return [mesh.get_group(a) for a in ("pod", "data")
            if a in names and mesh.size(names.index(a)) > 1]


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _summed_over(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return _summed_over(grad, ctx.groups), None


def sum_over_data(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed in fp32 over the ambient ``DeviceMesh``'s 'pod' and
    'data' ranks, forward and backward. Where each rank holds its own rows
    and every rank's loss reads the sum, each rank's share takes the sum of
    the ranks' gradients: once the step averages the ranks' gradients, the
    share's gradient is the whole batch's, neither divided nor multiplied
    by the data ranks."""
    return _SumOverData.apply(t, _data_groups())


# ------------------------------------------------------------ the vocabulary
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 mg: ModelGroup) -> torch.Tensor:
    """Rows of the whole embedding from this rank's slice ``table`` (V/m, D):
    ids outside the slice masked to zero, then summed over 'model'."""
    n = table.shape[0]
    local = tokens.long() - mg.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return reduce_from_model(rows, mg)


def _global_ids(logits: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    n = logits.shape[-1]
    return torch.arange(mg.rank * n, (mg.rank + 1) * n, device=logits.device)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                       mg: ModelGroup) -> torch.Tensor:
    """-log softmax over the whole vocabulary at ``labels``, a position at a
    time, from this rank's slice of fp32 ``logits`` (..., V/m): the padded
    vocabulary (global id >= ``vocab_size``) masked as ``loss_fn`` masks it,
    the log-sum-exp's max and sum and the gold logit taken over 'model'."""
    ids = _global_ids(logits, mg)
    logits = logits.masked_fill(ids >= vocab_size, -1e30)
    top = logits.detach().amax(-1, keepdim=True)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mg.group)
    logz = top[..., 0] + torch.log(reduce_from_model(torch.exp(logits - top).sum(-1), mg))
    n = logits.shape[-1]
    local = labels.long() - mg.rank * n
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    inside = (local >= 0) & (local < n)
    return logz - reduce_from_model(torch.where(inside, gold, torch.zeros_like(gold)), mg)


@torch.no_grad()
def greedy(logits: torch.Tensor, vocab_size: int,
           mg: Optional[ModelGroup] = None) -> torch.Tensor:
    """The argmax over the first ``vocab_size`` ids of the last dim; with
    ``mg``, of vocab-split ``logits`` (..., V/m), by all-reduce only: the
    largest value, then the lowest id among equals (``argmax``'s tie rule)."""
    if mg is None:
        return logits[..., :vocab_size].argmax(-1)
    ids = _global_ids(logits, mg)
    lf = logits.float().masked_fill(ids >= vocab_size, float("-inf"))
    idx = lf.argmax(-1)
    val = lf.gather(-1, idx[..., None])[..., 0]
    top = val.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mg.group)
    cand = torch.where(val == top, ids[idx], torch.full_like(idx, torch.iinfo(idx.dtype).max))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=mg.group)
    return cand


@torch.no_grad()
def gather_vocab(logits: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """The whole logits (..., V) from this rank's slice: an all-reduce of a
    zero-filled whole buffer. ``mg`` None: ``logits``."""
    if mg is None:
        return logits
    n = logits.shape[-1]
    full = logits.new_zeros(logits.shape[:-1] + (n * mg.size,))
    full[..., mg.rank * n:(mg.rank + 1) * n] = logits
    return summed(full, mg)
