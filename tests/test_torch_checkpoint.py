"""Checkpoint-as-fork (DESIGN.md §17) in the PyTorch port: the cases of
``tests/test_checkpoint_fork_gc.py`` against the port's ``CheckpointManager``
on the port's own log, with torch tensors for leaves.

Covers: save/restore roundtrip (incl. bf16 leaves and a model's named
parameters), keep-prune through chain-GC, fork-per-experiment (merge =
promote, abandon = squash + GC), crash-orphan recovery, §4.1 hold interplay,
the churn property bounding byte amplification at 1.2x, the training
launcher's crash/resume on the CPU (the losses after the resume equal an
uninterrupted run's exactly), and the one record format both packages
share: the reference's PyTreeDef proto read and written without JAX (the
writer's bytes JAX's own for every registered config's state), a malformed
one or a model's state without its config refused with a clear error, a
reference checkpoint restored bit for bit, the port's restored by the
reference leaf for leaf, and a launcher job resumed across the packages
both ways; records of the port's earlier JSON treedef still restore; a
model split over 'model' by two gloo ranks (``tests/_gloo.py``) saves the
record one process writes of it gathered, which the reference restores. The byte-liveness oracle is the JAX package's JAX-free
``repro.core.oracle``, applied to the port's system (the same code, copied).
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core.oracle import (check_manifest_audit, check_storage_liveness,  # noqa: E402
                               check_storage_safety)
import repro_torch as rt  # noqa: E402
from repro_torch.core import BoltSystem  # noqa: E402
from repro_torch.core.errors import AgileLogError  # noqa: E402
from repro_torch.streams.records import encode_record  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402


def _params(seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)).to(dtype),
            "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))}


def _opt(seed):
    return {"m": torch.zeros((8, 8)), "v": torch.full((8,), float(seed)),
            "step": torch.tensor(seed, dtype=torch.int32)}


def _assert_trees_equal(a, b):
    """The same keys at every level and every leaf equal bit for bit; the
    record is JAX's, whose flatten order sorts a dict's keys, so a restored
    dict holds them in that order."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for key in a:
            _assert_trees_equal(a[key], b[key])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _drain(system):
    system.flush()
    for _ in range(32):
        if not system.gc_quantum():
            break


def _dead(system, log_id):
    meta = system.metadata.state.logs.get(log_id)
    return meta is None or not meta.alive


# ---------------------------------------------------------------------------
# roundtrip + atomicity
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip():
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, keep=3)
    p, o = _params(0), _opt(0)
    ckpt.save(10, p, o, extra={"cursor": [10, 0]})
    step, p2, o2, extra = ckpt.restore(device="cpu")
    assert step == 10 and extra["cursor"] == [10, 0]
    _assert_trees_equal(p, p2)
    _assert_trees_equal(o, o2)
    check_manifest_audit(system.metadata.state)


def test_bf16_leaves_roundtrip():
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system)
    p = _params(1, dtype=torch.bfloat16)
    ckpt.save(5, p, _opt(1))
    _, p2, _, _ = ckpt.restore(5, device="cpu")
    _assert_trees_equal(p, p2)


def test_chunked_leaves_roundtrip():
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, chunk_bytes=64)   # force many chunks
    p, o = _params(2), _opt(2)
    ckpt.save(1, p, o)
    rec = ckpt._replay()[1]
    assert max(hi - lo for lo, hi in rec["spans"]) > 1
    _, p2, o2, _ = ckpt.restore(device="cpu")
    _assert_trees_equal(p, p2)
    _assert_trees_equal(o, o2)


def test_seed_signature_fails_loudly():
    system = BoltSystem(n_brokers=2)
    with pytest.raises(TypeError):
        CheckpointManager(system.store)


def test_reattach_sees_existing_checkpoints():
    """Checkpoint lineage lives in the log, so a fresh manager (new client
    process, same shared-log service) finds everything by name."""
    system = BoltSystem(n_brokers=2)
    p, o = _params(3), _opt(3)
    CheckpointManager(system).save(7, p, o)
    again = CheckpointManager(system)
    assert again.steps() == [7]
    _, p2, _, _ = again.restore(device="cpu")
    _assert_trees_equal(p, p2)


# ---------------------------------------------------------------------------
# prune == squash == chain-GC (the seed's leak, fixed)
# ---------------------------------------------------------------------------

def test_prune_hands_bytes_to_reaper():
    system = BoltSystem(n_brokers=2, gc=True)
    ckpt = CheckpointManager(system, keep=2)
    forks = {s: ckpt.save(s, _params(s), _opt(s)) for s in (10, 20, 30)}
    assert ckpt.steps() == [20, 30]               # 10 pruned
    assert _dead(system, forks[10])               # its data fork is squashed
    assert not _dead(system, forks[20]) and not _dead(system, forks[30])
    _drain(system)
    # every byte the store still holds is referenced by a live manifest
    check_manifest_audit(system.metadata.state)
    check_storage_safety(system)
    check_storage_liveness(system)
    # restorable checkpoints actually restore after the reaper ran
    _, p2, _, _ = ckpt.restore(20, device="cpu")
    _assert_trees_equal(_params(20), p2)


def test_prune_is_recorded_in_catalog():
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, keep=1)
    for s in (1, 2, 3):
        ckpt.save(s, _params(s), _opt(s))
    # a second manager replays the same catalog to the same index
    assert CheckpointManager(system, keep=1).steps() == [3]


# ---------------------------------------------------------------------------
# crash orphans: the §13 reaper path replaces the seed's leak
# ---------------------------------------------------------------------------

def _crashed_save(ckpt, nbytes=4096):
    """Simulate a save that died between the data-fork flush and the catalog
    append: a live fork full of bytes that no manifest references."""
    fork = ckpt.data_root.cfork(promotable=False)
    fork.append_batch([b"x" * 512 for _ in range(nbytes // 512)]).wait()
    fork.flush()
    return fork.log_id


def test_recover_squashes_crash_orphans():
    system = BoltSystem(n_brokers=2, gc=True)
    ckpt = CheckpointManager(system, keep=3)
    ckpt.save(1, _params(1), _opt(1))
    orphan = _crashed_save(ckpt)
    assert not _dead(system, orphan)
    recovered = ckpt.recover()
    assert recovered == [orphan]
    assert _dead(system, orphan)
    _drain(system)
    check_storage_liveness(system)
    assert ckpt.steps() == [1]                    # real checkpoint untouched
    assert ckpt.recover() == []                   # idempotent


def test_recover_keeps_experiment_referenced_forks():
    """A fork referenced only by a live experiment catalog is NOT an orphan:
    recover() must scan experiment forks too, or a concurrent experiment's
    checkpoint gets destroyed."""
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, keep=3)
    exp = ckpt.experiment("sweep")
    fid = exp.save(100, _params(9), _opt(9))
    assert ckpt.recover() == []                   # trunk can't see the save,
    assert not _dead(system, fid)                 # but must not reap it
    exp.merge()
    assert ckpt.steps() == [100]


# ---------------------------------------------------------------------------
# fork-per-experiment: merge = promote, abandon = squash + chain-GC
# ---------------------------------------------------------------------------

def test_experiment_merge_lands_saves_atomically():
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, keep=5)
    ckpt.save(10, _params(0), _opt(0))
    with ckpt.experiment("lr-sweep") as exp:
        assert exp.steps() == [10]                # trunk state visible (ltt)
        exp.save(20, _params(1), _opt(1))
        exp.save(30, _params(2), _opt(2))
        assert ckpt.steps() == [10]               # withheld from trunk (§4.1)
    assert ckpt.steps() == [10, 20, 30]           # squash-on-merge landed
    _, p2, _, _ = ckpt.restore(30, device="cpu")
    _assert_trees_equal(_params(2), p2)
    check_manifest_audit(system.metadata.state)


def test_experiment_abandon_reclaims_every_byte():
    system = BoltSystem(n_brokers=2, gc=True)
    ckpt = CheckpointManager(system, keep=5)
    ckpt.save(10, _params(0), _opt(0))
    exp = ckpt.experiment("doomed")
    fid = exp.save(20, _params(1), _opt(1))
    exp.abandon()
    assert ckpt.steps() == [10]                   # trunk untouched
    assert _dead(system, fid)
    _drain(system)
    check_storage_safety(system)
    check_storage_liveness(system)
    _, p2, _, _ = ckpt.restore(10, device="cpu")
    _assert_trees_equal(_params(0), p2)


def test_experiment_abandons_on_exception():
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, keep=5)
    with pytest.raises(RuntimeError):
        with ckpt.experiment("boom") as exp:
            exp.save(1, _params(0), _opt(0))
            raise RuntimeError("training diverged")
    assert ckpt.steps() == []
    with pytest.raises(AgileLogError):
        exp.save(2, _params(1), _opt(1))          # closed experiments refuse


def test_trunk_saves_during_experiment_are_withheld_not_lost():
    """§4.1: an open (promotable) experiment holds the trunk catalog — a
    trunk save during the experiment is sequenced but withheld, and becomes
    visible once the experiment resolves."""
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, keep=5)
    exp = ckpt.experiment("hold")
    ckpt.save(10, _params(0), _opt(0))            # sequenced-but-withheld
    assert ckpt.steps() == []                     # trunk reader capped
    exp.abandon()
    assert ckpt.steps() == [10]                   # released by the resolve
    _, p2, _, _ = ckpt.restore(10, device="cpu")
    _assert_trees_equal(_params(0), p2)


# ---------------------------------------------------------------------------
# the real training loop: crash/resume trace audits clean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", [None, "granite-moe-smoke", "deepseek-v2-lite-smoke"])
def test_train_checkpoint_restore_trace_audits_clean(config):
    """Drive the port's launch driver through a crash/resume cycle on ONE
    shared-log service: checkpoint bytes audit against the §13 manifests
    over the whole trace, the resume picks up where the crashed client
    stopped, and its losses equal an uninterrupted run's bit for bit. The
    small attn+mlp config, granite's MoE smoke config (its router, expert
    and aux-loss state through the checkpoint), and deepseek-v2-lite's (MLA
    leaves, a dense first layer and a shared expert)."""
    from repro_torch.launch.train import run

    kw = dict(d_model=32, n_layers=2, batch=2, seq=32, vocab=256, log_every=10,
              device="cpu")
    if config is not None:
        kw["config"] = rt.get_smoke_config({"granite-moe-smoke": "granite-moe-3b-a800m",
                                            "deepseek-v2-lite-smoke": "deepseek-v2-lite-16b"}
                                           [config])
    straight, _, _, _ = run(steps=30, system=BoltSystem(n_brokers=2), ckpt_every=100, **kw)
    system = BoltSystem(n_brokers=2, gc=True)
    first, _, _, _ = run(steps=20, system=system, ckpt_every=10, **kw)
    assert first == straight[:20]
    check_manifest_audit(system.metadata.state)
    losses, model, _, _ = run(steps=30, system=system, ckpt_every=10, resume=True, **kw)
    assert len(losses) == 10                      # resumed at step 20
    assert losses == straight[20:]                # exactly: same bits
    assert all(p.requires_grad for p in model.parameters())
    if config is not None:
        assert any(n.endswith("moe.e_in") for n, _ in model.named_parameters())
    if config == "deepseek-v2-lite-smoke":
        assert {n.rsplit(".", 1)[1] for n, _ in model.named_parameters() if ".mla." in n} == {
            "w_dkv", "kv_norm", "w_uk", "w_uv", "wq", "wo"}
    ckpt = CheckpointManager(system)
    assert ckpt.latest_step() == 30
    _drain(system)
    check_manifest_audit(system.metadata.state)
    check_storage_safety(system)
    check_storage_liveness(system, max_byte_amplification=1.2)


def test_model_and_optimizer_roundtrip():
    """A module and its AdamW state are saved in the reference's layout (a
    PyTreeDef proto, each pattern entry's layers stacked), which needs the
    config; restored with it, both come back bit for bit, bf16 included, by
    parameter name."""
    from repro_torch.train import AdamWConfig, adamw_init, pytree_proto
    cfg = rt.get_smoke_config("qwen3-8b")
    model = rt.init_params(cfg, 3, device="cpu", trainable=True)
    state = adamw_init(model, AdamWConfig(moments_dtype="bfloat16"))
    state["m"]["embed"].add_(1.5)
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system, chunk_bytes=4096)
    with pytest.raises(ValueError, match=r"save\(cfg=\.\.\.\)"):
        ckpt.save(4, model, state)
    ckpt.save(4, model, state, extra={"cursor": [3, 1]}, cfg=cfg)
    rec = ckpt._replay()[4]
    paths = pytree_proto.key_paths(pytree_proto.parse(bytes.fromhex(rec["treedef"])))
    assert paths[0] == ("opt", "m", "embed") and ("params", "embed") in paths
    assert ("params", "groups", 0, "attn", "wq") in paths and ("opt", "step") in paths
    assert len(paths) == len(rec["dtypes"]) and ("opt", "master", "embed") in paths
    step, params, opt, extra = ckpt.restore(device="cpu", cfg=cfg)
    assert step == 4 and extra == {"cursor": [3, 1]}
    _assert_trees_equal(dict(model.named_parameters()), params)
    _assert_trees_equal(state, opt)
    assert list(params) == [name for name, _ in model.named_parameters()]


def _json_record(ckpt, step, state):
    """A save record as the port's earlier writer made it: the leaves in
    insertion order, the treedef a JSON list of their paths."""
    from repro_torch.train.checkpoint import _leaf_bytes

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for key, sub in tree.items()
                    for x in flat(sub, f"{prefix}/{key}" if prefix else key)]
        return [(prefix, tree)]

    paths, leaves = zip(*flat(state))
    fork = ckpt.data_root.cfork(promotable=False)
    dtypes = []
    for leaf in leaves:
        raw, dt = _leaf_bytes(leaf)
        fork.append_batch([raw]).wait()
        dtypes.append(dt)
    fork.flush()
    ckpt.catalog.append(encode_record({
        "op": "save", "step": step, "data_log": fork.log_id, "exp": "",
        "spans": [[i, i + 1] for i in range(len(leaves))], "dtypes": dtypes,
        "treedef": json.dumps(list(paths)), "extra": {"cursor": [1, 2]}})).wait()


SPLIT_SAVE = r'''
from repro_torch import get_smoke_config, init_params
from repro_torch.distributed import tp
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import (AdamWConfig, adamw_init, distribute_opt_state,
                               opt_state_shardings)

cfg = get_smoke_config(spec["arch"])
mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
model = init_params(cfg, 2, device="cpu", trainable=True)
opt = AdamWConfig()
whole = adamw_init(model, opt)
gen = torch.Generator().manual_seed(6)
for key in ("m", "v"):
    for t in whole[key].values():
        t.normal_(generator=gen)
whole["step"].fill_(5)
state = distribute_opt_state(whole, opt_state_shardings(cfg, model, mesh, opt), mesh)
tp.split_model(cfg, model, mesh)
system = BoltSystem(n_brokers=2)
log_id = CheckpointManager(system, chunk_bytes=4096).save(5, model, state,
                                                           extra={"cursor": [5, 1]},
                                                           cfg=cfg, mesh=mesh)
get = tp.host_params(cfg, model, mesh)             # gathered as one process holds them
one_model = init_params(cfg, None, device="cpu", trainable=True)
with torch.no_grad():
    for n, p in one_model.named_parameters():
        p.copy_(get(n))
one_state = {k: {n: tp.host_leaf(d) for n, d in state[k].items()} for k in ("m", "v", "master")}
one_state["step"] = state["step"].to_local()
report = {"log_id": log_id, "split": [list(p.shape) for p in model.parameters()]}
if rank == 0:
    one = BoltSystem(n_brokers=2)
    mine = CheckpointManager(one, chunk_bytes=4096).save(5, one_model, one_state,
                                                         extra={"cursor": [5, 1]}, cfg=cfg)
    report["equal"] = record(system, log_id) == record(one, mine)
    report["rank0"] = log_id == CheckpointManager(system)._replay()[5]["data_log"]
    dump_record(system, log_id, f"{out}/record.pkl")
json.dump(report, open(f"{out}/rank{rank}.json", "w"))
dist.destroy_process_group()
'''


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
                                  "xlstm-1.3b", "whisper-small"])
def test_split_save_writes_the_one_rank_record(arch, tmp_path):
    """A bf16 smoke model split over 'model' by 2 gloo ranks on (1, 2), with
    its ZeRO-1 state (random moments, step 5), is saved by both ranks: each
    split leaf gathered over 'model', each state leaf from its chunks, rank
    0 writing. The record equals byte for byte the one a single process
    writes of the gathered model and state, every rank returns rank 0's
    data fork id, and carried into a reference ``BoltSystem`` the JAX
    ``CheckpointManager.restore`` reads it leaf for leaf equal to
    ``params_to_jax`` and ``opt_state_to_jax`` of the whole model and state."""
    import jax
    from _gloo import RECORDS, load_record, run_ranks
    from repro.core import BoltSystem as JaxBoltSystem
    from repro.streams.records import encode_record as jax_encode_record
    from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro_torch.train import AdamWConfig, adamw_init, pytree_proto
    reports = run_ranks(tmp_path, 2, RECORDS + SPLIT_SAVE, {"arch": arch})
    assert reports[0]["equal"] and reports[0]["rank0"]
    assert reports[0]["log_id"] == reports[1]["log_id"]
    cfg = rt.get_smoke_config(arch)
    model = rt.init_params(cfg, 2, device="cpu", trainable=True)
    assert reports[0]["split"] != [list(p.shape) for p in model.parameters()]   # a split ran
    opt = adamw_init(model, AdamWConfig())
    gen = torch.Generator().manual_seed(6)
    for key in ("m", "v"):
        for t in opt[key].values():
            t.normal_(generator=gen)
    opt["step"].fill_(5)
    jckpt = load_record(tmp_path / "record.pkl",
                        lambda: JaxCheckpointManager(JaxBoltSystem(n_brokers=2)),
                        jax_encode_record)
    step, params, jopt, extra = jckpt.restore()
    assert step == 5 and extra == {"cursor": [5, 1]}
    want = {"params": rt.params_to_jax(cfg, model), "opt": rt.opt_state_to_jax(cfg, model, opt)}
    got = {"params": params, "opt": jopt}
    assert (jax.tree_util.tree_structure(got).serialize_using_proto()
            == pytree_proto.serialize(pytree_proto.structure(want)))
    for g, w in zip(jax.tree_util.tree_leaves(got), pytree_proto.leaves(want)):
        g, w = _jax_bits(g), _as_numpy(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


LEAVES = {"fp32": lambda: torch.randn(130, 17, 3), "bf16": lambda: torch.randn(7).bfloat16(),
          "int32 scalar": lambda: torch.tensor(5, dtype=torch.int32),
          "empty": lambda: torch.zeros(0, 4), "transposed": lambda: torch.randn(4, 6).t(),
          "numpy int64": lambda: np.arange(10, dtype=np.int64),
          "numpy scalar": lambda: np.float32(2.5)}


@pytest.mark.parametrize("kind", list(LEAVES))
def test_leaf_chunks_are_np_save_bytes_cut(kind):
    """The writer cuts a leaf's ``.npy`` bytes into records without a whole
    copy of them (``_leaf_chunks``: np.save's header, then the array's own
    buffer sliced): for every chunk size, the records equal ``np.save``'s
    bytes cut, and ``_leaf_restore`` reads them back bit for bit."""
    from repro_torch.train.checkpoint import _leaf_bytes, _leaf_chunks, _leaf_restore
    leaf = LEAVES[kind]()
    raw, dt = _leaf_bytes(leaf)
    for size in (1, 7, 64, 128, 129, 1 << 20):
        chunks, dt2 = _leaf_chunks(leaf, size)
        assert dt2 == dt and chunks == ([raw[o:o + size] for o in range(0, len(raw), size)]
                                        or [b""]), size
    back = _leaf_restore(bytearray().join(chunks), dt, "cpu")
    want = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
    assert back.dtype == want.dtype and torch.equal(back, want)


def test_json_treedef_records_still_restore():
    """Records the port wrote before it wrote the reference's record (a
    JSON treedef of leaf paths) restore as the nested dicts they were, a
    model's parameters by name, beside a record of the new writer."""
    from repro_torch.train import AdamWConfig, adamw_init
    cfg = rt.get_smoke_config("granite-moe-3b-a800m")
    model = rt.init_params(cfg, 4, device="cpu", trainable=True)
    state = adamw_init(model, AdamWConfig())
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system)
    _json_record(ckpt, 3, {"params": dict(model.named_parameters()), "opt": state})
    ckpt.save(6, model, state, cfg=cfg)
    for step, kw in ((3, {}), (6, {"cfg": cfg})):
        got, params, opt, _ = ckpt.restore(step, device="cpu", **kw)
        assert got == step
        _assert_trees_equal(dict(model.named_parameters()), params)
        _assert_trees_equal(state, opt)
    plain = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2, dtype=torch.bfloat16)}
    _json_record(ckpt, 9, {"params": plain, "opt": {"step": torch.tensor(9)}})
    _, params, opt, extra = ckpt.restore(9, device="cpu")
    assert list(params) == ["w", "b"] and extra == {"cursor": [1, 2]}
    _assert_trees_equal(plain, params)


def _carry(jsystem, system, prefix="ckpt"):
    """Carry the reference's checkpoints into a port ``BoltSystem`` byte for
    byte: each live save's data fork, chunk by chunk, into a fresh fork of
    the port's data root, then its catalog manifest exactly as written with
    only ``data_log`` renumbered. The two packages' log classes are distinct
    copies, so the records cross by value."""
    from repro.streams.records import decode_record
    from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
    src, dst = JaxCheckpointManager(jsystem, prefix=prefix), CheckpointManager(system, prefix=prefix)
    index = src._replay()
    for step in sorted(index):
        chunks = list(jsystem.open_log(index[step]["data_log"]).scan())
        fork = dst.data_root.cfork(promotable=False)
        fork.append_batch(chunks).wait()
        fork.flush()
        for raw in src.catalog.scan():
            rec = decode_record(raw)
            if rec.get("op") == "save" and rec["step"] == step:
                dst.catalog.append(encode_record(dict(rec, data_log=fork.log_id))).wait()
    return dst


def _jax_saved(state, step=9):
    """A record the JAX package's manager wrote of ``state`` (numpy leaves),
    carried into a port system: the port's manager of that system."""
    from repro.core import BoltSystem as JaxBoltSystem
    from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
    jsystem = JaxBoltSystem(n_brokers=2)
    JaxCheckpointManager(jsystem).save(step, state["params"], state["opt"],
                                       extra={"cursor": [4, 2]})
    return _carry(jsystem, BoltSystem(n_brokers=2))


def test_jax_written_record_is_refused():
    """A save record the JAX package wrote holds a PyTreeDef proto as its
    treedef. A malformed one raises, naming the cause (here a string field
    that runs past the end); a well-formed one without the model's config
    raises too, naming ``cfg``: the reference's stacked leaves do not name
    the layer kinds."""
    pytest.importorskip("jax")
    system = BoltSystem(n_brokers=2)
    ckpt = CheckpointManager(system)
    fork = ckpt.data_root.cfork(promotable=False)
    fork.append_batch([b"x"]).wait()
    ckpt.catalog.append(encode_record({
        "op": "save", "step": 9, "data_log": fork.log_id, "exp": "",
        "spans": [[0, 1]], "dtypes": ["float32"], "treedef": "0a0208011202",
        "extra": {}})).wait()
    assert ckpt.steps() == [9]
    with pytest.raises(ValueError, match="truncated PyTreeDef proto"):
        ckpt.restore(9, device="cpu", cfg=rt.get_smoke_config("qwen3-8b"))
    ckpt = _jax_saved({"params": {"embed": np.zeros((4, 2), np.float32)},
                       "opt": {"step": np.zeros((), np.int32)}})
    with pytest.raises(ValueError, match=r"written by the JAX package.*restore\(cfg=\.\.\.\)"):
        ckpt.restore(9, device="cpu")


# ---------------------------------------------------------------------------
# restoring what the JAX package wrote
# ---------------------------------------------------------------------------

def _jax_state(arch, master=True, dtype="float32"):
    """The reference's ``{"params", "opt"}`` state of a smoke config, as
    shapes (nothing computed)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config
    from repro.models import lm as jlm
    from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
    from repro.train.optimizer import adamw_init as jax_adamw_init
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    ocfg = JaxAdamWConfig(master_weights=master)

    def state():
        params = jlm.init_params(cfg, jax.random.key(0))
        return {"params": params, "opt": jax_adamw_init(params, ocfg)}

    return cfg, jax.eval_shape(state)


def _jax_key_paths(tree):
    import jax
    return [tuple(k.key if hasattr(k, "key") else k.idx for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.slow
@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("arch", rt.ARCHS)
def test_proto_reader_matches_jax_key_paths(arch, master):
    """For each registered config's smoke state, the reader's key paths are
    ``tree_flatten_with_path``'s in order, and the containers it rebuilds
    (dicts, the groups' tuples) have JAX's structure."""
    import jax
    from repro_torch.train import pytree_proto
    _, state = _jax_state(arch, master)
    td = jax.tree_util.tree_structure(state)
    root = pytree_proto.parse(td.serialize_using_proto())
    paths = pytree_proto.key_paths(root)
    assert paths == _jax_key_paths(state)
    rebuilt = pytree_proto.unflatten(root, list(range(len(paths))))
    assert jax.tree_util.tree_structure(rebuilt) == td
    assert jax.tree_util.tree_leaves(rebuilt) == list(range(len(paths)))


def test_proto_reader_reads_lists_and_none():
    """The kinds the reference's states do not use: a list and a None (the
    tree whose proto the module docstring decodes, with an empty list)."""
    jax = pytest.importorskip("jax")
    from repro_torch.train import pytree_proto
    tree = {"params": {"b": 1.0, "a": [1.0, (1.0, None), []]}, "opt": {"step": 1.0, "m": None}}
    td = jax.tree_util.tree_structure(tree)
    root = pytree_proto.parse(td.serialize_using_proto())
    assert pytree_proto.key_paths(root) == _jax_key_paths(tree)
    rebuilt = pytree_proto.unflatten(root, [1, 2, 3, 4])
    assert rebuilt == {"opt": {"m": None, "step": 1},
                       "params": {"a": [2, (3, None), []], "b": 4}}
    assert jax.tree_util.tree_structure(rebuilt) == td


def _unknown_kind():
    return bytes.fromhex("0a021009")            # one node of kind 9


def _truncated():
    jax = pytest.importorskip("jax")
    return jax.tree_util.tree_structure({"w": 1.0, "b": [1.0]}).serialize_using_proto()[:-1]


@pytest.mark.parametrize("case", ["truncated", "unknown kind", "leaf count"])
def test_proto_reader_refuses(case):
    """A truncated proto, an unknown kind and a leaf count other than the
    record's each raise a ValueError naming the cause."""
    from repro_torch.train import pytree_proto
    from repro_torch.train.checkpoint import _jax_tree
    if case == "truncated":
        with pytest.raises(ValueError, match="truncated PyTreeDef proto"):
            pytree_proto.parse(_truncated())
    elif case == "unknown kind":
        with pytest.raises(ValueError, match="kind 9"):
            pytree_proto.parse(_unknown_kind())
    else:
        good = "0a021001"                       # one leaf (kind 1)
        with pytest.raises(ValueError, match="holds 1 leaves, its record 2"):
            _jax_tree({"step": 3, "treedef": good, "spans": [[0, 1], [1, 2]]})
        with pytest.raises(ValueError, match="holds 1 leaves, the record 2"):
            pytree_proto.unflatten(pytree_proto.parse(bytes.fromhex(good)), [0, 1])


def _jax_trained(arch, steps=3, seed=0):
    """The reference trains a smoke config in fp32 for ``steps`` steps:
    (cfg, step fn, params, AdamW state, the next batch)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import lm as jlm
    from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
    from repro.train.optimizer import adamw_init as jax_adamw_init
    from repro.train.step import make_train_step as jax_make_train_step
    cfg = get_smoke_config(arch).with_(dtype="float32")
    ocfg = JaxAdamWConfig(lr=1e-3, weight_decay=0.01)
    params = jlm.init_params(cfg, jax.random.key(seed))
    opt = jax_adamw_init(params, ocfg)
    step = jax.jit(jax_make_train_step(cfg, ocfg, accum=1, grad_dtype="float32"))
    rng = np.random.default_rng(seed + 1)
    batches = [rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
               for _ in range(steps + 1)]
    for toks in batches[:steps]:
        params, opt, _ = step(params, opt, {"tokens": jnp.asarray(toks[:, :-1]),
                                            "labels": jnp.asarray(toks[:, 1:])})
    return cfg, step, params, opt, batches[-1]


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b", "xlstm-1.3b"])
def test_restore_jax_written_checkpoint_fp32(arch):
    """The reference's manager saves its state after 3 reference train steps;
    carried into a port system and restored with ``cfg``, every parameter
    and every m, v and master leaf equals the reference's bit for bit, and
    one more port step equals the reference's next step within STEP_TOL."""
    import jax
    import jax.numpy as jnp
    from repro.core import BoltSystem as JaxBoltSystem
    from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro_torch.convert import _leaves
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import STEP_TOL
    cfg, jstep, jparams, jopt, toks = _jax_trained(arch)
    jsystem = JaxBoltSystem(n_brokers=2)
    JaxCheckpointManager(jsystem, chunk_bytes=4096).save(3, jparams, jopt,
                                                         extra={"cursor": [3, 0]})
    ckpt = _carry(jsystem, BoltSystem(n_brokers=2))
    step, params, opt, extra = ckpt.restore(device="cpu", cfg=cfg)
    assert step == 3 and extra == {"cursor": [3, 0]}
    model = rt.init_params(cfg, None, device="cpu", trainable=True)
    assert list(params) == [name for name, _ in model.named_parameters()]
    assert set(opt) == {"m", "v", "master", "step"} and int(opt["step"]) == 3
    assert opt["step"].dtype == torch.int32
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    host = jax.device_get({"params": jparams, **{k: jopt[k] for k in ("m", "v", "master")}})
    for key in ("params", "m", "v", "master"):
        got = params if key == "params" else opt[key]
        for name, _, leaf in _leaves(cfg, model, host[key]):
            want = np.asarray(leaf)
            assert got[name].dtype == torch.float32 and got[name].shape == want.shape, name
            assert np.array_equal(got[name].numpy(), want), f"{key} {name}"
    jnext, _, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks[:, :-1]),
                                         "labels": jnp.asarray(toks[:, 1:])})
    tstep = make_train_step(cfg, AdamWConfig(lr=1e-3, weight_decay=0.01), grad_dtype="float32")
    model, opt, tm = tstep(model, opt, {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                                        "labels": torch.from_numpy(toks[:, 1:]).long()})
    assert int(opt["step"]) == 4
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
    for name, p, leaf in _leaves(cfg, model, jax.device_get(jnext)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(leaf), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=name)


@pytest.mark.slow
def test_wrong_config_names_the_leaf():
    """Restored with another config than the one that wrote it, the
    converter's shape error names the leaf."""
    cfg, state = _jax_state("qwen3-8b")
    import jax
    ckpt = _jax_saved(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), state))
    with pytest.raises(ValueError, match=r"embed: JAX \(512, 64\)"):
        ckpt.restore(device="cpu", cfg=cfg.with_(d_model=32))


@pytest.mark.slow
def test_port_resumes_a_jax_launcher_job():
    """The reference's launcher trains k steps and checkpoints; the records
    carried into a port system, the port's ``run(resume=True)`` continues to
    step 2k. Its losses stay within the bf16 step tolerance of the
    reference's uninterrupted 2k-step run, and its data cursor at 2k equals
    the reference's."""
    from repro.core import BoltSystem as JaxBoltSystem
    from repro.launch.train import run as jax_run
    from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro_torch.launch.train import run
    from repro_torch.train.step import BF16_STEP_TOL
    k = 4
    kw = dict(d_model=32, n_layers=2, batch=2, seq=32, vocab=256, log_every=100, ckpt_every=k)
    jsystem = JaxBoltSystem(n_brokers=2)
    straight, _, _ = jax_run(steps=2 * k, system=jsystem, **kw)
    half = JaxBoltSystem(n_brokers=2)
    first, _, _ = jax_run(steps=k, system=half, **kw)
    assert first == straight[:k]
    system = BoltSystem(n_brokers=2)
    _carry(half, system)
    losses, model, _, _ = run(steps=2 * k, system=system, resume=True, device="cpu", **kw)
    assert len(losses) == k and all(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(losses, straight[k:], rtol=0, atol=BF16_STEP_TOL["loss"])
    want = JaxCheckpointManager(jsystem)._replay()[2 * k]["extra"]["cursor"]
    assert CheckpointManager(system)._replay()[2 * k]["extra"]["cursor"] == want


# ---------------------------------------------------------------------------
# records the port writes, restored by the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("arch", rt.ARCHS)
def test_proto_writer_bytes_equal_jax(arch, master):
    """``serialize(structure(state))`` of the reference's state of each
    smoke config, with and without master weights, is the bytes of JAX's
    own ``serialize_using_proto``, and ``leaves`` is JAX's leaf order."""
    import jax
    from repro_torch.train import pytree_proto
    _, state = _jax_state(arch, master)
    want = jax.tree_util.tree_structure(state).serialize_using_proto()
    assert pytree_proto.serialize(pytree_proto.structure(state)) == want
    assert pytree_proto.serialize(pytree_proto.parse(want)) == want
    assert pytree_proto.leaves(state) == jax.tree_util.tree_leaves(state)


@pytest.mark.parametrize("tree", [
    1.0, None, {}, [], (), {"b": 1.0, "a": [1.0, (1.0, None), []]},
    {"x": {"a": 1.0, "b": 2.0}, "y": {"a": 3.0}, "z": [{"a": None}, ({"c": ()},)]},
    {f"k{i}": list(range(i)) for i in range(150)},          # arity and ids past one byte
], ids=["leaf", "none", "empty-dict", "empty-list", "empty-tuple", "lists-none",
        "shared-keys", "wide"])
def test_proto_writer_lists_tuples_none(tree):
    """The kinds the reference's states do not use, shared dict keys (each
    string interned once) and varints longer than a byte."""
    jax = pytest.importorskip("jax")
    from repro_torch.train import pytree_proto
    want = jax.tree_util.tree_structure(tree).serialize_using_proto()
    assert pytree_proto.serialize(pytree_proto.structure(tree)) == want
    assert pytree_proto.leaves(tree) == jax.tree_util.tree_leaves(tree)


def _as_numpy(t):
    """A converter's CPU tensor leaf as the reference's array's bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_bits(leaf):
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _jax_random_state(arch, master):
    """The reference's bf16 smoke state with random values in every leaf
    (params, m, v and master), step 7."""
    import jax
    cfg, shapes = _jax_state(arch, master, dtype="bfloat16")
    rng = np.random.default_rng(len(arch))
    state = jax.tree.map(lambda s: jax.numpy.asarray(rng.normal(size=s.shape), s.dtype), shapes)
    state["opt"]["step"] = np.int32(7)
    return cfg, jax.device_get(state)


@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("arch", rt.ARCHS)
def test_to_jax_converters_round_trip(arch, master):
    """``params_to_jax`` and ``opt_state_to_jax`` invert ``params_from_jax``
    and ``opt_state_from_jax`` bit for bit, in the reference's tree
    (``groups`` a tuple, ``master`` only where the state has it, ``step`` an
    int32 scalar), on every smoke config in bf16."""
    import jax
    from repro_torch.train import pytree_proto
    cfg, state = _jax_random_state(arch, master)
    model = rt.params_from_jax(cfg, state["params"], device="cpu")
    opt = rt.opt_state_from_jax(cfg, model, state["opt"])
    assert ("master" in opt) == master
    back = {"params": rt.params_to_jax(cfg, model), "opt": rt.opt_state_to_jax(cfg, model, opt)}
    assert back["opt"]["step"].dtype == torch.int32 and back["opt"]["step"].shape == ()
    assert isinstance(back["params"]["groups"], tuple)
    assert (pytree_proto.serialize(pytree_proto.structure(back))
            == jax.tree_util.tree_structure(state).serialize_using_proto())
    for got, want in zip(pytree_proto.leaves(back), jax.tree_util.tree_leaves(state)):
        got, want = _as_numpy(got), _jax_bits(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-small", "jamba-1.5-large-398b"])
def test_lazy_to_jax_leaves_are_made_when_called(arch):
    """With ``lazy``, every leaf of ``params_to_jax`` and ``opt_state_to_jax``
    but ``step`` is a callable that makes it only when called (the
    checkpoint writer holds one stacked leaf at a time): a change to the
    model after the tree was built shows in the leaves, which then equal
    the eager trees' bit for bit."""
    from repro_torch.train import AdamWConfig, adamw_init, pytree_proto
    cfg = rt.get_smoke_config(arch)
    model = rt.init_params(cfg, 3, device="cpu", trainable=True)
    opt = adamw_init(model, AdamWConfig())
    lazy = {"params": rt.params_to_jax(cfg, model, lazy=True),
            "opt": rt.opt_state_to_jax(cfg, model, opt, lazy=True)}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1)
        for t in opt["m"].values():
            t.normal_()
    eager = {"params": rt.params_to_jax(cfg, model), "opt": rt.opt_state_to_jax(cfg, model, opt)}
    assert (pytree_proto.serialize(pytree_proto.structure(lazy))
            == pytree_proto.serialize(pytree_proto.structure(eager)))
    for got, want in zip(pytree_proto.leaves(lazy), pytree_proto.leaves(eager)):
        assert callable(got) == (want.shape != ())
        got = got() if callable(got) else got
        assert got.dtype == want.dtype and torch.equal(got, want)


def _carry_back(system, jsystem, prefix="ckpt"):
    """The reverse of ``_carry``: the port's live saves, each data fork
    chunk by chunk into a fresh fork of the reference's data root, then its
    manifest exactly as written with only ``data_log`` renumbered."""
    from repro.streams.records import encode_record as jax_encode_record
    from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro_torch.streams.records import decode_record
    src, dst = CheckpointManager(system, prefix=prefix), JaxCheckpointManager(jsystem, prefix=prefix)
    index = src._replay()
    for step in sorted(index):
        chunks = list(system.open_log(index[step]["data_log"]).scan())
        fork = dst.data_root.cfork(promotable=False)
        fork.append_batch(chunks).wait()
        fork.flush()
        for raw in src.catalog.scan():
            rec = decode_record(raw)
            if rec.get("op") == "save" and rec["step"] == step:
                dst.catalog.append(jax_encode_record(dict(rec, data_log=fork.log_id))).wait()
    return dst


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b", "whisper-small",
                                  "xlstm-1.3b"])
def test_jax_restores_a_port_written_record(arch):
    """A record the port's ``save`` wrote (a bf16 smoke model and its AdamW
    state with master weights), carried byte for byte into a reference
    ``BoltSystem``, restores through the JAX ``CheckpointManager.restore``
    leaf for leaf equal to ``params_to_jax`` and ``opt_state_to_jax``, in
    JAX's own tree; the cursor rides ``extra``."""
    import jax
    from repro.core import BoltSystem as JaxBoltSystem
    from repro_torch.train import AdamWConfig, adamw_init
    cfg = rt.get_smoke_config(arch)
    model = rt.init_params(cfg, 2, device="cpu", trainable=True)
    opt = adamw_init(model, AdamWConfig())
    for key in ("m", "v"):
        for t in opt[key].values():
            t.normal_()
    opt["step"].fill_(5)
    system = BoltSystem(n_brokers=2)
    CheckpointManager(system, chunk_bytes=4096).save(5, model, opt, extra={"cursor": [5, 1]},
                                                     cfg=cfg)
    jckpt = _carry_back(system, JaxBoltSystem(n_brokers=2))
    step, params, jopt, extra = jckpt.restore()
    assert step == 5 and extra == {"cursor": [5, 1]}
    want = {"params": rt.params_to_jax(cfg, model), "opt": rt.opt_state_to_jax(cfg, model, opt)}
    got = {"params": params, "opt": jopt}
    from repro_torch.train import pytree_proto
    assert (jax.tree_util.tree_structure(got).serialize_using_proto()
            == pytree_proto.serialize(pytree_proto.structure(want)))
    for g, w in zip(jax.tree_util.tree_leaves(got), pytree_proto.leaves(want)):
        g, w = _jax_bits(g), _as_numpy(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    assert np.asarray(jopt["step"]).dtype == np.int32 and int(jopt["step"]) == 5


@pytest.mark.slow
def test_jax_launcher_resumes_a_port_launcher_job():
    """The mirror of ``test_port_resumes_a_jax_launcher_job``: the port's
    launcher trains k steps and checkpoints; the records carried into a
    reference system, the JAX launcher's ``run(resume=True)`` continues to
    step 2k. Its losses stay within the bf16 step tolerance of the port's
    uninterrupted 2k-step run, and its data cursor at 2k, which it took back
    from the record's ``extra``, equals the port's."""
    from repro.core import BoltSystem as JaxBoltSystem
    from repro.launch.train import run as jax_run
    from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro_torch.launch.train import run
    from repro_torch.train.step import BF16_STEP_TOL
    k = 4
    kw = dict(d_model=32, n_layers=2, batch=2, seq=32, vocab=256, log_every=100, ckpt_every=k)
    system = BoltSystem(n_brokers=2)
    straight, _, _, _ = run(steps=2 * k, system=system, device="cpu", **kw)
    half = BoltSystem(n_brokers=2)
    first, _, _, _ = run(steps=k, system=half, device="cpu", **kw)
    assert first == straight[:k]
    jsystem = JaxBoltSystem(n_brokers=2)
    _carry_back(half, jsystem)
    losses, _, _ = jax_run(steps=2 * k, system=jsystem, resume=True, **kw)
    assert len(losses) == k
    np.testing.assert_allclose(losses, straight[k:], rtol=0, atol=BF16_STEP_TOL["loss"])
    want = CheckpointManager(system)._replay()[2 * k]["extra"]["cursor"]
    assert JaxCheckpointManager(jsystem)._replay()[2 * k]["extra"]["cursor"] == want


# ---------------------------------------------------------------------------
# churn property: byte amplification stays bounded
# ---------------------------------------------------------------------------

@settings(max_examples=12, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.booleans()),
                min_size=4, max_size=14))
def test_checkpoint_churn_bounds_amplification(ops):
    """Random save / crashed-save / experiment(merge|abandon) / recover
    churn, then drain GC: the §13 manifests must audit clean and the store
    must hold at most 1.2x the live checkpoint bytes (the seed's leaked
    orphans and pruned leaves would fail this immediately)."""
    system = BoltSystem(n_brokers=2, gc=True)
    ckpt = CheckpointManager(system, keep=2)
    step = 0
    for op, flag in ops:
        step += 1
        if op == 0:
            ckpt.save(step, _params(step), _opt(step))
        elif op == 1:
            _crashed_save(ckpt)
        elif op == 2:
            exp = ckpt.experiment(f"e{step}")
            exp.save(step * 1000, _params(step), _opt(step))
            if flag:
                exp.merge()
            else:
                exp.abandon()
        else:
            ckpt.recover()
    ckpt.recover()
    _drain(system)
    check_manifest_audit(system.metadata.state)
    check_storage_safety(system)
    check_storage_liveness(system, max_byte_amplification=1.2)
    for s in ckpt.steps():                        # survivors all restore
        ckpt.restore(s, device="cpu")
