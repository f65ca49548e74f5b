"""Run a worker script as gloo ranks in a subprocess, for the CPU tests of
the port's distribution.

The ranks rendezvous through a ``FileStore`` in the test's temporary
directory and run in a process of their own, so that no process group
starts inside a test worker. Each rank runs ``worker`` as
``worker.py RANK WORLD STORE OUT SPEC`` (``SPEC`` a JSON file) and writes
what it reports to ``OUT/rank{RANK}.json``.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# The head of every worker: its arguments, one torch thread, the group.
PRELUDE = r'''
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4], json.loads(open(sys.argv[5]).read()))
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
'''

# Records of a port BoltSystem as files: a save record's manifest (less its
# data_log) and its data fork's chunks, which cross between processes and
# between the packages by value, as tests/test_torch_checkpoint.py carries them.
RECORDS = r'''
import pickle
from repro_torch.core import BoltSystem
from repro_torch.streams.records import encode_record
from repro_torch.train import CheckpointManager


def record(system, log_id):
    """(manifest less data_log, chunks) of the save whose data fork is log_id."""
    rec = next(r for r in CheckpointManager(system)._replay().values()
               if r["data_log"] == log_id)
    return ({k: v for k, v in rec.items() if k != "data_log"},
            list(system.open_log(log_id).scan()))


def dump_record(system, log_id, path):
    with open(path, "wb") as f:
        pickle.dump(record(system, log_id), f)


def load_record(system, path):
    """A dumped record appended to system's catalog; returns its data fork id."""
    with open(path, "rb") as f:
        manifest, chunks = pickle.load(f)
    ckpt = CheckpointManager(system)
    fork = ckpt.data_root.cfork(promotable=False)
    fork.append_batch(chunks).wait()
    fork.flush()
    ckpt.catalog.append(encode_record(dict(manifest, data_log=fork.log_id))).wait()
    return fork.log_id
'''

LAUNCHER = r'''
import subprocess, sys, time
worker, world, store, out, spec, limit = sys.argv[1:7]
procs = [subprocess.Popen([sys.executable, worker, str(r), world, store, out, spec])
         for r in range(int(world))]
deadline = time.time() + float(limit)
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


def run_ranks(tmp_path: Path, world: int, worker: str, spec: dict, limit: float = 150):
    """Run ``PRELUDE + worker`` as ``world`` gloo ranks; returns each rank's
    report (``OUT/rank{r}.json``). Fails the test where a rank fails or the
    ranks outlast ``limit`` seconds."""
    (tmp_path / "worker.py").write_text(PRELUDE + worker)
    (tmp_path / "launch.py").write_text(LAUNCHER)
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "launch.py"), str(tmp_path / "worker.py"),
         str(world), str(tmp_path / "store"), str(tmp_path), str(tmp_path / "spec.json"),
         str(limit)],
        env=env, cwd=tmp_path, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=limit + 30)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"the ranks did not finish in {limit + 30} s:\n" + out[-4000:])
    assert proc.returncode == 0, out[-4000:]
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)]


def load_record(path, make_manager, encode):
    """A record dumped by ``RECORDS``' ``dump_record`` appended to the
    catalog of ``make_manager()`` (either package's manager; ``encode``
    its ``encode_record``); returns the manager."""
    import pickle
    manifest, chunks = pickle.loads(Path(path).read_bytes())
    ckpt = make_manager()
    fork = ckpt.data_root.cfork(promotable=False)
    fork.append_batch(chunks).wait()
    fork.flush()
    ckpt.catalog.append(encode(dict(manifest, data_log=fork.log_id))).wait()
    return ckpt


def dump_record(ckpt, step, path):
    """The save at ``step`` of either package's manager as ``RECORDS``
    dumps it (manifest less data_log, chunks)."""
    import pickle
    rec = ckpt._replay()[step]
    chunks = list(ckpt.system.open_log(rec["data_log"]).scan())
    Path(path).write_bytes(pickle.dumps(({k: v for k, v in rec.items() if k != "data_log"},
                                         chunks)))
