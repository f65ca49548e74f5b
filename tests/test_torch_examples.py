"""The examples' PyTorch twins (``examples/*_torch.py``) run to completion on
the CPU as real subprocesses, with ``jax`` and ``repro`` blocked from import:
a user of the port alone, on a machine without JAX, runs them the same way.
Each twin asserts its own invariants (exact speculative decode, the durable
serve cursor, the agents' outcomes), so a zero exit code and the lines that
``tests/test_examples_smoke.py`` greps the reference examples for are the
contract."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120          # seconds a twin may take; each takes under 20 here alone

_BLOCKED = (
    "import runpy, sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'repro'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
    "assert not bad, bad\n")

TWINS = {
    "quickstart_torch.py": ((), ("committed at", "losing path rejected:",
                                 "next poll sees the new record:")),
    "serve_torch.py": ((), ("engine served 4 requests", "byte-identical to sequential")),
    "train_e2e_torch.py": (("--steps", "60"), ("resumed from step", "phase2 final")),
    "agents_on_streams_torch.py": ((), ("[analytics] root log untouched: True",
                                        "[testing] no test event leaked: True",
                                        "[supply-chain] mistake caught before promote: True",
                                        "[gc] reclaimed")),
}


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_runs_on_the_cpu_without_jax(name):
    args, lines = TWINS[name]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(ROOT / "examples" / name), *args,
         "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, (
        f"{name} failed:\n--- stdout ---\n{proc.stdout[-2000:]}"
        f"\n--- stderr ---\n{proc.stderr[-2000:]}")
    for line in lines:
        assert line in proc.stdout, (line, proc.stdout[-2000:])
