"""The PyTorch port's package boundary.

* The JAX-free modules the port needs are byte-identical copies of the JAX
  package's (the port imports nothing of ``repro``); a copy that drifts fails.
* The port, and the examples' twins (``examples/*_torch.py``), import
  neither ``jax`` nor ``repro``, and their entry points ask for the card
  unless told otherwise (a twin through its ``--device`` default).
* A reference quirk, pinned: the JAX full-sequence forward returns keys from
  before qk-norm and RoPE as its cache (``attention.py:243``), which no decode
  step can use; the port's prefill cache is the one decode builds.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

COPIES = (
    [f"core/{m}.py" for m in ("__init__", "api", "broker", "compact", "errors",
                              "faults", "gc", "index", "linearize", "ltt",
                              "metadata", "objectstore", "raft", "sim")]
    + [f"streams/{m}.py" for m in ("__init__", "records", "topics")]
    + ["serve/speculative.py", "models/config.py"]
    + [f"data/{m}.py" for m in ("__init__", "pipeline")]
    + [f"agents/{m}.py" for m in ("__init__", "analytics", "supplychain", "testing")]
    + sorted(f"configs/{p.name}" for p in (SRC / "configs").glob("*.py")))


def test_copies_cover_every_config_module():
    assert len([c for c in COPIES if c.startswith("configs/")]) == 12


def test_copies_cover_every_agents_module():
    assert sorted(c for c in COPIES if c.startswith("agents/")) == \
        sorted(f"agents/{p.name}" for p in (SRC / "agents").glob("*.py"))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (SRC / rel).read_bytes(), \
        f"src/repro_torch/{rel} drifted from src/repro/{rel}"


_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:\.|\s|$)", re.M)


TWINS = sorted((ROOT / "examples").glob("*_torch.py"))


def test_port_sources_import_no_jax_or_repro():
    assert [p.name for p in TWINS] == ["agents_on_streams_torch.py", "quickstart_torch.py",
                                       "serve_torch.py", "train_e2e_torch.py"]
    for path in sorted(PORT.rglob("*.py")) + TWINS:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _run_twin(path):
    """An example twin as ``python examples/<name>`` with no arguments."""
    import runpy
    argv = sys.argv
    sys.argv = [str(path)]
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv


def test_entry_points_default_to_the_card(monkeypatch):
    import repro_torch as rt
    from repro_torch.models.layers import resolve_device
    cfg = rt.get_smoke_config("smollm-135m")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, start_single_rank
    for call in (lambda: rt.init_params(cfg, 0),
                 lambda: rt.init_caches(cfg, 1, 4),
                 lambda: rt.params_from_jax(cfg, {}),
                 lambda: make_host_mesh(),
                 lambda: make_mesh((1, 1), ("data", "model")),
                 lambda: start_single_rank(),
                 *(lambda path=path: _run_twin(path) for path in TWINS)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device().type == "cuda"
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.slow
def test_prefill_cache_quirk_of_the_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro_torch as rt
    from repro.configs import get_smoke_config
    from repro.models import lm as jlm
    from repro.models.layers import rms_norm

    cfg = get_smoke_config("qwen3-8b").with_(dtype="float32")   # qk-norm on
    jp = jlm.init_params(cfg, jax.random.key(0))
    tm = rt.params_from_jax(cfg, jax.device_get(jp), device="cpu")
    B, S = 2, 8
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    _, _, jfull, _ = jlm.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                                 want_caches=True)
    jdec = jlm.init_caches(cfg, B, S)
    for t in range(S):
        _, jdec = jlm.decode_step(cfg, jp, jdec, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(t, jnp.int32))
    k_full = np.asarray(jfull["groups"][0]["k"])          # (layers, B, KH, S, Dh)
    k_dec = np.asarray(jdec["groups"][0]["k"])
    # the quirk: layer 0's "cache" is the raw projection of its input ...
    g0 = jax.tree.map(lambda a: a[0], jp["groups"][0])
    h = rms_norm(jp["embed"][toks] * cfg.d_model ** 0.5, g0["ln1"], cfg.norm_eps)
    k_raw = np.asarray(jnp.einsum("bsd,dhq->bhsq", h, g0["attn"]["wk"]))
    np.testing.assert_allclose(k_full[0], k_raw, rtol=1e-5, atol=1e-5)
    # ... so it is not the cache the decode step builds
    assert np.abs(k_full - k_dec).max() > 0.1
    _, _, tcache, _ = rt.forward(cfg, tm, {"tokens": torch.from_numpy(toks)},
                                 want_caches=True)
    for i, layer in enumerate(tcache["layers"]):
        np.testing.assert_allclose(layer["k"].numpy(), k_dec[i], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(layer["v"].numpy(),
                                   np.asarray(jdec["groups"][0]["v"][i]),
                                   rtol=1e-5, atol=1e-5)
