"""The port's serving cost model (``repro_torch.serve.costs``) against the
reference's (``repro.serve.costs``), on the CPU.

The analytic constructors keep the reference's formulas: every ``Cost``
term equals the reference's exactly, for every registered config at full
size over a grid of batch, context, draft depth and tensor-parallel width.
The roofline is the reference's rule on the H100 datasheet figures, which
the port holds in one place (``launch/h100.py``). The analytic decode
FLOPs are held against ``FlopCounterMode``'s count of one ``decode_step``
on the meta device. Neither package's cost module imports JAX.
"""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.serve import costs as ref  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun, h100  # noqa: E402
from repro_torch.serve import ServeCosts, costs  # noqa: E402

BATCHES, CONTEXTS, DEPTHS, DEVICES = (1, 4, 32), (1, 512, 32768), (0, 1, 4), (1, 2, 8)


def _terms(cost):
    return cost.flops, cost.bytes, cost.coll


def test_figures_are_the_h100_datasheet_in_one_place():
    """989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM, NVLink 4 at 450e9 B/s a
    direction: ``launch/h100.py``'s constants, which the cost model and the
    dry run both import. The serving layer does not load the dry run."""
    assert (h100.PEAK_FLOPS, h100.HBM_BW, h100.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert costs.PEAK_FLOPS is h100.PEAK_FLOPS and costs.HBM_BW is h100.HBM_BW
    assert costs.NVLINK_BW is h100.NVLINK_BW
    assert dryrun.PEAK_FLOPS is h100.PEAK_FLOPS and dryrun.HBM_BW is h100.HBM_BW
    assert not hasattr(costs, "ICI_BW") and not hasattr(costs, "step_cost_from_hlo")
    src = Path(h100.__file__).read_text()
    assert "import" not in src.split('"""')[-1]
    code = ("import sys, repro_torch.serve; "
            "assert 'repro_torch.launch.dryrun' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, env={
        **os.environ, "PYTHONPATH": str(Path(h100.__file__).parents[2])})


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_terms_equal_the_reference(arch):
    """flops, bytes and the collectives of decode, prefill and verify, and
    the helpers under them, equal the reference's exactly."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert costs._attn_layers(cfg) == ref._attn_layers(jcfg)
    assert costs.kv_bytes_per_token(cfg) == ref.kv_bytes_per_token(jcfg)
    for batch, context, n in itertools.product(BATCHES, CONTEXTS, DEVICES):
        assert _terms(costs.decode_cost(cfg, batch, context, n)) == \
            _terms(ref.decode_cost(jcfg, batch, context, n))
        assert _terms(costs.prefill_cost(cfg, batch, context, n)) == \
            _terms(ref.prefill_cost(jcfg, batch, context, n))
        for k in DEPTHS:
            assert _terms(costs.verify_cost(cfg, batch, context, k, n)) == \
                _terms(ref.verify_cost(jcfg, batch, context, k, n))


@pytest.mark.parametrize("n", DEVICES)
def test_roofline_is_the_max_of_three_terms(n):
    """max(flops / n / peak, bytes / n / HBM, link bytes / NVLink); each term
    wins somewhere in the grid (the link term only under tensor parallelism)."""
    won = set()
    for arch in ARCHS:
        cfg = get_config(arch)
        for cost in (costs.decode_cost(cfg, 4, 512, n), costs.prefill_cost(cfg, 32, 32768, n),
                     costs.verify_cost(cfg, 32, 1, 4, n)):
            terms = (cost.flops / n / 989e12, cost.bytes / n / 3.35e12,
                     cost.collective_bytes / 450e9)
            assert costs.roofline_seconds(cost, n) == max(terms)
            won.add(terms.index(max(terms)))
    assert won == ({0, 1} if n == 1 else {0, 1, 2})


@pytest.mark.parametrize("n", [0, -1])
def test_roofline_refuses_fewer_than_one_device(n):
    with pytest.raises(ValueError, match="n_devices must be >= 1"):
        costs.roofline_seconds(costs.Cost(1.0, 1.0), n)


@pytest.mark.parametrize("target, draft, batch, context, devices", [
    ("qwen3-8b", "smollm-135m", 4, 32, (1, 1)),
    ("qwen3-8b", "smollm-135m", 8, 512, (1, 1)),
    ("deepseek-67b", "smollm-135m", 16, 4096, (8, 1)),
    ("jamba-1.5-large-398b", "qwen3-8b", 2, 32768, (8, 2)),
])
def test_serve_costs_are_the_reference_costs_on_the_h100(target, draft, batch, context, devices):
    """``ServeCosts.for_models`` equals the reference's ``Cost``s pushed
    through the port's roofline, to 1e-12 relative."""
    td, dd = devices
    got = ServeCosts.for_models(get_config(target), get_config(draft), batch=batch,
                                context=context, target_devices=td, draft_devices=dd)
    jt, jd = jax_get_config(target), jax_get_config(draft)
    roof = costs.roofline_seconds
    v0 = roof(ref.verify_cost(jt, batch, context, 0, td), td)
    v4 = roof(ref.verify_cost(jt, batch, context, 4, td), td)
    want = {"prefill_per_token": roof(ref.prefill_cost(jt, batch, context, td), td) / context,
            "decode_step": roof(ref.decode_cost(jt, batch, context, td), td),
            "draft_step": roof(ref.decode_cost(jd, batch, context, dd), dd),
            "verify_base": v0, "verify_per_token": (v4 - v0) / 4.0}
    for key, value in want.items():
        assert getattr(got, key) == pytest.approx(value, rel=1e-12, abs=0), key
    for k in range(5):
        assert got.verify(k) == pytest.approx(v0 + (v4 - v0) / 4.0 * k, rel=1e-12)


@pytest.mark.parametrize("arch, ratio", [("smollm-135m", 4 / 3), ("qwen3-8b", 38 / 27)])
def test_decode_flops_against_the_flop_counter(arch, ratio):
    """The analytic decode FLOPs, ``2 * active * batch``, against
    ``FlopCounterMode``'s count of one ``decode_step`` of the smoke config on
    the meta device (B=4, a cache of 32 positions). ``active`` leaves out the
    vocabulary matrices (``count_params``: embeddings are excluded from
    active), and the formula charges no attention FLOPs, so the counter
    sees exactly two terms more: the head's product, 2 B V D (tied or not),
    and the decode attention over the cache, 2 products of 2 B H Dh ctx a
    layer. At this small size they weigh a third (smollm, 4 layers) and 0.41
    (qwen3, 3 layers) of the analytic count. At full size, same batch and
    context, the head is 0.0897 of qwen3-8b's analytic count and 0.267 of
    smollm-135m's, the attention 0.0014 and 0.0104: the decode roofline is
    bytes-bound there, so its time does not move."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.specs import abstract_caches, abstract_params
    from repro_torch.models.lm import decode_step
    cfg = get_smoke_config(arch)
    B, ctx = 4, 32
    model, caches = abstract_params(cfg), abstract_caches(cfg, B, ctx)
    tokens = torch.zeros((B, 1), dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        decode_step(cfg, model, caches, tokens, ctx - 1)
    counted = counter.get_total_flops()
    analytic = costs.decode_cost(cfg, B, ctx).flops
    head = 2 * B * cfg.padded_vocab * cfg.d_model
    attention = 2 * 2 * B * costs._attn_layers(cfg) * cfg.n_heads * cfg.head_dim_ * ctx
    assert counted == analytic + head + attention
    assert counted / analytic == pytest.approx(ratio, rel=1e-12)
