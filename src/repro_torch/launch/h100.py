"""H100 SXM datasheet figures, in one place, as PERF.md's kernel bounds use
them: the dry run's roofline (``launch/dryrun.py``) and the serving cost
model (``serve/costs.py``) read them from here. This module imports
nothing, so the serving layer does not load the dry run."""

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per card
HBM_BW = 3.35e12             # B/s per card
NVLINK_BW = 450e9            # NVLink 4, B/s per card in each direction
