"""The histogram tier rule (the JAX package's ``ops/autotune.py``
:815-872, copied): the dense pass over ``[F, N]`` bins, or the sparse
scatter over the nnz explicit entries of a CSR-built train set
(ops/hist_wave.py ``wave_histogram_sparse``). The rest of that module
times the TPU kernels' chunk and route choices, which have no
counterpart here."""
from __future__ import annotations

from ..utils import log

# auto-tier density ceiling: the sparse scatter touches about nnz
# entries a channel where the dense pass touches N * F cells whatever
# the density; a rule, not a timed sweep, because the tier also decides
# exactness (see tune_hist_tier)
SPARSE_TIER_MAX_DENSITY = 0.125
# the GPU's lower ceiling: there the sparse tier forfeits the fused
# partition + histogram kernel, so it must win by more
SPARSE_TIER_MAX_DENSITY_GPU = 1.0 / 16.0


def tune_hist_tier(*, requested: int, density: float, quant: bool,
                   backend: str) -> bool:
    """True = the sparse histogram tier serves this booster, False = the
    dense one. ``requested`` is config.tpu_sparse (-1 auto, 0 off, 1
    force); ``backend`` is "gpu" on the card, else "cpu". Auto is
    exactness-first: integer (quantized) sums do not depend on their
    order, so only there is the sparse tier's default-bin completion
    bit-equal to the dense tier, and only under the backend's density
    ceiling. tpu_sparse=1 forces it for f32 histograms too, whose sums
    can then part from the dense tier's in the last ulp."""
    if requested == 0:
        return False
    if requested == 1:
        if not quant:
            log.info("tpu_sparse=1 with f32 histograms: the sparse "
                     "tier's default-bin completion reassociates "
                     "sums — final-ulp drift vs the dense tier is "
                     "possible (tpu_quantized_hist makes it bit-exact)")
        return True
    if not quant:
        return False
    ceiling = (SPARSE_TIER_MAX_DENSITY_GPU if backend == "gpu"
               else SPARSE_TIER_MAX_DENSITY)
    return float(density) <= ceiling
