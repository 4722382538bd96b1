"""The histogram tier rule (the JAX package's ``ops/autotune.py``
:815-872, copied): the dense pass over ``[F, N]`` bins, or the sparse
scatter over the nnz explicit entries of a CSR-built train set
(ops/hist_wave.py ``wave_histogram_sparse``); and the data learner's
three collective rules (:872-1063): the quantized wire, its dtype and
its slots (parallel/learners.py). The rest of that module times the TPU
kernels' chunk and route choices, which have no counterpart here."""
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


# ---------------------------------------------------------------------------
# the data learner's histogram collective (the JAX package's :872-1063)
# ---------------------------------------------------------------------------

# the int32 wire's bound: every device sums the int8 tier in int32 here
# (the JAX package's CPU route sums integer-valued f32, bound 2^24)
INT32_WIRE_BOUND = 2 ** 31
# the narrow wires' wrap bounds: a cell's |sum| <= 127 * n_rows_global,
# and inside the narrow signed range the narrowing cast, the integer sum
# and the widening cast are all exact, bit-identical to the int32 wire
PSUM_WIRE_BOUNDS = (("int8", 2 ** 7), ("int16", 2 ** 15))


def tune_hist_psum(*, world: int, W: int, F: int, B: int, channels: int,
                   n_rows_global: int, requested: int = -1) -> bool:
    """The data learner's wire (``tpu_quantized_psum``: -1 auto, 0 off,
    1 force): True sums the raw int32 histograms and dequantizes after
    the collective (exact: the int8 trees equal the serial learner's),
    False sums dequantized f32. The int32 wire holds while
    127 * n_rows_global < 2^31; past it the f32 wire is used. Auto is
    the int32 wire: the JAX package times the two wires on a TPU mesh
    and otherwise takes this analytic default, and the port has no
    tuner cache (``measure_psum_s`` times a collective on demand)."""
    if requested == 0:
        return False
    if 127 * max(int(n_rows_global), 1) >= INT32_WIRE_BOUND:
        if requested == 1:
            log.warning("tpu_quantized_psum=1 requested but %d global rows "
                        "could overflow the quantized wire; using the f32 "
                        "reduction", n_rows_global)
        return False
    return True


def tune_psum_wire(*, n_rows_global: int, requested: int = -1) -> str:
    """The quantized collective's dtype (``tpu_psum_wire``): "int8" or
    "int16" where the 127*N bound proves the narrow sum exact, else
    "int32". 0 keeps int32; 1 forces narrow (with a warning and int32
    where the bound refuses); -1 takes the narrowest safe width."""
    if requested == 0:
        return "int32"
    n = max(int(n_rows_global), 1)
    for wire, bound in PSUM_WIRE_BOUNDS:
        if 127 * n < bound:
            return wire
    if requested == 1:
        log.warning("tpu_psum_wire=1 requested but %d global rows exceed "
                    "every narrow wrap bound (127*N < 2^15 needed for "
                    "int16); using the int32 wire", n)
    return "int32"


def tune_hist_psum_async(*, F: int, requested: int = -1) -> int:
    """The slot count of the histogram collective (``tpu_async_psum``):
    1 = one collective, 2 = two along the feature axis (bit-identical,
    parallel/learners.py ``slot_psum``). 0 sync, 1 force two, -1 one.
    The JAX package's auto takes two off a TPU, where XLA overlaps the
    two collectives; here they are two blocking calls in turn, each
    staged through host memory under gloo, so auto keeps one
    (``measure_psum_s`` times the two against each other on a group:
    chip_smoke.py phase 30, PERF.md)."""
    if F < 2:
        if requested == 1:
            log.info("tpu_async_psum=1 with a single feature column: the "
                     "collective has one slot either way")
        return 1
    return 2 if requested == 1 else 1


def measure_psum_s(shape, dtype, repeats: int = 5, device=None,
                   slots: int = 1) -> float:
    """Seconds the histogram collective of ``shape`` and ``dtype`` takes
    on this process group in ``slots`` slots (``slot_psum``; the median
    of ``repeats`` calls, every rank calling together): the real
    collective, staging included, outside the training step. 0.0
    alone."""
    import statistics
    import time

    import torch

    from ..parallel import learners
    x = torch.ones(shape, dtype=dtype, device=device)
    times = []
    for _ in range(max(int(repeats), 1)):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        y = learners.slot_psum(x, slots)
        if y.device.type == "cuda":
            torch.cuda.synchronize(y.device)
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times)) if learners._group_size() > 1 \
        else 0.0
