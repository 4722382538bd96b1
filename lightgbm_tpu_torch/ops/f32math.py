"""f32 arithmetic with the JAX package's bits on every device.

The quantized tiers hash every gradient's bits into their rounding salt
(ops/quantize.py), so a gradient one ulp off re-draws every row's
rounding. The port therefore computes the two f32 operations whose
rounding XLA chooses itself the way XLA does on the CPU, with PyTorch
ops that give the same bits on the CPU and on a CUDA card:

- ``fma``: XLA contracts ``a * b + c`` into one fused multiply-add (the
  score update, ``scores + out * shrink``, and every step of its exp).
  Here: the product and the sum in float64 (the product is exact), the
  sum's rounding error by TwoSum, the sum rounded to odd, then to f32.
  Rounding to odd with 29 spare bits makes the double rounding exact
  (Boldo and Melquiond), so this is the correctly rounded fma;
- ``exp``: XLA's f32 exp on the CPU is the Cephes polynomial, evaluated
  with fused multiply-adds, with results below the smallest normal f32
  flushed to zero. Equal bit for bit to ``jax.numpy.exp`` except for
  inputs in (88.376, 88.723], within 0.35 of f32 overflow, where XLA
  splits the power of two differently and they may differ by an ulp.
"""
from __future__ import annotations

import torch

F32_TINY = 1.1754943508222875e-38       # smallest normal f32
EXP_HI = 88.3762626647949
EXP_INF = 88.72283935546875             # XLA returns inf above this
EXP_LO = -88.3762626647949
LOG2E = 1.44269504088896341
LN2_HI = -0.693359375                   # -ln 2 in two parts (Cephes)
LN2_LO = 2.12194440e-4
EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
            4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def fma(a, b, c) -> torch.Tensor:
    """The correctly rounded f32 ``a * b + c`` of f32 tensors (or
    scalars, taken as f32), broadcast."""
    ref = next(t for t in (a, b, c) if torch.is_tensor(t))
    p = _f32(a, ref).double() * _f32(b, ref).double()      # exact
    c64 = _f32(c, ref).double()
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)                      # p + c == s + err
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp with XLA's CPU bits (see the module docstring)."""
    x_in = x.to(torch.float32)
    x = x_in.clamp(EXP_LO, EXP_HI)
    fx = torch.floor(fma(x, LOG2E, 0.5))
    r = fma(fx, LN2_HI, x)
    r = fma(fx, LN2_LO, r)
    z = r * r
    y = torch.full_like(r, EXP_POLY[0])
    for coef in EXP_POLY[1:]:
        y = fma(y, r, coef)
    y = fma(y, z, r) + 1.0
    pow2 = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    y = y * pow2
    y = torch.where(x_in > EXP_INF, float("inf"), y)
    return torch.where(y < F32_TINY, 0.0, y)


# -- XLA's CPU orders of addition ---------------------------------------------
#
# A long f32 sum or prefix sum rounds by its order of addition, and XLA on
# the CPU picks that order itself. The functions below add in the same
# order with elementwise ops only, so they give the same bits on the CPU
# and on a CUDA card (a library reduction on the card adds in an order of
# its own).

SUM_WINDOW = 32      # XLA's tree reduction: windows of 32, pad split
SCAN_BLOCK = 16      # XLA's cumulative-sum rewrite: blocks of 16


def _seq_last(x: torch.Tensor) -> torch.Tensor:
    """[..., w] -> [...]: 0 + x0 + x1 + ... in sequence (the summed axis
    moved to the front first, so that each add reads contiguous rows)."""
    x = x.movedim(-1, 0).contiguous()
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for j in range(x.shape[0]):
        acc += x[j]
    return acc


def xla_sum(x: torch.Tensor, length: int = 0) -> torch.Tensor:
    """The f32 sum over the last axis in XLA's CPU order: a reduction
    longer than 32 becomes windows of 32 added in sequence, over the
    axis padded with zeros split evenly before and after (the lower half
    rounded down), repeated until at most 32 are left, which are added in
    sequence. ``length`` (>= the axis) sums as if the axis were that long
    with zeros after ``x``'s entries: the order of a longer reduction
    whose tail is zero."""
    n = max(int(length), x.shape[-1])
    while n > SUM_WINDOW:
        pad = (-n) % SUM_WINDOW
        lo = pad // 2
        w = x.shape[-1]
        tail = (-(lo + w)) % SUM_WINDOW
        x = torch.cat([x.new_zeros(x.shape[:-1] + (lo,)), x,
                       x.new_zeros(x.shape[:-1] + (tail,))], dim=-1)
        x = _seq_last(x.reshape(*x.shape[:-1], -1, SUM_WINDOW))
        n = (n + pad) // SUM_WINDOW
    return _seq_last(x)


VEC_LANES = 8        # the vectorized loop's f32 accumulators (256 bits)


def _lane_last(x: torch.Tensor) -> torch.Tensor:
    """[..., w] -> [...] in the order of a reduction loop vectorized over
    8 lanes: lane k adds x[k], x[k + 8], ... of the first 8 * (w // 8)
    entries in sequence, the lanes are folded by halves (k + 4, then
    k + 2, then k + 1), and the rest follow one by one."""
    w = x.shape[-1]
    k = w // VEC_LANES * VEC_LANES
    if k == 0:
        return _seq_last(x)
    lanes = _seq_last(x[..., :k].reshape(*x.shape[:-1], -1, VEC_LANES)
                      .transpose(-1, -2))                  # [..., 8]
    h = VEC_LANES
    while h > 1:
        h //= 2
        lanes = lanes[..., :h] + lanes[..., h:2 * h]
    acc = lanes[..., 0]
    for j in range(k, w):
        acc = acc + x[..., j]
    return acc


# the widths at which XLA's CPU compiler (on x86-64 with 256-bit vectors)
# was seen to add a reduction of at most 32 entries over 8 lanes, as
# ``_lane_last`` does; below 12 it adds in sequence, as ``xla_sum`` does,
# and at 12-15, 20-23 and 32 by loops not followed here
LANE_WIDTHS = frozenset(range(16, 20)) | frozenset(range(24, SUM_WINDOW))


def xla_vec_sum(x: torch.Tensor, length: int = 0) -> torch.Tensor:
    """``xla_sum`` of a reduction that XLA's CPU compiler vectorizes (the
    lambdarank step's pair sums): over ``length`` entries (zeros after
    ``x``'s) in ``LANE_WIDTHS`` the order of ``_lane_last``, else
    ``xla_sum``'s."""
    n = max(int(length), x.shape[-1])
    if n not in LANE_WIDTHS:
        return xla_sum(x, n)
    if x.shape[-1] < n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (n - x.shape[-1],))],
                      dim=-1)
    return _lane_last(x)


def xla_segment_sum(x: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, length: int = 0) -> torch.Tensor:
    """[S] f32: for each segment ``[start, start + count)`` of ``x`` [n],
    ``xla_sum`` of ``x`` with every entry outside the segment zero (the
    sum a vmapped JAX reduction of a masked row gives), without building
    the masked rows. A window inside the segment sums as in the unmasked
    reduction; only the first and last window of each level differ, and
    those are added here segment by segment. Empty segments give 0.
    ``length`` (>= n): the order of a sum over that many entries, the
    ones past ``x`` zero."""
    dev = x.device
    n = x.shape[0]
    a = starts.to(torch.int64).clone()
    b = a + counts.to(torch.int64)           # exclusive end
    empty = b <= a
    a = torch.where(empty, 0, a)
    b = torch.where(empty, 1, b)
    first = x[a.clamp(max=n - 1)]
    last = x[(b - 1).clamp(max=n - 1)]
    level = x
    lvl_n = max(int(length), n)
    win = torch.arange(SUM_WINDOW, device=dev)

    def masked(level, lo, a, b, first, last, c):
        """seq sum of window c of the level padded by ``lo`` in front,
        entries outside [a, b) zero, entry a is ``first`` and b - 1 is
        ``last`` (a == b - 1: ``first``)."""
        pos = c[:, None] * SUM_WINDOW + win[None, :] - lo   # level index
        inside = (pos >= a[:, None]) & (pos < b[:, None])
        vals = level[pos.clamp(0, level.shape[0] - 1)]
        vals = torch.where(pos == (b - 1)[:, None], last[:, None], vals)
        vals = torch.where(pos == a[:, None], first[:, None], vals)
        return _seq_last(torch.where(inside, vals, 0.0))

    while lvl_n > SUM_WINDOW:
        pad = (-lvl_n) % SUM_WINDOW
        lo = pad // 2
        ca = (a + lo) // SUM_WINDOW
        cb = (b - 1 + lo) // SUM_WINDOW
        new_first = masked(level, lo, a, b, first, last, ca)
        new_last = masked(level, lo, a, b, first, last, cb)
        w = level.shape[0]
        tail = (-(lo + w)) % SUM_WINDOW
        padded = torch.cat([level.new_zeros(lo), level, level.new_zeros(tail)])
        level = _seq_last(padded.reshape(-1, SUM_WINDOW))
        a, b, first, last = ca, cb + 1, new_first, new_last
        lvl_n = (lvl_n + pad) // SUM_WINDOW
    # the last level: at most 32 entries, added in sequence
    acc = torch.zeros(a.shape[0], dtype=x.dtype, device=dev)
    for j in range(lvl_n):
        v = torch.where(a == j, first,
                        torch.where(b - 1 == j, last,
                                    level[min(j, level.shape[0] - 1)]))
        acc = acc + torch.where((j >= a) & (j < b), v, 0.0)
    return torch.where(empty, 0.0, acc)


def xla_segment_cumsum(x: torch.Tensor,
                       seg_start: torch.Tensor) -> torch.Tensor:
    """[n] f32: at each row i, the prefix sum up to i of ``x`` [n] with
    every entry before ``seg_start[i]`` zero, in the order of
    ``jnp.cumsum`` on the CPU (the masked rows of a vmapped JAX cumsum,
    without building them). XLA rewrites a prefix sum longer than 16 into
    blocks of 16: sums in sequence within each block, the same rewrite of
    the block totals for the carries, each entry its in-block sum plus its
    block's carry. Only the block holding a segment's first entry differs
    from the unmasked sums, so each level carries, per row, its segment's
    first block index and that block's partial total."""
    B = SCAN_BLOCK
    dev = x.device
    n = x.shape[0]
    col = torch.arange(B, device=dev)
    q = torch.arange(n, device=dev)
    s = seg_start.to(torch.int64)
    f = x[s.clamp(max=max(n - 1, 0))]
    level = x
    parts = []            # per level: (in-block sum, carry needed)
    while True:
        m = level.shape[0]
        tail = (-m) % B
        padded = torch.cat([level, level.new_zeros(tail)])

        def block_sum(upto):
            """seq sum over the block of ``upto`` from max(block start,
            s) to ``upto``, the entry at s read as f."""
            base = (upto // B) * B
            pos = base[:, None] + col[None, :]
            vals = padded[pos.clamp(max=padded.shape[0] - 1)]
            vals = torch.where(pos == s[:, None], f[:, None], vals)
            keep = (pos >= s[:, None]) & (pos <= upto[:, None])
            return _seq_last(torch.where(keep, vals, 0.0))

        e = block_sum(q)
        if m <= B:
            parts.append((e, None))
            break
        carry = (q // B) > (s // B)
        parts.append((e, carry))
        f_next = block_sum((s // B) * B + B - 1)
        level = _seq_last(padded.reshape(-1, B))
        q = torch.clamp(q // B - 1, min=0)
        s, f = s // B, f_next
    out, _ = parts[-1]
    for e, carry in reversed(parts[:-1]):
        out = e + torch.where(carry, out, 0.0)
    return out


# XLA's f32 log on the CPU: the Cephes polynomial as Eigen's plog writes
# it, with fused multiply-adds; log1p: XLA's elemental form (a Cephes
# rational function below sqrt(2) - 1, log(1 + x) above)
LOG_SQRTHF = 0.707106781186547524
LOG_POLY = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
            -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
            2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
LOG_Q1, LOG_Q2 = -2.12194440e-4, 0.693359375
LOG1P_SMALL = 0.41421356237309504880
LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
             6.5787325942061044846969E0, 2.9911919328553073277375E1,
             6.0949667980987787057556E1, 5.7112963590585538103336E1,
             2.0039553499201281259648E1)
LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
             2.2176239823732856465394E2, 3.0909872225312059774938E2,
             2.1642788614495947685003E2, 6.0118660497603843919306E1)


def log(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log with XLA's CPU bits (0 -> -inf, < 0 -> NaN;
    subnormal inputs read as 0, as XLA's flush-to-zero reads them)."""
    x = x.to(torch.float32)
    x = torch.where(x.abs() < F32_TINY, 0.0, x)
    t = torch.clamp(x, min=F32_TINY)
    bits = t.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    # the mantissa in [0.5, 1)
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = t < LOG_SQRTHF
    tmp = torch.where(small, t, 0.0)
    t = t - 1.0
    e = e - torch.where(small, 1.0, 0.0)
    t = t + tmp
    x2 = t * t
    x3 = x2 * t
    p = LOG_POLY
    y = fma(fma(t, p[0], p[1]), t, p[2])
    y1 = fma(fma(t, p[3], p[4]), t, p[5])
    y2 = fma(fma(t, p[6], p[7]), t, p[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, LOG_Q1 * e)
    t = fma(-0.5, x2, t)
    t = fma(LOG_Q2, e, t + y)
    t = torch.where(x == 0, float("-inf"), t)
    t = torch.where(x < 0, float("nan"), t)
    return torch.where(torch.isinf(x) & (x > 0), float("inf"), t)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma(p, x, c)
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 log(1 + x) with XLA's CPU bits (subnormal inputs read as
    0)."""
    x = x.to(torch.float32)
    x = torch.where(x.abs() < F32_TINY, 0.0, x)
    x2 = x * x
    small = (x * x2) * (_horner(x, LOG1P_NUM) / _horner(x, LOG1P_DEN))
    small = x + fma(-0.5, x2, small)
    return torch.where(x.abs() < LOG1P_SMALL, small, log(x + 1.0))
