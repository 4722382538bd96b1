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
