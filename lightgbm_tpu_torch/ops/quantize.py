"""Gradient quantization of the int8 histogram tiers.

The quantize prelude of the JAX package's wave grower
(``ops/wave_grower.py:531-584``, with ``_mix32`` and ``_hash_uniform`` at
:190-210), serial learner: per tree, the scales ``sg = max|g| / 127`` and
``sh = max h / 127``, and integer g/h in [-127, 127] and [0, 127] by
stochastic rounding, ``floor(v / scale + u)``, where ``u`` is a lowbias32
hash of the row index and a per-tree salt. The salt mixes the scales'
bits with a wrapping 32-bit sum of the gradients' bits, so the draws
change whenever any gradient moves.

Bit parity with the JAX package on the CPU needs three things:
- uint32 arithmetic, which PyTorch lacks: every step runs in int64 and is
  masked to 32 bits, and the multiplies are split into 16-bit halves so
  that no int64 product overflows;
- the gradients' bit sum wraps mod 2^32: it is summed exactly in int64
  and masked;
- XLA rewrites a division by the constant 127 into a product with
  f32(1/127) (its algebraic simplifier), so ``sg`` and ``sh`` are that
  product here too; the division of each gradient by the (traced) scale
  stays a division.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INV127 = float(np.float32(1.0) / np.float32(127.0))   # XLA's rewrite of /127
GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) as int64, without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 (``_mix32``): uint32 values held in int64."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_uniform(idx: torch.Tensor, salt) -> torch.Tensor:
    """Per-row uniform draws in [0, 1) (``_hash_uniform``): the top 24
    bits of mix32(idx ^ salt), times 2^-24, in f32."""
    return (mix32(idx ^ salt) >> 8).to(torch.float32) * (2.0 ** -24)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The IEEE bits of an f32 scalar tensor, as an int64 in [0, 2^32)."""
    return x.reshape(1).view(torch.int32).to(torch.int64)[0] & MASK32


class Quantized(NamedTuple):
    """One tree's quantized gradients: int8 gq, hq [N] and their f32
    scalar scales (the sums dequantize as ``sum * scale``)."""
    gq: torch.Tensor
    hq: torch.Tensor
    sg: torch.Tensor
    sh: torch.Tensor


def _same(x):
    return x


def quantize(grad: torch.Tensor, hess: torch.Tensor, max_reduce=_same,
             sum_reduce=_same, row_offset: int = 0) -> Quantized:
    """Quantize one tree's gradients on their device, with no readback;
    ``grad`` and ``hess`` are f32 and already multiplied by the bagging
    mask.

    A row-sharded learner (parallel/learners.py) passes its collectives:
    ``max_reduce`` makes the scales global (a max over ranks is exact),
    ``sum_reduce`` adds the ranks' int64 bit sums (exact; the salt takes
    them mod 2^32, as a wrapping sum would), and ``row_offset`` is the
    global index of the first row, so each row draws what it draws in a
    serial run (the JAX package's :535-569)."""
    tiny = float(np.float32(1e-30))
    sg = torch.clamp(max_reduce(grad.abs().max()), min=tiny) * INV127
    sh = torch.clamp(max_reduce(hess.max()), min=tiny) * INV127
    bg, bh = _bits(sg), _bits(sh)
    gbits = sum_reduce(grad.view(torch.int32).to(torch.int64).sum()) & MASK32
    salt = bg ^ (((bh << 16) | (bh >> 16)) & MASK32) ^ mix32(gbits)
    idx = torch.arange(grad.shape[0], dtype=torch.int64,
                       device=grad.device) + row_offset
    u_g = hash_uniform(idx, salt)
    u_h = hash_uniform(idx, salt ^ GOLDEN)
    gq = torch.clamp(torch.floor(grad / sg + u_g), -127.0, 127.0)
    hq = torch.clamp(torch.floor(hess / sh + u_h), 0.0, 127.0)
    return Quantized(gq.to(torch.int8), hq.to(torch.int8), sg, sh)
