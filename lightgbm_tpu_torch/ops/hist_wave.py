"""Wave histograms (K2) and the fused partition + histogram pass (K1).

Counterparts of the JAX package's ``ops/hist_wave.py``:

- ``wave_histogram`` replaces ``wave_histogram_pallas`` (:482) and its
  Pallas-Triton twin (:1263): ``[W, F, B, 3]`` histograms (sum g, sum h,
  count) of the rows whose leaf id is each wave leaf (a -1 slot gives
  zeros);
- ``fused_partition_histogram`` replaces
  ``fused_partition_histogram_pallas`` (:984) and its twin (:1454): it
  applies a wave of W splits to the rows' leaf ids (``row_goes_right``)
  and builds each slot's smaller-child histogram over in-bag rows.

Each launches csrc/hist_wave.cu for CUDA tensors and runs its plain
version for CPU tensors; there is no other route. The plain versions are
the JAX package's XLA formulations (``wave_histogram_xla``,
``fused_partition_histogram_xla``): one ``index_add_`` of the three
channels, which on the CPU adds each cell's values in row order, bit-equal
to the JAX package's scatter. The kernel adds each cell in row order
within a row range (``row_ranges``) and the ranges in order: the same
bits on every run, and the bits of the plain version run on the CPU one
range at a time with the partials added in range order, which
chip_smoke.py holds it to. The hi/lo
bf16 channel layouts of the TPU kernels exist to pack MXU lanes; here
each channel is one f32 sum, and the layout only set the wave-width cap.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from ..utils.device import Counter
from ..utils.log import LightGBMError

# rows of K1's packed per-slot split table ([TBL_ROWS, W] int32)
TBL_PARENT, TBL_NEW, TBL_FEAT, TBL_BIN, TBL_DLEFT = 0, 1, 2, 3, 4
TBL_MISS, TBL_DEFBIN, TBL_NUMBIN, TBL_SMALL = 5, 6, 7, 8
TBL_ROWS = 9

MAX_WAVE = 64            # slot ids are one byte (csrc/hist_wave.cu)
MAX_BINS = 256           # the kernels read uint8 bins
TARGET_BLOCKS = 8 * 132  # histogram blocks per launch: 8 per H100 SM
TILE_ROWS = 1024         # rows a block stages at a time

# kernel launches since the last reset (plain versions never count)
k2_launches = Counter()
k1_launches = Counter()


def _library():
    lib = cuda_build.library("hist_wave")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wave_histogram_launch.argtypes = [p, p, p, p, p, i, ll, i, i, p, p,
                                          i, ll, p, p]
    lib.wave_histogram_launch.restype = i
    lib.fused_partition_histogram_launch.argtypes = [
        p, p, p, p, p, p, i, ll, i, i, p, p, p, i, ll, p, p]
    lib.fused_partition_histogram_launch.restype = i
    return lib


def row_ranges(n: int, num_features: int):
    """(ranges R, rows per range) of the histogram pass: about
    TARGET_BLOCKS blocks of (feature, range), each range at least one
    tile, R * rows >= n > (R - 1) * rows."""
    want = -(-TARGET_BLOCKS // max(num_features, 1))
    per = max(-(-n // max(1, min(want, -(-n // TILE_ROWS)))), 1)
    return max(-(-n // per), 1), per


# ---------------------------------------------------------------------------
# plain versions (the JAX package's XLA formulations)
# ---------------------------------------------------------------------------

def _scatter_hist3(bins_t, g, h, base, num_bins: int, num_slots: int):
    """One index_add_ of all three channels: each (row, feature) adds
    (g, h, 1) at ``base_row + f * B + bin``; rows with base = W*F*B
    land past the kept slots and are dropped. Runs in g's dtype."""
    F, n = bins_t.shape
    B = num_bins
    size = num_slots * F * B
    flat = (base[None, :].to(torch.int64)
            + torch.arange(F, device=bins_t.device)[:, None] * B
            + bins_t.to(torch.int64)).reshape(-1)
    vals = torch.stack([g.expand(F, n), h.to(g.dtype).expand(F, n),
                        torch.ones((), dtype=g.dtype,
                                   device=g.device).expand(F, n)],
                       dim=-1).reshape(-1, 3)
    hist = torch.zeros((size + F * B, 3), dtype=g.dtype, device=g.device)
    hist.index_add_(0, flat, vals)
    return hist[:size].reshape(num_slots, F, B, 3)


def _first_slot(memb):
    """[W, N] membership -> (found [N], first slot [N])."""
    return memb.any(dim=0), torch.argmax(memb.to(torch.uint8), dim=0)


def wave_histogram_plain(bins_t, g, h, leaf_ids, wave_leaves, num_bins):
    """``wave_histogram_xla`` (hist_wave.py:85) in PyTorch."""
    F, n = bins_t.shape
    W = wave_leaves.shape[0]
    B = num_bins
    eq = ((leaf_ids[None, :] == wave_leaves[:, None])
          & (wave_leaves >= 0)[:, None])
    found, slot = _first_slot(eq)
    base = torch.where(found, slot * (F * B), W * F * B)
    return _scatter_hist3(bins_t, g, h, base, B, W)


def fused_partition_histogram_plain(bins_t, g, h, sample_mask, leaf_ids, tbl,
                                    num_bins):
    """``fused_partition_histogram_xla`` (hist_wave.py:150) in PyTorch,
    numerical splits: returns (new leaf ids [N], hist [W, F, B, 3])."""
    from .partition import row_goes_right
    F, n = bins_t.shape
    B = num_bins
    W = tbl.shape[1]
    wl, new_ids, small_ids = tbl[TBL_PARENT], tbl[TBL_NEW], tbl[TBL_SMALL]
    cols = bins_t[tbl[TBL_FEAT].to(torch.int64)].to(torch.int32)  # [W, N]
    right = row_goes_right(cols, tbl[TBL_BIN][:, None],
                           tbl[TBL_DLEFT][:, None] != 0,
                           tbl[TBL_MISS][:, None], tbl[TBL_DEFBIN][:, None],
                           tbl[TBL_NUMBIN][:, None])
    eq = (leaf_ids[None, :] == wl[:, None]) & (wl >= 0)[:, None]
    moved = eq & right
    # rows match at most one slot: the masked sum is the select chain
    dest1 = torch.where(moved, new_ids[:, None] + 1, 0).sum(dim=0)
    leaf_new = torch.where(dest1 > 0, dest1 - 1, leaf_ids).to(torch.int32)
    in_bag = sample_mask > 0
    small_right = small_ids == new_ids
    memb = (eq & (moved == small_right[:, None])
            & (small_ids >= 0)[:, None] & in_bag[None, :])
    found, slot = _first_slot(memb)
    base = torch.where(found, slot * (F * B), W * F * B)
    return leaf_new, _scatter_hist3(bins_t, g, h, base, B, W)


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------

def _check_cuda(bins_t, tensors, num_bins: int, W: int) -> None:
    if bins_t.dtype != torch.uint8:
        raise LightGBMError("the histogram kernels read uint8 bins "
                            f"(max_bin <= 255); got {bins_t.dtype}")
    if not 1 <= W <= MAX_WAVE or not 1 <= num_bins <= MAX_BINS:
        raise LightGBMError(f"histogram kernel needs 1 <= W <= {MAX_WAVE} "
                            f"and 1 <= B <= {MAX_BINS}; got W={W}, "
                            f"B={num_bins}")
    for name, t, dtype in tensors:
        if t.device != bins_t.device:
            raise LightGBMError(f"{name} is on {t.device}, bins on "
                                f"{bins_t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise LightGBMError(f"{name} must be contiguous {dtype}")


def _scratch(bins_t, num_bins: int, W: int):
    F, n = bins_t.shape
    R, per = row_ranges(n, F)
    dev = bins_t.device
    slot = torch.empty(n, dtype=torch.uint8, device=dev)
    part = torch.empty((R, F, W, num_bins, 3), dtype=torch.float32,
                       device=dev)
    out = torch.empty((W, F, num_bins, 3), dtype=torch.float32, device=dev)
    return R, per, slot, part, out


def wave_histogram(bins_t, g, h, leaf_ids, wave_leaves, num_bins: int):
    """[W, F, B, 3] histograms of the rows whose leaf id equals each wave
    leaf (-1 slots give zeros). g and h are pre-masked by bagging;
    out-of-bag rows carry leaf id -1."""
    if bins_t.device.type == "cpu":
        return wave_histogram_plain(bins_t, g, h, leaf_ids, wave_leaves,
                                    num_bins)
    if bins_t.device.type != "cuda":
        raise LightGBMError(f"no histogram kernel for {bins_t.device}")
    F, n = bins_t.shape
    W = wave_leaves.shape[0]
    _check_cuda(bins_t, [("bins_t", bins_t, torch.uint8),
                         ("g", g, torch.float32), ("h", h, torch.float32),
                         ("leaf_ids", leaf_ids, torch.int32),
                         ("wave_leaves", wave_leaves, torch.int32)],
                num_bins, W)
    R, per, slot, part, out = _scratch(bins_t, num_bins, W)
    if n == 0:
        return out.zero_()
    with torch.cuda.device(bins_t.device):
        err = _library().wave_histogram_launch(
            bins_t.data_ptr(), g.data_ptr(), h.data_ptr(),
            leaf_ids.data_ptr(), wave_leaves.data_ptr(), W, n, F, num_bins,
            slot.data_ptr(), part.data_ptr(), R, per, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise LightGBMError(f"wave histogram kernel failed: CUDA error {err}")
    k2_launches.add()
    return out


def fused_partition_histogram(bins_t, g, h, sample_mask, leaf_ids, tbl,
                              num_bins: int):
    """Apply one wave of splits and build its smaller-child histograms:
    (new leaf ids [N] int32, hist [W, F, B, 3]). ``tbl`` is the packed
    [TBL_ROWS, W] int32 split table (TBL_* rows; inactive slots have
    parent -1 and safe feature 0). g and h are pre-masked; out-of-bag
    rows (sample_mask 0) move but are never counted."""
    if bins_t.device.type == "cpu":
        return fused_partition_histogram_plain(bins_t, g, h, sample_mask,
                                               leaf_ids, tbl, num_bins)
    if bins_t.device.type != "cuda":
        raise LightGBMError(f"no histogram kernel for {bins_t.device}")
    F, n = bins_t.shape
    W = tbl.shape[1]
    if tbl.shape[0] != TBL_ROWS:
        raise LightGBMError(f"split table must be [{TBL_ROWS}, W]")
    _check_cuda(bins_t, [("bins_t", bins_t, torch.uint8),
                         ("g", g, torch.float32), ("h", h, torch.float32),
                         ("sample_mask", sample_mask, torch.float32),
                         ("leaf_ids", leaf_ids, torch.int32),
                         ("tbl", tbl, torch.int32)], num_bins, W)
    R, per, slot, part, out = _scratch(bins_t, num_bins, W)
    leaf_out = torch.empty_like(leaf_ids)
    if n == 0:
        return leaf_out, out.zero_()
    with torch.cuda.device(bins_t.device):
        err = _library().fused_partition_histogram_launch(
            bins_t.data_ptr(), g.data_ptr(), h.data_ptr(),
            sample_mask.data_ptr(), leaf_ids.data_ptr(), tbl.data_ptr(), W,
            n, F, num_bins, leaf_out.data_ptr(), slot.data_ptr(),
            part.data_ptr(), R, per, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise LightGBMError(f"fused partition+histogram kernel failed: "
                            f"CUDA error {err}")
    k1_launches.add()
    return leaf_out, out
