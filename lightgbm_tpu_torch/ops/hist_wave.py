"""Wave histograms (K2) and the fused partition + histogram pass (K1).

Counterparts of the JAX package's ``ops/hist_wave.py``:

- ``wave_histogram`` replaces ``wave_histogram_pallas`` (:482) and its
  Pallas-Triton twin (:1263): ``[W, F, B, 3]`` histograms (sum g, sum h,
  count) of the rows whose leaf id is each wave leaf (a -1 slot gives
  zeros);
- ``fused_partition_histogram`` replaces
  ``fused_partition_histogram_pallas`` (:984) and its twin (:1454): it
  applies a wave of W splits to the rows' leaf ids (``row_goes_right``)
  and builds each slot's smaller-child histogram over in-bag rows. With
  ``any_cat`` the split table carries each slot's categorical flag and
  left-set bitset (``TBL_ISCAT``, ``TBL_CATW``: 18 rows in the JAX
  package's row order); without it the categorical rows are not read
  and may be left out (9 rows), as the JAX kernel's static ``any_cat``
  compiles them out.

Both come in the JAX kernels' variants:

- ``precision="f32"`` (the exact tier): f32 g, h; [W, F, B, 3] f32 sums;
- ``precision="int8"`` (``tpu_quantized_hist``): int8 g, h from
  ops/quantize.py; exact int32 sums over [W, F, B, 3], or with
  ``count_proxy`` [W, F, B, 2] (no count channel) and, from K1, each
  slot's exact in-bag moved-right count ``cnt_r`` [W] f32. With
  ``gh_scale = (sg, sh)`` the sums come back dequantized, ``sum.to(f32)
  * scale`` per channel (the JAX package's order), else as raw int32;
- ``packed4``: bins [ceil(F/2), N] with two 4-bit bins per byte (feature
  f in byte row f // 2, low nibble when f is even; ``pack4``) and
  ``num_features`` = F; with the f32 or the count-proxy tier.

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

The int8 plain versions add int64 in one ``index_add_`` per channel and
cast to int32, the TPU kernel's exact int32 sums. The JAX package's CPU
route instead adds integer-valued f32, exact only while a cell's |sum|
< 2^24; on smaller inputs the two agree. A packed plain version unpacks
first. Integer sums do not depend on order, so the int8 kernels equal
their plain versions on the card; a packed kernel launch reads the same
bins in the same order as an unpacked one and gives its bits.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from ..utils.device import Counter
from ..utils.log import LightGBMError

# rows of K1's packed per-slot split table ([TBL_ROWS, W] int32): the
# numerical rows, then the categorical flag and NCAT_WORDS bitset words
TBL_PARENT, TBL_NEW, TBL_FEAT, TBL_BIN, TBL_DLEFT = 0, 1, 2, 3, 4
TBL_MISS, TBL_DEFBIN, TBL_NUMBIN, TBL_SMALL = 5, 6, 7, 8
TBL_ROWS_NUM = 9
TBL_ISCAT = 9
TBL_CATW = 10
TBL_ROWS = 18

MAX_WAVE = 64            # slot ids are one byte (csrc/hist_wave.cu)
MAX_BINS = 256           # the kernels read uint8 bins
MAX_BINS_PACKED = 16     # two 4-bit bins per byte
TARGET_BLOCKS = 8 * 132  # histogram blocks per launch: 8 per H100 SM
TILE_ROWS = 1024         # rows a block stages at a time

# kernel launches since the last reset (plain versions never count), in
# all and by variant
VARIANTS = ("f32", "f32_packed4", "int8", "proxy", "proxy_packed4")
k2_launches = Counter()
k1_launches = Counter()
k2_variant_launches = {v: Counter() for v in VARIANTS}
k1_variant_launches = {v: Counter() for v in VARIANTS}
# K1 launches that read the categorical rows (``any_cat``)
k1_cat_launches = Counter()


def variant(precision: str, count_proxy: bool, packed4: bool) -> str:
    """The name of a histogram kernel variant (``VARIANTS``)."""
    base = ("proxy" if count_proxy else "int8") if precision == "int8" \
        else "f32"
    return base + ("_packed4" if packed4 else "")


def _library():
    lib = cuda_build.library("hist_wave")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wave_histogram_launch.argtypes = [p, p, p, p, p, i, ll, i, i, i, p,
                                          p, i, ll, p, p]
    lib.wave_histogram_launch.restype = i
    lib.fused_partition_histogram_launch.argtypes = [
        p, p, p, p, p, p, i, ll, i, i, i, i, p, p, p, i, ll, p, p]
    lib.fused_partition_histogram_launch.restype = i
    lib.wave_histogram_int_launch.argtypes = [
        p, p, p, p, p, i, ll, i, i, i, i, p, i, ll, p, p]
    lib.wave_histogram_int_launch.restype = i
    lib.fused_partition_histogram_int_launch.argtypes = [
        p, p, p, p, p, p, i, ll, i, i, i, i, i, p, p, p, i, ll, p, p]
    lib.fused_partition_histogram_int_launch.restype = i
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


def _scatter_hist_int(bins_t, gq, hq, base, num_bins: int, num_slots: int,
                      channels: int):
    """The int8 tier's scatter: the flat index of ``_scatter_hist3``, one
    int64 ``index_add_`` per channel ((gq, hq, 1), or (gq, hq) for 2
    channels), cast to the kernels' int32: [W, F, B, channels]."""
    F, n = bins_t.shape
    B = num_bins
    size = num_slots * F * B
    flat = (base[None, :].to(torch.int64)
            + torch.arange(F, device=bins_t.device)[:, None] * B
            + bins_t.to(torch.int64)).reshape(-1)
    hist = torch.zeros((channels, size + F * B), dtype=torch.int64,
                       device=bins_t.device)
    ones = torch.ones((), dtype=torch.int64, device=bins_t.device)
    for c, v in enumerate((gq, hq, ones)[:channels]):
        hist[c].index_add_(0, flat, v.to(torch.int64).expand(F, n)
                           .reshape(-1))
    return (hist[:, :size].to(torch.int32)
            .reshape(channels, num_slots, F, B).permute(1, 2, 3, 0)
            .contiguous())


def _scatter(bins_t, g, h, base, num_bins, num_slots, count_proxy):
    """The tier's scatter: int8 g/h give exact int32 sums (2 channels
    under count-proxy), f32 or f64 g/h their own dtype's sums."""
    if g.dtype == torch.int8:
        return _scatter_hist_int(bins_t, g, h, base, num_bins, num_slots,
                                 2 if count_proxy else 3)
    return _scatter_hist3(bins_t, g, h, base, num_bins, num_slots)


def pack4(bins_t: torch.Tensor) -> torch.Tensor:
    """[F, N] uint8 bins of at most 16 values -> [ceil(F/2), N], two per
    byte, even features in the low nibble (the JAX package's
    ``_pack4_host``; an odd F gets a zero row)."""
    if bins_t.shape[0] % 2:
        bins_t = torch.cat([bins_t, bins_t.new_zeros(1, bins_t.shape[1])])
    return bins_t[0::2] | (bins_t[1::2] << 4)


def unpack4(packed: torch.Tensor, num_features: int) -> torch.Tensor:
    """``pack4``'s inverse: [F, N] uint8."""
    return torch.stack([packed & 15, packed >> 4], dim=1).reshape(
        -1, packed.shape[1])[:num_features]


def _first_slot(memb):
    """[W, N] membership -> (found [N], first slot [N])."""
    return memb.any(dim=0), torch.argmax(memb.to(torch.uint8), dim=0)


def wave_histogram_plain(bins_t, g, h, leaf_ids, wave_leaves, num_bins,
                         count_proxy=False, packed4=False,
                         num_features=None):
    """``wave_histogram_xla`` (hist_wave.py:85) in PyTorch: raw sums in
    the tier of g's dtype (int8 -> int32)."""
    if packed4:
        bins_t = unpack4(bins_t, num_features)
    F, n = bins_t.shape
    W = wave_leaves.shape[0]
    B = num_bins
    eq = ((leaf_ids[None, :] == wave_leaves[:, None])
          & (wave_leaves >= 0)[:, None])
    found, slot = _first_slot(eq)
    base = torch.where(found, slot * (F * B), W * F * B)
    return _scatter(bins_t, g, h, base, B, W, count_proxy)


def fused_partition_histogram_plain(bins_t, g, h, sample_mask, leaf_ids, tbl,
                                    num_bins, count_proxy=False,
                                    packed4=False, num_features=None,
                                    any_cat=False):
    """``fused_partition_histogram_xla`` (hist_wave.py:150) in PyTorch:
    returns (new leaf ids [N], hist [W, F, B, C]) with raw sums in the
    tier of g's dtype, and with ``count_proxy`` also cnt_r [W] f32, each
    slot's in-bag rows moved right. With ``any_cat``, slots whose
    ``TBL_ISCAT`` row is set split categorically on their bitset."""
    from .partition import row_goes_right
    if packed4:
        bins_t = unpack4(bins_t, num_features)
    F, n = bins_t.shape
    B = num_bins
    W = tbl.shape[1]
    wl, new_ids, small_ids = tbl[TBL_PARENT], tbl[TBL_NEW], tbl[TBL_SMALL]
    cols = bins_t[tbl[TBL_FEAT].to(torch.int64)].to(torch.int32)  # [W, N]
    cat = {}
    if any_cat:
        cat = dict(is_cat=tbl[TBL_ISCAT][:, None] != 0,
                   cat_words=tbl[TBL_CATW:TBL_ROWS].T)
    right = row_goes_right(cols, tbl[TBL_BIN][:, None],
                           tbl[TBL_DLEFT][:, None] != 0,
                           tbl[TBL_MISS][:, None], tbl[TBL_DEFBIN][:, None],
                           tbl[TBL_NUMBIN][:, None], **cat)
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
    hist = _scatter(bins_t, g, h, base, B, W, count_proxy)
    if not count_proxy:
        return leaf_new, hist
    cnt_r = (moved & in_bag[None, :]).sum(dim=1).to(torch.float32)
    return leaf_new, hist, cnt_r


def dequantize(hist: torch.Tensor, gh_scale) -> torch.Tensor:
    """int32 sums [..., C] -> f32: channel 0 times sg, 1 times sh, the
    count channel (C = 3) times 1, as the JAX package's ``_qscale_vec``."""
    sg, sh = gh_scale
    one = torch.ones((), dtype=torch.float32, device=hist.device)
    scale = torch.stack([sg.to(torch.float32).reshape(()),
                         sh.to(torch.float32).reshape(()), one])
    return hist.to(torch.float32) * scale[:hist.shape[-1]]


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------

def _check_tier(n: int, num_bins: int, precision: str, count_proxy: bool,
                packed4: bool, num_features, g) -> None:
    """The JAX kernels' refusals (hist_wave.py:508-531, :1023-1048)."""
    if precision not in ("f32", "int8"):
        raise LightGBMError(f"unknown histogram precision {precision!r}")
    int8 = precision == "int8"
    if int8 != (g.dtype == torch.int8):
        raise LightGBMError(f"precision={precision} got g of {g.dtype}")
    if count_proxy and not int8:
        raise NotImplementedError("count_proxy requires precision='int8'")
    if packed4:
        if num_bins > MAX_BINS_PACKED:
            raise NotImplementedError("packed4 needs max_bin <= 16")
        if int8 and not count_proxy:
            raise NotImplementedError(
                "packed4 needs the count-proxy or hi/lo exact tier")
        if num_features is None:
            raise LightGBMError("packed4 needs num_features")
    if int8 and 127 * n >= 2 ** 31:
        raise NotImplementedError(
            "int8 histogram sums could overflow int32 beyond ~16.9M "
            "rows; disable tpu_quantized_hist")


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
        if name not in ("bins_t", "wave_leaves", "tbl") and \
                t.shape != (bins_t.shape[1],):
            raise LightGBMError(f"{name} must have one entry per row "
                                f"({bins_t.shape[1]}); got {tuple(t.shape)}")


def _logical_features(bins_t, packed4: bool, num_features) -> int:
    F = int(num_features) if packed4 else bins_t.shape[0]
    if packed4 and bins_t.shape[0] != (F + 1) // 2:
        raise LightGBMError(f"packed bins of {bins_t.shape[0]} rows hold "
                            f"{2 * bins_t.shape[0]} features, not {F}")
    return F


def _finish(hist, gh_scale, precision):
    if precision == "int8" and gh_scale is not None:
        return dequantize(hist, gh_scale)
    return hist


def wave_histogram(bins_t, g, h, leaf_ids, wave_leaves, num_bins: int, *,
                   precision: str = "f32", count_proxy: bool = False,
                   packed4: bool = False, num_features=None,
                   gh_scale=None):
    """[W, F, B, C] histograms of the rows whose leaf id equals each wave
    leaf (-1 slots give zeros). g and h are pre-masked by bagging;
    out-of-bag rows carry leaf id -1. See the module docstring for the
    tiers; int8 sums come back raw unless ``gh_scale`` is given."""
    n = bins_t.shape[1]
    _check_tier(n, num_bins, precision, count_proxy, packed4, num_features,
                g)
    if bins_t.device.type == "cpu":
        return _finish(wave_histogram_plain(
            bins_t, g, h, leaf_ids, wave_leaves, num_bins, count_proxy,
            packed4, num_features), gh_scale, precision)
    if bins_t.device.type != "cuda":
        raise LightGBMError(f"no histogram kernel for {bins_t.device}")
    F = _logical_features(bins_t, packed4, num_features)
    W = wave_leaves.shape[0]
    gdt = torch.int8 if precision == "int8" else torch.float32
    _check_cuda(bins_t, [("bins_t", bins_t, torch.uint8),
                         ("g", g, gdt), ("h", h, gdt),
                         ("leaf_ids", leaf_ids, torch.int32),
                         ("wave_leaves", wave_leaves, torch.int32)],
                num_bins, W)
    R, per = row_ranges(n, F)
    dev = bins_t.device
    slot = torch.empty(n, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    int8 = precision == "int8"
    out = torch.zeros((W, F, num_bins, (2 if count_proxy else 3)),
                      dtype=torch.int32 if int8 else torch.float32,
                      device=dev)
    if n == 0:
        return _finish(out, gh_scale, precision)
    lib = _library()
    with torch.cuda.device(dev):
        if int8:
            err = lib.wave_histogram_int_launch(
                bins_t.data_ptr(), g.data_ptr(), h.data_ptr(),
                leaf_ids.data_ptr(), wave_leaves.data_ptr(), W, n, F,
                num_bins, out.shape[-1], int(packed4), slot.data_ptr(), R,
                per, out.data_ptr(), stream)
        else:
            part = torch.empty((R, F, W, num_bins, 3), dtype=torch.float32,
                               device=dev)
            err = lib.wave_histogram_launch(
                bins_t.data_ptr(), g.data_ptr(), h.data_ptr(),
                leaf_ids.data_ptr(), wave_leaves.data_ptr(), W, n, F,
                num_bins, int(packed4), slot.data_ptr(), part.data_ptr(), R,
                per, out.data_ptr(), stream)
    if err != 0:
        raise LightGBMError(f"wave histogram kernel failed: CUDA error {err}")
    k2_launches.add()
    k2_variant_launches[variant(precision, count_proxy, packed4)].add()
    return _finish(out, gh_scale, precision)


def fused_partition_histogram(bins_t, g, h, sample_mask, leaf_ids, tbl,
                              num_bins: int, *, precision: str = "f32",
                              count_proxy: bool = False,
                              packed4: bool = False, num_features=None,
                              gh_scale=None, any_cat: bool = False):
    """Apply one wave of splits and build its smaller-child histograms:
    (new leaf ids [N] int32, hist [W, F, B, C]), and with ``count_proxy``
    also cnt_r [W] f32, each slot's in-bag rows moved right. ``tbl`` is
    the packed [TBL_ROWS, W] int32 split table (TBL_* rows; inactive
    slots have parent -1 and safe feature 0); without ``any_cat`` its
    first TBL_ROWS_NUM rows suffice. g and h are pre-masked; out-of-bag
    rows (sample_mask 0) move but are never counted."""
    n = bins_t.shape[1]
    _check_tier(n, num_bins, precision, count_proxy, packed4, num_features,
                g)
    rows = TBL_ROWS if any_cat else TBL_ROWS_NUM
    if tbl.shape[0] not in (rows, TBL_ROWS):
        raise LightGBMError(f"split table must be [{rows}, W] or "
                            f"[{TBL_ROWS}, W]; got {tuple(tbl.shape)}")
    if bins_t.device.type == "cpu":
        out = fused_partition_histogram_plain(
            bins_t, g, h, sample_mask, leaf_ids, tbl, num_bins, count_proxy,
            packed4, num_features, any_cat)
        return (out[0], _finish(out[1], gh_scale, precision)) + out[2:]
    if bins_t.device.type != "cuda":
        raise LightGBMError(f"no histogram kernel for {bins_t.device}")
    F = _logical_features(bins_t, packed4, num_features)
    W = tbl.shape[1]
    gdt = torch.int8 if precision == "int8" else torch.float32
    _check_cuda(bins_t, [("bins_t", bins_t, torch.uint8),
                         ("g", g, gdt), ("h", h, gdt),
                         ("sample_mask", sample_mask, torch.float32),
                         ("leaf_ids", leaf_ids, torch.int32),
                         ("tbl", tbl, torch.int32)], num_bins, W)
    R, per = row_ranges(n, F)
    dev = bins_t.device
    slot = torch.empty(n, dtype=torch.uint8, device=dev)
    leaf_out = torch.empty_like(leaf_ids)
    stream = torch.cuda.current_stream(dev).cuda_stream
    int8 = precision == "int8"
    cnt = torch.zeros(W, dtype=torch.int32, device=dev)
    out = torch.zeros((W, F, num_bins, (2 if count_proxy else 3)),
                      dtype=torch.int32 if int8 else torch.float32,
                      device=dev)
    if n > 0:
        lib = _library()
        with torch.cuda.device(dev):
            if int8:
                err = lib.fused_partition_histogram_int_launch(
                    bins_t.data_ptr(), g.data_ptr(), h.data_ptr(),
                    sample_mask.data_ptr(), leaf_ids.data_ptr(),
                    tbl.data_ptr(), W, n, F, num_bins, out.shape[-1],
                    int(packed4), int(any_cat), leaf_out.data_ptr(),
                    slot.data_ptr(),
                    cnt.data_ptr() if count_proxy else None, R, per,
                    out.data_ptr(), stream)
            else:
                part = torch.empty((R, F, W, num_bins, 3),
                                   dtype=torch.float32, device=dev)
                err = lib.fused_partition_histogram_launch(
                    bins_t.data_ptr(), g.data_ptr(), h.data_ptr(),
                    sample_mask.data_ptr(), leaf_ids.data_ptr(),
                    tbl.data_ptr(), W, n, F, num_bins, int(packed4),
                    int(any_cat), leaf_out.data_ptr(), slot.data_ptr(),
                    part.data_ptr(), R, per, out.data_ptr(), stream)
        if err != 0:
            raise LightGBMError(f"fused partition+histogram kernel failed: "
                                f"CUDA error {err}")
        k1_launches.add()
        k1_variant_launches[variant(precision, count_proxy, packed4)].add()
        if any_cat:
            k1_cat_launches.add()
    res = (leaf_out, _finish(out, gh_scale, precision))
    return res + ((cnt.to(torch.float32),) if count_proxy else ())
