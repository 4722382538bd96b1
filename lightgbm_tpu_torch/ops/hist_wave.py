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
to the JAX package's scatter. The f32 kernel adds each cell in row order
within a row range (``row_ranges``), in float64, and the ranges' f32
partials in order, in float64: the same bits on every run, and the bits
of the plain version run on the CPU with ``kernel_order=True`` (``scatter_in_ranges``: one range at a time, the
partials added in range order; ``plain_in_kernel_order``), which the
card tests and chip_smoke.py hold it to. ``hist_plan`` is the f32 pass's
launch plan (feature groups, slot classes, warps, ranges); it and
``row_ranges`` are pure functions of the shapes, so the CPU computes the
kernel's ranges without a card. The hi/lo bf16 channel layouts of the
TPU kernels exist to pack MXU lanes; here each channel is one f32 sum,
and the layout only set the wave-width cap.

The int8 plain versions add int64 in one ``index_add_`` per channel and
cast to int32, the TPU kernel's exact int32 sums. The JAX package's CPU
route instead adds integer-valued f32, exact only while a cell's |sum|
< 2^24; on smaller inputs the two agree. A packed plain version unpacks
first. Integer sums do not depend on order, so the int8 kernels equal
their plain versions on the card; a packed kernel launch reads the same
bins in the same order as an unpacked one and gives its bits.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import cuda_build
from .step_cache import FEATURE_PAD, bucket_features
from ..utils.device import Counter, card_plan, on_device
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
TILE_ROWS = 1024         # rows an f32 histogram block stages at a time
# the f32 pass's limits and the card's (csrc/hist_wave.cu; an H100 SM)
WARP_COUNTS = (4, 8, 16)  # warps per f32 histogram block
MAX_WARPS = WARP_COUNTS[-1]
MAX_CLASSES = 16         # slot classes per feature
SLOT_PARTS = (1, 2, 4)   # parts a wave's slots may be cut into
SMEM_MAX = 232_448       # dynamic shared memory a block may use
SMEM_PER_SM = 233_472    # shared memory of one SM
SMEM_RESERVED = 1024     # taken per resident block
THREADS_PER_SM = 2048
REGISTERS_PER_SM = 65_536
# registers a thread of the f32 histogram kernel may use, by warps a
# block (its launch bounds)
THREAD_REGISTERS = {4: 80, 8: 64, 16: 64}
NUM_SMS = 132            # H100 SXM: sizes the ranges, not the grid
TARGET_WARPS = 32        # resident warps per SM the plan aims for
ITEM_WAVES = 4           # work items per resident block, about
# the int8 pass's limits (csrc/hist_wave.cu int_group_histogram_kernel)
INT_WARPS = 16           # warps per int8 histogram block
INT_LANE_ROWS = 8        # rows a lane loads a step: one 8-byte load an array
INT_BYTE_ROWS = 8        # bin byte rows a block stages: 8 features, or 16
INT_COPIES = (1, 2, 4, 8, 16)  # copies of a cell: lane l adds to l % copies
INT_SMALL_TILE = 4096    # bytes of a feature's [W, B, C] tile held small

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


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "hist_wave_pass_events": [_P],
    "hist_wave_smem_bytes": [_I, _I, _I, _I],
    "hist_wave_resident_blocks": [_I, _I, _I, _I, _I, _I],
    "wave_histogram_launch": [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P, _P, _I, _LL, _P, _P],
    "fused_partition_histogram_launch": [
        _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _I, _LL, _P, _P],
    "hist_wave_int_smem_bytes": [_I, _I, _I, _I, _I, _I],
    "hist_wave_int_resident_blocks": [_I] * 10,
    "wave_histogram_int_launch": [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                  _I, _LL, _P, _P],
    "fused_partition_histogram_int_launch": [
        _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _P, _P, _P, _P, _I, _LL, _P, _P],
}
_fns = {}


def _fn(name: str):
    """The library's C function ``name``, its types bound once."""
    fn = _fns.get(name)
    if fn is None:
        lib = cuda_build.library("hist_wave")
        for sym, argtypes in _SIGNATURES.items():
            f = getattr(lib, sym)
            f.argtypes = argtypes
            f.restype = _I
            _fns[sym] = f
        fn = _fns[name]
    return fn


def hist_smem_bytes(W: int, B: int, fg: int, classes: int) -> int:
    """Dynamic shared memory of one f32 histogram block: ``fg`` [W, B]
    tiles of 20 bytes a cell (g and h in double, a count) and the staging
    of a TILE_ROWS tile (the counted rows' g and h in double, slot and
    row index, each slot class's count per 32-row chunk, fg bin rows);
    the library's ``hist_wave_smem_bytes``."""
    return (fg * W * B * 20 + TILE_ROWS * 16
            + (TILE_ROWS // 32 + 1) * classes * 4 + TILE_ROWS * 3
            + fg * TILE_ROWS)


def _blocks_per_sm(smem: int, warps: int) -> int:
    """Blocks of ``warps`` warps and ``smem`` bytes one SM holds, by its
    shared memory, threads and registers (the card's own count is
    ``hist_wave_resident_blocks``)."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED),
               THREADS_PER_SM // (32 * warps),
               REGISTERS_PER_SM // (THREAD_REGISTERS[warps] * 32 * warps))


def _group_plan_for(F: int, W: int, B: int, S: int):
    """(key, (Fg, K, warps, S)) of the best plan whose blocks hold
    ceil(W / S) slots (see ``_group_plan``), None when none fits."""
    Wp = -(-W // S)
    best = None
    K = 1
    while K <= min(Wp, MAX_CLASSES):
        for fg in range(1, min(F, MAX_WARPS // K) + 1):
            smem = hist_smem_bytes(Wp, B, fg, K)
            if smem > SMEM_MAX:
                break
            warps = next(w for w in WARP_COUNTS if w >= fg * K)
            resident = min(_blocks_per_sm(smem, warps) * warps,
                           TARGET_WARPS)
            idle = -(-F // fg) * fg - F
            key = (resident, -K, -S, fg * K - warps, -idle, fg)
            if best is None or key > best[0]:
                best = (key, (fg, K, warps, S))
        K *= 2
    return best


def _group_plan(F: int, W: int, B: int):
    """(features per group Fg, slot classes K, warps, slot parts S) of
    the f32 pass, a warp per job (feature, class), 4, 8 or 16 warps: the
    most resident warps per SM (up to TARGET_WARPS), then the fewest
    classes (classes split a tile's counted rows into short lists, whose
    32-row steps run part empty), then the fewest slot parts (each part
    stages the rows again), then the fewest warps without a job, then the
    fewest idle feature slots in the last group, then the largest groups
    (each group stages the rows again). A block holds the slots of one
    part, ceil(W / S) of them, S 1, 2 or 4: more parts make a feature's
    tile smaller (20 bytes a cell), so that a block takes more features
    in fewer classes or more blocks fit an SM, or, where one feature's
    tile of all W slots overflows shared memory, one fits. On the H100
    this rule's plans timed within 6% of the best of S = 1-4 at the main
    path's f32 shapes (PERF.md)."""
    plans = [_group_plan_for(F, W, B, S) for S in SLOT_PARTS if S <= W]
    return max(p for p in plans if p is not None)[1]


class HistPlan(NamedTuple):
    fg: int              # features per group
    classes: int         # slot classes (jobs per feature)
    warps: int           # warps per block
    groups: int          # feature groups, ceil(F / fg)
    ranges: int          # row ranges R
    rows_per_range: int
    smem: int            # dynamic shared memory per block
    slot_parts: int      # S: a block's slots are ceil(W / S) of the W


def _rows_per_range(n: int, F: int, W: int, B: int) -> int:
    """Rows per range of the f32 pass for n rows of F features, a
    multiple of TILE_ROWS. Planned for the step cache's bucket of F (the
    features ``step_cache.bucket_features`` pads to one width) at its
    middle width, so that every F of a bucket, the padded width too,
    adds in one order: about ITEM_WAVES items per block resident on the
    card, unless the ranges' partial tiles (R * F * W * B * 12 bytes,
    written and read again by the reduction) would outweigh the rows'
    own bytes (n * (F + 12)): then fewer, longer ranges."""
    F = bucket_features(F) - FEATURE_PAD // 2
    fg, K, warps, S = _group_plan(F, W, B)
    smem = hist_smem_bytes(-(-W // S), B, fg, K)
    want = ITEM_WAVES * NUM_SMS * _blocks_per_sm(smem, warps)
    tiles = max(-(-n // TILE_ROWS), 1)
    by_bytes = n * (F + 12) // (F * W * B * 12)
    R = max(min(-(-want // (-(-F // fg) * S)), tiles, by_bytes), 1)
    return -(-tiles // R) * TILE_ROWS


@functools.lru_cache(maxsize=4096)
def hist_plan(n: int, num_features: int, num_slots: int,
              num_bins: int) -> HistPlan:
    """The f32 histogram pass's launch plan for n rows of F features
    into W slots of B bins: a block walks work items (feature group,
    slot part, row range). The groups, classes, warps and parts are
    planned from F; the rows per range (``_rows_per_range``), which fix
    the order of addition, from F's bucket, so that a set and its copy
    padded as the step cache pads it add every cell in one order."""
    F, W, B = max(num_features, 1), num_slots, num_bins
    fg, K, warps, S = _group_plan(F, W, B)
    smem = hist_smem_bytes(-(-W // S), B, fg, K)
    per = _rows_per_range(n, F, W, B)
    return HistPlan(fg, K, warps, -(-F // fg), max(-(-n // per), 1), per,
                    smem, S)


def row_ranges(n: int, num_features: int, num_slots: int, num_bins: int,
               counted=None):
    """(ranges R, rows per range) of the f32 histogram pass, the one
    definition of its order of addition: R * rows >= n > (R - 1) * rows
    (R = 1 when n = 0), rows a multiple of TILE_ROWS. ``counted``: the
    rows that can be counted, the first of the n when the others are
    passengers (valid rows, never counted); the rows per range are
    planned from them alone, so a counted row's range, and so the bits
    of its sums, do not depend on the passengers behind it."""
    per = hist_plan(n if counted is None else counted, num_features,
                    num_slots, num_bins).rows_per_range
    return max(-(-n // per), 1), per


def int_smem_bytes(W: int, B: int, C: int, fg: int, classes: int,
                   copies: int) -> int:
    """Dynamic shared memory of one int8 histogram block: the unit's
    int32 tile, C channels of fg features, ceil(W / classes) slots and B
    bins, ``copies`` copies of each cell; the library's
    ``hist_wave_int_smem_bytes``."""
    return copies * C * fg * -(-W // classes) * B * 4


def _int_blocks_per_sm(smem: int) -> int:
    """int8 histogram blocks one SM holds: two where their shared memory
    allows, else one; 0 when none fits. The plan's ``blocks``, which
    also picks the kernel's instance (64 registers a thread for two, 128
    for one); the card's own count is ``hist_wave_int_resident_blocks``."""
    if smem > SMEM_MAX:
        return 0
    return 2 if 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM else 1


def _int_groups(F: int, packed4: bool):
    """The feature group sizes an int8 block may take: up to
    INT_BYTE_ROWS bin byte rows; packed, whole byte rows (an even group,
    so that every group starts at a byte row) unless one group holds
    every feature."""
    if not packed4:
        return range(1, min(F, INT_BYTE_ROWS) + 1)
    return sorted({fg for fg in range(2, 2 * INT_BYTE_ROWS + 1, 2)
                   if fg <= F} | ({F} if F <= 2 * INT_BYTE_ROWS else set()))


class IntPlan(NamedTuple):
    fg: int              # features per group
    classes: int         # slot classes K: a unit owns the slots s % K == c
    copies: int          # copies of each cell (lane l adds to copy l % copies)
    byte_rows: int       # the kernel instance's bin byte rows, 4 or 8
    blocks: int          # blocks an SM counted on: the instance's registers
    warps: int           # warps per block
    units: int           # ceil(F / fg) * classes
    parts: int           # row parts P
    rows_per_part: int   # a multiple of INT_LANE_ROWS
    items: int           # work items, units * parts
    smem: int            # dynamic shared memory per block


def int_plans(n: int, num_features: int, num_slots: int, num_bins: int,
              channels: int, packed4: bool) -> list:
    """Every plan of the int8 histogram pass that fits an SM: each
    feature group size, number of slot classes and copies of a cell,
    cut into row parts by ``int_plan_with``."""
    F, W = max(num_features, 1), num_slots
    out = []
    K = 1
    while K <= min(W, MAX_CLASSES):
        for fg in _int_groups(F, packed4):
            for copies in INT_COPIES:
                if _int_blocks_per_sm(int_smem_bytes(W, num_bins, channels,
                                                     fg, K, copies)):
                    out.append(int_plan_with(n, F, W, num_bins, channels,
                                             packed4, fg, K, copies))
        K *= 2
    return out


@functools.lru_cache(maxsize=4096)
def int_plan(n: int, num_features: int, num_slots: int, num_bins: int,
             channels: int, packed4: bool) -> IntPlan:
    """The int8 histogram pass's launch plan for n rows of F features
    into W slots of B bins and C channels (csrc/hist_wave.cu
    int_group_histogram_kernel), one of ``int_plans``. A unit is a group
    of fg features and a slot class; each unit stages every row again, so
    the plan takes the fewest units (ceil(F / fg) * K), then the most
    blocks an SM, then the fewest idle features in the last group, then
    the fewest classes (classes split the counted rows unevenly), each
    unit with as many copies of its cells as fit (up to INT_COPIES[-1]).
    Where a feature's whole tile is small (W * B * C cells of at most
    INT_SMALL_TILE bytes, the root pass at W = 1), the lanes of a warp
    meet on few cells, by chance or because most rows share a bin: there
    the most copies come first. Raises when no plan fits an SM."""
    F, W, B, C = max(num_features, 1), num_slots, num_bins, channels
    most = {}
    for p in int_plans(n, F, W, B, C, packed4):
        got = most.setdefault((p.fg, p.classes), p)
        if p.copies > got.copies:
            most[(p.fg, p.classes)] = p
    if not most:
        raise LightGBMError(f"no int8 histogram plan fits an SM: W={W}, "
                            f"B={B}, C={C}")
    small = W * B * C * 4 <= INT_SMALL_TILE
    return max(most.values(), key=lambda p: (
        p.copies if small else 0, -p.units, p.blocks,
        F - -(-F // p.fg) * p.fg, -p.classes))


def int_plan_with(n: int, num_features: int, num_slots: int, num_bins: int,
                  channels: int, packed4: bool, fg: int, classes: int,
                  copies: int, byte_rows=None, blocks=None) -> IntPlan:
    """The int8 plan of units of ``fg`` features and one of ``classes``
    slot classes with ``copies`` copies of each cell. Its kernel instance
    reads INT_BYTE_ROWS // 2 bin byte rows where the group's fit, else
    INT_BYTE_ROWS, and has the registers of two blocks an SM where their
    shared memory fits, else of one; ``byte_rows`` and ``blocks`` ask for
    another instance instead, to time it against that choice. The rows
    are cut into parts so that the work items fill one wave of the
    ``blocks`` resident on every SM (a part starts on an 8-row vector),
    unless the partial tiles (written and read again by the flush) would
    outweigh the rows' own bytes and every SM has an item."""
    F, W, B, C = max(num_features, 1), num_slots, num_bins, channels
    smem = int_smem_bytes(W, B, C, fg, classes, copies)
    fits = _int_blocks_per_sm(smem)
    if fits < 1:
        raise LightGBMError(f"int8 histogram units of {fg} features, "
                            f"{classes} classes and {copies} copies fit no "
                            f"SM ({smem} bytes)")
    need = -(-fg // 2) if packed4 else fg
    byte_rows = byte_rows or (INT_BYTE_ROWS // 2
                              if need <= INT_BYTE_ROWS // 2
                              else INT_BYTE_ROWS)
    blocks = blocks or fits
    if byte_rows not in (INT_BYTE_ROWS // 2, INT_BYTE_ROWS) \
            or need > byte_rows or blocks not in (1, 2):
        raise LightGBMError(f"no int8 histogram instance of {byte_rows} "
                            f"byte rows and {blocks} blocks an SM holds "
                            f"{fg} features")
    units = -(-F // fg) * classes
    vectors = max(-(-n // INT_LANE_ROWS), 1)
    by_bytes = n * (F + 3) // (units * fg * -(-W // classes) * B * C * 8)
    P = max(min(blocks * NUM_SMS // units, vectors,
                max(by_bytes, NUM_SMS // units)), 1)
    per = -(-vectors // P) * INT_LANE_ROWS
    P = max(-(-n // per), 1)
    return IntPlan(fg, classes, copies, byte_rows, blocks, INT_WARPS, units,
                   P, per, units * P, smem)


_int_choice = {}


@contextlib.contextmanager
def use_int_plan(fg: int, classes: int, copies: int, byte_rows=None,
                 blocks=None):
    """Within this block every int8 launch runs the plan
    ``int_plan_with`` makes of these choices for its own shape, not
    ``int_plan``'s: for timing plans and kernel instances against each
    other (int8_plan_sweep.py). Integer sums do not depend on the plan."""
    _int_choice.update(fg=fg, classes=classes, copies=copies,
                       byte_rows=byte_rows, blocks=blocks)
    try:
        yield
    finally:
        _int_choice.clear()


def int_aligned(*tensors) -> bool:
    """Whether the int8 pass may read 8 bytes at a time from these
    contiguous byte tensors: each one's data 8-byte aligned, and so each
    row of a 2-D one (rows of a multiple of 8 bytes, or a single row,
    whose ragged end takes byte loads)."""
    return all(t.data_ptr() % INT_LANE_ROWS == 0
               and (t.dim() == 1 or t.shape[0] == 1
                    or t.stride(0) % INT_LANE_ROWS == 0)
               for t in tensors)


def _int_launch_args(bins_t, g, h, n, F, W, B, C, packed4, dev) -> tuple:
    """(plan arguments, partial-tile scratch) of an int8 launch: the
    library's vec, Fg, K, copies, byte rows, blocks, grid, then P and
    rows per part."""
    vec = int_aligned(bins_t, g, h)
    lp = launch_int_plan(n, F, W, B, C, packed4, vec, dev)
    part = torch.empty(lp["items"] * lp["fg"] * -(-W // lp["classes"]) * B
                       * C, dtype=torch.int32, device=dev)
    return ((int(vec), lp["fg"], lp["classes"], lp["copies"],
             lp["byte_rows"], lp["blocks"], lp["grid"]),
            (lp["parts"], lp["rows_per_part"]), part)


def launch_plan(n: int, F: int, W: int, B: int, packed4: bool,
                dev: torch.device, counted=None, order_features=None) -> dict:
    """``hist_plan`` of an f32 launch on ``dev``, with its grid
    (``utils.device.card_plan``); its ranges are ``row_ranges``' of
    ``order_features`` (default F)."""
    R, per = row_ranges(n, order_features or F, W, B, counted)
    p = hist_plan(n if counted is None else counted, F, W, B)._replace(
        ranges=R, rows_per_range=per)
    Wp = -(-W // p.slot_parts)
    return card_plan(p, p.groups * p.slot_parts * p.ranges, dev,
                     (_fn("hist_wave_smem_bytes"), Wp, B, p.fg, p.classes),
                     (_fn("hist_wave_resident_blocks"), int(packed4), Wp,
                      B, p.fg, p.classes, p.warps))


def launch_int_plan(n: int, F: int, W: int, B: int, C: int, packed4: bool,
                    vec: bool, dev: torch.device) -> dict:
    """``int_plan`` (or ``use_int_plan``'s) of an int8 launch on ``dev``,
    with its grid (``utils.device.card_plan``); ``vec``: the 8-byte loads
    (``int_aligned``)."""
    p = (int_plan_with(n, F, W, B, C, bool(packed4), **_int_choice)
         if _int_choice else int_plan(n, F, W, B, C, bool(packed4)))
    got = card_plan(p, p.items, dev,
                    (_fn("hist_wave_int_smem_bytes"), W, B, C, p.fg,
                     p.classes, p.copies),
                    (_fn("hist_wave_int_resident_blocks"), int(packed4), C,
                     int(vec), W, B, p.fg, p.classes, p.copies,
                     p.byte_rows, p.blocks))
    return dict(got, vec=bool(vec))


def pass_times(fn, runs: int) -> dict:
    """Card milliseconds of a launch's slot, histogram and reduce (the
    int8 tier's flush) kernels, each averaged over ``runs`` calls of
    ``fn`` (one K1 or K2 launch of any tier on the current device): CUDA
    events that the launches record at their pass boundaries while this
    runs."""
    names = ("slot", "histogram", "reduce")
    sums = dict.fromkeys(names, 0.0)
    for _ in range(runs):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for e in events:
            e.record()          # creates the event the launch records
        handles = (ctypes.c_void_p * 4)(*[e.cuda_event for e in events])
        _fn("hist_wave_pass_events")(handles)
        try:
            fn()
        finally:
            _fn("hist_wave_pass_events")(None)
        events[3].synchronize()
        for k, name in enumerate(names):
            sums[name] += events[k].elapsed_time(events[k + 1])
    return {name: v / runs for name, v in sums.items()}


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


def scatter_in_ranges(bins_t, g, h, base, num_bins: int, num_slots: int,
                      ranges):
    """``_scatter_hist3`` in the f32 kernel's order of addition: each
    row range of ``ranges`` = (R, rows per range) on its own, each cell's
    f32 g and h added in row order from 0.0 in float64 and rounded once
    to f32; then the ranges' f32 partials added in range order from 0.0
    in float64 and rounded once. ``index_add_`` on the CPU adds in index
    order, so on CPU tensors this is the kernel's sum bit for bit. In
    float64 a range's rows cannot drift the way a long f32 running sum
    does (ROADMAP queue 3 P, tests/test_torch_hist_order.py)."""
    n = bins_t.shape[1]
    R, per = ranges
    g64, h64 = g.double(), h.double()
    out = None
    for r in range(R):
        rows = slice(r * per, min(n, (r + 1) * per))
        part = _scatter_hist3(bins_t[:, rows], g64[rows], h64[rows],
                              base[rows], num_bins, num_slots).float()
        if out is None:
            out = torch.zeros(part.shape, dtype=torch.float64,
                              device=part.device)
        out += part.double()
    return out.float()


def _scatter(bins_t, g, h, base, num_bins, num_slots, count_proxy,
             kernel_order=False, counted=None, order_features=None):
    """The tier's scatter: int8 g/h give exact int32 sums (2 channels
    under count-proxy), f32 or f64 g/h their own dtype's sums, with
    ``kernel_order`` in the f32 kernel's order (``scatter_in_ranges``
    over ``row_ranges`` of ``order_features``, default F)."""
    if g.dtype == torch.int8:
        return _scatter_hist_int(bins_t, g, h, base, num_bins, num_slots,
                                 2 if count_proxy else 3)
    if kernel_order:
        F, n = bins_t.shape
        return scatter_in_ranges(bins_t, g, h, base, num_bins, num_slots,
                                 row_ranges(n, order_features or F,
                                            num_slots, num_bins, counted))
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
                         num_features=None, kernel_order=False,
                         counted_rows=None, order_features=None):
    """``wave_histogram_xla`` (hist_wave.py:85) in PyTorch: raw sums in
    the tier of g's dtype (int8 -> int32); f32 sums with
    ``kernel_order`` in the kernel's order of addition (``row_ranges``
    of ``counted_rows`` and ``order_features``)."""
    if packed4:
        bins_t = unpack4(bins_t, num_features)
    F, n = bins_t.shape
    W = wave_leaves.shape[0]
    B = num_bins
    eq = ((leaf_ids[None, :] == wave_leaves[:, None])
          & (wave_leaves >= 0)[:, None])
    found, slot = _first_slot(eq)
    base = torch.where(found, slot * (F * B), W * F * B)
    return _scatter(bins_t, g, h, base, B, W, count_proxy, kernel_order,
                    counted_rows, order_features)


def fused_partition_histogram_plain(bins_t, g, h, sample_mask, leaf_ids, tbl,
                                    num_bins, count_proxy=False,
                                    packed4=False, num_features=None,
                                    any_cat=False, kernel_order=False,
                                    counted_rows=None):
    """``fused_partition_histogram_xla`` (hist_wave.py:150) in PyTorch:
    returns (new leaf ids [N], hist [W, F, B, C]) with raw sums in the
    tier of g's dtype, and with ``count_proxy`` also cnt_r [W] f32, each
    slot's in-bag rows moved right. With ``any_cat``, slots whose
    ``TBL_ISCAT`` row is set split categorically on their bitset; with
    ``kernel_order``, f32 sums in the kernel's order of addition."""
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
    hist = _scatter(bins_t, g, h, base, B, W, count_proxy, kernel_order,
                    counted_rows)
    if not count_proxy:
        return leaf_new, hist
    cnt_r = (moved & in_bag[None, :]).sum(dim=1).to(torch.float32)
    return leaf_new, hist, cnt_r


def plain_in_kernel_order(plain, *args, **kw):
    """``plain(*args, **kw)``, a plain histogram version (or a function
    passing ``kernel_order`` on to one), run on CPU copies of the tensor
    arguments with ``kernel_order=True``: the f32 kernel's bits. The
    outputs go back to the first argument's device."""
    dev = args[0].device
    out = plain(*[a.cpu() if torch.is_tensor(a) else a for a in args],
                kernel_order=True, **kw)
    if isinstance(out, tuple):
        return tuple(o.to(dev) for o in out)
    return out.to(dev)


def dequantize(hist: torch.Tensor, gh_scale) -> torch.Tensor:
    """int32 sums [..., C] -> f32: channel 0 times sg, 1 times sh, the
    count channel (C = 3) times 1, as the JAX package's ``_qscale_vec``."""
    sg, sh = gh_scale
    one = torch.ones((), dtype=torch.float32, device=hist.device)
    scale = torch.stack([sg.to(torch.float32).reshape(()),
                         sh.to(torch.float32).reshape(()), one])
    return hist.to(torch.float32) * scale[:hist.shape[-1]]


# ---------------------------------------------------------------------------
# the sparse tier (CSR-built train sets): PyTorch ops on every device
# ---------------------------------------------------------------------------

def _cell_sums(index: torch.Tensor, values: torch.Tensor,
               size: int) -> torch.Tensor:
    """[size] sums of ``values`` [E] at ``index`` [E] (entries at
    ``size`` dropped): integers by ``index_add_`` (exact in any order);
    f32 on the CPU by ``index_add_``, serial in entry order, the bits of
    XLA's CPU scatter; f32 on the card by a stable sort of the entries by
    cell and each cell's segment added in XLA's order of a reduction
    (``xla_segment_sum``), the same bits on every run."""
    if values.dtype != torch.float32 or values.device.type == "cpu":
        out = torch.zeros(size + 1, dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, index, values)[:size]
    from .f32math import xla_segment_sum
    order = torch.sort(index, stable=True).indices
    counts = torch.bincount(index, minlength=size + 1)[:size]
    starts = torch.cumsum(counts, 0) - counts
    return xla_segment_sum(values[order], starts, counts)


def wave_histogram_sparse(sp, g, h, leaf_ids, wave_leaves, num_bins: int,
                          num_features: int, num_leaves: int,
                          gh_scale=None) -> torch.Tensor:
    """[W, F, B, 3] wave histograms by scatter over the explicit entries
    of a CSR-built set (the JAX package's ``wave_histogram_sparse``,
    hist_wave.py:233-309). ``sp`` = (codes, feat, row, zero_bins): each
    entry's bin, inner feature and row [E] and each feature's bin of 0.0
    [F]; entries with feat >= F are dropped. Each channel adds the
    entries' row values at (slot, feature, code), then completes each
    (slot, feature)'s bin of 0.0 with the slot's row total minus the
    feature's explicit subtotal. A row's slot comes from a leaf -> slot
    table of ``num_leaves`` + 1 entries gathered per entry, not the JAX
    package's [W, E] compare matrix: the same slots.

    g and h int8 (the quantized tier): integer sums, bit-equal to the
    dense tier, dequantized with ``gh_scale`` as ``dequantize``. f32: the
    completion reassociates the sums of the bin of 0.0, so they can part
    from the dense tier's in the last ulp; on the CPU the sums are the
    JAX package's bits, on the card within ``refit.sum_bound`` of them
    (``_cell_sums``)."""
    codes, feat, row, zb = sp
    F, B, W = int(num_features), int(num_bins), wave_leaves.shape[0]
    dev = g.device
    i64 = torch.int64
    size = W * F * B
    wl = wave_leaves.to(i64)
    ok = wl >= 0
    table = torch.full((int(num_leaves) + 1,), W, dtype=i64, device=dev)
    table[wl[ok] + 1] = torch.arange(W, device=dev)[ok]
    slot_row = table[leaf_ids.to(i64) + 1]                    # [N], W: none
    row = row.to(i64)
    feat = feat.to(i64)
    slot = slot_row[row]
    found = (slot < W) & (feat < F)
    flat = torch.where(found, slot * (F * B) + feat * B + codes.to(i64),
                       size)
    flatf = torch.where(found, slot * F + feat, W * F)
    didx = (torch.arange(W, device=dev)[:, None] * (F * B)
            + torch.arange(F, device=dev)[None, :] * B
            + torch.as_tensor(zb, device=dev).to(i64)[None, :]).reshape(-1)
    int_tier = g.dtype == torch.int8
    acc = i64 if int_tier else torch.float32

    def chan(v):
        v = v.to(acc)
        ev = v[row]
        he = _cell_sums(flat, ev, size)
        sub = _cell_sums(flatf, ev, W * F)
        ls = _cell_sums(slot_row, v, W)
        he[didx] += (ls[:, None] - sub.reshape(W, F)).reshape(-1)
        return he

    ones = torch.ones(leaf_ids.shape[0], dtype=acc, device=dev)
    hist = torch.stack([chan(g), chan(h), chan(ones)], dim=1)
    hist = hist.reshape(W, F, B, 3)
    if int_tier:
        hist = hist.to(torch.int32)
        return hist if gh_scale is None else dequantize(hist, gh_scale)
    return hist


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
                   gh_scale=None, counted_rows=None, order_features=None):
    """[W, F, B, C] histograms of the rows whose leaf id equals each wave
    leaf (-1 slots give zeros). g and h are pre-masked by bagging;
    out-of-bag rows carry leaf id -1. See the module docstring for the
    tiers; int8 sums come back raw unless ``gh_scale`` is given.
    ``counted_rows``: only the first rows can be counted, the others are
    passengers (``row_ranges``). ``order_features``: the width whose f32
    order of addition the sums keep (default F): a slice of a set's
    features, given the set's width, adds every cell as the whole set's
    pass does (the feature learner, parallel/learners.py)."""
    n = bins_t.shape[1]
    _check_tier(n, num_bins, precision, count_proxy, packed4, num_features,
                g)
    if bins_t.device.type == "cpu":
        return _finish(wave_histogram_plain(
            bins_t, g, h, leaf_ids, wave_leaves, num_bins, count_proxy,
            packed4, num_features, counted_rows=counted_rows,
            order_features=order_features), gh_scale, precision)
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
    dev = bins_t.device
    int8 = precision == "int8"
    shape = (W, F, num_bins, 2 if count_proxy else 3)
    dtype = torch.int32 if int8 else torch.float32
    if n == 0:
        return _finish(torch.zeros(shape, dtype=dtype, device=dev), gh_scale,
                       precision)
    out = torch.empty(shape, dtype=dtype, device=dev)
    slot = torch.empty(n, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (bins_t.data_ptr(), g.data_ptr(), h.data_ptr(),
            leaf_ids.data_ptr(), wave_leaves.data_ptr())
    with on_device(dev):
        if int8:
            plan, parts, part = _int_launch_args(bins_t, g, h, n, F, W,
                                                 num_bins, shape[-1],
                                                 packed4, dev)
            err = _fn("wave_histogram_int_launch")(
                *ptrs, W, n, F, num_bins, shape[-1], int(packed4), *plan,
                slot.data_ptr(), part.data_ptr(), *parts, out.data_ptr(),
                stream)
        else:
            lp = launch_plan(n, F, W, num_bins, packed4, dev, counted_rows,
                             order_features)
            part = torch.empty((lp["ranges"], F, W, num_bins, 3),
                               dtype=torch.float32, device=dev)
            err = _fn("wave_histogram_launch")(
                *ptrs, W, n, F, num_bins, int(packed4), lp["fg"],
                lp["classes"], lp["slot_parts"], lp["warps"], lp["grid"],
                slot.data_ptr(),
                part.data_ptr(), lp["ranges"], lp["rows_per_range"],
                out.data_ptr(), stream)
    if err != 0:
        raise LightGBMError(f"wave histogram kernel failed: CUDA error {err}")
    k2_launches.add()
    k2_variant_launches[variant(precision, count_proxy, packed4)].add()
    return _finish(out, gh_scale, precision)


def fused_partition_histogram(bins_t, g, h, sample_mask, leaf_ids, tbl,
                              num_bins: int, *, precision: str = "f32",
                              count_proxy: bool = False,
                              packed4: bool = False, num_features=None,
                              gh_scale=None, any_cat: bool = False,
                              counted_rows=None):
    """Apply one wave of splits and build its smaller-child histograms:
    (new leaf ids [N] int32, hist [W, F, B, C]), and with ``count_proxy``
    also cnt_r [W] f32, each slot's in-bag rows moved right. ``tbl`` is
    the packed [TBL_ROWS, W] int32 split table (TBL_* rows; inactive
    slots have parent -1 and safe feature 0); without ``any_cat`` its
    first TBL_ROWS_NUM rows suffice. g and h are pre-masked; out-of-bag
    rows (sample_mask 0) move but are never counted; so do passengers,
    the rows past ``counted_rows`` (``row_ranges``)."""
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
            packed4, num_features, any_cat, counted_rows=counted_rows)
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
    dev = bins_t.device
    int8 = precision == "int8"
    shape = (W, F, num_bins, 2 if count_proxy else 3)
    dtype = torch.int32 if int8 else torch.float32
    leaf_out = torch.empty_like(leaf_ids)
    if n == 0:
        out = torch.zeros(shape, dtype=dtype, device=dev)
        cnt = torch.zeros(W, dtype=torch.int32, device=dev)
    else:
        # every cell and count is written by the launch (the reduce
        # passes, the slot pass's own memset)
        out = torch.empty(shape, dtype=dtype, device=dev)
        cnt = torch.empty(W, dtype=torch.int32, device=dev) \
            if count_proxy else None
        slot = torch.empty(n, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (bins_t.data_ptr(), g.data_ptr(), h.data_ptr(),
                sample_mask.data_ptr(), leaf_ids.data_ptr(), tbl.data_ptr())
        with on_device(dev):
            if int8:
                plan, parts, part = _int_launch_args(bins_t, g, h, n, F, W,
                                                     num_bins, shape[-1],
                                                     packed4, dev)
                err = _fn("fused_partition_histogram_int_launch")(
                    *ptrs, W, n, F, num_bins, shape[-1], int(packed4),
                    int(any_cat), *plan, leaf_out.data_ptr(),
                    slot.data_ptr(), cnt.data_ptr() if count_proxy else None,
                    part.data_ptr(), *parts, out.data_ptr(), stream)
            else:
                lp = launch_plan(n, F, W, num_bins, packed4, dev,
                                 counted_rows)
                part = torch.empty((lp["ranges"], F, W, num_bins, 3),
                                   dtype=torch.float32, device=dev)
                err = _fn("fused_partition_histogram_launch")(
                    *ptrs, W, n, F, num_bins, int(packed4), int(any_cat),
                    lp["fg"], lp["classes"], lp["slot_parts"], lp["warps"],
                    lp["grid"], leaf_out.data_ptr(), slot.data_ptr(),
                    part.data_ptr(),
                    lp["ranges"], lp["rows_per_range"], out.data_ptr(),
                    stream)
        if err != 0:
            raise LightGBMError(f"fused partition+histogram kernel failed: "
                                f"CUDA error {err}")
        k1_launches.add()
        k1_variant_launches[variant(precision, count_proxy, packed4)].add()
        if any_cat:
            k1_cat_launches.add()
    res = (leaf_out, _finish(out, gh_scale, precision))
    return res + ((cnt.to(torch.float32),) if count_proxy else ())
