"""Forest traversal: the CUDA kernel, its launch plan, and its plain
PyTorch version.

Counterpart of the JAX package's fused forest kernel
(lightgbm_tpu/ops/stacked_predict.py:1048 ``forest_predict_pallas`` and
:1157 ``forest_predict_pallas_gpu``): feature-major bin codes ``[F, N]``
in, ``[N, K]`` f32 scores out (or ``[N, T]`` int32 leaf indices). The
TPU kernel finds each leaf through two one-hot matrix products; here a
lane walks each tree from its root, one lane per tree of a 32-tree
chunk, over compact node records staged in shared memory
(csrc/forest_predict.cu says why and how).

``forest_predict`` launches the kernel for CUDA tensors and runs
``forest_predict_plain`` for CPU tensors; there is no other route. The
plain version walks the per-node decision rows the compact records were
built from and adds the same f32 values in the same order, so the two
agree bit for bit. ``forest_predict_from_x`` is the same walk over f32
rows ``[n, F]`` that the kernel bins in its tile staging (the JAX
package's :906 ``forest_predict_from_x`` and :1204
``forest_predict_from_x_gpu``); its plain version is ``codes_from_x``
then ``forest_predict_plain``, the two launches it replaces. Both count
in ``launches``. ``forest_plan`` decides every launch; the library only
checks the plan. The library is built by utils/cuda_build.py.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import Counter, card_plan
from ..utils.log import LightGBMError

# kernel launches since the last reset (the plain version never counts);
# ``from_x_launches`` counts those of them that binned f32 rows
launches = Counter()
from_x_launches = Counter()

# the kernel's limits (csrc/forest_predict.cu) and the card's (an H100 SM)
LANES = 32               # trees a chunk: one lane each
WARPS = 32               # warps a block: the kernel's launch bounds, which
                         # leave 64 registers a thread, so one block an SM
BATCH = 16               # rows a warp walks between its ordered sums
BATCH_GROUPED = 8        # the same where the range is walked in groups
SMEM_MAX = 232_448       # dynamic shared memory a block may use
SMEM_PER_SM = 233_472    # shared memory of one SM
SMEM_RESERVED = 1024     # taken per resident block
NUM_SMS = 132            # H100 SXM: sizes the tiles, not the grid


class Walk(NamedTuple):
    """The kernel's tables (ops/stacked_predict.py ``compact_tables``)."""
    feat: torch.Tensor       # [Fu, 4] int32: feature, code offset, width,
                             # zero band (lo | hi << 16, or -1)
    rec: torch.Tensor        # [C, S, 32] int64 records, or [C, S, 32, 4]
                             # int32 (16-byte records)
    leaf: torch.Tensor       # [C, L, 32] f32 leaf values
    bits: torch.Tensor       # [nb] int32 bitset words
    bits_base: torch.Tensor  # [T] int32: a tree's first bitset word
    root: torch.Tensor       # [T] int32: 0, or -1 for a single-leaf tree
    code_bytes: int          # staged codes: 1 (u8) or 2 (u16)
    tail: int                # m: the last chunk's m <= 16 trees are copied
                             # into its spare columns (0: not copied)

    @property
    def rec_bytes(self) -> int:
        return 16 if self.rec.dim() == 4 else 8

    def to(self, device) -> "Walk":
        return self._replace(**{name: getattr(self, name).to(device)
                                for name in self._fields[:6]})


class Forest(NamedTuple):
    """A model's walk tables: the plain version's per-node tables (built
    by ops/stacked_predict.py, on the host unless moved) and the
    kernel's compact ones (``walk``, on the model's device)."""
    nodes: torch.Tensor       # [T, S, 4] int32: feature, left, right, offset
    dec: torch.Tensor         # [T, S, Wn] uint8: go-left per local code
    leaf: torch.Tensor        # [T, L] f32
    root_host: np.ndarray     # [T] int32: 0, or -1 for a single-leaf tree
    depth: np.ndarray         # [T] nodes on the longest root-leaf path
    num_class: int
    num_features: int
    walk: Walk

    def to(self, device) -> "Forest":
        """Every table on ``device`` (the plain version on a card)."""
        return self._replace(nodes=self.nodes.to(device),
                             dec=self.dec.to(device),
                             leaf=self.leaf.to(device),
                             walk=self.walk.to(device))


class ForestPlan(NamedTuple):
    """One launch of the forest kernel (``forest_plan``)."""
    code_bytes: int   # staged codes: 1 (u8) or 2 (u16)
    rec_bytes: int    # 8 or 16
    score: bool       # sums of leaf values (False: leaf indices)
    warps: int        # warps a block
    batch: int        # rows a warp walks between its ordered sums
    rows: int         # rows a tile (warps * batch divides it)
    chunks: int       # 32-tree chunks the range spans
    buffers: int      # chunk slots: ``chunks`` (loaded once a block), 1
                      # (each chunk loaded after the last is walked), or 0
                      # (records read from global memory); ``_plan`` also
                      # makes 2 <= buffers < chunks (a ring of slots)
    tiles: int
    smem: int         # dynamic shared memory a block


def _pad16(b: int) -> int:
    return -(-b // 16) * 16


def chunk_bytes(S: int, L: int, rec_bytes: int, score: bool) -> int:
    """Bytes of one chunk: 32 trees' records and, for scores, their leaf
    values."""
    return LANES * (S * rec_bytes + (4 * L if score else 0))


def smem_bytes(S: int, L: int, Fu: int, K: int, code_bytes: int,
               rec_bytes: int, score: bool, warps: int, batch: int,
               rows: int, buffers: int) -> int:
    """Dynamic shared memory of one block: the chunk slots and their
    mbarriers, the rows' sums (scores), the rows' staged codes (a row
    padded to a word) and each warp's [batch, 32] buffer; the library's
    ``forest_smem_bytes``."""
    row = -(-Fu * code_bytes // 4) * 4
    return (buffers * chunk_bytes(S, L, rec_bytes, score)
            + _pad16(buffers * 8) + (_pad16(rows * K * 4) if score else 0)
            + _pad16(rows * row) + warps * batch * LANES * 4)


def forest_plan(n: int, first: int, last: int, S: int, L: int, Fu: int,
                K: int, code_bytes: int, rec_bytes: int, score: bool,
                grouped: bool = False) -> ForestPlan:
    """The launch of trees [first, last) over ``n`` rows, from the
    model's shape (S nodes and L leaves a tree, Fu features read, K
    classes, the walk's code and record widths), whether the range is one
    chunk walked in groups of rows (``grouped``: the model's last chunk
    of m <= 16 trees, copied into its spare columns) and the card's
    limits.

    The most warps a block (32) that leave room for a batch of rows each;
    with them the chunk slots: the whole range resident when it fits, else
    one (each chunk loads after the last is walked), else none (trees too
    large for shared memory walk out of global memory). Two slots, the
    next chunk loading while this one is walked, read slower wherever
    chip_smoke.py times them (PERF.md), so the plan does not take them.
    A batch of 16 rows a warp, 8 for a grouped range (PERF.md gives the
    readings of both at each shape chip_smoke.py measures). One block an
    SM. Rows a tile: as many as fit, cut so that the tiles fill every SM
    in as few rounds as the rows need."""
    return _plan(n, first, last, S, L, Fu, K, code_bytes, rec_bytes, score,
                 batch=BATCH_GROUPED if grouped else BATCH)


def _plan(n: int, first: int, last: int, S: int, L: int, Fu: int, K: int,
          code_bytes: int, rec_bytes: int, score: bool, *,
          buffers: Optional[int] = None, batch: int = BATCH) -> ForestPlan:
    """``forest_plan``'s launch with ``batch`` rows a warp (fewer where
    they do not fit) and, if given, ``buffers`` chunk slots: the other
    launches chip_smoke.py times and the card tests run."""
    if not 0 <= first < last:
        raise LightGBMError(f"empty tree range [{first}, {last})")
    chunks = (last - 1) // LANES - first // LANES + 1
    row = -(-Fu * code_bytes // 4) * 4 + (4 * K if score else 0)

    def rows_fit(buf: int, warps: int, batch: int) -> int:
        room = SMEM_MAX - 32 - smem_bytes(S, L, Fu, K, code_bytes, rec_bytes,
                                          score, warps, batch, 0, buf)
        unit = warps * batch
        if room < unit * row:
            return 0
        return min(room // row if row else 1 << 20, 1 << 20) // unit * unit

    if buffers is not None:
        options = (buffers,)
    else:
        options = (chunks,) + ((1,) if chunks > 1 else ()) + (0,)
    # a smaller batch only where a batch of rows a warp does not fit
    pick = next(((w, b, bt) for bt in (batch, 8, 4, 2, 1) if bt <= batch
                 for w in (WARPS, 16, 8, 4, 2, 1) for b in options
                 if rows_fit(b, w, bt)), None)
    if pick is None:
        raise LightGBMError(f"no forest launch fits: {Fu} features, {S} "
                            f"nodes a tree")
    warps, buf, batch = pick
    unit = warps * batch
    most = rows_fit(buf, warps, batch)
    rounds = -(-max(n, 1) // (NUM_SMS * most))
    rows = min(most, -(-max(n, 1) // (NUM_SMS * rounds * unit)) * unit)
    return ForestPlan(
        code_bytes=code_bytes, rec_bytes=rec_bytes, score=bool(score),
        warps=warps, batch=batch, rows=rows, chunks=chunks, buffers=buf,
        tiles=-(-max(n, 1) // rows),
        smem=smem_bytes(S, L, Fu, K, code_bytes, rec_bytes, score, warps,
                        batch, rows, buf))


def plan_for(forest: Forest, n: int, first: int, last: int,
             leaf_mode: bool = False) -> ForestPlan:
    """``forest_plan``'s launch of trees [first, last) of ``forest`` over
    ``n`` rows."""
    w = forest.walk
    T = len(forest.root_host)
    grouped = bool(w.tail) and first == T - w.tail and last == T
    return forest_plan(n, first, last, w.rec.shape[1], w.leaf.shape[1],
                       w.feat.shape[0], forest.num_class, w.code_bytes,
                       w.rec_bytes, not leaf_mode, grouped)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "forest_smem_bytes": [_I] * 11,
    "forest_resident_blocks": [_I] * 3,
    "forest_predict_launch": [_P] * 8 + [_LL] + [_I] * 16 + [_P],
    "forest_predict_from_x_launch": ([_P, _I, _P, _I] + [_P] * 9 + [_LL]
                                     + [_I] * 16 + [_P]),
}
_fns = {}
_fns_lock = threading.Lock()


def _fn(name: str):
    """The library's C function ``name``, its types bound once. Several
    threads launch K4 (the scoring daemon's dispatcher, registrations
    warming a model, the LRB loop's server), so the first binding is
    made under a lock and published whole: no thread sees a function
    whose types are not yet set."""
    fn = _fns.get(name)
    if fn is None:
        with _fns_lock:
            if not _fns:
                lib = cuda_build.library("forest_predict")
                bound = {}
                for sym, argtypes in _SIGNATURES.items():
                    f = getattr(lib, sym)
                    f.argtypes = argtypes
                    f.restype = _I
                    bound[sym] = f
                _fns.update(bound)
        fn = _fns[name]
    return fn


def launch_plan(plan: ForestPlan, S: int, L: int, Fu: int, K: int,
                dev: torch.device) -> dict:
    """``plan`` on ``dev`` with its grid: the library's shared-memory
    bytes must equal the plan's, and the grid is the tiles or one round
    of the blocks the card holds resident, the fewer."""
    return card_plan(
        plan, plan.tiles, dev,
        (_fn("forest_smem_bytes"), S, L, Fu, K, plan.code_bytes,
         plan.rec_bytes, int(plan.score), plan.warps, plan.batch, plan.rows,
         plan.buffers),
        (_fn("forest_resident_blocks"), plan.code_bytes, plan.warps,
         plan.smem))


def _check(codes_t: torch.Tensor, forest: Forest, first: int,
           last: int) -> None:
    if codes_t.dtype != torch.int32 or codes_t.dim() != 2:
        raise LightGBMError(f"codes must be [F, N] int32, got "
                            f"{tuple(codes_t.shape)} {codes_t.dtype}")
    if codes_t.shape[0] != forest.num_features:
        raise LightGBMError(f"codes have {codes_t.shape[0]} features, the "
                            f"forest reads {forest.num_features}")
    if not 0 <= first <= last <= len(forest.root_host):
        raise LightGBMError(f"tree range [{first}, {last}) outside "
                            f"[0, {len(forest.root_host)}]")


def _check_walk(codes_t: torch.Tensor, walk: Walk) -> None:
    for name, dtype in (("feat", torch.int32), ("leaf", torch.float32),
                        ("bits", torch.int32), ("bits_base", torch.int32),
                        ("root", torch.int32)):
        t = getattr(walk, name)
        if t.dtype != dtype:
            raise LightGBMError(f"walk.{name} must be {dtype}")
    for name in Walk._fields[:6]:
        t = getattr(walk, name)
        if t.device != codes_t.device:
            raise LightGBMError(f"walk.{name} is on {t.device}, codes on "
                                f"{codes_t.device}")
        if not t.is_contiguous():
            raise LightGBMError(f"walk.{name} must be contiguous")
    if not codes_t.is_contiguous():
        raise LightGBMError("codes must be contiguous")
    if walk.rec.dtype != (torch.int32 if walk.rec_bytes == 16
                          else torch.int64):
        raise LightGBMError("walk.rec must be int64, or int32 [.., 4]")
    if walk.rec.data_ptr() % 16 or walk.leaf.data_ptr() % 16:
        raise LightGBMError("walk.rec and walk.leaf must be 16-byte aligned")


def forest_predict(codes_t: torch.Tensor, forest: Forest, first: int,
                   last: int, leaf_mode: bool = False) -> torch.Tensor:
    """Trees [first, last) over codes_t [F, N] int32 -> [N, K] f32 scores
    (tree t adds to class t % K), or [N, last - first] int32 leaf indices
    with ``leaf_mode``. CUDA tensors launch the kernel by ``plan_for``'s
    plan; CPU tensors run the plain version."""
    return _predict(codes_t, forest, first, last, leaf_mode, None)


def _predict(codes_t: torch.Tensor, forest: Forest, first: int, last: int,
             leaf_mode: bool, plan: Optional[ForestPlan]) -> torch.Tensor:
    """``forest_predict``, launched by ``plan`` where one is given (a
    plan of ``_plan``'s for these tables)."""
    _check(codes_t, forest, first, last)
    if codes_t.device.type == "cpu":
        return forest_predict_plain(codes_t, forest, first, last, leaf_mode)
    _check_walk(codes_t, forest.walk)
    return _launch("forest_predict_launch", (codes_t.data_ptr(),), codes_t,
                   codes_t.shape[1], forest, first, last, leaf_mode, plan,
                   None)


def forest_predict_from_x(x: torch.Tensor, edges, forest: Forest,
                          first: int, last: int, leaf_mode: bool = False,
                          out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Trees [first, last) over f32 rows ``x [N, F]`` (F = the forest's
    features), binned by ``edges`` = (E [F, M] f32 edges rounded down,
    off32 [F], nan_slot [F]; ops/stacked_predict.py ``edge_tensors``), as
    ``forest_predict`` over ``codes_from_x(x, *edges)``: one launch for
    CUDA tensors (``out``, when given, is the [N, K] or [N, last - first]
    result it writes: a serving entry's static scores), the two steps'
    plain versions for CPU tensors (into ``out`` alike)."""
    E, off32, nan_slot = edges
    if x.dtype != torch.float32 or x.dim() != 2 or \
            x.shape[1] != forest.num_features:
        raise LightGBMError(f"rows must be [N, {forest.num_features}] "
                            f"float32, got {tuple(x.shape)} {x.dtype}")
    if not 0 <= first <= last <= len(forest.root_host):
        raise LightGBMError(f"tree range [{first}, {last}) outside "
                            f"[0, {len(forest.root_host)}]")
    if x.device.type == "cpu":
        got = forest_predict_plain(codes_from_x(x, *edges), forest, first,
                                   last, leaf_mode)
        return got if out is None else out.copy_(got)
    for name, t, dtype in (("E", E, torch.float32), ("off32", off32,
                                                     torch.int32),
                           ("nan_slot", nan_slot, torch.int32)):
        if t.dtype != dtype or t.device != x.device or \
                not t.is_contiguous() or t.shape[0] != x.shape[1]:
            raise LightGBMError(f"{name} must be contiguous {dtype} with "
                                f"one row a feature, on {x.device}")
    _check_walk(x, forest.walk)
    return _launch("forest_predict_from_x_launch",
                   (x.data_ptr(), x.shape[1], E.data_ptr(), E.shape[1],
                    off32.data_ptr(), nan_slot.data_ptr()), x, x.shape[0],
                   forest, first, last, leaf_mode, None, out)


def _launch(entry: str, inputs: tuple, like: torch.Tensor, n: int,
            forest: Forest, first: int, last: int, leaf_mode: bool,
            plan: Optional[ForestPlan], out: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """One launch of the library's ``entry`` (codes, or rows and their
    binning tables: ``inputs``) over ``n`` rows into ``out`` (allocated
    when None), by ``plan`` (``plan_for``'s when None)."""
    walk = forest.walk
    if n >= 2 ** 31:
        raise LightGBMError(f"{n} rows in one launch; chunk the rows")
    K = forest.num_class
    dev = like.device
    shape = (n, last - first) if leaf_mode else (n, K)
    dtype = torch.int32 if leaf_mode else torch.float32
    if out is None:
        if not leaf_mode and first == last:
            return torch.zeros(shape, dtype=dtype, device=dev)
        # the kernel writes every row's K sums
        out = torch.empty(shape, dtype=dtype, device=dev)
    elif out.shape != shape or out.dtype != dtype or \
            out.device != dev or not out.is_contiguous():
        raise LightGBMError(f"out must be contiguous {dtype} {shape}")
    elif not leaf_mode and first == last:
        return out.zero_()
    if n == 0 or first == last:
        return out
    S, L, Fu = walk.rec.shape[1], walk.leaf.shape[1], walk.feat.shape[0]
    if plan is None:
        plan = plan_for(forest, n, first, last, leaf_mode)
    elif (plan.code_bytes, plan.rec_bytes, plan.score) != (
            walk.code_bytes, walk.rec_bytes, not leaf_mode):
        raise LightGBMError(f"{plan} is not a plan for these tables")
    lp = launch_plan(plan, S, L, Fu, K, dev)
    # the library launches on the current device: make the tensors' own
    # current for the call, and the caller's current again after it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn(entry)(
            *inputs, walk.feat.data_ptr(), walk.rec.data_ptr(),
            walk.leaf.data_ptr(), walk.bits.data_ptr(),
            walk.bits_base.data_ptr(), walk.root.data_ptr(), out.data_ptr(),
            n, first, last, K, S, L, Fu, walk.tail, len(forest.root_host),
            int(plan.score), plan.code_bytes,
            plan.rec_bytes, plan.warps, plan.batch, plan.rows, plan.buffers,
            lp["grid"], stream)
    if err != 0:
        raise LightGBMError(f"forest kernel launch failed: CUDA error {err}")
    launches.add()
    if entry == "forest_predict_from_x_launch":
        from_x_launches.add()
    return out


def codes_from_x(x: torch.Tensor, E: torch.Tensor, off32: torch.Tensor,
                 nan_slot: torch.Tensor) -> torch.Tensor:
    """f32 rows [n, F] -> feature-major global codes [F, n] int32.

    The JAX package counts ``sum(x > E)`` over a [n, F, M] comparison;
    over sorted edges (inf-padded) that count is the left insertion
    point, so one searchsorted per feature gives the same codes without
    the [n, F, M] intermediate."""
    xt = x.t().contiguous()
    bins = torch.searchsorted(E, xt).to(torch.int32)
    return torch.where(torch.isnan(xt), nan_slot[:, None],
                       off32[:, None] + bins).contiguous()


def forest_predict_plain(codes_t: torch.Tensor, forest: Forest, first: int,
                         last: int, leaf_mode: bool = False,
                         ) -> torch.Tensor:
    """The same walk in plain PyTorch on the per-node decision rows: all
    rows advance one node per step, tree by tree, adding leaf values in
    model order."""
    dev = codes_t.device
    n = codes_t.shape[1]
    rows = torch.arange(n, device=dev)
    k = forest.num_class
    if leaf_mode:
        out = torch.empty((n, last - first), dtype=torch.int32, device=dev)
    else:
        out = torch.zeros((n, k), dtype=torch.float32, device=dev)
    for t in range(first, last):
        node = torch.full((n,), int(forest.root_host[t]), dtype=torch.int64,
                          device=dev)
        nodes = forest.nodes[t].long()
        dec = forest.dec[t]
        for _ in range(int(forest.depth[t])):
            cur = node.clamp(min=0)
            nd = nodes[cur]
            code = codes_t[nd[:, 0], rows].long()
            left = dec[cur, code - nd[:, 3]] != 0
            node = torch.where(node >= 0,
                               torch.where(left, nd[:, 1], nd[:, 2]), node)
        leaf = ~node
        if leaf_mode:
            out[:, t - first] = leaf.int()
        else:
            out[:, t % k] += forest.leaf[t][leaf]
    return out
