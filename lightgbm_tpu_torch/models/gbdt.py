"""GBDT: training, model text in and out, prediction.

The JAX package's ``models/gbdt.py`` (gbdt.cpp, gbdt_model_text.cpp,
gbdt_prediction.cpp of the reference). Training is the serial gbdt path
on the exact f32 tier or the int8 quantized tiers (count-proxy or exact
counts), with 4-bit packed bins where the JAX package packs them, on
numerical and categorical features:
``init`` sets up the wave grower on the train set's device, and
``train_one_iter`` runs one boosting iteration there
(the step body of the JAX package's ``ops/step_cache.py:324-406``:
gradients of every objective, or custom ones, for all K classes at once;
the subclasses' sample hook (GOSS, models/boosting.py); then per class
its tree, the L1 family's leaf renewal (ops/renew.py), the shrinkage
fold, the score update of its row through the leaf-gather kernel, the
boost-from-average bias on the stored record). GOSS, DART and RF
(models/boosting.py, ``create_boosting``) build on this class; forced
splits (``forcedsplits_filename``) are a prefix of every tree's growth
(ops/wave_grower.py), and ``init_from_loaded`` continues training a
loaded model on a new train set.
Valid sets (``add_valid_data``) ride the grower's bin matrix as weight-0
passenger columns after the training rows, as in the JAX package
(gbdt.py:977-1013, :1165-1220): every split moves them, nothing counts
them, and each iteration's valid-score update is one leaf-gather launch
on their slice of the leaf ids. ``rollback_one_iter`` replays the last
tree and subtracts it (shrink -1.0) from the train and valid scores.
Bagging and feature sampling draw from the same numpy PCG64 streams as
the JAX package, so both pick the same rows and features. Prediction
goes through the stacked forest kernel (ops/stacked_predict.py) for
every ensemble the stacker can host; the others, and
``pred_early_stop``, take the float64 host walk.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..io.binning import BinType
from .tree import Tree, record_arrays_from_tree, tree_from_record
from ..analysis import lockorder
from ..ops.grower import TreeRecord
from ..objectives import ObjectiveFunction, parse_objective_from_model_string
from ..ops.f32math import fma
from ..ops import predict_cache
from ..ops.predict import add_leaf_outputs, replay_partition
from ..ops.renew import renew_leaf_outputs
from ..ops.split import SplitParams
from ..ops.wave_grower import WaveGrower, WaveGrowerConfig
from ..utils import log
from ..utils.device import resolve_device
from ..utils.log import LightGBMError

K_MODEL_VERSION = "v2"     # gbdt.h kModelVersion

# the objectives whose training starts from their average score (the JAX
# package's gbdt.py:1260)
_BOOST_FROM_AVERAGE = ("regression", "regression_l1", "quantile", "huber",
                       "fair", "mape", "binary", "cross_entropy", "poisson",
                       "gamma", "tweedie")

# the JAX package's exact-tier wave caps (ops/autotune.py:731)
EXACT_TIER_CAPS = {"hilo5": 24, "hilo4": 32, "hilo3": 40}


class GBDT:
    """A boosting model, trained (``init`` + ``train_one_iter``) or
    loaded. ``device`` is where a loaded model predicts: None means
    ``cuda:0`` (raising at predict time when there is no card);
    ``"cpu"`` runs the plain PyTorch path. A trained model lives on its
    train set's device."""

    def __init__(self, device=None):
        self.device = device
        self.config: Optional[Config] = None
        self.objective: Optional[ObjectiveFunction] = None
        self.models: List[Tree] = []            # class-major order
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.max_feature_idx = 0
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.average_output = False
        self.records: list = []              # grown TreeRecords
        self._tree_shrinkage: List[float] = []
        self._stacked_lock = lockorder.named_lock("gbdt._stacked_lock")
        self._stacked = None              # guarded-by: _stacked_lock
        self._stacked_built = False       # guarded-by: _stacked_lock

    def _stacked_model(self):
        """The whole-ensemble device predictor, built once per loaded
        model under the lock; None when the stacker cannot host it."""
        with self._stacked_lock:
            if not self._stacked_built:
                from ..ops.stacked_predict import StackedModel
                nf = self.max_feature_idx + 1
                if nf <= 0 and self.models:
                    nf = max([max(t.split_feature, default=-1)
                              for t in self.models]) + 1
                cfg = self.config
                sm = StackedModel(self.models, max(nf, 1),
                                  self.num_tree_per_iteration,
                                  resolve_device(self.device),
                                  serve_bucket=(cfg.tpu_serve_bucket
                                                if cfg is not None
                                                else None))
                self._stacked = sm if sm.ok else None
                self._stacked_built = True
            return self._stacked

    # -- training (gbdt.cpp:47-412) -----------------------------------------

    def init(self, config: Config, train_data, objective: ObjectiveFunction,
             training_metrics: Sequence = ()) -> "GBDT":
        """Set up training on ``train_data`` (io/dataset.py
        BinnedDataset) on its device (gbdt.cpp:47-117)."""
        self.config = config
        self.train_data = train_data
        self.device = train_data.device
        self.objective = objective
        self.training_metrics = list(training_metrics)
        self.iter_ = 0
        self.num_class = config.num_class
        self.shrinkage_rate = config.learning_rate
        self.num_tree_per_iteration = (objective.num_model_per_iteration
                                       if objective is not None
                                       else config.num_class)
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = train_data.feature_infos()
        self.models, self.records, self._tree_shrinkage = [], [], []
        # valid sets (io/dataset BinnedDatasets), their names, metrics,
        # [K, Nv] scores and (offset, rows) in the grower's bin matrix
        self.valid_sets, self.valid_names, self.valid_metrics = [], [], []
        self._valid_scores: List[torch.Tensor] = []
        self._valid_row_slices: List[tuple] = []
        self._invalidate_stacked()
        # the process default of the serving buckets
        # (ops/predict_cache.py); each stack keeps its own booster's
        predict_cache.configure(config.tpu_serve_bucket)
        self._n = n = self._n_total = train_data.num_data
        self._host_meta = train_data.feature_meta()
        self._grower_cfg = None
        # the forced splits in this train set's bins, read once a file
        self._forced_file, self._forced_splits = None, ()
        self._setup_grower()
        dev = self.device
        self._scores = self._initial_scores(train_data)
        self._full_mask = torch.ones(n, dtype=torch.float32, device=dev)
        self._bagging_rng = np.random.default_rng(config.bagging_seed)
        self._feature_rng = np.random.default_rng(
            config.feature_fraction_seed)
        self._renew = self._renew_aux(objective, self.device)
        return self

    def _jax_score_width(self) -> int:
        """The JAX package's score width for this train set: its step
        pads the rows to a bucket (ops/step_cache.py bucket_rows, under
        ``tpu_row_bucket``; exact with ``tpu_step_cache=0``). Its
        weighted leaf renewal sums over that width, and the order of
        that f32 sum depends on it."""
        cfg, n = self.config, self._n
        policy = cfg.tpu_row_bucket
        if cfg.tpu_step_cache == 0 or policy == 0:
            return n
        if policy > 0:
            return -(-n // policy) * policy
        b = max(n, 256)
        if b <= 1 << 14:
            return 1 << (b - 1).bit_length()
        step = 1 << ((b - 1).bit_length() - 4)
        return -(-b // step) * step

    @staticmethod
    def _renew_aux(obj, dev):
        """(alpha, label [N] f32, weights [N] f32 or None) on ``dev`` for
        objectives that renew their leaf outputs (the L1 family), else
        None (the JAX package's _renew_aux): the transformed label, and
        MAPE's label weights in place of the row weights."""
        if obj is None or not obj.is_renew_tree_output():
            return None
        lbl = getattr(obj, "trans_label", obj.label)
        w = getattr(obj, "label_weight", None)
        if w is None:
            w = obj.weights
        return (float(obj.renew_tree_output_percentile()),
                torch.from_numpy(np.asarray(lbl, np.float32)).to(dev),
                None if w is None else torch.from_numpy(
                    np.asarray(w, np.float32)).to(dev))

    def _setup_grower(self) -> None:
        """The grower of the serial learner and its histogram tier: split
        hyperparameters, precision, count-proxy, packed bins, the wave
        width W and the histogram width B (the JAX package's
        gbdt.py:300-480, serial learner, no EFB bundles or sparse tier,
        which the port has not)."""
        cfg = self.config
        td = self.train_data
        if cfg.tree_learner != "serial":
            log.warning("tree_learner=%s needs several devices; the port "
                        "trains with the serial learner", cfg.tree_learner)
        hp = SplitParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            max_delta_step=cfg.max_delta_step,
            min_data_in_leaf=float(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            max_cat_to_onehot=cfg.max_cat_to_onehot,
            max_cat_threshold=cfg.max_cat_threshold,
            cat_l2=cfg.cat_l2, cat_smooth=cfg.cat_smooth,
            min_data_per_group=float(cfg.min_data_per_group),
            has_cat=any(m.bin_type == BinType.CATEGORICAL
                        for m in td.mappers))
        quant = cfg.tpu_quantized_hist
        forced = bool(cfg.forcedsplits_filename)
        if cfg.forcedsplits_filename != self._forced_file:
            self._forced_file = cfg.forcedsplits_filename
            self._forced_splits = (self._parse_forced_splits() if forced
                                   else ())
        # count-proxy: int8 only, no forced splits and no categorical
        # features, whose search takes a side's count as num_data minus
        # the other's, which would turn the proxy's lower bounds into
        # over-estimates (EFB bundles and the sparse tier, which it also
        # excludes, are not ported)
        proxy = (quant and not forced and not hp.has_cat
                 and cfg.tpu_count_proxy != 0)
        if cfg.tpu_count_proxy == 1 and not proxy:
            log.warning("tpu_count_proxy needs tpu_quantized_hist with "
                        "tree_learner serial/data, no EFB bundles, no "
                        "forced splits and no categorical features; "
                        "using exact counts")
        if proxy and cfg.tpu_count_proxy == -1:
            log.info("tpu_count_proxy auto-enabled (int8 count-proxy "
                     "histograms, 64-leaf waves): per-bin counts are "
                     "conservative lower bounds for the "
                     "min_data_in_leaf gate; set tpu_count_proxy=0 for "
                     "exact counts")
        # 4-bit packed bins ride the count-proxy tier or the exact tier
        packed4_exact = not quant and cfg.tpu_use_dp and not forced
        packed4 = ((proxy or packed4_exact) and td.max_bin_global <= 16
                   and cfg.tpu_packed_bins != 0)
        if quant and proxy:
            precision, w_cap = "int8", 64    # 2 channels
            hp = hp._replace(count_lb=True)  # conservative min_data gate
        elif quant:
            precision, w_cap = "int8", 40    # 3 channels
        elif cfg.tpu_use_dp:
            # the exact tier's channel layout only sets the wave cap; off
            # the TPU the JAX package takes the widest layout its
            # objective allows (ops/autotune.py tune_exact_tier): hilo3
            # for an objective with constant hessians under gbdt, else
            # hilo4
            precision = "f32"
            const_h = bool(self.objective is not None
                           and self.objective.is_constant_hessian
                           and cfg.boosting_type() == "gbdt")
            variant = cfg.tpu_exact_tier or (
                "hilo5" if cfg.tpu_autotune == "off"
                else "hilo3" if const_h else "hilo4")
            if variant == "hilo3" and not const_h:
                log.warning("tpu_exact_tier=hilo3 needs a constant-unit-"
                            "hessian objective without row weights (the "
                            "fused hess/count plane would misread varying "
                            "hessians); using hilo4")
                variant = "hilo4"
            w_cap = EXACT_TIER_CAPS[variant]
        else:
            precision, w_cap = "f32", 32
        W = cfg.tpu_wave_size or w_cap
        if W > w_cap:
            log.warning("tpu_wave_size=%d exceeds the Pallas lane cap for "
                        "this precision; clamping to %d", W, w_cap)
        W = max(1, min(W, w_cap, max(cfg.num_leaves, 2) - 1))
        if quant and 127 * self._n >= 2 ** 31:
            raise NotImplementedError(
                "int8 histogram sums could overflow int32 beyond ~16.9M "
                "rows; disable tpu_quantized_hist")
        # the histogram width: the JAX package's default bucket policy
        # (step_cache.bucket_bins), a power of two >= 16, unless
        # tpu_row_bucket=0 asks for exact shapes. Bins past a feature's
        # num_bin stay empty; keeping the JAX width keeps the split
        # finder's prefix products the same shape as the reference's.
        B = max(td.max_bin_global, 2)
        if cfg.tpu_row_bucket != 0:
            B = 1 << (max(B, 16) - 1).bit_length()
        grower_cfg = WaveGrowerConfig(
            num_leaves=max(cfg.num_leaves, 2), num_bins=B, wave_size=W,
            max_depth=cfg.max_depth, hp=hp, precision=precision,
            count_proxy=proxy, packed4=packed4, forced=self._forced_splits)
        if self._grower_cfg == grower_cfg:
            return                      # reset_config changed no field
        self._grower_cfg = grower_cfg
        if packed4:
            nbytes = -(-td.num_features // 2) * self._n
            log.info("4-bit packed bins: %.1f MB HBM (vs %.1f MB unpacked)",
                     nbytes / 1e6, 2 * nbytes / 1e6)
        self._grower = WaveGrower(self._grower_cfg, td.feature_meta(),
                                  self.device)

    def _parse_forced_splits(self) -> tuple:
        """The ``forcedsplits_filename`` JSON as ((parent leaf, inner
        feature, bin), ...) in BFS order, the reference's ForceSplits
        leaf numbering (serial_tree_learner.cpp:546-701; the JAX
        package's gbdt.py:910): the left child keeps its parent's leaf,
        the right child takes the next id in the order of application.
        A node on an unused or a categorical feature is skipped with its
        subtree, with a warning; at most num_leaves - 1 splits."""
        import collections
        import json
        cfg = self.config
        try:
            with open(cfg.forcedsplits_filename) as fh:
                spec = json.load(fh)
        except (OSError, ValueError) as e:
            log.fatal(f"Cannot read forced splits file "
                      f"{cfg.forcedsplits_filename!r}: {e}")
        td = self.train_data
        out = []
        q = collections.deque([(spec, 0)])
        next_leaf = 1
        cap = max(cfg.num_leaves, 2) - 1
        while q and len(out) < cap:
            node, leaf = q.popleft()
            if not isinstance(node, dict) or "feature" not in node:
                continue
            if "threshold" not in node:
                log.fatal(f"Forced split node missing 'threshold': "
                          f"{node!r}")
            inner = td.real_to_inner.get(int(node["feature"]))
            if inner is None:
                log.warning("Forced split on unused feature %s skipped",
                            node["feature"])
                continue
            if td.mappers[inner].bin_type == BinType.CATEGORICAL:
                log.warning("Forced split on categorical feature %s is "
                            "not supported; skipped", node["feature"])
                continue
            tbin = int(td.mappers[inner].value_to_bin(
                np.asarray([float(node["threshold"])]))[0])
            out.append((leaf, int(inner), tbin))
            right_leaf = next_leaf
            next_leaf += 1
            if node.get("left"):
                q.append((node["left"], leaf))
            if node.get("right"):
                q.append((node["right"], right_leaf))
        if out:
            log.info("Applying %d forced splits per tree", len(out))
        return tuple(out)

    def _initial_scores(self, data) -> torch.Tensor:
        """[K, N] f32 scores of ``data`` before any tree: its init scores
        (class-major), else zeros (the JAX package's _init_scores)."""
        k, n = self.num_tree_per_iteration, data.num_data
        init = np.zeros((k, n), np.float32)
        if data.metadata.init_score is not None:
            init += np.asarray(data.metadata.init_score,
                               np.float32).reshape(k, n)
        return torch.from_numpy(init).to(self.device)

    def _replay(self, rec, bins_t: torch.Tensor) -> torch.Tensor:
        """Leaf ids of the rows of ``bins_t`` [F, N] (unpacked) in a
        grown tree, its splits read from one host copy of the record."""
        return replay_partition(TreeRecord(**rec.to_numpy()), bins_t,
                                self._host_meta)

    def _replay_into(self, scores: torch.Tensor, bins_t: torch.Tensor,
                     records: Sequence) -> None:
        """Add the trees of ``records`` to ``scores`` [K, N] of the rows
        of ``bins_t`` [F, N] (unpacked), each at shrink 1.0, as a valid
        set added late or a continued model's train set starts."""
        k = self.num_tree_per_iteration
        for t_idx, rec in enumerate(records):
            add_leaf_outputs(scores[t_idx % k], self._replay(rec, bins_t),
                             rec.leaf_output, 1.0)

    def init_from_loaded(self, config: Config, train_data, objective,
                         training_metrics: Sequence = ()) -> "GBDT":
        """Continue training a loaded model on ``train_data`` (the JAX
        package's gbdt.py:1015-1054; reference GBDT::ResetTrainingData):
        each loaded tree gets a record in the new mappers' bin space
        (``record_arrays_from_tree``) and is replayed into the train
        scores; training goes on at iteration ``trees / K``, so the
        bagging and sampling schedules go on too. The loaded host Trees
        stay as they were loaded, so their thresholds in the model text
        are the ones read."""
        self._ensure_host_trees()
        loaded = list(self.models)
        k_loaded = max(self.num_tree_per_iteration, 1)
        self.init(config, train_data, objective, training_metrics)
        K = self.num_tree_per_iteration
        if K != k_loaded:
            log.fatal("num_class of input_model doesn't match config")
        L = self._grower_cfg.num_leaves
        self.models = loaded
        self.records = []
        self._tree_shrinkage = [m.shrinkage if m.shrinkage else 1.0
                                for m in loaded]
        for tree in loaded:
            arrs = record_arrays_from_tree(
                tree, train_data.real_to_inner, train_data.mappers, L)
            self.records.append(TreeRecord(**{
                k: int(v) if k == "num_leaves"
                else torch.from_numpy(v).to(self.device)
                for k, v in arrs.items()}))
        self.iter_ = len(loaded) // K
        self._replay_into(self._scores, train_data.bins_t, self.records)
        self._invalidate_stacked()
        log.info("Continuing training from iteration %d", self.iter_)
        return self

    def add_valid_data(self, valid_data, metrics: Sequence = (),
                       name: str = "") -> None:
        """Add a validation set (io/dataset BinnedDataset binned with the
        train set's mappers; the JAX package's gbdt.py:977): its scores
        start from its init scores plus the trees so far, replayed at
        shrink 1.0, and from then on its rows ride the grower's bin
        matrix as passengers."""
        if valid_data.device != self.device:
            raise LightGBMError(f"the validation set is on "
                                f"{valid_data.device}, the model on "
                                f"{self.device}")
        self.valid_sets.append(valid_data)
        self.valid_names.append(name or f"valid_{len(self.valid_sets)}")
        self.valid_metrics.append(list(metrics))
        scores = self._initial_scores(valid_data)
        self._valid_scores.append(scores)
        if self.records:
            self._replay_into(scores, valid_data.bins_t, self.records)
        self._rebuild_grower_bins()

    def _rebuild_grower_bins(self) -> None:
        """The grower's bin matrix: the training columns, then each valid
        set's (the JAX package's _rebuild_grower_bins), in the grower's
        form (4-bit packed or not). Each set then holds a view of its
        columns of it rather than a copy; the masks pad with zeros to the
        combined width."""
        packed4 = self._grower_cfg.packed4
        sets = [self.train_data] + self.valid_sets
        parts = [ds.bins_in(packed4) for ds in sets]
        combined = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        slices, off = [], 0
        for ds in sets:
            ds.share_bins(combined[:, off:off + ds.num_data])
            slices.append((off, ds.num_data))
            off += ds.num_data
        self._bins_dev = combined
        self._valid_row_slices = slices[1:]
        self._n_total = off
        self._full_mask = torch.cat([
            torch.ones(self._n, dtype=torch.float32, device=self.device),
            torch.zeros(off - self._n, dtype=torch.float32,
                        device=self.device)])

    def _grower_bins(self) -> torch.Tensor:
        """The bin matrix a tree grows on: the train set's, or with valid
        sets the combined one."""
        if self.valid_sets:
            return self._bins_dev
        return self.train_data.grower_bins(self._grower_cfg.packed4)

    def reset_config(self) -> None:
        """Take up a changed ``config`` (ResetConfig, the JAX package's
        Booster.reset_parameter): the learning rate, and a new grower
        only if a field of its ``WaveGrowerConfig`` changed; the valid
        sets' columns are packed anew only if the grower's bin form
        changed."""
        packed4 = self._grower_cfg.packed4
        self.shrinkage_rate = self.config.learning_rate
        self._setup_grower()
        if self.valid_sets and self._grower_cfg.packed4 != packed4:
            self._rebuild_grower_bins()

    def _bagging_mask(self, iteration: int) -> Optional[np.ndarray]:
        """Bagging (gbdt.cpp:161-243): a fresh subset every
        ``bagging_freq`` iterations, from the bagging PCG64 stream."""
        cfg = self.config
        if not (cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0):
            return None
        if iteration % cfg.bagging_freq != 0 and hasattr(self, "_bag_cache"):
            return self._bag_cache
        n = self._n
        idx = self._bagging_rng.choice(n, int(n * cfg.bagging_fraction),
                                       replace=False)
        mask = np.zeros(n, np.float32)
        mask[idx] = 1.0
        self._bag_cache = mask
        return mask

    def _feature_mask(self) -> np.ndarray:
        """feature_fraction: the features a tree may split on."""
        cfg = self.config
        f = max(self.train_data.num_features, 1)
        mask = np.ones(f, bool)
        if cfg.feature_fraction < 1.0:
            used = max(1, int(f * cfg.feature_fraction))
            mask = np.zeros(f, bool)
            mask[self._feature_rng.choice(f, used, replace=False)] = True
        return mask

    def boost_from_average(self, class_id: int) -> float:
        """BoostFromAverage (gbdt.cpp:311-330): only while the model is
        empty, the train set has no init scores and the objective is one
        the JAX package starts from its average (gbdt.py:1260); the valid
        sets' scores take the same bias."""
        if (self.models or not self.config.boost_from_average
                or self.objective is None
                or self.objective.name not in _BOOST_FROM_AVERAGE
                or self.train_data.metadata.init_score is not None):
            return 0.0
        init = self.objective.boost_from_score(class_id)
        if init != 0.0:
            bias = float(np.float32(init))
            for scores in [self._scores] + self._valid_scores:
                scores[class_id] += bias
            log.info("Start training from score %g", init)
        return init

    def _sample(self, g_all: torch.Tensor, h_all: torch.Tensor,
                mask: torch.Tensor) -> tuple:
        """The sample hook between the gradients [K, N] and the trees
        (GOSS overrides it; the JAX package's ``sample_hook``,
        ops/step_cache.py:340-348): (g, h, mask [N + passengers])."""
        return g_all, h_all, mask

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (gbdt.cpp:333-412; the step body of the
        JAX package's ops/step_cache.py:324-406); True when training
        should stop. ``grad`` and ``hess``: custom [K, N] gradients (any
        array of K * N values, class-major), else the objective's.

        The gradients come from the whole [K, N] score matrix at once;
        then each class k in order grows its tree on its row with the
        iteration's bagging and feature masks, and its leaf outputs
        update row k of the train scores and of each valid set's scores
        (one leaf-gather launch each). Objectives of the L1 family renew
        a tree's leaf outputs against the scores before its update; a
        tree that could not split is not renewed. The stored records are
        model-equivalent: shrinkage and the first iteration's
        boost-from-average bias are folded into their outputs, as the
        reference's Shrinkage + AddBias do.

        An iteration in which no class's tree can split stops training
        at once (gbdt.cpp:393-409) and is dropped, unless it is the
        first, which stays as the constant model. The JAX package defers
        this check to spare a device sync; here ``grow`` has read the
        leaf counts back already."""
        K = self.num_tree_per_iteration
        custom = grad is not None and hess is not None
        if custom:
            init_scores = [0.0] * K
        else:
            if self.objective is None:
                log.fatal("No objective; pass custom grad/hess")
            init_scores = [self.boost_from_average(k) for k in range(K)]
        first_iteration = not self.models
        dev = self.device
        n, tail = self._n, self._n_total - self._n
        mask_np = self._bagging_mask(self.iter_)
        if mask_np is None:
            mask = self._full_mask
        else:
            if tail:
                mask_np = np.concatenate([mask_np,
                                          np.zeros(tail, np.float32)])
            mask = torch.from_numpy(mask_np).to(dev)
        fmask = torch.from_numpy(self._feature_mask()).to(dev)
        if custom:
            g_all, h_all = (torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, np.float32).reshape(K, n))).to(dev)
                for a in (grad, hess))
        else:
            g_all, h_all = self.objective.get_gradients(
                self._scores if K > 1 else self._scores[0])
            if K == 1:
                g_all, h_all = g_all[None], h_all[None]
        g_all, h_all, mask = self._sample(g_all, h_all, mask)
        renew = None if custom else self._renew
        grown = []
        for k in range(K):
            g, h = g_all[k], h_all[k]
            if tail:
                # the passengers' g and h: exact +0.0
                g = torch.cat([g, g.new_zeros(tail)])
                h = torch.cat([h, h.new_zeros(tail)])
            rec, leaf_ids = self._grower.grow(self._grower_bins(), g, h,
                                              mask, fmask, counted_rows=n)
            if renew is not None and rec.num_leaves > 1:
                # against the scores before this tree's update
                # (serial_tree_learner.cpp:780-818)
                alpha, label, w = renew
                rec = rec._replace(leaf_output=renew_leaf_outputs(
                    leaf_ids[:n], label - self._scores[k], w,
                    self._grower_cfg.num_leaves, alpha, rec.leaf_output,
                    mask[:n], sum_length=self._jax_score_width()))
            grown.append((rec, leaf_ids))
        splitless = all(rec.num_leaves <= 1 for rec, _ in grown)
        if splitless:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if not first_iteration:
                return True
        shrink = float(np.float32(self.shrinkage_rate))
        for k, (rec, leaf_ids) in enumerate(grown):
            # out-of-bag rows included: the partition covers every row.
            # The last class's shrinkage rides the add as one fused
            # multiply-add, as XLA contracts the JAX package's step; the
            # other classes' updates XLA leaves unfused: their outputs
            # are shrunk (rounded) first
            if k == K - 1:
                table, scale = rec.leaf_output, shrink
            else:
                table, scale = rec.leaf_output * shrink, 1.0
            add_leaf_outputs(self._scores[k], leaf_ids[:n], table, scale)
            # each valid set's rows: their slice of the leaf ids, one
            # launch on row k
            for scores, (off, nv) in zip(self._valid_scores,
                                         self._valid_row_slices):
                add_leaf_outputs(scores[k], leaf_ids[off:off + nv], table,
                                 scale)
            # AddBias on the stored record only (tree.h:151): the init
            # score reached the scores through boost_from_average already
            # (XLA contracts the JAX package's shrinkage and bias into one
            # fused multiply-add here too)
            init = init_scores[k] if first_iteration else 0.0
            bias = float(np.float32(init))
            self.records.append(rec._replace(
                leaf_output=fma(rec.leaf_output, shrink, bias),
                internal_value=fma(rec.internal_value, shrink, bias)))
            self.models.append(None)
            self._tree_shrinkage.append(
                1.0 if first_iteration and abs(init) > 1e-15
                else self.shrinkage_rate)
        self._invalidate_stacked()
        self.iter_ += 1
        return splitless

    def _ensure_host_trees(self) -> None:
        """Host Trees for the records that have none yet."""
        td = getattr(self, "train_data", None)
        for i, m in enumerate(self.models):
            if m is None:
                tree = tree_from_record(
                    self.records[i].to_numpy(), td.mappers,
                    td.used_feature_map, self._grower_cfg.num_leaves)
                tree.shrinkage = self._tree_shrinkage[i]
                self.models[i] = tree

    def _drop_last_iterations(self, n_groups: int) -> None:
        """Remove the last ``n_groups`` iterations and subtract their
        trees, replayed, from the train and valid scores (shrink -1.0:
        one rounding each, as the JAX package's gbdt.py:1747; the forward
        step's fma rounded once too, so the scores come back within an
        ulp or two, not always to their bits)."""
        K = self.num_tree_per_iteration
        train_bins = self.train_data.bins_t
        valid_bins = [v.bins_t for v in self.valid_sets]
        for _ in range(n_groups):
            for k in range(K - 1, -1, -1):
                rec = self.records.pop()
                self.models.pop()
                self._tree_shrinkage.pop()
                add_leaf_outputs(self._scores[k],
                                 self._replay(rec, train_bins),
                                 rec.leaf_output, -1.0)
                for scores, bins in zip(self._valid_scores, valid_bins):
                    add_leaf_outputs(scores[k], self._replay(rec, bins),
                                     rec.leaf_output, -1.0)
            self.iter_ -= 1
        self._invalidate_stacked()

    def rollback_one_iter(self) -> None:
        """RollbackOneIter (gbdt.cpp:414-430)."""
        if self.iter_ > 0:
            self._drop_last_iterations(1)

    def train_scores(self) -> torch.Tensor:
        """[K, N] raw scores of the train set, on the device."""
        return self._scores

    def valid_scores(self, data_idx: int) -> torch.Tensor:
        """[K, Nv] raw scores of valid set ``data_idx`` (1, 2, ...), on
        the device."""
        return self._valid_scores[data_idx - 1]

    def get_eval_at(self, data_idx: int) -> List[tuple]:
        """[(metric name, value, bigger is better)] on the train set
        (data_idx 0) or a valid set (1, 2, ...); NDCG and MAP give one
        entry for each cut of ``eval_at``. Each metric gives float64
        values on the device; they come back in one readback."""
        if data_idx == 0:
            scores, metrics = self._scores, self.training_metrics
        else:
            scores = self.valid_scores(data_idx)
            metrics = self.valid_metrics[data_idx - 1]
        if not metrics:
            return []
        vals = torch.cat([m.eval_tensor(scores, self.objective).reshape(-1)
                          for m in metrics])
        names = [(name, m.bigger_is_better) for m in metrics
                 for name in m.names()]
        return [(name, v, bigger)
                for (name, bigger), v in zip(names, vals.tolist())]

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = 0) -> np.ndarray:
        """Per feature, the times it is split on ("split") or its splits'
        summed gains ("gain") in the first ``iteration`` iterations (0:
        all), the JAX package's gbdt.py:2731."""
        self._ensure_host_trees()
        n_models = len(self.models)
        if iteration > 0:
            n_models = min(n_models, iteration * self.num_tree_per_iteration)
        return self._importance(n_models, importance_type)

    def _importance(self, n_models: int, importance_type: str) -> np.ndarray:
        """``feature_importance`` over the first ``n_models`` trees (the
        model file's ``feature importances:`` block counts splits)."""
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        for t in self.models[:n_models]:
            for i in range(t.num_leaves - 1):
                imp[t.split_feature[i]] += (
                    1.0 if importance_type == "split"
                    else max(t.split_gain[i], 0.0))
        return imp

    @property
    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    def num_model_per_iteration(self) -> int:
        return self.num_tree_per_iteration

    def prepare_serving(self, warm_rows: int = 0) -> bool:
        """Build this model's serving path BEFORE it is published into a
        live request stream (the swap seam of the pipelined LRB loop,
        lrb.py): the host trees, the stacked tables on the device and,
        with ``warm_rows`` > 0, one throwaway predict of that many zero
        rows through the whole path (the forest kernel's library loads
        on its first launch). Returns True when a stacked predictor is
        available."""
        self._ensure_host_trees()
        sm = self._stacked_model() if self.models else None
        if sm is None:
            return False
        if warm_rows > 0:
            self.predict(np.zeros((int(warm_rows),
                                   max(self.max_feature_idx + 1, 1))))
        return True

    def _invalidate_stacked(self) -> None:
        with self._stacked_lock:
            self._stacked = None
            self._stacked_built = False

    # -- prediction ---------------------------------------------------------

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1,
                    start_iteration: int = 0,
                    pred_early_stop: bool = False,
                    pred_early_stop_freq: int = 10,
                    pred_early_stop_margin: float = 10.0) -> np.ndarray:
        """Raw scores [N] or [N, K] (gbdt_prediction.cpp:9-30).

        ``pred_early_stop``: stop accumulating trees for rows whose
        prediction margin exceeds the threshold, re-checked every
        ``freq`` trees (prediction_early_stop.cpp:20-84: binary margin
        = 2|raw|, multiclass margin = top1 - top2). Rows stop in
        batches of ``freq`` — data-dependent, so it runs on the host
        tree path."""
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        k = self.num_tree_per_iteration
        self._ensure_host_trees()
        ntree = len(self.models)
        if num_iteration >= 0:
            ntree = min(ntree, (start_iteration + num_iteration) * k)
        first = start_iteration * k
        # the reference enables early stop only where approximate
        # predictions are acceptable: binary / multiclass
        # (NeedAccuratePrediction, prediction_early_stop.cpp)
        if pred_early_stop and k == 1 and not (
                self.objective is not None
                and self.objective.name in ("binary", "multiclassova",
                                            "cross_entropy")):
            log.warning("pred_early_stop is only supported for "
                        "binary/multiclass objectives; ignoring")
            pred_early_stop = False
        if pred_early_stop and k >= 1 and ntree > first:
            out = np.zeros((k, n), np.float64)
            active = np.arange(n)
            Xa = X                      # re-sliced only when rows stop
            for t_idx in range(first, ntree):
                cls = t_idx % k
                out[cls, active] += self.models[t_idx].predict(Xa)
                done_group = ((t_idx - first + 1) % max(
                    pred_early_stop_freq * k, 1) == 0)
                if done_group and len(active):
                    if k == 1:
                        margin = 2.0 * np.abs(out[0, active])
                    else:
                        part = np.sort(out[:, active], axis=0)
                        margin = part[-1] - part[-2]
                    keep = margin <= pred_early_stop_margin
                    if not keep.all():
                        active = active[keep]
                        Xa = X[active]
                    if not len(active):
                        break
            if self.average_output:
                out /= max((ntree - first) // k, 1)
            return out[0] if k == 1 else out.T
        # every stackable ensemble goes through the forest kernel, even
        # one of a single tree: the card path is the route a caller gets
        sm = self._stacked_model() if self.models else None
        if sm is not None:
            out = sm.predict(X, first, ntree)
        else:
            out = np.zeros((k, n), np.float64)
            for t_idx in range(first, ntree):
                out[t_idx % k] += self.models[t_idx].predict(X)
        if self.average_output:
            # reference divides by the iteration count actually predicted
            # (gbdt_prediction.cpp:51-65)
            used_iters = max((ntree - first) // k, 1)
            out /= used_iters
        return out[0] if k == 1 else out.T

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                **pred_kw) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration, **pred_kw)
        if self.objective is None:
            return raw
        # convert_output is class-major [K, N] like the reference's
        # ConvertOutput; predict_raw returns [N, K]
        r = raw.T if raw.ndim == 2 else raw
        out = self.objective.convert_output(torch.from_numpy(
            np.ascontiguousarray(r))).numpy()
        return out.T if raw.ndim == 2 else out

    def predict_leaf_index(self, X: np.ndarray,
                           num_iteration: int = -1) -> np.ndarray:
        X = np.asarray(X, np.float64)
        self._ensure_host_trees()
        ntree = len(self.models)
        if num_iteration >= 0:
            ntree = min(ntree, num_iteration * self.num_tree_per_iteration)
        sm = self._stacked_model() if self.models else None
        if sm is not None:
            return sm.predict(X, 0, ntree, pred_leaf=True)
        out = np.zeros((X.shape[0], ntree), np.int32)
        for t in range(ntree):
            out[:, t] = self.models[t].predict_leaf_index(X)
        return out

    def predict_contrib(self, X: np.ndarray,
                        num_iteration: int = -1) -> np.ndarray:
        """SHAP feature contributions [N, F+1] (or [N, K*(F+1)] for
        multiclass): per-feature Shapley values and the bias column
        (gbdt.h PredictContrib / tree.h:118), by TreeSHAP on the host in
        float64, as the JAX package computes them; no kernel runs."""
        self._ensure_host_trees()
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        k = self.num_tree_per_iteration
        f1 = self.max_feature_idx + 2
        ntree = len(self.models)
        if num_iteration >= 0:
            ntree = min(ntree, num_iteration * k)
        out = np.zeros((k, n, f1), np.float64)
        for t_idx in range(ntree):
            self.models[t_idx].predict_contrib(X, out[t_idx % k])
        if self.average_output:
            out /= max(ntree // k, 1)
        if k == 1:
            return out[0]
        return out.transpose(1, 0, 2).reshape(n, k * f1)

    # -- model text (gbdt_model_text.cpp:240-450) ---------------------------

    def model_to_string(self, start_iteration: int = 0,
                        num_iteration: int = -1) -> str:
        lines = ["tree"]
        lines.append(f"version={K_MODEL_VERSION}")
        lines.append(f"num_class={self.num_class}")
        lines.append(f"num_tree_per_iteration={self.num_tree_per_iteration}")
        lines.append(f"label_index={self.label_idx}")
        lines.append(f"max_feature_idx={self.max_feature_idx}")
        if self.objective is not None:
            lines.append(f"objective={self.objective.to_string()}")
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("feature_infos=" + " ".join(self.feature_infos))

        self._ensure_host_trees()
        eff = len(self.models)
        total_iter = eff // max(self.num_tree_per_iteration, 1)
        start_iteration = max(0, min(start_iteration, total_iter))
        num_used = eff
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration)
                           * self.num_tree_per_iteration, num_used)
        start_model = start_iteration * self.num_tree_per_iteration

        tree_strs = []
        for i in range(start_model, num_used):
            s = f"Tree={i - start_model}\n" + self.models[i].to_string() + "\n"
            tree_strs.append(s)
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "".join(tree_strs)
        body += "end of trees\n"

        # as the JAX package counts: whole iterations, or every tree
        # when fewer than one iteration is written
        k = max(self.num_tree_per_iteration, 1)
        imp = self._importance(num_used // k * k or eff, "split")
        pairs = [(int(imp[i]), self.feature_names[i])
                 for i in range(len(imp)) if imp[i] > 0]
        pairs.sort(key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        for v, name in pairs:
            body += f"{name}={v}\n"
        if self.config is not None:
            body += "\nparameters:\n" + self.config.to_string() + "\n"
            body += "end of parameters\n"
        return body

    def save_model_to_file(self, filename: str, start_iteration: int = 0,
                           num_iteration: int = -1) -> None:
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(start_iteration, num_iteration))

    def load_model_from_string(self, s: str, source: str = "") -> "GBDT":
        """LoadModelFromString (gbdt_model_text.cpp:339-450).

        Truncated or corrupt input fails with a one-line error naming
        the source, what is malformed and the expected shape."""
        where = source or "model text"
        lines = s.splitlines()
        first = next((ln.strip() for ln in lines if ln.strip()), "")
        if first != "tree":
            log.fatal(f"{where}: not a LightGBM model (first line "
                      f"{first[:40]!r}, expected 'tree'; model version "
                      f"{K_MODEL_VERSION})")
        kv = {}
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            if line.startswith("Tree="):
                break
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
            elif line == "average_output":
                kv["average_output"] = "1"
            i += 1
        self.num_class = int(kv.get("num_class", 1))
        self.num_tree_per_iteration = int(kv.get("num_tree_per_iteration", 1))
        self.label_idx = int(kv.get("label_index", 0))
        self.max_feature_idx = int(kv.get("max_feature_idx", 0))
        self.average_output = "average_output" in kv
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos = kv.get("feature_infos", "").split()
        if self.config is None:
            self.config = Config()
        if "objective" in kv:
            self.objective = parse_objective_from_model_string(
                kv["objective"], self.config)
        # parse trees
        self.models, self.records, self._tree_shrinkage = [], [], []
        with self._stacked_lock:
            self._stacked = None
            self._stacked_built = False
        cur: List[str] = []
        seen_end = False
        for line in lines[i:]:
            t = line.strip()
            if t.startswith("Tree=") or t == "end of trees":
                if cur:
                    try:
                        self.models.append(
                            Tree.from_string("\n".join(cur)))
                    except (KeyError, ValueError, IndexError) as e:
                        log.fatal(
                            f"{where}: malformed Tree="
                            f"{len(self.models)} block "
                            f"({type(e).__name__}: {e})")
                    cur = []
                if t == "end of trees":
                    seen_end = True
                    break
            elif t:
                cur.append(t)
        if not seen_end:
            log.fatal(f"{where}: truncated model text — no 'end of "
                      f"trees' terminator after {len(self.models)} "
                      f"tree(s) (file cut off mid-write?)")
        return self

    def dump_model(self, start_iteration: int = 0,
                   num_iteration: int = -1) -> dict:
        """DumpModel JSON (gbdt_model_text.cpp:15-54)."""
        self._ensure_host_trees()
        num_used = len(self.models)
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration)
                           * self.num_tree_per_iteration, num_used)
        start_model = start_iteration * self.num_tree_per_iteration
        return {
            "name": "tree",
            "version": K_MODEL_VERSION,
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": self.label_idx,
            "max_feature_idx": self.max_feature_idx,
            "objective": (self.objective.to_string()
                          if self.objective else "none"),
            "average_output": self.average_output,
            "feature_names": self.feature_names,
            "tree_info": [t.to_json()
                          for t in self.models[start_model:num_used]],
        }

    # -- edits of a model in place (c_api.cpp SetLeafValue, ShuffleModels) --

    def set_leaf_value(self, tree_idx: int, leaf_idx: int,
                       value: float) -> None:
        """Tree::SetLeafOutput on the host tree and on its record, where
        it has one; the stacked tables are dropped, so the forest kernel
        serves the edited tree."""
        self._ensure_host_trees()
        t = int(tree_idx)
        self.models[t].set_leaf_output(int(leaf_idx), float(value))
        if t < len(self.records):
            out = self.records[t].leaf_output.clone()
            out[int(leaf_idx)] = float(np.float32(value))
            self.records[t] = self.records[t]._replace(leaf_output=out)
        self._invalidate_stacked()

    def shuffle_models(self, start: int = 0, end: int = -1) -> None:
        """A random permutation of the iterations in [start, end) (end
        <= 0: all), whole iteration groups, drawn as the JAX package
        draws it (numpy PCG64 from ``data_random_seed``); the stacked
        tables are dropped."""
        self._ensure_host_trees()
        k = max(self.num_tree_per_iteration, 1)
        n_groups = len(self.models) // k
        end = n_groups if end <= 0 else min(int(end), n_groups)
        start = max(int(start), 0)
        rng = np.random.default_rng(getattr(self.config, "data_random_seed",
                                            1))
        gperm = np.arange(n_groups)
        gperm[start:end] = rng.permutation(gperm[start:end])
        # tree t serves class t % k: whole groups move
        perm = (gperm[:, None] * k + np.arange(k)[None, :]).reshape(-1)
        self.models = [self.models[i] for i in perm]
        # a loaded model has neither records nor their shrinkage
        if self.records:
            self.records = [self.records[i] for i in perm]
            self._tree_shrinkage = [self._tree_shrinkage[i] for i in perm]
        self._invalidate_stacked()

    # -- refit (gbdt.cpp:265-289 RefitTree) ---------------------------------

    def refit_existing(self, decay_rate: Optional[float] = None) -> None:
        """RefitTree against the current train set (the JAX package's
        gbdt.py:2243): every tree keeps its structure and re-learns its
        leaf outputs on the new data's gradients, blended with
        ``refit_decay_rate`` (ops/refit.py). Sequential as the
        reference: iteration i's gradients see the refit outputs of
        iterations 0..i-1, from the train set's init scores. A tree's
        leaf ids come from its replay (``_replay``), and its outputs reach
        the scores through the leaf-gather kernel at shrink 1.0 (exactly
        ``scores + out[leaf]``, as in the JAX package). Call after
        ``init_from_loaded`` bound this booster to the new data."""
        from ..ops.refit import refit_leaf_outputs
        cfg = self.config
        decay = cfg.refit_decay_rate if decay_rate is None else decay_rate
        if self.objective is None:
            log.fatal("Refit requires an objective")
        K = self.num_tree_per_iteration
        bins = self.train_data.bins_t
        self._scores = self._initial_scores(self.train_data)
        for it in range(len(self.records) // K):
            g_all, h_all = self.objective.get_gradients(
                self._scores if K > 1 else self._scores[0])
            if K == 1:
                g_all, h_all = g_all[None], h_all[None]
            for k in range(K):
                t = it * K + k
                rec = self.records[t]
                leaf = self._replay(rec, bins)
                out = refit_leaf_outputs(
                    leaf, g_all[k], h_all[k], rec.leaf_output,
                    cfg.lambda_l1, cfg.lambda_l2, cfg.max_delta_step,
                    self._tree_shrinkage[t], decay)
                add_leaf_outputs(self._scores[k], leaf, out, 1.0)
                self.records[t] = rec._replace(leaf_output=out)
                self.models[t] = None
        self._invalidate_stacked()
        log.info("Refit %d trees with decay_rate=%g", len(self.records),
                 decay)

    # -- the CLI training driver (gbdt.cpp:245-263 GBDT::Train) -------------

    def train(self, snapshot_freq: int = -1, output_model: str = "",
              resume_from: str = "") -> None:
        """The application's training loop: boosting iterations with the
        metric lines of OutputMetric (gbdt.cpp:466-534), the reference's
        early stopping (EvalAndCheckEarlyStopping, gbdt.cpp:432-448: the
        last ``early_stopping_round`` iterations are dropped on a stop),
        and a model snapshot every ``snapshot_freq`` iterations. One
        synchronous loop: the JAX driver's pipelined evaluations change
        when its work is dispatched, not the metric lines, the stop
        iteration or the model it writes. A splitless iteration ends the
        loop and is dropped by ``train_one_iter`` itself, so no trim is
        left for the end. Checkpoints, run reports and the profiler
        window are not ported yet (ROADMAP item 20)."""
        import time
        from ..utils import timing
        cfg = self.config
        for key, on in (("tpu_run_report", cfg.tpu_run_report),
                        ("tpu_checkpoint_dir", cfg.tpu_checkpoint_dir),
                        ("tpu_resume_from", resume_from),
                        ("tpu_profile_dir", cfg.tpu_profile_dir)):
            if on:
                raise NotImplementedError(f"{key} is not ported yet")
        self._best_score = [[-np.inf] * len(ms) for ms in self.valid_metrics]
        self._best_iter = [[0] * len(ms) for ms in self.valid_metrics]
        self._best_msg = [[""] * len(ms) for ms in self.valid_metrics]
        start_time = time.monotonic()
        for add in range(cfg.num_iterations):
            with timing.phase("train/iteration"):
                is_finished = self.train_one_iter()
            if not is_finished:
                with timing.phase("train/eval"):
                    is_finished = self._eval_and_check_early_stopping(
                        add + 1)
            log.info("%f seconds elapsed, finished iteration %d",
                     time.monotonic() - start_time, add + 1)
            if snapshot_freq > 0 and (add + 1) % snapshot_freq == 0:
                self._write_snapshot(output_model, add + 1)
            if is_finished:
                break
        if output_model:
            with timing.phase("io/save_model"):
                self.save_model_to_file(output_model)
            log.info("Finished training; model saved to %s", output_model)
        timing.log_report("training phase timings "
                          "(serial_tree_learner.cpp:14-41 analog)")

    def _write_snapshot(self, output_model: str, it: int) -> None:
        """A model snapshot (save_period): written atomically, the newest
        ``tpu_snapshot_keep`` kept; a failed write warns and training
        goes on."""
        from ..utils.fileio import atomic_write, prune_numbered
        path = f"{output_model}.snapshot_iter_{it}"
        try:
            with atomic_write(path) as fh:
                fh.write(self.model_to_string())
        except OSError as e:
            log.warning("snapshot %s failed (%s); training continues",
                        path, e)
            return
        prune_numbered(output_model, ".snapshot_iter_*",
                       r"\.snapshot_iter_(\d+)$",
                       self.config.tpu_snapshot_keep)

    def _eval_and_check_early_stopping(self, it: int) -> bool:
        """``it`` counts the rounds of this loop, as the reference's
        iter_. True when early stopping fired (its iterations are
        dropped)."""
        best_msg = self._output_metric(it)
        if not best_msg:
            return False
        es = self.config.early_stopping_round
        log.info("Early stopping at iteration %d, the best iteration "
                 "round is %d", it, it - es)
        log.info("Output of best iteration round:\n%s", best_msg)
        self._drop_last_iterations(es)
        return True

    def _output_metric(self, it: int) -> str:
        """OutputMetric (gbdt.cpp:466-534): the metric lines every
        ``metric_freq`` iterations and the early-stopping bookkeeping;
        returns the best round's message when the stop condition is
        met."""
        cfg = self.config
        need_output = cfg.metric_freq > 0 and (it % cfg.metric_freq) == 0
        es_round = cfg.early_stopping_round
        ret = ""
        msg_lines: List[str] = []
        if need_output:
            for name, val, _ in self.get_eval_at(0):
                line = f"Iteration:{it}, training {name} : {val:g}"
                log.info("%s", line)
                if es_round > 0:
                    msg_lines.append(line)
        met_best: List[tuple] = []
        if need_output or es_round > 0:
            for i in range(len(self.valid_sets)):
                for j, (name, val, bigger) in enumerate(
                        self.get_eval_at(i + 1)):
                    line = (f"Iteration:{it}, valid_{i + 1} {name}"
                            f" : {val:g}")
                    if need_output:
                        log.info("%s", line)
                    if es_round > 0:
                        msg_lines.append(line)
                        cur = val if bigger else -val
                        if cur > self._best_score[i][j]:
                            self._best_score[i][j] = cur
                            self._best_iter[i][j] = it
                            met_best.append((i, j))
                        elif not ret and \
                                it - self._best_iter[i][j] >= es_round:
                            ret = self._best_msg[i][j]
        msg = "\n".join(msg_lines)
        for i, j in met_best:
            self._best_msg[i][j] = msg
        return ret
