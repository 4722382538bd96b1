"""GBDT: training, model text in and out, prediction.

The JAX package's ``models/gbdt.py`` (gbdt.cpp, gbdt_model_text.cpp,
gbdt_prediction.cpp of the reference). Training is the serial gbdt path
of the exact f32 tier: ``init`` sets up the wave grower on the train
set's device, and ``train_one_iter`` runs one boosting iteration there
(the step body of the JAX package's ``ops/step_cache.py:324-406``:
gradients, the tree, the shrinkage fold, the score update through the
leaf-gather kernel, the boost-from-average bias on the stored record).
Bagging and feature sampling draw from the same numpy PCG64 streams as
the JAX package, so both pick the same rows and features. Prediction
goes through the stacked forest kernel (ops/stacked_predict.py) for
every ensemble the stacker can host; the others, and
``pred_early_stop``, take the float64 host walk.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from .tree import Tree, tree_from_record
from ..objectives import ObjectiveFunction, parse_objective_from_model_string
from ..ops.predict import add_leaf_outputs
from ..ops.split import SplitParams
from ..ops.wave_grower import WaveGrower, WaveGrowerConfig
from ..utils import log
from ..utils.device import resolve_device

K_MODEL_VERSION = "v2"     # gbdt.h kModelVersion

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
        self._stacked_lock = threading.Lock()
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
                sm = StackedModel(self.models, max(nf, 1),
                                  self.num_tree_per_iteration,
                                  resolve_device(self.device))
                self._stacked = sm if sm.ok else None
                self._stacked_built = True
            return self._stacked

    # -- training (gbdt.cpp:47-412) -----------------------------------------

    def init(self, config: Config, train_data, objective: ObjectiveFunction,
             training_metrics: Sequence = ()) -> "GBDT":
        """Set up training on ``train_data`` (io/dataset.py
        BinnedDataset) on its device (gbdt.cpp:47-117)."""
        if config.boosting_type() != "gbdt":
            raise NotImplementedError(
                f"boosting={config.boosting_type()} is not ported yet")
        if config.tpu_quantized_hist:
            raise NotImplementedError("the quantized histogram tier is not "
                                      "ported yet")
        if objective is None:
            raise NotImplementedError("custom objectives are not ported yet")
        self.config = config
        self.train_data = train_data
        self.device = train_data.device
        self.objective = objective
        self.training_metrics = list(training_metrics)
        self.iter_ = 0
        self.num_class = config.num_class
        self.shrinkage_rate = config.learning_rate
        self.num_tree_per_iteration = objective.num_model_per_iteration
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = train_data.feature_infos()
        self.models, self.records, self._tree_shrinkage = [], [], []
        self._invalidate_stacked()
        self._n = n = train_data.num_data
        self._setup_grower()
        dev = self.device
        self._scores = torch.zeros((1, n), dtype=torch.float32, device=dev)
        self._full_mask = torch.ones(n, dtype=torch.float32, device=dev)
        self._bagging_rng = np.random.default_rng(config.bagging_seed)
        self._feature_rng = np.random.default_rng(
            config.feature_fraction_seed)
        return self

    def _setup_grower(self) -> None:
        """The grower of the serial learner (gbdt.py:300-480): split
        hyperparameters, the wave width W, the histogram width B."""
        cfg = self.config
        if cfg.tree_learner != "serial":
            log.warning("tree_learner=%s needs several devices; the port "
                        "trains with the serial learner", cfg.tree_learner)
        hp = SplitParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            max_delta_step=cfg.max_delta_step,
            min_data_in_leaf=float(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split)
        if cfg.tpu_use_dp:
            # the exact tier's channel layout only sets the wave cap; off
            # the TPU the JAX package takes the widest layout its
            # objective allows: hilo4 (hilo3 needs constant hessians,
            # which binary logloss does not have)
            variant = cfg.tpu_exact_tier or (
                "hilo5" if cfg.tpu_autotune == "off" else "hilo4")
            if variant == "hilo3":
                log.warning("tpu_exact_tier=hilo3 needs a constant-unit-"
                            "hessian objective; using hilo4")
                variant = "hilo4"
            w_cap = EXACT_TIER_CAPS[variant]
        else:
            w_cap = 32
        W = cfg.tpu_wave_size or w_cap
        if W > w_cap:
            log.warning("tpu_wave_size=%d exceeds the lane cap of this tier; "
                        "clamping to %d", W, w_cap)
        W = max(1, min(W, w_cap, max(cfg.num_leaves, 2) - 1))
        td = self.train_data
        # the histogram width: the JAX package's default bucket policy
        # (step_cache.bucket_bins), a power of two >= 16, unless
        # tpu_row_bucket=0 asks for exact shapes. Bins past a feature's
        # num_bin stay empty; keeping the JAX width keeps the split
        # finder's prefix products the same shape as the reference's.
        B = max(td.max_bin_global, 2)
        if cfg.tpu_row_bucket != 0:
            B = 1 << (max(B, 16) - 1).bit_length()
        self._grower_cfg = WaveGrowerConfig(
            num_leaves=max(cfg.num_leaves, 2), num_bins=B, wave_size=W,
            max_depth=cfg.max_depth, hp=hp)
        self._grower = WaveGrower(self._grower_cfg, td.feature_meta(),
                                  self.device)

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
        empty."""
        if self.models or not self.config.boost_from_average:
            return 0.0
        init = self.objective.boost_from_score(class_id)
        if init != 0.0:
            self._scores[class_id] += float(np.float32(init))
            log.info("Start training from score %g", init)
        return init

    def train_one_iter(self) -> bool:
        """One boosting iteration (gbdt.cpp:333-412); True when training
        should stop. The stored record is model-equivalent: shrinkage and
        the first iteration's boost-from-average bias are folded into its
        outputs, as the reference's Shrinkage + AddBias do.

        A tree that cannot split stops training at once (gbdt.cpp:393-409)
        and is dropped, unless it is the first, which stays as the
        constant model. The JAX package defers this check to spare a
        device sync; here ``grow`` has read the leaf count back already."""
        init_score = self.boost_from_average(0)
        first_iteration = not self.models
        dev = self.device
        mask_np = self._bagging_mask(self.iter_)
        mask = (self._full_mask if mask_np is None
                else torch.from_numpy(mask_np).to(dev))
        fmask = torch.from_numpy(self._feature_mask()).to(dev)
        g, h = self.objective.get_gradients(self._scores[0])
        rec, leaf_ids = self._grower.grow(self.train_data.bins_t, g, h, mask,
                                          fmask)
        splitless = rec.num_leaves <= 1
        if splitless:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if not first_iteration:
                return True
        shrink = float(np.float32(self.shrinkage_rate))
        leaf_output = rec.leaf_output * shrink
        internal_value = rec.internal_value * shrink
        # out-of-bag rows included: the partition covers every row
        add_leaf_outputs(self._scores[0], leaf_ids, leaf_output)
        # AddBias on the stored record only (tree.h:151): the init score
        # reached the scores through boost_from_average already
        bias = float(np.float32(init_score if first_iteration else 0.0))
        self.records.append(rec._replace(
            leaf_output=leaf_output + bias,
            internal_value=internal_value + bias))
        self.models.append(None)
        self._tree_shrinkage.append(
            1.0 if first_iteration and abs(init_score) > 1e-15
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

    def get_eval_at(self, data_idx: int) -> List[tuple]:
        """[(metric name, value, bigger is better)] on the train set
        (data_idx 0); valid sets are not ported yet."""
        if data_idx != 0:
            raise NotImplementedError("valid sets are not ported yet")
        return [(m.name, m.eval(self._scores, self.objective),
                 m.bigger_is_better) for m in self.training_metrics]

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

    # -- model text (gbdt_model_text.cpp:240-450) ---------------------------

    def _split_counts(self, n_models: int) -> np.ndarray:
        """Times each feature is split on in the first ``n_models``
        trees (the model file's ``feature importances:`` block)."""
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        for t in self.models[:n_models]:
            for i in range(t.num_leaves - 1):
                imp[t.split_feature[i]] += 1.0
        return imp

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
        imp = self._split_counts(num_used // k * k or eff)
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
