"""GBDT, serving half: model text in and out, prediction.

The JAX package's ``models/gbdt.py`` (gbdt.cpp, gbdt_model_text.cpp,
gbdt_prediction.cpp of the reference) for a loaded model: parse the v2
model text, write it back, and predict raw scores, converted outputs and
leaf indices. Prediction goes through the stacked forest kernel
(ops/stacked_predict.py) for every ensemble the stacker can host; the
others, and ``pred_early_stop``, take the float64 host walk.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from .tree import Tree
from ..objectives import ObjectiveFunction, parse_objective_from_model_string
from ..utils import log
from ..utils.device import resolve_device

K_MODEL_VERSION = "v2"     # gbdt.h kModelVersion


class GBDT:
    """A loaded boosting model. ``device`` is where prediction runs:
    None means ``cuda:0`` (raising at predict time when there is no
    card); ``"cpu"`` runs the plain PyTorch path."""

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
        imp = self._split_counts(num_used // k * k or len(self.models))
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
        self.models = []
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
