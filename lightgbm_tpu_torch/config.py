"""Parameter/config system (the JAX package's ``config.py``, copied).

Counterpart of the reference config machinery (include/LightGBM/config.h:27,
src/io/config.cpp:153, src/io/config_auto.cpp:4). One dataclass holds every
documented parameter; aliases are resolved before parsing; cross-parameter
conflicts are checked like Config::CheckParamConflict (src/io/config.cpp:202).
The field list, its order and the parsing match the JAX package's, so one
params dict gives equal field values in both packages and ``to_string``
writes the same ``parameters:`` block into model text.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List

from .utils import log

# ---------------------------------------------------------------------------
# Alias table (reference: src/io/config_auto.cpp:4-156). alias -> canonical.
# ---------------------------------------------------------------------------
ALIAS_TABLE: Dict[str, str] = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective", "app": "objective", "application": "objective",
    "boosting_type": "boosting", "boost": "boosting",
    "train": "data", "train_data": "data", "train_data_file": "data",
    "data_filename": "data",
    "test": "valid", "valid_data": "valid", "valid_data_file": "valid",
    "test_data": "valid", "test_data_file": "valid", "valid_filenames": "valid",
    "num_iteration": "num_iterations", "n_iter": "num_iterations",
    "num_tree": "num_iterations", "num_trees": "num_iterations",
    "num_round": "num_iterations", "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations", "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "max_leaves": "num_leaves", "max_leaf": "num_leaves",
    "tree": "tree_learner", "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_thread": "num_threads", "nthread": "num_threads",
    "nthreads": "num_threads", "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed", "random_state": "seed",
    "min_data_per_leaf": "min_data_in_leaf", "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "max_tree_output": "max_delta_step", "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2", "lambda": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints", "monotone_constraint": "monotone_constraints",
    "feature_contrib": "feature_contri", "fc": "feature_contri",
    "fp": "feature_contri", "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename",
    "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "hist_pool_size": "histogram_pool_size",
    "data_seed": "data_random_seed",
    "model_output": "output_model", "model_out": "output_model",
    "save_period": "snapshot_freq",
    "model_input": "input_model", "model_in": "input_model",
    "predict_result": "output_result", "prediction_result": "output_result",
    "predict_name": "output_result", "prediction_name": "output_result",
    "pred_name": "output_result", "name_pred": "output_result",
    "init_score_filename": "initscore_filename",
    "init_score_file": "initscore_filename", "init_score": "initscore_filename",
    "input_init_score": "initscore_filename",
    "valid_data_init_scores": "valid_data_initscores",
    "valid_init_score_file": "valid_data_initscores",
    "valid_init_score": "valid_data_initscores",
    "is_pre_partition": "pre_partition",
    "is_enable_bundle": "enable_bundle", "bundle": "enable_bundle",
    "is_sparse": "is_enable_sparse", "enable_sparse": "is_enable_sparse",
    "sparse": "is_enable_sparse",
    "two_round_loading": "two_round", "use_two_round_loading": "two_round",
    "is_save_binary": "save_binary", "is_save_binary_file": "save_binary",
    "load_from_binary_file": "enable_load_from_binary_file",
    "binary_load": "enable_load_from_binary_file",
    "load_binary": "enable_load_from_binary_file",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column", "group_id": "group_column",
    "query_column": "group_column", "query": "group_column",
    "query_id": "group_column",
    "ignore_feature": "ignore_column", "blacklist": "ignore_column",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score", "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib", "contrib": "predict_contrib",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
    "metrics": "metric", "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at", "ndcg_at": "eval_at",
    "map_eval_at": "eval_at", "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port", "port": "local_listen_port",
    "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename", "mlist": "machine_list_filename",
    "workers": "machines", "nodes": "machines",
}


def _compile_cache_from_cpu_knob(v: Any) -> int:
    """Value remap of the pre-rename tpu_compile_cache_cpu: its 1 (CPU
    opt-in) is tpu_compile_cache=1; its 0 meant "CPU off, TPU still
    on" — which is the new knob's -1 auto, NOT its 0 (that would turn
    the cache off on TPU/GPU too)."""
    try:
        return 1 if int(float(v)) == 1 else -1
    except (TypeError, ValueError):
        return -1


# renamed knobs accepted with a deprecation warning. Unlike
# ALIAS_TABLE these remap the VALUE too, so they are resolved in
# Config.set() (on the normalized pre-alias key), not in
# key_alias_transform — an alias-table entry would silently pass the
# old value through with changed semantics.
DEPRECATED_ALIASES = {
    "tpu_compile_cache_cpu": ("tpu_compile_cache",
                              _compile_cache_from_cpu_knob),
}


@dataclass
class Config:
    """All parameters with reference defaults (include/LightGBM/config.h)."""

    # --- core ---
    config: str = ""
    task: str = "train"                    # train, predict, convert_model, refit
    objective: str = "regression"
    boosting: str = "gbdt"                 # gbdt, rf, dart, goss
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"           # serial, feature, data, voting
    num_threads: int = 0
    # parsed for parity with the JAX package; it routes nothing here (the
    # entry points take a device argument, utils/device.py)
    device_type: str = "cpu"               # cpu, gpu, tpu
    seed: int = 0
    # --- learning control ---
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    early_stopping_round: int = 0
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    verbosity: int = 1
    # --- IO / dataset ---
    max_bin: int = 255
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    histogram_pool_size: float = -1.0
    data_random_seed: int = 1
    output_model: str = "LightGBM_model.txt"
    snapshot_freq: int = -1
    input_model: str = ""
    output_result: str = "LightGBM_predict_result.txt"
    initscore_filename: str = ""
    valid_data_initscores: List[str] = field(default_factory=list)
    pre_partition: bool = False
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    is_enable_sparse: bool = True
    sparse_threshold: float = 0.8
    use_missing: bool = True
    zero_as_missing: bool = False
    two_round: bool = False
    save_binary: bool = False
    enable_load_from_binary_file: bool = True
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: str = ""
    # --- predict ---
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    num_iteration_predict: int = -1
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    # --- convert model ---
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"
    # --- objective ---
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    max_position: int = 20
    label_gain: List[float] = field(default_factory=list)
    # --- metric ---
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    # --- network ---
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""
    # --- device ---
    # gpu_* are kept for reference compatibility. The tpu_* knobs belong to
    # the JAX package; the port parses and keeps them so that one params
    # dict gives the same Config in both packages.
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    tpu_use_dp: bool = True
    tpu_hist_chunk: int = 0
    tpu_donate_buffers: bool = True
    tpu_wave_size: int = 0
    tpu_quantized_hist: bool = False
    tpu_count_proxy: int = -1
    tpu_quantized_psum: int = -1
    tpu_psum_wire: int = -1
    tpu_async_psum: int = -1
    tpu_ckpt_async: int = -1
    tpu_packed_bins: int = -1
    tpu_exact_tier: str = ""
    tpu_autotune: str = "on"
    tpu_tuning_cache: str = ""
    tpu_profile_dir: str = ""
    tpu_profile_iters: int = 0
    tpu_run_report: str = ""
    tpu_watchdog_factor: float = 8.0
    tpu_stop_check_interval: int = 8
    tpu_dispatch_sync_interval: int = 32
    tpu_ingest: int = -1
    tpu_ingest_chunk_rows: int = 0
    tpu_out_of_core: int = -1
    tpu_ooc_block_rows: int = 0
    tpu_goss_hash: int = -1
    tpu_step_cache: int = -1
    tpu_row_bucket: int = -1
    tpu_predict_cache: int = -1
    tpu_serve_bucket: int = -1
    tpu_compile_cache: int = -1
    tpu_trace: str = ""
    tpu_trace_buffer: int = 65536
    tpu_metrics_export: str = ""
    tpu_metrics_interval_s: float = 5.0
    tpu_metrics_port: int = 0
    tpu_reqlog: str = ""
    tpu_reqlog_sample: float = 1.0
    tpu_slo: str = ""
    tpu_fleet_port: int = 0
    tpu_fleet_coalesce_us: int = 2000
    tpu_fleet_max_batch: int = 4096
    tpu_fleet_queue: int = 1024
    tpu_fleet_slo_p99_ms: float = 0.0
    tpu_fleet_shed_budget: float = 0.25
    tpu_flight_buffer: int = 256
    tpu_flight_dir: str = ""
    tpu_cluster_obs: int = -1
    tpu_checkpoint_dir: str = ""
    tpu_checkpoint_freq: int = 0
    tpu_resume_from: str = ""
    tpu_snapshot_keep: int = 3
    tpu_faults: str = ""
    tpu_fault_seed: int = 0
    tpu_retry_attempts: int = 4
    tpu_lrb_pipeline: int = -1
    tpu_lrb_ring: int = -1
    tpu_sparse: int = -1
    tpu_num_machines: int = 0
    tpu_machine_rank: int = -1
    tpu_coordinator: str = ""
    tpu_collective_timeout_s: float = 60.0

    def __post_init__(self):
        self._raw_params: Dict[str, str] = {}

    # -- parsing ------------------------------------------------------------

    @staticmethod
    def key_alias_transform(key: str) -> str:
        """ParameterAlias::KeyAliasTransform (config_auto.cpp:4)."""
        k = key.strip().lower().replace("-", "_")
        return ALIAS_TABLE.get(k, k)

    @classmethod
    def str2map(cls, params: str) -> Dict[str, str]:
        """KV2Map over 'k1=v1 k2=v2' strings (src/io/config.cpp:9-36)."""
        out: Dict[str, str] = {}
        for token in params.replace("\n", " ").split():
            if "=" in token:
                k, v = token.split("=", 1)
                out[k] = v
            elif token:
                log.warning("Unknown parameter %s", token)
        return out

    def set(self, params: Dict[str, Any]) -> "Config":
        """Config::Set (src/io/config.cpp:153): alias-resolve, parse, check."""
        resolved: Dict[str, Any] = {}
        for k, v in params.items():
            nk = k.strip().lower().replace("-", "_")
            if nk in DEPRECATED_ALIASES:
                ck, remap = DEPRECATED_ALIASES[nk]
                nv = remap(v)
                log.warning("%s is deprecated; use %s (mapped %s=%s to "
                            "%s=%s)", nk, ck, nk, v, ck, nv)
                v = nv
            else:
                ck = self.key_alias_transform(k)
            if ck in resolved and str(resolved[ck]) != str(v):
                log.warning(
                    "%s is set with %s=%s, will be overridden by %s=%s",
                    ck, k, resolved[ck], k, v)
            resolved[ck] = v
        for k, v in resolved.items():
            self._set_one(k, v)
        self._raw_params.update({k: str(v) for k, v in resolved.items()})
        self.check_param_conflict()
        return self

    def _set_one(self, key: str, value: Any) -> None:
        if not hasattr(self, key):
            # Unknown keys warn (objective-specific passthrough keys allowed)
            log.warning("Unknown parameter: %s", key)
            return
        cur = getattr(self, key)
        try:
            if isinstance(cur, bool):
                setattr(self, key, _parse_bool(value))
            elif isinstance(cur, int):
                setattr(self, key, int(float(value)))
            elif isinstance(cur, float):
                setattr(self, key, float(value))
            elif isinstance(cur, list):
                setattr(self, key, _parse_list(key, value))
            else:
                setattr(self, key, str(value).strip())
        except (TypeError, ValueError) as e:
            log.fatal(f"Bad value for parameter {key}: {value!r} ({e})")

    # -- semantics ----------------------------------------------------------

    def check_param_conflict(self) -> None:
        """Config::CheckParamConflict (src/io/config.cpp:202), with the
        JAX package's clamps of its tpu_* knobs (same results, table
        driven)."""
        if self.convert_model_language and \
                "convert_model_language" in self._raw_params:
            log.warning("Parameter convert_model_language is accepted for "
                        "compatibility but not implemented yet; it has no "
                        "effect")
        if self.device_type.lower() not in ("cpu", "gpu", "cuda", "tpu"):
            log.fatal(f"Unknown device type {self.device_type!r}")
        # reference value aliases first (GetTreeLearnerType,
        # src/io/config.cpp:57-74), THEN the whitelist
        tl = self.tree_learner.lower()
        self.tree_learner = {"serial": "serial",
                             "feature": "feature",
                             "feature_parallel": "feature",
                             "data": "data", "data_parallel": "data",
                             "voting": "voting",
                             "voting_parallel": "voting"}.get(tl, tl)
        if self.tree_learner not in ("serial", "feature", "data",
                                     "voting"):
            log.warning("Unknown tree_learner %r (want one of "
                        "serial/feature/data/voting); using 'serial'",
                        self.tree_learner)
            self.tree_learner = "serial"
        for key in _TRISTATE_KEYS:
            if getattr(self, key) not in (-1, 0, 1):
                log.warning("%s=%d is not one of -1/0/1; using -1 (auto)",
                            key, getattr(self, key))
                setattr(self, key, -1)
        if self.tpu_count_proxy == 1 and not self.tpu_quantized_hist:
            log.fatal("tpu_count_proxy=1 requires tpu_quantized_hist="
                      "true (the count-proxy tier rides the int8 "
                      "quantized histogram kernels); set "
                      "tpu_quantized_hist=true or drop tpu_count_proxy")
        if self.tpu_packed_bins == 1:
            if self.tpu_quantized_hist and self.tpu_count_proxy == 0:
                log.fatal("tpu_packed_bins=1 with tpu_quantized_hist "
                          "needs the count-proxy tier: leave "
                          "tpu_count_proxy enabled (-1/1) or drop "
                          "tpu_packed_bins")
            if not self.tpu_quantized_hist and not self.tpu_use_dp:
                log.fatal("tpu_packed_bins=1 needs the count-proxy "
                          "int8 tier (tpu_quantized_hist=true) or the "
                          "hi/lo exact tier (tpu_use_dp=true); "
                          "single-bf16 (tpu_use_dp=false) packed bins "
                          "are not implemented")
            if self.max_bin > 16:
                log.fatal(f"tpu_packed_bins=1 needs max_bin <= 16 "
                          f"(two 4-bit bins per byte); max_bin="
                          f"{self.max_bin}")
        if self.tpu_exact_tier not in ("", "hilo5", "hilo4", "hilo3"):
            log.warning("tpu_exact_tier=%r is not one of ''/hilo5/"
                        "hilo4/hilo3; using '' (auto)",
                        self.tpu_exact_tier)
            self.tpu_exact_tier = ""
        if self.tpu_autotune not in ("on", "off", "exhaustive"):
            log.warning("tpu_autotune=%r is not one of on/off/exhaustive;"
                        " using 'on'", self.tpu_autotune)
            self.tpu_autotune = "on"
        for key, (lo, hi, fallback) in _RANGES.items():
            v = getattr(self, key)
            if (lo is not None and v < lo) or (hi is not None and v > hi):
                new = (fallback if fallback is not None
                       else min(max(v, lo), hi))
                log.warning("%s=%s is outside its range; using %s",
                            key, v, new)
                setattr(self, key, type(v)(new))
        if self.tpu_checkpoint_freq > 0 and not self.tpu_checkpoint_dir:
            log.warning("tpu_checkpoint_freq=%d but tpu_checkpoint_dir "
                        "is empty; no checkpoints will be written",
                        self.tpu_checkpoint_freq)
        if (self.tpu_num_machines > 1
                and self.tpu_machine_rank >= self.tpu_num_machines):
            log.fatal(f"tpu_machine_rank={self.tpu_machine_rank} is "
                      f"outside [0, tpu_num_machines="
                      f"{self.tpu_num_machines}) — every process needs "
                      f"a distinct rank below the world size")
        if self.tpu_collective_timeout_s <= 0:
            log.warning("tpu_collective_timeout_s=%g is not positive; "
                        "using 60.0", self.tpu_collective_timeout_s)
            self.tpu_collective_timeout_s = 60.0
        if self.tpu_metrics_interval_s <= 0:
            log.warning("tpu_metrics_interval_s=%g is not positive; "
                        "using 5.0", self.tpu_metrics_interval_s)
            self.tpu_metrics_interval_s = 5.0
        if not 0.0 < self.sparse_threshold <= 1.0:
            log.warning("sparse_threshold=%g is outside (0, 1]; using "
                        "0.8", self.sparse_threshold)
            self.sparse_threshold = 0.8
        if self.num_machines > 1 and self.tree_learner == "serial":
            log.warning("num_machines>1 with serial tree learner; only one "
                        "machine will train")
        if self.tree_learner in ("data", "voting") and \
                self.histogram_pool_size >= 0:
            log.warning(
                "Histogram LRU queue was enabled (histogram_pool_size=%g); "
                "will disable this for distributed learning",
                self.histogram_pool_size)
            self.histogram_pool_size = -1.0
        if self.boosting == "rf" and not (
                self.bagging_freq > 0 and 0.0 < self.bagging_fraction < 1.0):
            log.fatal("Random forest needs bagging_freq > 0 and "
                      "bagging_fraction in (0, 1)")
        if self.objective in ("lambdarank", "rank_xendcg") and \
                self.num_class != 1:
            log.fatal("Ranking objectives don't support multiclass")

    def boosting_type(self) -> str:
        """GetBoostingType normalization (src/io/config.cpp:45)."""
        b = self.boosting
        for name, aliases in (("gbdt", ("gbdt", "gbrt")), ("dart", ("dart",)),
                              ("goss", ("goss",)),
                              ("rf", ("rf", "random_forest"))):
            if b in aliases:
                return name
        log.fatal(f"Unknown boosting type {b}")

    def to_string(self) -> str:
        """Config::ToString — saved into the model file `parameters:` block."""
        lines = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list):
                v = ",".join(str(x) for x in v)
            elif isinstance(v, bool):
                v = "1" if v else "0"
            lines.append(f"[{f.name}: {v}]")
        return "\n".join(lines)


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "+", "yes", "on"):
        return True
    if s in ("false", "0", "-", "no", "off"):
        return False
    raise ValueError(f"not a bool: {v!r}")


_INT_LIST_KEYS = {"monotone_constraints", "eval_at"}
_STR_LIST_KEYS = {"valid", "metric", "valid_data_initscores"}


def _parse_list(key: str, v: Any) -> list:
    if isinstance(v, (list, tuple)):
        items = list(v)
    else:
        items = [x for x in str(v).replace(";", ",").split(",") if x != ""]
    if key in _INT_LIST_KEYS:
        return [int(float(x)) for x in items]
    if key in _STR_LIST_KEYS:
        return [str(x).strip() for x in items]
    return [float(x) for x in items]


# knobs that take -1 (auto), 0 (off) or 1 (on); anything else becomes -1
_TRISTATE_KEYS = (
    "tpu_count_proxy", "tpu_packed_bins", "tpu_quantized_psum",
    "tpu_psum_wire", "tpu_async_psum", "tpu_ckpt_async", "tpu_ingest",
    "tpu_out_of_core", "tpu_goss_hash", "tpu_step_cache",
    "tpu_predict_cache", "tpu_compile_cache", "tpu_lrb_pipeline",
    "tpu_lrb_ring", "tpu_sparse", "tpu_cluster_obs")

# key -> (low, high, replacement): a value outside [low, high] becomes the
# replacement, or is clamped into the range where that is None
_RANGES = {
    "tpu_hist_chunk": (0, None, 0),
    "tpu_wave_size": (0, None, 0),
    "tpu_stop_check_interval": (1, None, 1),
    "tpu_dispatch_sync_interval": (0, None, 0),
    "tpu_ingest_chunk_rows": (0, None, 0),
    "tpu_ooc_block_rows": (0, None, 0),
    "tpu_watchdog_factor": (0.0, None, 0.0),
    "tpu_profile_iters": (0, None, 0),
    "tpu_row_bucket": (-1, None, -1),
    "tpu_serve_bucket": (-1, None, -1),
    "tpu_trace_buffer": (1024, None, 1024),
    "tpu_checkpoint_freq": (0, None, 0),
    "tpu_snapshot_keep": (1, None, 1),
    "tpu_retry_attempts": (1, None, 1),
    "tpu_num_machines": (0, None, 0),
    "tpu_machine_rank": (-1, None, -1),
    "tpu_metrics_port": (0, 65535, 0),
    "tpu_reqlog_sample": (0.0, 1.0, None),
    "tpu_fleet_port": (0, 65535, 0),
    "tpu_fleet_coalesce_us": (0, 1_000_000, None),
    "tpu_fleet_max_batch": (1, None, 1),
    "tpu_fleet_queue": (1, None, 1),
    "tpu_fleet_slo_p99_ms": (0.0, None, 0.0),
    "tpu_fleet_shed_budget": (0.0, 1.0, None),
    "tpu_flight_buffer": (0, None, 0),
}
