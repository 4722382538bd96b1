"""Command-line application: train, predict, refit, convert_model.

The JAX package's ``application.py`` (reference Application,
src/application/application.cpp:29-281 and src/main.cpp). Parameters
come from ``key=value`` argv tokens plus an optional ``config=<file>`` of
``key = value`` lines (comments with '#'), the command line winning, as
Application::LoadParameters (application.cpp:64-108); data and model
paths in a config file resolve relative to that file. Tasks:

- train: load the data and valid sets (io/loader.py), build the
  objective and metrics, run the GBDT::Train driver
  (models/gbdt.py ``train``), save ``output_model``; ``input_model``
  continues training a model;
- refit: re-learn ``input_model``'s leaf values on ``data``;
- predict: load ``input_model``, parse the data file, write
  ``output_result`` (``f"{v:g}"`` per value, tab-separated rows);
- convert_model: the model as standalone if-else C++ code.

Everything runs on ``device``: None means ``cuda:0`` (raising without a
card), whatever the config's ``device_type`` says; tests pass
``device="cpu"``.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from .config import Config
from .io.loader import DatasetLoader
from .metrics import create_metrics, metric_names
from .models.boosting import create_boosting
from .models.gbdt import GBDT
from .objectives import create_objective
from .utils import log
from .utils.device import resolve_device


def parse_config_file(path: str) -> Dict[str, str]:
    """Config-file 'key = value' lines (application.cpp:76-99)."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out.setdefault(k.strip(), v.strip())
    return out


def load_parameters(argv: List[str]) -> Config:
    """argv 'k=v' tokens override config-file values
    (application.cpp:64-108: cmd wins over file)."""
    cmd: Dict[str, str] = {}
    for tok in argv:
        if "=" in tok:
            k, v = tok.split("=", 1)
            cmd[Config.key_alias_transform(k)] = v.strip()
        elif tok:
            log.warning("Unknown parameter %s", tok)
    params = dict(cmd)
    if "config" in cmd:
        for k, v in parse_config_file(cmd["config"]).items():
            params.setdefault(Config.key_alias_transform(k), v)
    cfg = Config()
    cfg.set(params)
    # -1 = fatal-only, 0 = warnings, 1 = info, 2+ = debug (log.h:22)
    log.set_level(max(-1, min(cfg.verbosity, 2)))
    return cfg


def _rel_to_config(cfg: Config, path: str) -> str:
    """Data paths in a config file resolve relative to that file."""
    if path and not os.path.isabs(path) and not os.path.exists(path) \
            and cfg.config:
        cand = os.path.join(os.path.dirname(os.path.abspath(cfg.config)),
                            path)
        if os.path.exists(cand):
            return cand
    return path


def write_result(path: str, out: np.ndarray) -> None:
    """A prediction result file: one ``f"{v:g}"`` a line, or a row of
    them joined by tabs (application.cpp:234-249)."""
    out = np.asarray(out)
    with open(path, "w") as fh:
        if out.ndim == 1:
            fh.writelines(f"{v:g}\n" for v in out)
        else:
            fh.writelines("\t".join(f"{v:g}" for v in row) + "\n"
                          for row in out)


class Application:
    """Application (application.cpp:29-63), on ``device`` (None:
    cuda:0)."""

    def __init__(self, argv: List[str], device=None):
        self.config = load_parameters(argv)
        self.device = resolve_device(device)
        if self.config.task in ("train", "refit") and not self.config.data:
            log.fatal("No training/prediction data, application quit")

    def run(self) -> None:
        task = self.config.task
        if task == "train":
            self.train()
        elif task == "predict":
            self.predict()
        elif task == "convert_model":
            self.convert_model()
        elif task == "refit":
            self.refit()
        else:
            log.fatal(f"Unknown task: {task}")

    def _load_model(self, what: str) -> GBDT:
        cfg = self.config
        path = _rel_to_config(cfg, cfg.input_model)
        if not path or not os.path.isfile(path):
            log.fatal(f"Model file {cfg.input_model!r} not found; set "
                      f"input_model for the {what} task")
        with open(path) as fh:
            text = fh.read()
        booster = (create_boosting(cfg.boosting_type(), self.device)
                   if what in ("train", "refit") else GBDT(self.device))
        return booster.load_model_from_string(text, source=path)

    # -- train (application.cpp:110-232 LoadData + Train) -------------------

    def train(self) -> None:
        cfg = self.config
        loader = DatasetLoader(cfg, self.device)
        train_data = loader.load_from_file(_rel_to_config(cfg, cfg.data))
        objective = create_objective(cfg.objective, cfg)
        if objective is not None:
            objective.init(train_data.metadata, train_data.num_data)
        names = metric_names(cfg)
        train_metrics = []
        if cfg.is_provide_training_metric:
            train_metrics = create_metrics(
                names, cfg, train_data.metadata, train_data.num_data)
        if cfg.input_model:
            booster = self._load_model("train")
            booster.init_from_loaded(cfg, train_data, objective,
                                     train_metrics)
        else:
            booster = create_boosting(cfg.boosting_type(), self.device)
            booster.init(cfg, train_data, objective, train_metrics)
        for vpath in cfg.valid:
            vdata = loader.load_from_file(_rel_to_config(cfg, vpath),
                                          reference=train_data)
            vmetrics = create_metrics(names, cfg, vdata.metadata,
                                      vdata.num_data)
            booster.add_valid_data(vdata, vmetrics, os.path.basename(vpath))
        booster.train(cfg.snapshot_freq, cfg.output_model,
                      resume_from=cfg.tpu_resume_from)

    def refit(self) -> None:
        """Task refit: re-learn input_model's leaf values on ``data``
        (application.cpp task=refit -> GBDT::RefitTree)."""
        cfg = self.config
        booster = self._load_model("refit")
        train_data = DatasetLoader(cfg, self.device).load_from_file(
            _rel_to_config(cfg, cfg.data))
        objective = create_objective(cfg.objective, cfg)
        if objective is not None:
            objective.init(train_data.metadata, train_data.num_data)
        booster.init_from_loaded(cfg, train_data, objective, [])
        booster.refit_existing()
        booster.save_model_to_file(cfg.output_model)
        log.info("Refit model saved to %s", cfg.output_model)

    # -- predict (application.cpp:234-249) ----------------------------------

    def predict(self) -> None:
        cfg = self.config
        booster = self._load_model("predict")
        X, _ = DatasetLoader(cfg, self.device).load_predict_matrix(
            _rel_to_config(cfg, cfg.data), booster.max_feature_idx + 1)
        n_iter = cfg.num_iteration_predict
        early = dict(pred_early_stop=cfg.pred_early_stop,
                     pred_early_stop_freq=cfg.pred_early_stop_freq,
                     pred_early_stop_margin=cfg.pred_early_stop_margin)
        if cfg.predict_leaf_index:
            out = booster.predict_leaf_index(X, n_iter)
        elif cfg.predict_contrib:
            out = booster.predict_contrib(X, n_iter)
        elif cfg.predict_raw_score:
            out = booster.predict_raw(X, n_iter, **early)
        else:
            out = booster.predict(X, n_iter, **early)
        out_path = cfg.output_result or "LightGBM_predict_result.txt"
        write_result(out_path, out)
        log.info("Finished prediction; results saved to %s", out_path)

    # -- convert_model (if-else codegen) -------------------------------------

    def convert_model(self) -> None:
        from .models.codegen import model_to_if_else
        cfg = self.config
        booster = self._load_model("convert_model")
        with open(cfg.convert_model, "w") as fh:
            fh.write(model_to_if_else(booster))
        log.info("Converted model saved to %s", cfg.convert_model)


def main(argv: List[str] = None, device=None) -> None:
    if argv is None:
        argv = sys.argv[1:]
    Application(argv, device).run()
