"""Port parity: lightgbm_tpu_torch.config against lightgbm_tpu.config.

One params dict must give the same Config field values in both packages
(the port keeps every parameter name, alias and clamp), and the same
``parameters:`` block for model text.
"""
import dataclasses

import pytest

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.lrb import TRAIN_PARAMS
from lightgbm_tpu_torch.config import Config as TorchConfig
from lightgbm_tpu_torch.utils.log import LightGBMError

pytestmark = pytest.mark.torch_port

# bench.py's HIGGS training dict, and one of clamped / aliased values
BENCH_PARAMS = {
    "objective": "binary", "metric": "auc", "num_leaves": 255,
    "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 20,
    "tpu_stop_check_interval": 10_000, "tpu_quantized_hist": True,
    "tree_learner": "serial", "tpu_ingest": -1, "tpu_run_report": "",
}
EDGE_PARAMS = {
    "num_trees": "7", "sub_feature": "0.5", "reg_lambda": 2,
    "tree": "data_parallel", "tpu_wave_size": -3, "tpu_count_proxy": 5,
    "tpu_fleet_shed_budget": 2.0, "tpu_reqlog_sample": -1,
    "tpu_metrics_interval_s": 0, "tpu_trace_buffer": 10,
    "tpu_fleet_coalesce_us": 5_000_000, "tpu_autotune": "fast",
    "tpu_compile_cache_cpu": 0, "histogram_pool_size": 16,
    "eval_at": "1,3", "metric": "auc;binary_logloss", "device": "gpu",
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("params", [TRAIN_PARAMS, BENCH_PARAMS,
                                    EDGE_PARAMS, {}],
                         ids=["lrb", "bench", "edges", "defaults"])
def test_config_fields_equal(params):
    jax_cfg = JaxConfig().set(dict(params))
    port_cfg = TorchConfig().set(dict(params))
    assert _fields(port_cfg) == _fields(jax_cfg)
    assert port_cfg.to_string() == jax_cfg.to_string()


def test_config_str2map_and_bad_values():
    s = "objective=binary num_leaves=15 max_bin=63"
    assert TorchConfig.str2map(s) == JaxConfig.str2map(s)
    with pytest.raises(LightGBMError):
        TorchConfig().set({"num_leaves": "many"})
    with pytest.raises(LightGBMError):
        TorchConfig().set({"device_type": "abacus"})
