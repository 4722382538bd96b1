from .metric import (AUCMetric, BinaryErrorMetric, BinaryLoglossMetric,
                     Metric, create_metric, create_metrics,
                     default_metric_for_objective, metric_names)

__all__ = ["AUCMetric", "BinaryErrorMetric", "BinaryLoglossMetric", "Metric",
           "create_metric", "create_metrics", "default_metric_for_objective",
           "metric_names"]
