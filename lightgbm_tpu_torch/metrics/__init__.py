from .metric import (AUCMetric, BinaryErrorMetric, BinaryLoglossMetric,
                     Metric, create_metric, create_metrics, metric_names)

__all__ = ["AUCMetric", "BinaryErrorMetric", "BinaryLoglossMetric", "Metric",
           "create_metric", "create_metrics", "metric_names"]
