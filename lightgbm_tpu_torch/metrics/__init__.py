from .metric import (AUCMetric, BinaryLoglossMetric, Metric, create_metric,
                     create_metrics, metric_names)

__all__ = ["AUCMetric", "BinaryLoglossMetric", "Metric", "create_metric",
           "create_metrics", "metric_names"]
