"""The distributed learners and their runtime (the JAX package's
``parallel/``): ``learners`` (data, feature and voting on
``torch.distributed``), ``cluster`` (bootstrap, heartbeats, the no-hang
guarantees) and ``elastic`` (the worker and its launcher)."""
