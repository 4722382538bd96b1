"""``train``: the training entry point (the JAX package's ``engine.py``,
reference python-package engine.py:19-238), without valid sets, custom
objectives, custom evals, callbacks or ``cv``, which are not ported."""
from __future__ import annotations

import copy
from typing import Dict

from .basic import Booster, Dataset

_NUM_BOOST_ROUND_ALIASES = [
    "num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
    "num_round", "num_rounds", "num_boost_round", "n_estimators"]


def train(params: Dict, train_set: Dataset, num_boost_round: int = 100,
          device=None) -> Booster:
    """Train ``num_boost_round`` iterations on ``device`` (None: cuda:0).
    A ``num_iterations`` alias in ``params`` overrides the round count,
    as in the reference. Training stops at the first iteration that
    could not split (``Booster.update`` returns True)."""
    params = copy.deepcopy(params) if params else {}
    for alias in _NUM_BOOST_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            break
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    train_set.params.update(params)
    booster = Booster(params=params, train_set=train_set, device=device)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
