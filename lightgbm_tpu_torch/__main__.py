"""CLI entry point: ``python -m lightgbm_tpu_torch config=train.conf
[k=v ...]``, on cuda:0 (reference: src/main.cpp)."""
from .application import main

if __name__ == "__main__":
    main()
