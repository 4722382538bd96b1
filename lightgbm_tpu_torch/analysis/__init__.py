"""Analysis of the port's own invariants (stdlib only; the JAX package's
``analysis/``, pointed at ``lightgbm_tpu_torch/``):

- ``capture``         — functions recorded into CUDA graphs close only
  over their graph's key, the state's static tensors and static kinds,
  and sync with no host inside;
- ``lock_discipline`` — ``# guarded-by: <lock>`` annotated attributes
  are written only inside a matching ``with`` block;
- ``contracts``       — ``tpu_*`` knob declaration, validation, docs and
  VOLATILE_KNOBS classification, obs metric names and bounded label
  cardinality, atomic artifact writes in obs/ and utils/;
- ``lockorder``       — the dynamic companion: the lock-order detector
  the port's long-lived locks are created through.

Driver: ``python -m lightgbm_tpu_torch.analysis`` (baseline file
``analysis/baseline.json``, ``--json``, exit 0/1/2). Nothing heavy is
imported here: ``lockorder`` is imported by production modules.
"""
