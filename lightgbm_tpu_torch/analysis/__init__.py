"""Runtime analysis for the port: ``lockorder``, the lock-order detector
the port's long-lived locks are created through (stdlib only)."""
