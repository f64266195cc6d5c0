"""The benchmark of surreal_tpu_torch (see README.md)."""
