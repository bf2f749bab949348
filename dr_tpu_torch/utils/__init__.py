"""See the package docstring of ``dr_tpu_torch``."""
