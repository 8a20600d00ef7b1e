"""Subpackage of the bdls_tpu_torch port (see the package docstring)."""
