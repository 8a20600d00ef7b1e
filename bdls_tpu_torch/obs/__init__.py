"""Subpackage of the bdls_tpu_torch port (see the package docstring):
the flight recorder (``tsdb``), the counterpart of ``bdls_tpu/obs/tsdb.py``
that verifyd's operations endpoint serves at ``/debug/tsdb``."""
