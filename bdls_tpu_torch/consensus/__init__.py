"""Subpackage of the bdls_tpu_torch port (see the package docstring):
the consensus engine's batch-verify seam (``verifier``), the wire
identity and signing digest it needs (``identity``), and the
aggregate-BLS quorum certificates (``threshold``)."""
