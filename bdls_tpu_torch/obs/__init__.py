"""Subpackage of the bdls_tpu_torch port (see the package docstring): the
fleet observability plane, the counterpart of ``bdls_tpu/obs``.

- ``tsdb`` — the flight recorder, which verifyd's operations endpoint
  serves at ``/debug/tsdb``;
- ``stitch`` — cross-process trace stitching and the round's critical
  path;
- ``detect`` — incidents off the recorder's series (counter onset,
  EWMA z-score, SLO burn rate);
- ``collector`` — the fleet collector: scrape, stitch, archive, judge
  (``python -m bdls_tpu_torch.obs.collector``);
- ``trace_report`` — latency reports over traces, archives and
  recorders (``python -m bdls_tpu_torch.obs.trace_report``).
"""
