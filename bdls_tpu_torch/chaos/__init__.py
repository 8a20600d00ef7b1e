"""Fault injection on the port (the counterpart of ``bdls_tpu/chaos``).

The chaos layer turns failure behavior into a regression surface, the
way :mod:`bdls_tpu_torch.utils.slo` turned performance into one:

- :mod:`bdls_tpu_torch.chaos.plan` — the seeded, JSON round-trippable
  :class:`FaultPlan` DSL scheduling faults on the virtual timeline;
- :mod:`bdls_tpu_torch.chaos.injectors` — the engage/revert actuators
  that bind each fault kind to its seam (VirtualNetwork loss/dup/
  reorder/partition/crash, sidecar kill/restart, key-cache churn, the
  ``chaos_stall_s`` slow-device seam below ``TorchCSP``'s dispatcher)
  plus the :class:`ChaosEngine` that drives them;
- :mod:`bdls_tpu_torch.chaos.runner` — the scenario runner composing
  loadgen traffic with a FaultPlan and judging the run through
  :func:`bdls_tpu_torch.utils.slo.evaluate_fleet`, verifying on the
  card unless the caller asks for the CPU;
- :mod:`bdls_tpu_torch.chaos.scenarios` — the canned catalog;
- :mod:`bdls_tpu_torch.chaos.loadgen` — the command line
  (``python -m bdls_tpu_torch.chaos.loadgen``).
"""

from bdls_tpu_torch.chaos.plan import KINDS, FaultEvent, FaultPlan  # noqa: F401
