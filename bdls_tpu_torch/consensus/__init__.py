"""The BDLS BFT consensus core on the port: the deterministic engine and
its batch-verify seam (the counterpart of ``bdls_tpu/consensus``).

Layout:
- ``wire_codec`` — the wire format (``wire.proto``), encoded by hand
- ``identity``  — secp256k1 identities, host-side signing, the envelope
- ``verifier``  — the batch-verification seam (host, card and provider)
- ``engine``    — the pure ``y = f(x, t)`` state machine
- ``ipc``       — deterministic in-process test harness (virtual clock)
- ``rounds``    — the round driver: N validators, one batch verifier
- ``errors``    — the full protocol-rejection taxonomy
- ``threshold`` — aggregate-BLS quorum certificates
"""

from bdls_tpu_torch.consensus.engine import (  # noqa: F401
    Config,
    Consensus,
    Stage,
    state_hash,
    DEFAULT_CONSENSUS_LATENCY,
    MAX_CONSENSUS_LATENCY,
    CONFIG_MINIMUM_PARTICIPANTS,
)
from bdls_tpu_torch.consensus.identity import (  # noqa: F401
    Signer,
    PROTOCOL_VERSION,
)
from bdls_tpu_torch.consensus.verifier import (  # noqa: F401
    BatchVerifier,
    CpuBatchVerifier,
    TorchBatchVerifier,
)
