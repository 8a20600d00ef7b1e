"""bdls_tpu_torch — the PyTorch/CUDA port of ``bdls_tpu`` for an NVIDIA H100.

The port carries the batched ECDSA verify path (P-256 and secp256k1)
behind the CSP plugin boundary: ``crypto.torch_provider.TorchCSP``
marshals requests into ``(16, B)`` limb arrays and launches hand-written
CUDA kernels, one per curve and program: the generic verify
(``csrc/verify.cu``) and, for keys pinned in the provider's
``crypto.key_cache.KeyTableCache``, the zero-doubling pinned-key verify
with the GLV split on the card (``csrc/pinned.cu``). Each has a plain
PyTorch twin (``ops.verify_fold.verify_fold``,
``ops.verify_fold.verify_fold_pinned``) that runs wherever the caller
explicitly asks for the CPU. ``consensus.verifier`` is the consensus
engine's batch-verify seam over the provider. The provider also carries
the block lane (``verify_block``), Ed25519 and the aggregate-BLS quorum
certificates of ``consensus.threshold`` (``verify_certificates``: the
BLS12-381 check of ``csrc/bls.cu``, plain twin ``ops.bls_kernel``), and
the reference's kernel generations behind ``TorchCSP(kernel_field=...)``:
the gen-1 ``mont16`` verify (``csrc/mont16.cu``, plain twin
``ops.ecdsa.verify_kernel`` over ``ops.mont`` and ``ops.jacobian``) and
the tensor-core limb product of the ``mxu`` builds (``csrc/mxu.cuh``,
plain twin ``ops.mxu``). ``consensus.engine`` is the BDLS engine itself,
over the hand-written wire codec ``consensus.wire_codec``; the round
driver ``consensus.rounds`` runs N validators through one batch verifier
on the card. The verification daemon (``sidecar.verifyd``) serves the
operations endpoint (``utils.operations``: metrics, health, the SLO
verdict of ``utils.slo``, the flight recorder ``obs.tsdb``).

The package imports ``torch`` and ``numpy`` only: never ``jax``, never
``bdls_tpu``, never ``cryptography``, never protobuf. Modules mirror
``bdls_tpu``'s names so each has an obvious counterpart in the JAX
reference.
"""

__version__ = "0.1.0"
