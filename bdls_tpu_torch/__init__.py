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
BLS12-381 check of ``csrc/bls.cu``, plain twin ``ops.bls_kernel``).

The package imports ``torch`` and ``numpy`` only: never ``jax``, never
``bdls_tpu``, never ``cryptography``, never protobuf. Modules mirror
``bdls_tpu``'s names so each has an obvious counterpart in the JAX
reference.
"""
