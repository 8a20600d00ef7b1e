"""bdls_tpu_torch — the PyTorch/CUDA port of ``bdls_tpu`` for an NVIDIA H100.

This first slice carries the batched ECDSA verify path (P-256 and
secp256k1) behind the CSP plugin boundary: ``crypto.torch_provider.TorchCSP``
marshals requests into ``(16, B)`` limb arrays and launches one
hand-written CUDA kernel per curve (``csrc/verify.cu``), with a plain
PyTorch twin (``ops.verify_fold.verify_fold``) that runs wherever the
caller explicitly asks for the CPU.

The package imports ``torch`` and ``numpy`` only: never ``jax``, never
``bdls_tpu``, never ``cryptography``. Modules mirror ``bdls_tpu``'s names
so each has an obvious counterpart in the JAX reference.
"""
