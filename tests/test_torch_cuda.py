"""The CUDA kernel and TorchCSP on the card (``-m cuda``).

Run on a machine with an NVIDIA GPU, nvcc and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which pins the JAX
package to its CPU backend.) The card is detected inside a fixture, so
every pytest worker collects the same tests; without a card each test
skips with the reason. The kernel is held lane for lane against the
plain PyTorch version on the same card and against the port's integer
ECDSA: verdicts are booleans, so the comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import ecdsa
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.ops.verify_fold import verify_fold

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda")


def _limbs(lanes, dev):
    return [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
            for c in vectors.columns(lanes)]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_kernel_matches_plain_and_integer_ecdsa(card, curve):
    rng = np.random.default_rng(77)
    lanes = vectors.mixed_lanes(curve, rng)
    lanes += vectors.signed_lanes(curve, 37, rng)     # ragged last block
    args = _limbs(lanes, card)
    before = ecdsa.LAUNCHES[curve]
    got = ecdsa.verify_fold_cuda(CURVES[curve], *args).cpu().numpy()
    assert ecdsa.LAUNCHES[curve] == before + 1
    plain = verify_fold(CURVES[curve], *args).cpu().numpy()
    assert got.tolist() == plain.tolist()
    assert got.tolist() == vectors.expected(curve, lanes)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    good = [torch.zeros((16, 8), dtype=torch.int32, device=card)] * 5
    with pytest.raises(ValueError):
        ecdsa.verify_fold_cuda(CURVES["P-256"], *good[:4],
                               good[4].to(torch.int64))
    with pytest.raises(ValueError):
        ecdsa.verify_fold_cuda(CURVES["P-256"], *good[:4], good[4].cpu())


def test_torch_csp_on_the_card(card):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    rng = np.random.default_rng(78)
    reqs, want = [], []
    for curve in sorted(CURVES):
        lanes = vectors.mixed_lanes(curve, rng)
        for (qx, qy, r, s, d, label), ok in zip(
                lanes, vectors.expected(curve, lanes)):
            reqs.append(VerifyRequest(PublicKey(curve, qx, qy), d, r, s))
            # the provider adds the low-S policy for P-256
            want.append(ok and (curve != "P-256"
                                or s <= CURVES[curve].fn.modulus // 2))
    csp = TorchCSP(key_cache_size=0, use_cpu_fallback=False)
    before = dict(ecdsa.LAUNCHES)
    try:
        assert csp.kernel == "cuda"
        assert csp.verify_batch(reqs) == want
        futs = [csp.submit(r) for r in reqs]
        csp.flush()
        assert [f.result(60) for f in futs] == want
    finally:
        csp.close()
    assert csp.stats["fallbacks"] == 0
    for curve in CURVES:
        assert ecdsa.LAUNCHES[curve] > before[curve]


def test_failed_launch_on_the_card_fails_futures(card, monkeypatch):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    with pytest.raises(ValueError, match="device='cpu' only"):
        TorchCSP(use_cpu_fallback=True)

    def broken(curve, arrs, *, device=None):
        raise RuntimeError("launch refused")

    lanes = vectors.mixed_lanes("P-256", np.random.default_rng(79))
    reqs = [VerifyRequest(PublicKey("P-256", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    csp = TorchCSP(key_cache_size=0)
    monkeypatch.setattr(ecdsa, "launch_verify", broken)
    try:
        with pytest.raises(RuntimeError, match="launch refused"):
            csp.verify_batch(reqs)
        with pytest.raises(RuntimeError, match="launch refused"):
            csp.warmup([("P-256", 8)])
    finally:
        csp.close()
    assert csp.stats["fallbacks"] == 0
