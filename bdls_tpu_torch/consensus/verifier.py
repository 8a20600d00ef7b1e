"""The batch-verification seam between the consensus engine and crypto.

The port's copy of ``bdls_tpu/consensus/verifier.py``: the engine hands
one <lock>/<select>/<decide> proof list to ``verify_envelopes`` and gets
one verdict an envelope.

- :func:`identity_keys` and :class:`CspBatchVerifier` are the
  reference's (``verifier.py:31-103``): the verifier routes the batch
  through a CSP provider (typically
  :class:`~bdls_tpu_torch.crypto.torch_provider.TorchCSP`) and warms the
  provider's pinned-key cache with the channel's consenters, so their
  votes run the pinned-key kernel from the first round on;
- :class:`TorchBatchVerifier` is ``TpuBatchVerifier``'s counterpart
  (``:106-195``): no provider, the generic kernel straight through
  :func:`bdls_tpu_torch.ops.ecdsa.verify_limbs`. Digests come from
  hashlib, which is the reference's own fallback for its native runtime.

``pin_consenters`` hands the committee's 2t+1 quorum to a provider with
a latency tier (``TorchCSP.set_quorum_hint``), which arms its
speculative flush.
"""

from __future__ import annotations

from typing import Sequence

from bdls_tpu_torch.consensus.identity import envelope_digest
from bdls_tpu_torch.crypto import marshal
from bdls_tpu_torch.crypto.csp import PublicKey
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.device import DeviceLike


def identity_keys(identities) -> list[PublicKey]:
    """Consensus identities (64-byte big-endian X‖Y of the secp256k1
    public key) -> the provider's PublicKeys. Malformed identities are
    skipped: pinning is an optimization hint, never a validity
    judgment."""
    keys = []
    for ident in identities:
        if len(ident) != 64:
            continue
        keys.append(PublicKey(
            curve="secp256k1",
            x=int.from_bytes(ident[:32], "big"),
            y=int.from_bytes(ident[32:], "big"),
        ))
    return keys


def _wire_lanes(envs) -> list:
    """The one shared wire screen (``marshal.from_wire_fields``):
    oversized attacker-controlled fields become invalid lanes (None)."""
    return [
        marshal.from_wire_fields(
            "secp256k1", e.pub_x, e.pub_y, e.sig_r, e.sig_s,
            envelope_digest(e.version, e.pub_x, e.pub_y, e.payload))
        for e in envs
    ]


class CspBatchVerifier:
    """Routes the engine's vote batches through a CSP provider, so one
    proof list becomes one instrumented ``verify_batch`` call.

    ``consenters`` (64-byte identities from the channel config) are
    key-identity hints: they pre-warm the provider's pinned-key table
    cache. :meth:`pin_consenters` re-warms after a membership change."""

    def __init__(self, csp, consenters=()):
        self._csp = csp
        if consenters:
            self.pin_consenters(consenters)

    def pin_consenters(self, identities) -> None:
        """Hint the provider's pinned-key cache with the (new) consenter
        set, and hand a provider that has a latency tier the committee's
        2t+1 quorum size; a no-op for providers with neither (SwCSP)."""
        identities = list(identities)
        hint = getattr(self._csp, "set_quorum_hint", None)
        if hint is not None and identities:
            n = len(identities)
            hint(2 * ((n - 1) // 3) + 1)
        warm = getattr(self._csp, "warm_keys", None)
        if warm is None:
            return
        keys = identity_keys(identities)
        if keys:
            warm(keys, wait=False)

    def verify_envelopes(self, envs: Sequence) -> list[bool]:
        if not envs:
            return []
        reqs = _wire_lanes(envs)
        live = [r for r in reqs if r is not None]
        oks = iter(self._csp.verify_batch(live)) if live else iter(())
        return [bool(next(oks)) if r is not None else False for r in reqs]


class TorchBatchVerifier:
    """Batched secp256k1 verification on the generic kernel, without a
    provider. Each call pads to the smallest bucket that holds it (calls
    above the largest split), so the kernel sees the provider's shapes.
    ``device`` defaults to ``cuda``; ``"cpu"`` runs the plain version."""

    def __init__(self, buckets: Sequence[int] = (8, 32, 128, 512, 2048, 8192),
                 device: DeviceLike = None):
        self.buckets = sorted(buckets)
        self.device = device

    def verify_envelopes(self, envs: Sequence) -> list[bool]:
        from bdls_tpu_torch.ops.curves import SECP256K1
        from bdls_tpu_torch.ops.ecdsa import verify_limbs

        if not envs:
            return []
        n = len(envs)
        size = next((b for b in self.buckets if b >= n), None)
        if size is None:
            size = self.buckets[-1]
            out: list[bool] = []
            for i in range(0, n, size):
                out.extend(self.verify_envelopes(envs[i:i + size]))
            return out
        pad = size - n
        with tracing.GLOBAL.span(
            "tpu.marshal", attrs={"n": n, "bucket": size, "pad": pad}
        ):
            # invalid lanes pack harmless filler and are forced False
            lanes = _wire_lanes(envs)
            ok_lane = [lane is not None for lane in lanes]
            arrs = marshal.pack_wire_requests(lanes, size)
        with tracing.GLOBAL.span(
            "verifier.kernel", attrs={"n": n, "bucket": size, "pad": pad}
        ):
            ok = verify_limbs(SECP256K1, arrs, device=self.device)
        return [bool(v) and lane for v, lane in zip(ok[:n], ok_lane)]
