"""Inbound message filter chain (reference: ``orderer/common/msgprocessor/``).

``StandardChannelProcessor.process_normal_msg`` runs the same filter
pipeline as the reference's StandardChannel: empty-reject, size filter,
signature filter (the per-message ECDSA verify that SigFilter does via
policy evaluation — here routed through the CSP so it batches on TPU),
and writer-policy check. Config messages take ``process_config_msg``.

The port's copy of ``bdls_tpu/ordering/msgprocessor.py``, over the
port's codec. ``_check_signature`` verifies each broadcast's creator
signature with ``csp.verify``: on the card when the provider is
``TorchCSP`` (K1, or K2 once the client's key is pinned).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from bdls_tpu_torch.crypto.csp import CSP, PublicKey, VerifyRequest
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import tx_digest


class FilterError(Exception):
    pass


class ErrEmptyMessage(FilterError): pass
class ErrMessageTooLarge(FilterError): pass
class ErrBadSignature(FilterError): pass
class ErrPolicyViolation(FilterError): pass
class ErrWrongChannel(FilterError): pass
class ErrMaintenance(FilterError): pass


@dataclass
class ChannelPolicy:
    """Minimal writer/reader policy: sets of orgs whose members may
    write/read, or explicit identities. The reference's equivalents are
    the ``/Channel/Writers`` implicit-meta policy evaluated by SigFilter
    (broadcast) and ``/Channel/Readers`` evaluated per Deliver stream
    (``common/deliver/deliver.go:198-357``)."""

    writer_orgs: frozenset[str] = frozenset()
    writer_keys: frozenset[tuple[int, int]] = frozenset()
    reader_orgs: frozenset[str] = frozenset()

    def allows(self, org: str, key: PublicKey) -> bool:
        if (key.x, key.y) in self.writer_keys:
            return True
        return org in self.writer_orgs

    def allows_read(self, org: str, key: PublicKey) -> bool:
        """Writers may always read; readers policy extends the set."""
        return org in self.reader_orgs or self.allows(org, key)

    @property
    def reads_restricted(self) -> bool:
        """A readers policy is enforced only when one is configured —
        channels without one keep open deliver (pre-ACL compatibility)."""
        return bool(self.reader_orgs)


@dataclass
class StandardChannelProcessor:
    channel_id: str
    csp: CSP
    policy: ChannelPolicy
    absolute_max_bytes: int = 10 * 1024 * 1024
    maintenance: bool = False
    config_seq: int = 0

    def classify(self, env: pb.TxEnvelope) -> int:
        return env.header.type

    def process_normal_msg(self, env: pb.TxEnvelope) -> int:
        """Returns the config sequence the message was validated against."""
        self._common_checks(env)
        if self.maintenance:
            raise ErrMaintenance("channel in maintenance mode")
        return self.config_seq

    def process_config_msg(self, env: pb.TxEnvelope) -> tuple[pb.TxEnvelope, int]:
        self._common_checks(env)
        if env.header.type != pb.TxType.TX_CONFIG:
            raise FilterError("not a config message")
        return env, self.config_seq

    def _common_checks(self, env: pb.TxEnvelope) -> None:
        if not env.payload and env.header.type == pb.TxType.TX_NORMAL:
            raise ErrEmptyMessage("empty payload")
        raw_size = env.ByteSize()
        if raw_size > self.absolute_max_bytes:
            raise ErrMessageTooLarge(f"{raw_size} > {self.absolute_max_bytes}")
        if env.header.channel_id != self.channel_id:
            raise ErrWrongChannel(env.header.channel_id)
        self._check_signature(env)

    def _check_signature(self, env: pb.TxEnvelope) -> None:
        hdr = env.header
        try:
            key = self.csp.key_import(
                "P-256",
                int.from_bytes(hdr.creator_x, "big"),
                int.from_bytes(hdr.creator_y, "big"),
            )
        except Exception as exc:
            raise ErrBadSignature(f"bad creator key: {exc}")
        if not self.policy.allows(hdr.creator_org, key):
            raise ErrPolicyViolation(hdr.creator_org)
        req = VerifyRequest(
            key=key,
            digest=tx_digest(env),
            r=int.from_bytes(env.sig_r, "big"),
            s=int.from_bytes(env.sig_s, "big"),
        )
        if not self.csp.verify(req):
            raise ErrBadSignature("creator signature invalid")

    def batch_check_signatures(self, envs: Sequence[pb.TxEnvelope]) -> list[bool]:
        """Batched variant for the committer path: all creator signatures
        of a block in one CSP call (BASELINE.json config 3 site)."""
        reqs = []
        for env in envs:
            hdr = env.header
            try:
                key = self.csp.key_import(
                    "P-256",
                    int.from_bytes(hdr.creator_x, "big"),
                    int.from_bytes(hdr.creator_y, "big"),
                )
            except Exception:
                reqs.append(None)
                continue
            reqs.append(
                VerifyRequest(
                    key=key,
                    digest=tx_digest(env),
                    r=int.from_bytes(env.sig_r, "big"),
                    s=int.from_bytes(env.sig_s, "big"),
                )
            )
        live = [r for r in reqs if r is not None]
        oks = iter(self.csp.verify_batch(live))
        return [False if r is None else next(oks) for r in reqs]
