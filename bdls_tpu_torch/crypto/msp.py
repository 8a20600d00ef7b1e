"""Membership service provider: org-scoped identities and signature
verification routed through the CSP.

Reference parity: ``msp/`` — the bccspmsp that validates identities
against org roots and funnels every signature check through
``Identity.Verify -> bccsp.Verify`` (msp/identities.go:170-199), so
swapping the CSP provider accelerates every MSP verification with no call
site changing. X.509 chains are reduced to org-registered raw EC keys
(certificate-less MSP); expiration is tracked per identity like
``common/crypto/expiration.go``.

The port's copy of ``bdls_tpu/crypto/msp.py``.
"""

from __future__ import annotations

import hashlib
import struct
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from bdls_tpu_torch.crypto.csp import CSP, PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.framing import framed_digest


class MSPError(Exception):
    pass


class ErrUnknownOrg(MSPError): pass
class ErrIdentityNotRegistered(MSPError): pass
class ErrIdentityExpired(MSPError): pass
class ErrNoOrgRoot(MSPError): pass
class ErrBadCertSignature(MSPError): pass
class ErrIdentityRevoked(MSPError): pass


# trailing curve-tag byte on serialized identities; absent = P-256
# (every pre-existing blob), so old and new encodings interoperate
_CURVE_TAGS = {"secp256k1": 1, "ed25519": 2}
_TAG_CURVES = {v: k for k, v in _CURVE_TAGS.items()}


@dataclass(frozen=True)
class Identity:
    """A member identity: org + EC key (+ optional expiry). P-256 is
    the Fabric default; ed25519 identities verify on the same batched
    device path (ops/ed25519.py) through the identical CSP funnel."""

    org: str
    key: PublicKey
    role: str = "member"  # member | admin
    not_after_unix: float = 0.0  # 0 = no expiry

    def serialize(self) -> bytes:
        tag = _CURVE_TAGS.get(self.key.curve)
        return (
            struct.pack("<H", len(self.org))
            + self.org.encode()
            + self.key.x.to_bytes(32, "big")
            + self.key.y.to_bytes(32, "big")
            + (b"" if tag is None else bytes([tag]))
        )

    @classmethod
    def deserialize(cls, raw: bytes) -> "Identity":
        (n,) = struct.unpack_from("<H", raw, 0)
        org = raw[2 : 2 + n].decode()
        x = int.from_bytes(raw[2 + n : 34 + n], "big")
        y = int.from_bytes(raw[34 + n : 66 + n], "big")
        curve = "P-256"
        if len(raw) > 66 + n:
            curve = _TAG_CURVES.get(raw[66 + n], "P-256")
        return cls(org=org, key=PublicKey(curve, x, y))


@dataclass
class SignedData:
    """(data, identity, signature) triple — the policy-evaluation unit
    (reference: protoutil SignedData)."""

    data: bytes
    identity: Identity
    r: int
    s: int


@dataclass(frozen=True)
class MemberCert:
    """A signed membership credential: the org root attests
    (org, member key, role, not_after). The reduced form of an X.509
    member cert in a two-level chain (reference ``msp/cert.go`` +
    ``msp/identities.go:170-199``: root CA -> member cert)."""

    org: str
    key: PublicKey
    role: str
    not_after_unix: float
    sig_r: int = 0
    sig_s: int = 0

    def tbs_digest(self) -> bytes:
        """Digest the root signs ("to-be-signed"); length-framed."""
        return framed_digest(b"BDLS_TPU_MEMBER_CERT", (
            self.org.encode(),
            self.key.x.to_bytes(32, "big"),
            self.key.y.to_bytes(32, "big"),
            self.role.encode(),
            struct.pack("<d", self.not_after_unix),
        ))


def issue_cert(csp: CSP, root_handle, org: str, key: PublicKey,
               role: str = "member", not_after_unix: float = 0.0) -> MemberCert:
    """Org-root-side credential issuance (the cryptogen role)."""
    cert = MemberCert(org=org, key=key, role=role,
                      not_after_unix=not_after_unix)
    r, s = csp.sign(root_handle, cert.tbs_digest())
    return MemberCert(org=org, key=key, role=role,
                      not_after_unix=not_after_unix, sig_r=r, sig_s=s)


class LocalMSP:
    """One org's membership registry on a node.

    Two registration paths: direct (``register``, operator-loaded raw
    keys) and chained (``register_org_root`` + ``enroll``: a member cert
    signed by the org root — the reference's cert-chain validation,
    ``msp/cert.go``), plus revocation (``revoke``, the CRL check in
    ``msp/revocation_support.go``)."""

    def __init__(self, csp: CSP):
        self.csp = csp
        self._orgs: dict[str, dict[bytes, Identity]] = {}
        self._roots: dict[str, PublicKey] = {}
        self._revoked: set[tuple[str, bytes]] = set()

    def register(self, identity: Identity) -> None:
        self._orgs.setdefault(identity.org, {})[identity.key.ski()] = identity

    # ---- chain of trust --------------------------------------------------
    def register_org_root(self, org: str, root_key: PublicKey) -> None:
        """Anchor an org's trust root (the MSP's cacerts)."""
        self._roots[org] = root_key

    def enroll(self, cert: MemberCert) -> Identity:
        """Validate a member cert against its org root and register the
        identity. Raises on unknown root or a bad chain signature."""
        root = self._roots.get(cert.org)
        if root is None:
            raise ErrNoOrgRoot(cert.org)
        ok = self.csp.verify(VerifyRequest(
            key=root, digest=cert.tbs_digest(), r=cert.sig_r, s=cert.sig_s,
        ))
        if not ok:
            raise ErrBadCertSignature(f"{cert.org} member cert")
        ident = Identity(org=cert.org, key=cert.key, role=cert.role,
                         not_after_unix=cert.not_after_unix)
        self.register(ident)
        return ident

    def revoke(self, org: str, key: PublicKey) -> None:
        """Add an identity to the org's revocation list; it stops
        validating immediately (CRL semantics)."""
        self._revoked.add((org, key.ski()))

    def register_org(self, org: str, identities: Sequence[Identity]) -> None:
        for ident in identities:
            if ident.org != org:
                raise MSPError(f"identity org {ident.org} != {org}")
            self.register(ident)

    def orgs(self) -> list[str]:
        return sorted(self._orgs)

    def validate(self, identity: Identity, now: Optional[float] = None) -> None:
        """Membership + expiry + revocation validation (msp.Validate)."""
        org = self._orgs.get(identity.org)
        if org is None:
            raise ErrUnknownOrg(identity.org)
        ski = identity.key.ski()
        registered = org.get(ski)
        if registered is None:
            raise ErrIdentityNotRegistered(
                f"{identity.org}:{ski.hex()[:12]}"
            )
        if (identity.org, ski) in self._revoked:
            raise ErrIdentityRevoked(f"{identity.org}:{ski.hex()[:12]}")
        if registered.not_after_unix:
            if (now if now is not None else time.time()) > registered.not_after_unix:
                raise ErrIdentityExpired(identity.org)

    def expiring_soon(self, within_s: float, now: Optional[float] = None) -> list[Identity]:
        """Cert-expiration early warning (common/crypto/expiration.go)."""
        now = now if now is not None else time.time()
        out = []
        for org in self._orgs.values():
            for ident in org.values():
                if ident.not_after_unix and now + within_s > ident.not_after_unix:
                    out.append(ident)
        return out

    # ---- verification (the CSP funnel) ----------------------------------
    def verify_signed_data(
        self, items: Sequence[SignedData], now: Optional[float] = None
    ) -> list[bool]:
        """Validate identities and batch-verify signatures: the
        ``SignatureSetToValidIdentities`` path (common/policies/
        policy.go:363-387) with the per-signature loop collapsed into one
        CSP batch call."""
        reqs: list[Optional[VerifyRequest]] = []
        for it in items:
            try:
                self.validate(it.identity, now)
            except MSPError:
                reqs.append(None)
                continue
            reqs.append(
                VerifyRequest(
                    key=it.identity.key,
                    digest=hashlib.sha256(it.data).digest(),
                    r=it.r,
                    s=it.s,
                )
            )
        live = [r for r in reqs if r is not None]
        oks = iter(self.csp.verify_batch(live))
        return [False if r is None else next(oks) for r in reqs]
