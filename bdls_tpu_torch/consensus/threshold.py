"""Threshold-aggregate quorum certificates over BLS12-381 — the
BASELINE config-5 consensus integration.

The BDLS engine's ECDSA design re-verifies 2t+1 individual proof
signatures inside every <lock>/<select>/<decide> message (reference
``vendor/.../bdls/consensus.go:549-584,852-885`` — the O(n²) hot loop
the TPU batch verifier absorbs). The threshold-aggregate alternative
replaces a round's 2t+1 vote signatures with ONE aggregate BLS
signature: every validator signs the same round digest, signatures add
in G2, and the certificate verifies with a single pairing equation
against the SUM of the signers' public keys —

    e(g1, aggregate_sig) == e(sum(pk_i), H(digest))

so certificate size and verification cost stop growing with n entirely.

The port's copy of ``bdls_tpu/consensus/threshold.py``. Host path: the
copied oracle (:mod:`bdls_tpu_torch.ops.bls_host`). Card path:
certificates batch across rounds/heights into the lanes of the pairing
kernel (K9, :func:`bdls_tpu_torch.ops.bls_kernel.verify_certificates`).

One change: points are read by duck typing. A coordinate is any value
whose ``.c`` holds 12 integers in [0, p) (:func:`as_fq12`), so the
reference's own ``FQ12`` objects, as the reference's verifyd and its
aggregators pass them, validate and pack as the port's do; a tuple of
plain ints still reads invalid.
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from bdls_tpu_torch.ops import bls_host as B


@dataclass
class VoteSigner:
    """One validator's BLS voting key."""

    sk: int
    pk: tuple

    @classmethod
    def from_seed(cls, seed: int) -> "VoteSigner":
        sk, pk = B.keygen(seed)
        return cls(sk=sk, pk=pk)

    def sign_vote(self, digest: bytes):
        return B.sign(self.sk, digest)

    def proof_of_possession(self):
        """PoP = signature over the key's own serialized form. Without
        registration-time PoP, same-message aggregation admits the
        classic rogue-key attack: a byzantine validator registering
        pk_b = [s]G1 - sum(other pks) could single-handedly forge any
        quorum certificate for a set it belongs to."""
        return B.sign(self.sk, _pk_bytes(self.pk))


def _pk_bytes(pk) -> bytes:
    return b"BDLS_TPU_BLS_POP" + str(pk[0].c + pk[1].c).encode()


def as_fq12(c) -> Optional["B.FQ12"]:
    """A coordinate as the port's FQ12, or None: the port's FQ12 as is,
    or anything whose ``.c`` is 12 ints (not bools) in [0, p)."""
    if isinstance(c, B.FQ12):
        return c
    cs = getattr(c, "c", None)
    if not isinstance(cs, (list, tuple)) or len(cs) != 12:
        return None
    if not all(type(x) is int and 0 <= x < B.P for x in cs):
        return None
    return B.FQ12(cs)


def valid_point(pt) -> bool:
    """Structural validation for wire-borne BLS group elements before any
    pairing math: a pair of FQ12 coordinates that actually lies on
    E/FQ12 (y^2 = x^3 + 4 — both G1 and the untwisted G2 live there).

    Votes and certificates arrive from byzantine peers; feeding a
    malformed tuple (ints, off-curve coordinates, y = 0 doubling
    corner) into the Miller loop raises from deep inside the field
    tower and would crash vote ingestion. Malformed input must read as
    an *invalid vote*, never an exception."""
    if not isinstance(pt, tuple) or len(pt) != 2:
        return False
    coords = tuple(as_fq12(c) for c in pt)
    if any(c is None for c in coords):
        return False
    try:
        return B.on_curve_fq12(coords)
    except Exception:
        return False


@dataclass
class QuorumCertificate:
    """An aggregated 2t+1 vote: (digest, signer bitmap, one signature)."""

    digest: bytes
    signers: tuple          # indices into the validator set
    agg_sig: object


class ThresholdAggregator:
    """Collects votes for one round digest and emits a certificate once
    quorum is reached; verifies certificates in O(1) pairings."""

    def __init__(self, validator_pks: list, quorum: int,
                 max_pending: int = 64, pops: Optional[list] = None):
        """``pops`` (proofs of possession, one per key) are verified at
        construction when provided; reject keys whose holder cannot
        sign with them (rogue-key defense for same-message
        aggregation). Callers composing certificates from multiple orgs
        MUST register with PoPs."""
        if pops is not None:
            assert len(pops) == len(validator_pks)
            for pk, pop in zip(validator_pks, pops):
                if not B.verify(pk, _pk_bytes(pk), pop):
                    raise ValueError("invalid proof of possession")
        self.pks = list(validator_pks)
        self.quorum = quorum
        # bound the per-digest vote sets: digests that never reach
        # quorum (view changes, byzantine spam) must not accumulate
        # forever — evict oldest-first past max_pending
        self.max_pending = max_pending
        self._votes: dict[bytes, dict[int, object]] = {}
        self._hm_cache: dict[bytes, object] = {}  # digest -> H(digest)
        # signer-bitmap -> aggregated pubkey. Steady state re-verifies
        # the SAME committee every round (membership churn is rare), so
        # the O(quorum) G1 additions amortize to a dict hit and the
        # certificate check is purely the two pairings.
        self._aggpk: OrderedDict[tuple, object] = OrderedDict()
        self.aggpk_cache_size = 128
        self.aggpk_hits = 0
        self.aggpk_misses = 0

    def _agg_pubkey(self, signers) -> object:
        """LRU-cached sum of the signers' public keys, keyed on the
        (deduped, sorted) signer bitmap."""
        key = tuple(sorted(set(signers)))
        agg = self._aggpk.get(key)
        if agg is not None or key in self._aggpk:
            self._aggpk.move_to_end(key)
            self.aggpk_hits += 1
            return agg
        self.aggpk_misses += 1
        agg = None
        for i in key:
            agg = B.pt_add(agg, self.pks[i])
        self._aggpk[key] = agg
        if len(self._aggpk) > self.aggpk_cache_size:
            self._aggpk.popitem(last=False)
        return agg

    def _hm(self, digest: bytes) -> object:
        hm = self._hm_cache.get(digest)
        if hm is None:
            if len(self._hm_cache) >= self.max_pending:
                self._hm_cache.pop(next(iter(self._hm_cache)))
            hm = B.hash_to_g2(digest)
            self._hm_cache[digest] = hm
        return hm

    def add_vote(self, digest: bytes, validator: int, sig) -> Optional[
            QuorumCertificate]:
        """Admit one vote (individually verified) and return a
        certificate when the quorum lands."""
        if not (0 <= validator < len(self.pks)):
            return None
        hm = self._hm(digest)
        if not valid_point(sig):
            return None
        sig = tuple(as_fq12(c) for c in sig)
        if B.pairing(sig, B.G1) != B.pairing(hm, self.pks[validator]):
            return None
        if digest not in self._votes and \
                len(self._votes) >= self.max_pending:
            self._votes.pop(next(iter(self._votes)))
        votes = self._votes.setdefault(digest, {})
        votes[validator] = sig
        if len(votes) < self.quorum:
            return None
        signers = tuple(sorted(votes))[:self.quorum]
        agg = B.aggregate([votes[i] for i in signers])
        self._votes.pop(digest, None)
        return QuorumCertificate(digest=digest, signers=signers,
                                 agg_sig=agg)

    def verify_certificate(self, cert: QuorumCertificate) -> bool:
        """ONE pairing equation regardless of n (vs 2t+1 ECDSA verifies
        in the reference's proof loops)."""
        if len(set(cert.signers)) < self.quorum:
            return False
        if any(not 0 <= i < len(self.pks) for i in cert.signers):
            return False
        if not valid_point(cert.agg_sig):
            return False
        sig = tuple(as_fq12(c) for c in cert.agg_sig)
        agg_pk = self._agg_pubkey(cert.signers)
        return B.pairing(sig, B.G1) == \
            B.pairing(self._hm(cert.digest), agg_pk)


def certificate_lanes(certs: list[QuorumCertificate],
                      aggregators: list[ThresholdAggregator]):
    """Shape a batch of certificates into pairing-kernel lanes
    (g1, sig, agg_pk, H(digest)) for bls_kernel.verify_kernel — the
    cross-round batch (many channels/heights verify together). Each lane
    group is a pair of (12, 12, B) uint32 word arrays
    (:func:`bdls_tpu_torch.ops.bls_kernel.pt_batch`).

    Returns (lanes, valid_mask): certificates failing the structural
    checks verify_certificate enforces (quorum size, dedup, index
    bounds) get a False mask and a dummy generator lane — they must not
    reach the pairing, where only the algebra is checked."""
    from bdls_tpu_torch.ops import bls_kernel as K

    g1s, sigs, pks, hms, mask = [], [], [], [], []
    for cert, agg in zip(certs, aggregators):
        signers = set(cert.signers)
        ok = (len(signers) >= agg.quorum
              and all(0 <= i < len(agg.pks) for i in signers)
              and valid_point(cert.agg_sig))  # malformed/None: mask, not crash
        mask.append(ok)
        if not ok:
            g1s.append(B.G1)
            sigs.append(B.G2)
            pks.append(B.G1)
            hms.append(B.G2)
            continue
        g1s.append(B.G1)
        sigs.append(cert.agg_sig)
        pks.append(agg._agg_pubkey(cert.signers))
        hms.append(agg._hm(cert.digest))
    return (K.pt_batch(g1s), K.pt_batch(sigs),
            K.pt_batch(pks), K.pt_batch(hms)), mask


# ---- wire encoding ------------------------------------------------------
#
# Points travel as their E/FQ12 affine coordinates: 12 x 48-byte
# big-endian field elements per coordinate (uncompressed — compression
# would need a canonical FQ12 square root, pure cost at these message
# rates). A certificate is digest || bitmap || point, so its wire size
# is ~1.2 KB + n/8 bytes and its verify cost is ONE pairing equation —
# both effectively flat in committee size, vs the 2t+1 embedded
# SignedEnvelopes (~160 B and one ECDSA verify EACH) it replaces.

_FQ_BYTES = 48
_PT_BYTES = 1 + 2 * 12 * _FQ_BYTES  # infinity flag + two FQ12 coords


def _fq12_to_bytes(x: "B.FQ12") -> bytes:
    return b"".join(c.to_bytes(_FQ_BYTES, "big") for c in x.c)


def _fq12_from_bytes(raw: bytes) -> "B.FQ12":
    cs = [int.from_bytes(raw[i * _FQ_BYTES:(i + 1) * _FQ_BYTES], "big")
          for i in range(12)]
    if any(c >= B.P for c in cs):
        raise ValueError("field element out of range")
    return B.FQ12(cs)


def serialize_point(pt) -> bytes:
    """G1/G2 element -> 1153 bytes (leading flag 0 = infinity)."""
    if pt is None:
        return b"\0" * _PT_BYTES
    return b"\x01" + _fq12_to_bytes(pt[0]) + _fq12_to_bytes(pt[1])


def deserialize_point(raw: bytes):
    """Inverse of :func:`serialize_point`. Raises ValueError on length
    or range violations; callers treat that as a malformed vote. The
    on-curve screen stays in :func:`valid_point` — deserialization is
    purely structural."""
    if len(raw) != _PT_BYTES:
        raise ValueError("bad point length")
    if raw[0] == 0:
        if any(raw[1:]):
            raise ValueError("nonzero infinity encoding")
        return None
    half = 12 * _FQ_BYTES
    return (_fq12_from_bytes(raw[1:1 + half]),
            _fq12_from_bytes(raw[1 + half:]))


def serialize_certificate(cert: QuorumCertificate) -> bytes:
    """digest(32) || u32 bitmap-bits || bitmap || agg_sig point."""
    if len(cert.digest) != 32:
        raise ValueError("certificate digest must be 32 bytes")
    nbits = (max(cert.signers) + 1) if cert.signers else 0
    bitmap = bytearray((nbits + 7) // 8)
    for i in cert.signers:
        bitmap[i // 8] |= 1 << (i % 8)
    return (cert.digest + struct.pack("<I", nbits) + bytes(bitmap)
            + serialize_point(cert.agg_sig))


def deserialize_certificate(raw: bytes) -> Optional[QuorumCertificate]:
    """Parse a wire certificate; ``None`` for structurally invalid input
    (byzantine bytes must read as an invalid cert, never raise)."""
    try:
        if len(raw) < 36:
            return None
        digest = raw[:32]
        (nbits,) = struct.unpack_from("<I", raw, 32)
        if nbits > 1 << 20:  # bound byzantine bitmap inflation
            return None
        nbytes = (nbits + 7) // 8
        bitmap = raw[36:36 + nbytes]
        if len(bitmap) != nbytes:
            return None
        signers = tuple(i for i in range(nbits)
                        if bitmap[i // 8] & (1 << (i % 8)))
        sig = deserialize_point(raw[36 + nbytes:])
        return QuorumCertificate(digest=digest, signers=signers,
                                 agg_sig=sig)
    except ValueError:
        return None
