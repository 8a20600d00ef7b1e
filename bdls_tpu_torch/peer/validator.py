"""Block validation with batched signature verification — the peer-side
verify firehose.

Reference parity: ``core/committer/txvalidator/v20/validator.go`` (per-tx
fan-out under a semaphore) + ``core/common/validation/msgvalidation.go``
(creator signature per tx) + the builtin v20 endorsement VSCC
(``core/handlers/validation/builtin/v20/validation_logic.go`` — one ECDSA
verify per endorsement). The device-first restructuring: instead of a
goroutine per transaction, ALL creator signatures and ALL endorsement
signatures of a block are collected into one ``CSP.verify_batch`` call
(BASELINE.json config 3: "endorsement signatures across a block").

Each transaction gets a validation flag mirroring Fabric's txflags.

The port's copy of ``bdls_tpu/peer/validator.py``, with one deliberate
difference: the reference's fused strategy catches any error of
``csp.verify_block`` and quietly answers through the lane-at-a-time
batch; here the error propagates, so a failed block launch fails
:meth:`TxValidator.validate_block` and the commit. ``TxFlag``'s values
are pinned to :mod:`bdls_tpu_torch.crypto.blocklane`'s verdicts.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional, Sequence

from bdls_tpu_torch.crypto.csp import CSP, VerifyRequest
from bdls_tpu_torch.crypto.framing import framed_digest, framed_preimage
from bdls_tpu_torch.crypto.msp import Identity, LocalMSP, MSPError
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import tx_digest


# State namespaces only the peer itself may write. ``_pvthash/`` keys
# are synthesized by the committer (the on-chain private-data hash
# mirror, peer/committer.py) AFTER validation — a transaction write-set
# that names them directly would let any contract forge "committed"
# private-data hashes for another chaincode's collections. Future
# system prefixes append here; ``_lifecycle/`` has its own richer guard
# in _lifecycle_writes_ok.
RESERVED_STATE_PREFIXES = ("_pvthash/",)


class TxFlag(IntEnum):
    VALID = 0
    BAD_CREATOR_SIGNATURE = 1
    ENDORSEMENT_POLICY_FAILURE = 2
    BAD_PAYLOAD = 3
    DUPLICATE_TXID = 4
    MVCC_READ_CONFLICT = 5
    CREATOR_NOT_MEMBER = 6
    LIFECYCLE_VIOLATION = 7
    NAMESPACE_VIOLATION = 8


@dataclass(frozen=True)
class EndorsementPolicy:
    """n-of-m org endorsement requirement (the cauthdsl subset the
    committer benchmark needs: AND/OR over orgs expressed as a
    threshold)."""

    required: int = 1
    orgs: frozenset[str] = frozenset()

    def satisfied(self, endorsing_orgs: Sequence[str]) -> bool:
        distinct = {o for o in endorsing_orgs if not self.orgs or o in self.orgs}
        return len(distinct) >= self.required


def endorsement_digest(action: pb.EndorsedAction) -> bytes:
    """Digest an endorser signs: covers the write-set, the read-set (so
    recorded MVCC versions cannot be stripped or altered after
    endorsement), and the proposal hash.

    Length-framed (crypto.framing): without framing, a byte string
    shifted across the write-set/read-set boundary would hash identically,
    letting a tx creator commit a write-set differing from what the
    endorsers signed."""
    return framed_digest(b"", (
        action.write_set.SerializeToString(),
        action.read_set.SerializeToString(),
        action.proposal_hash,
        # the contract label picks the endorsement policy at validation —
        # unsigned, a tx creator could relabel to a weaker policy
        action.contract.encode(),
    ))


def endorsement_preimage(action: pb.EndorsedAction) -> bytes:
    """The exact bytes :func:`endorsement_digest` hashes — what the
    fused block pipeline ships to the device so the hash stage runs
    in-kernel. By construction
    ``sha256(endorsement_preimage(a)) == endorsement_digest(a)``."""
    return framed_preimage(b"", (
        action.write_set.SerializeToString(),
        action.read_set.SerializeToString(),
        action.proposal_hash,
        action.contract.encode(),
    ))


def _block_lane_enabled() -> bool:
    """`BDLS_TPU_BLOCK_LANE=off` is the caller's explicit switch to the
    lane-at-a-time endorsement batch; default is on — the
    CSP ABC's host default keeps the semantics identical for providers
    without a fused program."""
    return os.environ.get("BDLS_TPU_BLOCK_LANE", "on").lower() not in (
        "off", "0", "false")


class TxValidator:
    """Validates one block; returns per-tx flags. All signature checks of
    the block go to the CSP in (at most) two batch calls.

    When an ``msp`` is provided, creator and endorser keys must be
    registered members of the org they claim — the VSCC's identity
    resolution (reference builtin/v20 validates endorser identities
    against the org MSP before counting them toward the policy). Without
    it, a self-minted key could claim any org."""

    def __init__(
        self,
        csp: CSP,
        policy: Optional[EndorsementPolicy] = None,
        msp: Optional[LocalMSP] = None,
        state_get=None,
    ):
        self.csp = csp
        self.policy = policy or EndorsementPolicy()
        self.msp = msp
        # committed-state reader for lifecycle definition/approval lookup
        # (reference: the VSCC resolves the invoked chaincode's committed
        # definition, validation_logic.go:87-218). None = static policy.
        self.state_get = state_get
        # endorsement preimage/digest memo, keyed by the serialized
        # action bytes: k endorsements of one action share one entry,
        # and re-submitted envelopes (endorsement storms replay the same
        # few payloads) skip both the framing re-serialize and the hash
        self._endo_memo: dict[bytes, tuple[bytes, bytes]] = {}
        self._endo_memo_max = 8192

    # ---- lifecycle resolution -------------------------------------------
    def _policy_for(self, action) -> "EndorsementPolicy":
        """The committed per-chaincode policy, else the static default.

        Lifecycle txs: an *approve* is org-scoped — it needs exactly the
        approving org's endorsement (the reference's ApproveForMyOrg
        path); a *commit* needs the channel policy (the reference's
        LifecycleEndorsement MAJORITY), on top of the separate
        approval-majority check in :meth:`_lifecycle_writes_ok`."""
        from bdls_tpu_torch.peer import lifecycle as lc

        if action.contract == "_lifecycle":
            appr = {p[2] for w in action.write_set.writes
                    if (p := lc.parse_approval_key(w.key)) is not None}
            has_def = any(w.key.startswith(lc.DEFS_PREFIX)
                          for w in action.write_set.writes)
            if appr and not has_def:
                return EndorsementPolicy(required=1, orgs=frozenset(appr))
            return self.policy
        if not action.contract or self.state_get is None:
            return self.policy
        raw = self.state_get(lc.defs_key(action.contract))
        if raw is None:
            return self.policy
        try:
            d = lc.ChaincodeDefinition.from_bytes(raw)
        except Exception:
            return self.policy
        return EndorsementPolicy(required=d.required, orgs=frozenset(d.orgs))

    def _lifecycle_writes_ok(self, env, action) -> bool:
        """Validator-side lifecycle rules (lifecycle.go + VSCC):
        approvals only from the approving org's own members; commits only
        with an identical-bytes approval majority at that sequence."""
        from bdls_tpu_torch.peer import lifecycle as lc

        majority = (len(self.msp.orgs()) // 2 + 1) if self.msp else 1
        for w in action.write_set.writes:
            if not w.key.startswith("_lifecycle/"):
                # the system contract must never touch application state:
                # otherwise an approve tx (validated under its org-scoped
                # 1-endorsement policy) could smuggle arbitrary app
                # writes past the channel endorsement policy
                return False
            parsed = lc.parse_approval_key(w.key)
            if parsed is not None:
                _, _, org = parsed
                if org != env.header.creator_org:
                    return False
                continue
            if w.key.startswith(lc.DEFS_PREFIX):
                name = w.key[len(lc.DEFS_PREFIX):]
                try:
                    d = lc.ChaincodeDefinition.from_bytes(w.value)
                except Exception:
                    return False
                if d.name != name or self.state_get is None:
                    return False
                approved = 0
                orgs = self.msp.orgs() if self.msp else [
                    env.header.creator_org]
                for org in orgs:
                    got = self.state_get(
                        lc.approval_key(name, d.sequence, org))
                    if got == w.value:
                        approved += 1
                if approved < majority:
                    return False
            elif parsed is None:
                return False  # unknown reserved _lifecycle/ key shape
        return True

    def _is_member(self, org: str, key) -> bool:
        if self.msp is None:
            return True
        try:
            self.msp.validate(Identity(org=org, key=key))
            return True
        except MSPError:
            return False

    def validate_block(self, block: pb.Block) -> list[TxFlag]:
        txs = list(block.data.transactions)
        flags: list[Optional[TxFlag]] = [None] * len(txs)
        envs: list[Optional[pb.TxEnvelope]] = [None] * len(txs)
        actions: list[Optional[pb.EndorsedAction]] = [None] * len(txs)

        # decode + duplicate txid screen
        seen_txids: set[str] = set()
        for i, raw in enumerate(txs):
            env = pb.TxEnvelope()
            try:
                env.ParseFromString(raw)
            except Exception:
                flags[i] = TxFlag.BAD_PAYLOAD
                continue
            if env.header.tx_id in seen_txids:
                flags[i] = TxFlag.DUPLICATE_TXID
                continue
            seen_txids.add(env.header.tx_id)
            envs[i] = env

        # ---- batch 1: creator signatures (1 per tx) ----------------------
        creator_reqs: list[VerifyRequest] = []
        creator_idx: list[int] = []
        for i, env in enumerate(envs):
            if env is None:
                continue
            try:
                key = self.csp.key_import(
                    "P-256",
                    int.from_bytes(env.header.creator_x, "big"),
                    int.from_bytes(env.header.creator_y, "big"),
                )
            except Exception:
                flags[i] = TxFlag.BAD_CREATOR_SIGNATURE
                continue
            if not self._is_member(env.header.creator_org, key):
                flags[i] = TxFlag.CREATOR_NOT_MEMBER
                continue
            creator_reqs.append(
                VerifyRequest(
                    key=key,
                    digest=tx_digest(env),
                    r=int.from_bytes(env.sig_r, "big"),
                    s=int.from_bytes(env.sig_s, "big"),
                )
            )
            creator_idx.append(i)
        for i, ok in zip(creator_idx, self.csp.verify_batch(creator_reqs)):
            if not ok:
                flags[i] = TxFlag.BAD_CREATOR_SIGNATURE

        # ---- batch 2: endorsement signatures (k per tx) ------------------
        # decode + screen actions first (shared by both endorsement
        # strategies below)
        for i, env in enumerate(envs):
            if env is None or flags[i] is not None:
                continue
            action = pb.EndorsedAction()
            try:
                action.ParseFromString(env.payload)
            except Exception:
                flags[i] = TxFlag.BAD_PAYLOAD
                continue
            if not action.endorsements:
                flags[i] = TxFlag.ENDORSEMENT_POLICY_FAILURE
                continue
            actions[i] = action

        # verify + policy-evaluate, either through the fused
        # hash→verify→policy block pipeline or the
        # lane-at-a-time host batch — bit-identical verdicts
        if _block_lane_enabled():
            self._endorse_fused(envs, actions, flags)
        else:
            self._endorse_batched(envs, actions, flags)

        for i in range(len(envs)):
            if actions[i] is None or flags[i] is not None:
                continue
            action = actions[i]
            touches_lc = any(w.key.startswith("_lifecycle/")
                             for w in action.write_set.writes)
            if action.contract == "_lifecycle" or touches_lc:
                if action.contract != "_lifecycle" or \
                        not self._lifecycle_writes_ok(envs[i], action):
                    flags[i] = TxFlag.LIFECYCLE_VIOLATION
                    continue
            if self._writes_reserved(action):
                flags[i] = TxFlag.NAMESPACE_VIOLATION
                continue
            if not self._namespace_ok(action):
                flags[i] = TxFlag.NAMESPACE_VIOLATION
                continue
            if not self._collections_ok(action):
                flags[i] = TxFlag.NAMESPACE_VIOLATION

        return [TxFlag.VALID if f is None else f for f in flags]

    # ---- endorsement strategies -------------------------------------------
    def _endo_parts(self, env, action) -> tuple[bytes, bytes]:
        """(preimage, digest) for one action, memoized on the envelope
        payload bytes: the k endorsements of one action — and storm
        replays of the same payload across blocks — share one framing
        serialize and one hash."""
        key = env.payload
        hit = self._endo_memo.get(key)
        if hit is None:
            pre = endorsement_preimage(action)
            hit = (pre, hashlib.sha256(pre).digest())
            if len(self._endo_memo) >= self._endo_memo_max:
                self._endo_memo.clear()
            self._endo_memo[key] = hit
        return hit

    @staticmethod
    def _wire32(value: bytes) -> Optional[bytes]:
        """Canonical 32-byte big-endian re-encoding of a wire field
        (None = value out of 256-bit range; the host path would verify
        it False, so the fused path simply drops the lane)."""
        try:
            return int.from_bytes(value, "big").to_bytes(32, "big")
        except OverflowError:
            return None

    def _endorse_fused(self, envs, actions, flags) -> None:
        """The device-resident block pipeline: every still-unflagged
        tx's endorsements become lanes of ONE ``csp.verify_block``
        request — raw framed preimages (hashed in-kernel), per-tx
        policies mapped onto the block's org universe — and the
        returned per-tx flags land directly. Host-side screens
        (key_import, MSP membership) still run per endorsement before
        the lane is built, exactly like the batched strategy."""
        from bdls_tpu_torch.crypto import blocklane

        rows = [i for i in range(len(envs))
                if actions[i] is not None and flags[i] is None]
        if not rows:
            return
        org_idx: dict[str, int] = {}
        lanes: list = []
        for t, i in enumerate(rows):
            action = actions[i]
            pre, _ = self._endo_parts(envs[i], action)
            for endo in action.endorsements:
                try:
                    key = self.csp.key_import(
                        "P-256",
                        int.from_bytes(endo.endorser_x, "big"),
                        int.from_bytes(endo.endorser_y, "big"),
                    )
                except Exception:
                    continue  # invalid key = missing endorsement
                if not self._is_member(endo.org, key):
                    continue
                qx = self._wire32(endo.endorser_x)
                qy = self._wire32(endo.endorser_y)
                r = self._wire32(endo.sig_r)
                s = self._wire32(endo.sig_s)
                if None in (qx, qy, r, s):
                    continue  # out-of-range sig: verifies False anyway
                o = org_idx.setdefault(endo.org, len(org_idx))
                lanes.append(blocklane.BlockLane(
                    msg=pre, qx=qx, qy=qy, r=r, s=s, tx=t, org=o))
        norgs = max(1, len(org_idx))
        policies = []
        for i in rows:
            pol = self._policy_for(actions[i])
            if pol.orgs:
                idxs = tuple(sorted(org_idx[o] for o in pol.orgs
                                    if o in org_idx))
                # none of the counting orgs endorsed: an out-of-range
                # index keeps the mask empty (the bare () would mean
                # "all orgs count" — the opposite)
                idxs = idxs or (norgs,)
            else:
                idxs = ()
            policies.append(blocklane.BlockPolicy(
                required=pol.required, orgs=idxs))
        breq = blocklane.BlockVerifyRequest(
            "P-256", lanes, policies, norgs=norgs)
        # no fallback here: an error of the block lane (a failed launch
        # on the card) fails validate_block, and with it the commit
        out = self.csp.verify_block(breq)
        for t, i in enumerate(rows):
            if int(out[t]) != blocklane.TXFLAG_VALID:
                flags[i] = TxFlag.ENDORSEMENT_POLICY_FAILURE

    def _endorse_batched(self, envs, actions, flags) -> None:
        """The lane-at-a-time reference strategy: hash on the host, one
        ``verify_batch`` over the block, Python policy evaluation."""
        endo_reqs: list[VerifyRequest] = []
        endo_meta: list[tuple[int, str]] = []  # request -> (tx index, org)
        for i, env in enumerate(envs):
            if env is None or actions[i] is None or flags[i] is not None:
                continue
            action = actions[i]
            _, digest = self._endo_parts(env, action)
            for endo in action.endorsements:
                try:
                    key = self.csp.key_import(
                        "P-256",
                        int.from_bytes(endo.endorser_x, "big"),
                        int.from_bytes(endo.endorser_y, "big"),
                    )
                except Exception:
                    continue  # invalid key = missing endorsement
                if not self._is_member(endo.org, key):
                    continue  # unregistered key cannot endorse for the org
                endo_reqs.append(
                    VerifyRequest(
                        key=key,
                        digest=digest,
                        r=int.from_bytes(endo.sig_r, "big"),
                        s=int.from_bytes(endo.sig_s, "big"),
                    )
                )
                endo_meta.append((i, endo.org))
        valid_orgs: dict[int, list[str]] = {}
        for (i, org), ok in zip(endo_meta,
                                self.csp.verify_batch(endo_reqs)):
            if ok:
                valid_orgs.setdefault(i, []).append(org)
        for i in range(len(envs)):
            if actions[i] is None or flags[i] is not None:
                continue
            # per-chaincode committed policy (VSCC dispatch), falling
            # back to the static channel policy
            if not self._policy_for(actions[i]).satisfied(
                    valid_orgs.get(i, [])):
                flags[i] = TxFlag.ENDORSEMENT_POLICY_FAILURE

    def _writes_reserved(self, action) -> bool:
        """True when the write-set touches a reserved system namespace
        (RESERVED_STATE_PREFIXES) no contract — with or without a
        committed definition — may ever write. Applies to public writes
        only: collection writes carry bare in-collection keys and are
        re-keyed by the committer, so they cannot escape into these
        namespaces."""
        return any(
            w.key.startswith(RESERVED_STATE_PREFIXES)
            for w in action.write_set.writes if not w.collection)

    def _collections_ok(self, action) -> bool:
        """Collection writes must (a) name a collection the invoked
        chaincode's committed definition declares, (b) carry a value
        hash and NO cleartext (a cleartext value on-chain would leak the
        private data to every peer)."""
        from bdls_tpu_torch.peer.lifecycle import ChaincodeDefinition, defs_key

        definition = None
        for w in action.write_set.writes:
            if not w.collection:
                continue
            if w.value or w.is_delete or len(w.value_hash) != 32:
                return False
            if self.state_get is None:
                return False
            if definition is None:
                raw = self.state_get(defs_key(action.contract))
                if raw is None:
                    return False
                try:
                    definition = ChaincodeDefinition.from_bytes(raw)
                except Exception:
                    return False
            if definition.collection_orgs(w.collection) is None:
                return False
        return True

    def _namespace_ok(self, action) -> bool:
        """Definition-governed chaincodes write only inside their own
        ``<name>/`` namespace — the reference's per-chaincode rwset
        namespacing, which is what stops a weakly-governed definition
        from authorizing writes to another chaincode's (or bare) state."""
        from bdls_tpu_torch.peer.lifecycle import defs_key

        if action.contract in ("", "_lifecycle") or self.state_get is None:
            return True
        if self.state_get(defs_key(action.contract)) is None:
            return True  # pre-lifecycle contracts keep flat keys
        prefix = action.contract + "/"
        # collection writes carry bare in-collection keys; they are
        # constrained by _collections_ok instead
        return all(w.key.startswith(prefix)
                   for w in action.write_set.writes if not w.collection)
