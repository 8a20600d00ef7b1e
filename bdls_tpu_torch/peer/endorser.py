"""Endorsing peer: proposal simulation + endorsement signing.

Reference parity: ``core/endorser/endorser.go`` ProcessProposal — verify
the client's proposal signature, simulate against current state to produce
a write-set, and endorse (sign) the result with the peer's identity. The
"chaincode" here is a pluggable Python callable (the reference launches
docker/external processes; the framework ships a kv contract runtime with
the same simulate-then-endorse contract).

The port's copy of ``bdls_tpu/peer/endorser.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Optional

from bdls_tpu_torch.crypto.csp import CSP, VerifyRequest
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.peer.committer import KVState
from bdls_tpu_torch.peer.validator import endorsement_digest


class EndorserError(Exception):
    pass


class ErrProposalSignature(EndorserError):
    pass


class ErrSimulationFailed(EndorserError):
    pass


@dataclass
class Proposal:
    """A client proposal: invoke ``contract`` with ``args`` on a channel."""

    channel_id: str
    contract: str
    args: list[bytes]
    creator_x: bytes
    creator_y: bytes
    creator_org: str
    sig_r: bytes = b""
    sig_s: bytes = b""

    def digest(self) -> bytes:
        h = hashlib.sha256()
        h.update(self.channel_id.encode() + b"\x00")
        h.update(self.contract.encode() + b"\x00")
        for a in self.args:
            h.update(hashlib.sha256(a).digest())
        h.update(self.creator_x + self.creator_y)
        h.update(self.creator_org.encode())
        return h.digest()


# a contract: (state_reader, args) -> list of (key, value|None) writes
Contract = Callable[[Callable[[str], Optional[bytes]], list[bytes]], list]


class _RecordingReader:
    """Wraps KVState.get to record the MVCC read-set of a simulation:
    (key, exists, version) per distinct key, as of simulation time.
    A non-empty ``namespace`` prefixes every access (per-chaincode
    namespacing for definition-governed contracts)."""

    def __init__(self, state: KVState, namespace: str = "", pvt_get=None):
        self._state = state
        self._ns = namespace
        self._pvt_get = pvt_get
        self.reads: dict[str, tuple[bool, tuple[int, int]]] = {}

    def __call__(self, key: str) -> Optional[bytes]:
        if key.startswith("@"):
            # private-collection read: served from the side store on
            # member peers; NOT MVCC-recorded (the reference tracks
            # private reads in the hashed rwset — out of scope here)
            from bdls_tpu_torch.peer.privdata import parse_private_key

            parsed = parse_private_key(key)
            if parsed is None or self._pvt_get is None:
                return None
            return self._pvt_get(*parsed)
        key = self._ns + key
        value = self._state.get(key)
        if key not in self.reads:
            ver = self._state.version(key)
            self.reads[key] = (ver is not None, ver or (0, 0))
        return value


class Endorser:
    def __init__(self, csp: CSP, signing_key, org: str, state: KVState,
                 contracts: Optional[dict[str, Contract]] = None,
                 pvt_get=None):
        self.csp = csp
        self.key = signing_key
        self.org = org
        self.state = state
        self.pvt_get = pvt_get
        self.contracts: dict[str, Contract] = contracts or {}
        self.stats = {"proposals": 0, "endorsed": 0, "rejected": 0}
        # proposal_hash -> {(collection, key): cleartext} (transient)
        self.transient: dict[bytes, dict] = {}

    def register_contract(self, name: str, fn: Contract) -> None:
        self.contracts[name] = fn

    def process_proposal(self, prop: Proposal) -> pb.EndorsedAction:
        """Verify, simulate, endorse (endorser.go:304 ProcessProposal)."""
        self.stats["proposals"] += 1
        try:
            key = self.csp.key_import(
                "P-256",
                int.from_bytes(prop.creator_x, "big"),
                int.from_bytes(prop.creator_y, "big"),
            )
            ok = self.csp.verify(
                VerifyRequest(
                    key=key,
                    digest=prop.digest(),
                    r=int.from_bytes(prop.sig_r, "big"),
                    s=int.from_bytes(prop.sig_s, "big"),
                )
            )
        except Exception:
            ok = False
        if not ok:
            self.stats["rejected"] += 1
            raise ErrProposalSignature("client proposal signature invalid")

        contract = self.contracts.get(prop.contract)
        if contract is None:
            self.stats["rejected"] += 1
            raise ErrSimulationFailed(f"unknown contract {prop.contract!r}")
        # definition-governed chaincodes simulate inside their own
        # "<name>/" namespace (reference: per-chaincode rwset namespaces)
        # so their committed endorsement policy can only ever authorize
        # their own state; pre-lifecycle contracts keep flat keys
        ns = ""
        if prop.contract not in ("", "_lifecycle"):
            from bdls_tpu_torch.peer.lifecycle import defs_key

            if self.state.get(defs_key(prop.contract)) is not None:
                ns = prop.contract + "/"
        pvt_get = None
        if self.pvt_get is not None:
            cc = prop.contract
            pvt_get = lambda coll, k: self.pvt_get(cc, coll, k)  # noqa: E731
        reader = _RecordingReader(self.state, namespace=ns, pvt_get=pvt_get)
        from bdls_tpu_torch.peer.privdata import split_private_writes, value_hash

        try:
            writes = contract(reader, prop.args)
            if ns:
                writes = [(k if k.startswith("@") else ns + k, v)
                          for k, v in writes]
            # private-data collections: hash on-chain, cleartext transient
            # (reference gossip/privdata; see peer/privdata.py)
            writes, private = split_private_writes(writes)
        except Exception as exc:
            self.stats["rejected"] += 1
            raise ErrSimulationFailed(str(exc))

        action = pb.EndorsedAction()
        action.proposal_hash = prop.digest()
        action.contract = prop.contract
        for key_name, (exists, ver) in sorted(reader.reads.items()):
            rd = action.read_set.reads.add()
            rd.key = key_name
            rd.exists = exists
            rd.version_block, rd.version_tx = ver
        for key_name, value in writes:
            w = action.write_set.writes.add()
            w.key = key_name
            if value is None:
                w.is_delete = True
            else:
                w.value = value
        for (coll, k), value in sorted(private.items()):
            w = action.write_set.writes.add()
            w.collection = coll
            w.key = k
            w.value_hash = value_hash(value)
        self.endorse(action)
        if private:
            # transient store: the client fetches these and hands them
            # to member-org peers (the reference's transient field flow)
            self.transient[bytes(action.proposal_hash)] = dict(private)
        self.stats["endorsed"] += 1
        return action

    def endorse(self, action: pb.EndorsedAction) -> None:
        """Append this peer's endorsement signature to an action."""
        r, s = self.csp.sign(self.key, endorsement_digest(action))
        e = action.endorsements.add()
        pub = self.key.public_key()
        e.endorser_x = pub.x.to_bytes(32, "big")
        e.endorser_y = pub.y.to_bytes(32, "big")
        e.org = self.org
        e.sig_r = r.to_bytes(32, "big")
        e.sig_s = s.to_bytes(32, "big")


def sign_proposal(csp: CSP, key_handle, prop: Proposal) -> Proposal:
    """Client-side proposal signing helper."""
    pub = key_handle.public_key()
    prop.creator_x = pub.x.to_bytes(32, "big")
    prop.creator_y = pub.y.to_bytes(32, "big")
    r, s = csp.sign(key_handle, prop.digest())
    prop.sig_r = r.to_bytes(32, "big")
    prop.sig_s = s.to_bytes(32, "big")
    return prop
