"""Chaincode lifecycle: install / approve / commit with per-chaincode
endorsement policies.

Reference parity: ``core/chaincode/lifecycle/lifecycle.go`` — chaincode
definitions (name, version, sequence, endorsement policy) are agreed
on-channel: each org *approves* a definition, and once enough orgs have
approved, a *commit* transaction activates it. Validation then enforces
the committed definition's policy per invoked chaincode
(``core/handlers/validation/builtin/v20/validation_logic.go:87-218``)
instead of one static channel-wide rule.

Device-first mapping: lifecycle state lives in the SAME versioned KV state
as application data, under reserved ``_lifecycle/`` keys, and lifecycle
operations are ordinary ordered transactions simulated by the built-in
``_lifecycle`` system contract (Fabric's approach exactly — _lifecycle
is a system chaincode writing to its own namespace). The policy rules
are enforced by the validator, not the contract:

- an approval write for org X is only valid from a creator in org X;
- a definition commit is only valid if a majority of channel orgs have
  approved the identical definition bytes at that sequence;
- sequence numbers advance by exactly 1.

Install (the package step) maps to registering the contract callable on
the endorsing peer (:meth:`bdls_tpu_torch.peer.endorser.Endorser.
register_contract`) — the runtime half the reference keeps node-local
too (package stores are per-peer, never on-chain).

The port's copy of ``bdls_tpu/peer/lifecycle.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

DEFS_PREFIX = "_lifecycle/defs/"
APPROVALS_PREFIX = "_lifecycle/approvals/"
LIFECYCLE_CONTRACT = "_lifecycle"


class LifecycleError(Exception):
    pass


@dataclass(frozen=True)
class ChaincodeDefinition:
    """The on-channel definition (lifecycle.go ChaincodeDefinition,
    reduced to the fields this framework enforces). ``collections``
    carries the private-data collection configs ({name: (orgs...)}) the
    reference packages with the definition."""

    name: str
    version: str
    sequence: int
    required: int = 1              # endorsement threshold…
    orgs: tuple = ()               # …over these orgs (empty = any)
    collections: tuple = ()        # ((coll_name, (orgs...)), ...)

    def to_bytes(self) -> bytes:
        return json.dumps({
            "name": self.name, "version": self.version,
            "sequence": self.sequence, "required": self.required,
            "orgs": sorted(self.orgs),
            "collections": sorted(
                [c, sorted(o)] for c, o in self.collections),
        }, sort_keys=True).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ChaincodeDefinition":
        d = json.loads(raw)
        return cls(name=d["name"], version=d["version"],
                   sequence=int(d["sequence"]),
                   required=int(d["required"]),
                   orgs=tuple(d["orgs"]),
                   collections=tuple(
                       (c, tuple(o)) for c, o in d.get("collections", [])))

    def collection_orgs(self, coll: str):
        for c, orgs in self.collections:
            if c == coll:
                return orgs
        return None


def defs_key(name: str) -> str:
    return DEFS_PREFIX + name


def approval_key(name: str, sequence: int, org: str) -> str:
    return f"{APPROVALS_PREFIX}{name}/{sequence}/{org}"


def parse_approval_key(key: str):
    """-> (name, sequence, org) or None."""
    if not key.startswith(APPROVALS_PREFIX):
        return None
    parts = key[len(APPROVALS_PREFIX):].rsplit("/", 2)
    if len(parts) != 3:
        return None
    try:
        return parts[0], int(parts[1]), parts[2]
    except ValueError:
        return None


def lifecycle_contract(read, args):
    """The built-in ``_lifecycle`` system contract.

    approve: args = [b"approve", def_bytes, org]
    commit:  args = [b"commit", def_bytes]

    Reads recorded here become MVCC guards: concurrent commits of the
    same chaincode conflict on the definition key.
    """
    if not args:
        raise LifecycleError("missing lifecycle op")
    op = args[0]
    if op == b"approve":
        if len(args) != 3:
            raise LifecycleError("approve needs [op, def, org]")
        d = ChaincodeDefinition.from_bytes(args[1])
        org = args[2].decode()
        cur = read(defs_key(d.name))
        cur_seq = ChaincodeDefinition.from_bytes(cur).sequence if cur else 0
        if d.sequence != cur_seq + 1:
            raise LifecycleError(
                f"approve sequence {d.sequence}, expected {cur_seq + 1}")
        return [(approval_key(d.name, d.sequence, org), d.to_bytes())]
    if op == b"commit":
        if len(args) != 2:
            raise LifecycleError("commit needs [op, def]")
        d = ChaincodeDefinition.from_bytes(args[1])
        cur = read(defs_key(d.name))
        cur_seq = ChaincodeDefinition.from_bytes(cur).sequence if cur else 0
        if d.sequence != cur_seq + 1:
            raise LifecycleError(
                f"commit sequence {d.sequence}, expected {cur_seq + 1}")
        return [(defs_key(d.name), d.to_bytes())]
    raise LifecycleError(f"unknown lifecycle op {op!r}")
