"""Signature policies: n-of-m trees over org principals + implicit meta.

Reference parity: ``common/cauthdsl`` (SignaturePolicyEnvelope compiled to
evaluator closures over SignedData sets), ``common/policydsl`` (the
textual ``AND('Org1.member', OR(...))`` language), and
``common/policies``' ImplicitMetaPolicy (ANY/ALL/MAJORITY over
sub-policies). Evaluation deduplicates identities and consumes
pre-verified signature bits so the underlying crypto rides the CSP batch
path exactly once per evaluation set.

The port's copy of ``bdls_tpu/crypto/policy.py``, whole. The one batch
of a signature set goes to the MSP's provider: on ``TorchCSP``, one
launch of K1, or of K2 for pinned keys.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

from bdls_tpu_torch.crypto.msp import LocalMSP, SignedData


class PolicyError(Exception):
    pass


@dataclass(frozen=True)
class Principal:
    """Leaf: an org role requirement ('Org1.member' / 'Org1.admin')."""

    org: str
    role: str = "member"

    def matches(self, sd: SignedData) -> bool:
        if sd.identity.org != self.org:
            return False
        if self.role == "member":
            return True
        return sd.identity.role == self.role


@dataclass(frozen=True)
class NOutOf:
    """n of the sub-policies must be satisfied by distinct signatures."""

    n: int
    rules: tuple["PolicyNode", ...]


PolicyNode = Union[Principal, NOutOf]


def and_(*rules: PolicyNode) -> NOutOf:
    return NOutOf(len(rules), tuple(rules))


def or_(*rules: PolicyNode) -> NOutOf:
    return NOutOf(1, tuple(rules))


_TOKEN = re.compile(
    r"\s*(AND|OR|OutOf|\(|\)|,|'[^']*'|\d+)\s*", re.IGNORECASE
)


def from_dsl(expr: str) -> PolicyNode:
    """Parse the reference's policy DSL subset:
    ``AND('Org1.member', OR('Org2.member','Org3.admin'), OutOf(2, ...))``.
    """
    tokens: list[str] = []
    scan = 0
    while scan < len(expr):
        m = _TOKEN.match(expr, scan)
        if m is None:
            if expr[scan:].strip():
                raise PolicyError(f"unparseable policy at {expr[scan:]!r}")
            break
        tokens.append(m.group(1))
        scan = m.end()
    pos = 0

    def peek() -> Optional[str]:
        return tokens[pos] if pos < len(tokens) else None

    def eat(expect: Optional[str] = None) -> str:
        nonlocal pos
        if pos >= len(tokens):
            raise PolicyError("unexpected end of policy")
        tok = tokens[pos]
        pos += 1
        if expect is not None and tok != expect:
            raise PolicyError(f"expected {expect!r}, got {tok!r}")
        return tok

    def parse_node() -> PolicyNode:
        tok = eat()
        up = tok.upper()
        if up in ("AND", "OR", "OUTOF"):
            eat("(")
            n: Optional[int] = None
            if up == "OUTOF":
                n = int(eat())
                eat(",")
            rules = [parse_node()]
            while peek() == ",":
                eat(",")
                rules.append(parse_node())
            eat(")")
            if up == "AND":
                return NOutOf(len(rules), tuple(rules))
            if up == "OR":
                return NOutOf(1, tuple(rules))
            return NOutOf(n, tuple(rules))
        if tok.startswith("'") and tok.endswith("'"):
            body = tok[1:-1]
            org, _, role = body.partition(".")
            if not org or role not in ("member", "admin", "peer", "client"):
                raise PolicyError(f"bad principal {body!r}")
            return Principal(org, "member" if role in ("peer", "client") else role)
        raise PolicyError(f"unexpected token {tok!r}")

    node = parse_node()
    if pos != len(tokens):
        raise PolicyError(f"trailing tokens in {expr!r}")
    return node


class SignaturePolicy:
    """A compiled policy evaluated against SignedData sets."""

    def __init__(self, root: PolicyNode, msp: LocalMSP):
        self.root = root
        self.msp = msp

    def evaluate(self, signed: Sequence[SignedData], now=None) -> bool:
        """True iff the (deduplicated, verified) signature set satisfies
        the tree — policy.EvaluateSignedData semantics."""
        return self.evaluate_verified(self.verify_set(signed, now))

    def verify_set(
        self, signed: Sequence[SignedData], now=None
    ) -> list[SignedData]:
        """Dedup by signer and batch-verify once; returns the valid set.
        Callers evaluating several policies over the same signatures
        (ImplicitMetaPolicy) verify once and reuse."""
        seen: set[bytes] = set()
        unique: list[SignedData] = []
        for sd in signed:
            ski = sd.identity.key.ski()
            if ski not in seen:
                seen.add(ski)
                unique.append(sd)
        oks = self.msp.verify_signed_data(unique, now)
        return [sd for sd, ok in zip(unique, oks) if ok]

    def evaluate_verified(self, valid: list[SignedData]) -> bool:
        used: set[int] = set()
        return self._eval(self.root, valid, used)

    def _eval(self, node: PolicyNode, valid: list[SignedData], used: set[int]) -> bool:
        """Greedy satisfaction with per-signature consumption (a signature
        satisfies at most one leaf, like cauthdsl's used-flags)."""
        if isinstance(node, Principal):
            for i, sd in enumerate(valid):
                if i not in used and node.matches(sd):
                    used.add(i)
                    return True
            return False
        satisfied = 0
        for rule in node.rules:
            snapshot = set(used)
            if self._eval(rule, valid, used):
                satisfied += 1
            else:
                used.clear()
                used.update(snapshot)
            if satisfied >= node.n:
                return True
        return False


@dataclass
class ImplicitMetaPolicy:
    """ANY/ALL/MAJORITY over named sub-policies
    (common/policies/implicitmeta.go)."""

    rule: str  # "ANY" | "ALL" | "MAJORITY"
    sub_policies: list[SignaturePolicy] = field(default_factory=list)

    def evaluate(self, signed: Sequence[SignedData], now=None) -> bool:
        if not self.sub_policies:
            return False
        # one batch verification, reused across every sub-policy
        valid = self.sub_policies[0].verify_set(signed, now)
        hits = sum(1 for p in self.sub_policies if p.evaluate_verified(valid))
        rule = self.rule.upper()
        if rule == "ANY":
            return hits >= 1
        if rule == "ALL":
            return hits == len(self.sub_policies)
        if rule == "MAJORITY":
            return hits > len(self.sub_policies) // 2
        raise PolicyError(f"unknown implicit meta rule {self.rule}")
