"""The port's signature policies (``bdls_tpu_torch/crypto/policy.py``)
against the JAX package's ``bdls_tpu/crypto/policy.py``, on the CPU.

- ``from_dsl``: the same tree for a table of expressions, and the same
  exception type and text for malformed ones.
- ``SignaturePolicy`` and ``ImplicitMetaPolicy`` (ANY, ALL, MAJORITY):
  the same verdicts over seeded ``SignedData`` sets that mix orgs and
  claimed roles, valid and tampered signatures, duplicate signers,
  expired members and identities outside the MSP; each package on its
  own ``SwCSP``, the port's sets also through ``TorchCSP(device="cpu")``
  (the plain twins of K1 and K2 carry the verdicts).
- ``verify_set`` makes exactly one ``verify_batch`` call, of the
  deduplicated set.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from bdls_tpu.crypto import csp as JC
from bdls_tpu.crypto import msp as JM
from bdls_tpu.crypto import policy as JP
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu_torch.crypto import msp as M
from bdls_tpu_torch.crypto import policy as P
from bdls_tpu_torch.crypto.csp import PublicKey
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP

torch.set_num_threads(1)

SW = SwCSP()
NOW = 5000.0

# (org, scalar, role, not_after): registered in both MSPs
MEMBERS = [("Org1", 0x7101, "member", 0.0), ("Org1", 0x7102, "admin", 0.0),
           ("Org2", 0x7201, "member", 0.0), ("Org2", 0x7202, "admin", 0.0),
           ("Org3", 0x7301, "member", 0.0),
           ("Org3", 0x7302, "member", 1000.0)]          # expired at NOW
OUTSIDERS = [("Org1", 0x7109, "member", 0.0), ("Org4", 0x7401, "admin", 0.0)]

DSL = [
    "AND('Org1.member', OR('Org2.member','Org3.admin'))",
    "OutOf(2,'Org1.member','Org2.member','Org3.member')",
    "OR('Org1.admin')",
    "and('Org1.peer', or('Org2.client', 'Org3.member'))",
    "OUTOF(1, AND('Org1.member','Org1.member'), 'Org2.admin')",
    "AND('Org1.member','Org2.member','Org3.member')",
    "OutOf(3, 'Org1.member', 'Org1.admin', 'Org2.member', 'Org2.admin')",
    "  OR ( 'Org2.member' , 'Org3.member' )  ",
]
BAD_DSL = [
    "XOR('Org1.member')", "AND('Org1.wizard')", "AND('Org1.member'",
    "AND('Org1.member'))", "OutOf(x, 'Org1.member')",
    "OutOf('Org1.member', 'Org2.member')", "", "'.member'", "OR()",
    "AND('Org1.member' 'Org2.member')", "OutOf(2)", "AND(", "'Org1'",
    "AND('Org1.member',)", "Org1.member", "AND('Org1.member'; 'x')",
]


def tree(node):
    """Either package's policy tree as nested tuples."""
    if hasattr(node, "rules"):
        return ("N", node.n, tuple(tree(r) for r in node.rules))
    return ("P", node.org, node.role)


def outcome(parse, expr):
    try:
        return ("ok", tree(parse(expr)))
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("expr", DSL + BAD_DSL)
def test_from_dsl_matches_reference(expr):
    got = outcome(P.from_dsl, expr)
    assert got == outcome(JP.from_dsl, expr)
    assert (got[0] == "ok") == (expr in DSL)


def test_and_or_helpers_match_reference():
    a = P.and_(P.Principal("Org1"), P.or_(P.Principal("Org2", "admin"),
                                          P.Principal("Org3")))
    b = JP.and_(JP.Principal("Org1"), JP.or_(JP.Principal("Org2", "admin"),
                                             JP.Principal("Org3")))
    assert tree(a) == tree(b) == ("N", 2, (("P", "Org1", "member"), (
        "N", 1, (("P", "Org2", "admin"), ("P", "Org3", "member")))))


def _pub(scalar):
    pub = SW.key_from_scalar("P-256", scalar).public_key()
    return pub.x, pub.y


def msps(csp=SW):
    port, ref = M.LocalMSP(csp), JM.LocalMSP(JSwCSP())
    for org, scalar, role, not_after in MEMBERS:
        x, y = _pub(scalar)
        port.register(M.Identity(org, PublicKey("P-256", x, y), role,
                                 not_after))
        ref.register(JM.Identity(org, JC.PublicKey("P-256", x, y), role,
                                 not_after))
    return port, ref


def signed_sets(seed: int, n_sets: int):
    """Seeded signature sets as plain tuples (org, scalar, role, data,
    r, s): members and outsiders, claimed roles that differ from the
    registered one, tampered signatures and duplicates."""
    rng = np.random.default_rng(seed)
    people = MEMBERS + OUTSIDERS
    out = []
    for _ in range(n_sets):
        rows = []
        for _ in range(int(rng.integers(1, 6))):
            org, scalar, role, _ = people[int(rng.integers(len(people)))]
            if rng.random() < 0.2:
                role = "admin" if role == "member" else "member"
            data = b"tx-%d" % int(rng.integers(3))
            r, s = SW.sign(SW.key_from_scalar("P-256", scalar),
                           hashlib.sha256(data).digest())
            if rng.random() < 0.15:
                s ^= 1 << int(rng.integers(8))
            rows.append((org, scalar, role, data, r, s))
            if rng.random() < 0.2:
                rows.append(rows[-1])            # a duplicate signer
        out.append(rows)
    return out


def as_port(rows):
    return [M.SignedData(data, M.Identity(org, PublicKey(
        "P-256", *_pub(scalar)), role), r, s)
        for org, scalar, role, data, r, s in rows]


def as_ref(rows):
    return [JM.SignedData(data, JM.Identity(org, JC.PublicKey(
        "P-256", *_pub(scalar)), role), r, s)
        for org, scalar, role, data, r, s in rows]


def test_signature_policies_match_reference():
    port_msp, ref_msp = msps()
    sets = signed_sets(7, 24)
    policies = [(P.SignaturePolicy(P.from_dsl(e), port_msp),
                 JP.SignaturePolicy(JP.from_dsl(e), ref_msp)) for e in DSL]
    subs = [(P.SignaturePolicy(P.from_dsl(f"OR('{o}.member')"), port_msp),
             JP.SignaturePolicy(JP.from_dsl(f"OR('{o}.member')"), ref_msp))
            for o in ("Org1", "Org2", "Org3")]
    metas = [(P.ImplicitMetaPolicy(rule, [p for p, _ in subs]),
              JP.ImplicitMetaPolicy(rule, [j for _, j in subs]))
             for rule in ("ANY", "ALL", "MAJORITY")]
    verdicts = {True: 0, False: 0}
    for rows in sets:
        port_valid = policies[0][0].verify_set(as_port(rows), NOW)
        ref_valid = policies[0][1].verify_set(as_ref(rows), NOW)
        assert [(sd.identity.org, sd.identity.key.x, sd.identity.role,
                 sd.r, sd.s) for sd in port_valid] == \
            [(sd.identity.org, sd.identity.key.x, sd.identity.role, sd.r,
              sd.s) for sd in ref_valid]
        for port_pol, ref_pol in policies:
            got = port_pol.evaluate_verified(port_valid)
            assert got == ref_pol.evaluate_verified(ref_valid)
            verdicts[got] += 1
        for port_meta, ref_meta in metas:
            assert port_meta.evaluate(as_port(rows), NOW) == \
                ref_meta.evaluate(as_ref(rows), NOW)
    assert verdicts[True] and verdicts[False]
    assert P.ImplicitMetaPolicy("ANY").evaluate([]) is False
    with pytest.raises(P.PolicyError, match="unknown implicit meta rule"):
        P.ImplicitMetaPolicy("SOME", [subs[0][0]]).evaluate(
            as_port(sets[0]), NOW)


def test_policies_on_the_kernels_plain_twins():
    """A SignaturePolicy's batch without the key cache (K1's plain twin)
    and an ImplicitMeta batch with it (K2's once a key is pinned),
    through ``TorchCSP(device="cpu")``: the verdicts of ``SwCSP``."""
    rows = [r for rows in signed_sets(11, 4) for r in rows][:8]
    rows.append(("Org3", 0x7302, "member", b"tx-0") + SW.sign(
        SW.key_from_scalar("P-256", 0x7302), hashlib.sha256(b"tx-0")
        .digest()))                                    # expired member

    def policies(msp):
        subs = [P.SignaturePolicy(P.from_dsl(f"OR('{o}.member')"), msp)
                for o in ("Org1", "Org2", "Org3")]
        return subs[0], P.ImplicitMetaPolicy("MAJORITY", subs)

    def names(valid):
        return [(sd.identity.key.x, sd.r, sd.s) for sd in valid]

    sw_sub, sw_meta = policies(msps()[0])
    for cache, check in ((0, "set"), (256, "meta")):
        csp = TorchCSP(device="cpu", key_cache_size=cache)
        try:
            sub, meta = policies(msps(csp)[0])
            if check == "set":
                assert names(sub.verify_set(as_port(rows), NOW)) == \
                    names(sw_sub.verify_set(as_port(rows), NOW))
            else:
                assert meta.evaluate(as_port(rows), NOW) == \
                    sw_meta.evaluate(as_port(rows), NOW)
        finally:
            csp.close()


def test_verify_set_makes_one_batch_call_of_the_deduplicated_set():
    calls = []

    class Counting(SwCSP):
        def verify_batch(self, reqs):
            calls.append(len(reqs))
            return super().verify_batch(reqs)

    msp, _ = msps(Counting())
    rows = signed_sets(3, 1)[0]
    rows = rows + rows                     # every signer twice
    pol = P.SignaturePolicy(P.from_dsl(DSL[0]), msp)
    valid = pol.verify_set(as_port(rows), NOW)
    unique = {scalar for _, scalar, *_ in rows}
    live = {scalar for org, scalar, *_ in rows
            if (org, scalar) in {(o, s) for o, s, r, n in MEMBERS if not n}}
    assert calls == [len(live)] and len(valid) <= len(unique)
    calls.clear()
    meta = P.ImplicitMetaPolicy("ALL", [pol, pol, pol])
    meta.evaluate(as_port(rows), NOW)
    assert calls == [len(live)]
