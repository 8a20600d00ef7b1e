"""Byzantine fault-injection tests for the BDLS engine on the port.

Every case of ``tests/test_byzantine.py``, on ``bdls_tpu_torch.consensus``
(the clusters of ``tests/test_torch_engine.py``: the host verifier
``CpuBatchVerifier()`` on every node), with the port's wire codec where
the reference builds ``wire_pb2`` messages. The reference's notes:

Model: SURVEY.md §4.2 — the reference's deterministic harness with
byzantine/failure matrices; ``Config.MessageValidator`` /
``MessageOutCallback`` (reference config.go:40-43) are the built-in
interception seams, and adversarial messages are crafted directly with
a participant's signer (the wire format is attacker-writable by
construction). The upstream repo ships NO such suite for its plugin —
this one exercises equivocation, proof tampering, cross-height replay,
leader forgery, and stale-round flooding against the engine's
dedup/OOM defenses (consensus.go:1246-1280 parity).
"""

import pytest

from bdls_tpu_torch.consensus import Signer
from bdls_tpu_torch.consensus import errors as E
from bdls_tpu_torch.consensus import wire_codec as W

from test_torch_engine import make_cluster


def craft(signer, mtype, height, round_, state=b"", proofs=()):
    m = W.ConsensusMessage()
    m.type = mtype
    m.height = height
    m.round = round_
    m.state = state
    for p in proofs:
        m.proof.append(W.copy_envelope(p))
    return signer.sign_payload(W.encode(m))


def test_equivocating_participant_cannot_split_agreement():
    """One byzantine participant sends CONFLICTING round-change states
    to different honest nodes each round; the honest quorum must still
    agree on one state per height (safety), because every decision
    carries 2t+1 re-verified proofs."""
    net = make_cluster(4)
    byz = Signer.from_scalar(1003)         # participant 3's key
    net.partitioned.add(3)                 # its engine never speaks

    honest = net.nodes[:3]
    for i, node in enumerate(honest):
        node.propose(b"state-%d" % i)

    decided: dict[int, dict[int, bytes]] = {}   # height -> node -> state
    seen_h = [0, 0, 0]
    now = 0.0
    for step in range(400):
        now = round(now + 0.25, 9)
        for i, n in enumerate(honest):
            n.propose(b"state-%d-h%d" % (i, n.latest_height + 1))
        # byzantine: tell node 0 "A", node 1 "B" at the current round
        h = honest[0].latest_height + 1
        for dst, state in ((0, b"byz-A"), (1, b"byz-B")):
            env = craft(byz, W.MsgType.ROUND_CHANGE, h,
                        honest[dst].current_round.number, state)
            try:
                honest[dst].receive_message(W.encode(env), now)
            except E.ConsensusError:
                pass
        net.run_until(now)
        for i, n in enumerate(honest):
            if n.latest_height > seen_h[i]:
                seen_h[i] = n.latest_height
                decided.setdefault(n.latest_height, {})[i] = \
                    bytes(n.latest_state)
        if min(seen_h) >= 3:
            break
    assert min(seen_h) >= 3
    # SAFETY: at every height every honest node decided the SAME state
    for h, per_node in decided.items():
        assert len(set(per_node.values())) == 1, \
            f"fork at height {h}: {per_node}"


def test_tampered_decide_proof_rejected():
    net = make_cluster(4)
    for node in net.nodes:
        node.propose(b"agreed")
    net.run_until(5.0)
    proof = net.nodes[0].current_proof()
    assert proof is not None

    fresh = make_cluster(4).nodes[0]
    # flip one byte inside an embedded commit proof's signature
    m = W.decode_message(proof.payload)
    assert m.proof
    m.proof[0].sig_r = bytes(
        b ^ (1 if i == 0 else 0) for i, b in enumerate(m.proof[0].sig_r))
    tampered = W.copy_envelope(proof)
    tampered.payload = W.encode(m)
    # NOTE: the outer envelope signature no longer matches either — both
    # rejection paths are typed errors, never a crash or acceptance
    with pytest.raises(E.ConsensusError):
        fresh.validate_decide_message(W.encode(tampered), b"agreed")

    # resign the outer envelope with a participant key: the inner proof
    # signature is still garbage and must be caught by re-verification
    resigner = Signer.from_scalar(1001)
    resigned = resigner.sign_payload(W.encode(m))
    with pytest.raises(E.ConsensusError):
        fresh.validate_decide_message(W.encode(resigned), b"agreed")


def test_replayed_roundchange_from_past_height_rejected():
    """Messages captured at height h must be inert when replayed after
    the network advanced (no state regression, typed rejection)."""
    captured = []
    net = make_cluster(4)
    net.nodes[0]._cfg.message_out_callback = \
        lambda m, env: captured.append(W.encode(env))
    for node in net.nodes:
        node.propose(b"v1")
    net.run_until(5.0)
    assert net.nodes[1].latest_height >= 1 and captured

    for node in net.nodes:
        node.propose(b"v2")
    net.run_until(10.0)
    h_before = net.nodes[1].latest_height
    state_before = net.nodes[1].latest_state
    replay_errors = 0
    for raw in captured[:20]:
        try:
            net.nodes[1].receive_message(raw, 10.0)
        except E.ConsensusError:
            replay_errors += 1
    assert net.nodes[1].latest_height == h_before
    assert net.nodes[1].latest_state == state_before
    assert replay_errors > 0   # stale-height messages get typed errors


def test_select_forged_by_non_leader_rejected():
    net = make_cluster(4)
    node = net.nodes[0]
    rnd = node.current_round.number
    leader = node.participants[rnd % len(node.participants)]
    non_leader = next(
        s for s in (Signer.from_scalar(1000 + i) for i in range(4))
        if s.identity != leader and s.identity != node.identity)
    env = craft(non_leader, W.MsgType.SELECT,
                node.latest_height + 1, rnd, b"forged")
    with pytest.raises(E.SelectError):
        node.receive_message(W.encode(env), 0.0)


def test_stale_round_flood_is_bounded():
    """A byzantine participant floods round-changes across hundreds of
    rounds; the engine keeps only the sender's highest round (the
    dedup/OOM defense, consensus.go:1246-1280) so memory stays flat.
    The dedup invariant holds for any flood length >= 2; 500 keeps the
    per-message sign+verify cost inside the tier-1 budget."""
    net = make_cluster(4)
    node = net.nodes[0]
    byz = Signer.from_scalar(1003)
    h = node.latest_height + 1
    for rnd in range(500):
        env = craft(byz, W.MsgType.ROUND_CHANGE, h, rnd,
                    b"flood-%d" % rnd)
        try:
            node.receive_message(W.encode(env), 0.0)
        except E.ConsensusError:
            pass
    # only ONE retained round-change for this sender across all rounds
    bx, by = byz.pub_xy
    total = sum(
        1 for r in node.rounds.values()
        for t in r.round_changes
        if t.signed.pub_x == bx and t.signed.pub_y == by
    )
    assert total <= 1, f"flood retained {total} entries"
