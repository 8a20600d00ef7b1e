"""The BDLS engine on the port: every case of ``tests/test_engine.py``.

The same protocol conformance cases, on ``bdls_tpu_torch.consensus``
(its engine, wire codec, virtual network and errors), each node with the
explicit host verifier ``CpuBatchVerifier()`` (the port's engine
verifies on the card when ``Config`` names no verifier). The 13-node
cell of the scale matrix rides the slow tier, as in the reference. Two
cases the reference has not: the oversized-field case runs the port's
``TorchBatchVerifier`` on the CPU, and the default verifier raises where
there is no card.
"""

import pytest
import torch

from bdls_tpu_torch.consensus import (
    Config,
    Consensus,
    CpuBatchVerifier,
    Signer,
    state_hash,
)
from bdls_tpu_torch.consensus import errors as E
from bdls_tpu_torch.consensus import wire_codec as W
from bdls_tpu_torch.consensus.ipc import VirtualNetwork

LATENCY = 0.05


def make_cluster(n, seed=0, epoch=0.0, net_latency=0.01, jitter=0.0, loss=0.0):
    signers = [Signer.from_scalar(1000 + i) for i in range(n)]
    participants = [s.identity for s in signers]
    net = VirtualNetwork(seed=seed, latency=net_latency, jitter=jitter, loss=loss)
    for s in signers:
        cfg = Config(
            epoch=epoch,
            signer=s,
            participants=participants,
            state_compare=lambda a, b: (a > b) - (a < b),
            state_validate=lambda s_, h_: True,
            latency=LATENCY,
            verifier=CpuBatchVerifier(),
        )
        node = Consensus(cfg)
        net.add_node(node)
    net.connect_all()
    return net


def test_config_validation():
    s = Signer.from_scalar(7)
    with pytest.raises(E.ErrConfigParticipants):
        Consensus(
            Config(
                epoch=0.0,
                signer=s,
                participants=[s.identity] * 3,
                state_compare=lambda a, b: 0,
                state_validate=lambda x, h: True,
                verifier=CpuBatchVerifier(),
            )
        )
    with pytest.raises(E.ErrConfigStateCompare):
        Consensus(
            Config(
                epoch=0.0,
                signer=s,
                participants=[s.identity] * 4,
                state_validate=lambda x, h: True,
                verifier=CpuBatchVerifier(),
            )
        )


def test_default_verifier_is_the_card_and_raises_without_one():
    """A deliberate difference from the reference, which falls back to
    its serial CPU verifier: without a verifier in ``Config`` the
    engine verifies on the card, and where there is none it raises at
    construction, never verifying on the host unasked."""
    s = Signer.from_scalar(7)
    cfg = Config(epoch=0.0, signer=s, participants=[s.identity] * 4,
                 state_compare=lambda a, b: 0,
                 state_validate=lambda x, h: True)
    if torch.cuda.is_available():
        from bdls_tpu_torch.consensus import TorchBatchVerifier

        node = Consensus(cfg)
        assert isinstance(node.verifier, TorchBatchVerifier)
        assert node.verifier.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            Consensus(cfg)


def test_four_nodes_decide_one_height():
    net = make_cluster(4)
    for node in net.nodes:
        node.propose(b"block-1")
    net.run_until(5.0)
    assert net.heights() == [1, 1, 1, 1]
    states = {n.latest_state for n in net.nodes}
    assert states == {b"block-1"}
    for n in net.nodes:
        assert n.current_proof() is not None


def test_four_nodes_progress_many_heights():
    net = make_cluster(4)
    target = 5
    t = 0.0
    while min(net.heights()) < target and t < 120.0:
        for node in net.nodes:
            node.propose(b"block-%d" % (node.latest_height + 1))
        t += 1.0
        net.run_until(t)
    assert min(net.heights()) >= target


def test_conflicting_proposals_converge():
    net = make_cluster(4)
    for i, node in enumerate(net.nodes):
        node.propose(b"proposal-from-%d" % i)
    net.run_until(10.0)
    assert net.heights() == [1, 1, 1, 1]
    assert len({n.latest_state for n in net.nodes}) == 1


def test_one_crashed_node_of_four_still_decides():
    # t = (4-1)//3 = 1 -> tolerates 1 failure
    net = make_cluster(4)
    net.partitioned.add(3)
    for i in range(3):
        net.nodes[i].propose(b"payload")
    net.run_until(15.0)
    assert all(h >= 1 for h in net.heights()[:3])


def test_crashed_leader_triggers_view_change():
    # node 1 is the leader of round 1 at height 1 (participants[r % n]);
    # round 0's leader is node 0 — crash node 0 so rounds must advance.
    net = make_cluster(4)
    net.partitioned.add(0)
    for i in range(1, 4):
        net.nodes[i].propose(b"after-leader-crash")
    net.run_until(30.0)
    assert all(h >= 1 for h in net.heights()[1:])
    assert {net.nodes[i].latest_state for i in (1, 2, 3)} == {b"after-leader-crash"}


def test_two_crashes_of_four_stall():
    net = make_cluster(4)
    net.partitioned.update({2, 3})
    for i in range(2):
        net.nodes[i].propose(b"never-decides")
    net.run_until(20.0)
    assert net.heights()[:2] == [0, 0]


def test_message_loss_recovers():
    net = make_cluster(4, seed=42, loss=0.10)
    for node in net.nodes:
        node.propose(b"lossy")
    net.run_until(60.0)
    assert all(h >= 1 for h in net.heights())


def test_seven_nodes():
    net = make_cluster(7)
    for node in net.nodes:
        node.propose(b"seven")
    net.run_until(10.0)
    assert all(h >= 1 for h in net.heights())


def test_non_participant_rejected():
    net = make_cluster(4)
    outsider = Signer.from_scalar(99999)
    env = outsider.sign_payload(b"\x08\x01")  # arbitrary payload
    err_box = []
    try:
        net.nodes[0].receive_message(W.encode(env), 0.0)
    except E.ErrMessageUnknownParticipant:
        err_box.append(True)
    assert err_box


def test_bad_signature_rejected():
    net = make_cluster(4)
    node = net.nodes[0]
    signer = Signer.from_scalar(1001)  # participant 1
    env = signer.sign_payload(b"\x08\x01")
    env.sig_r = (int.from_bytes(env.sig_r, "big") ^ 1).to_bytes(32, "big")
    with pytest.raises(E.ErrMessageSignature):
        node.receive_message(W.encode(env), 0.0)


def test_message_validator_hook():
    # the engine-level fault-injection seam (reference config.go:40)
    rejected = []

    net = make_cluster(4)
    node = net.nodes[0]
    node._cfg.message_validator = lambda c, m, env: (rejected.append(m.type), False)[1]
    signer = Signer.from_scalar(1001)

    m = W.ConsensusMessage()
    m.type = W.MsgType.ROUND_CHANGE
    m.height = 1
    m.round = 0
    m.state = b"x"
    env = signer.sign_payload(W.encode(m))
    with pytest.raises(E.ErrMessageValidator):
        node.receive_message(W.encode(env), 0.0)
    assert rejected


def test_decide_validation_for_nonparticipants():
    net = make_cluster(4)
    for node in net.nodes:
        node.propose(b"observed")
    net.run_until(5.0)
    proof = net.nodes[0].current_proof()
    assert proof is not None
    # a fresh engine configured with the same participants can validate
    fresh = make_cluster(4).nodes[0]
    fresh.validate_decide_message(W.encode(proof), b"observed")
    with pytest.raises(E.ErrMismatchedTargetState):
        fresh.validate_decide_message(W.encode(proof), b"wrong")


def test_propose_dedup():
    net = make_cluster(4)
    node = net.nodes[0]
    node.propose(b"dup")
    node.propose(b"dup")
    assert len(node.unconfirmed) == 1
    assert node.has_proposed(b"dup")
    assert not node.has_proposed(b"other")


def test_state_hash_none_equals_empty():
    assert state_hash(None) == state_hash(b"")


def test_oversized_wire_fields_rejected_not_crash():
    """A malicious envelope with >32-byte sig/pubkey fields must yield a
    typed rejection on every verifier, never an unhandled OverflowError.
    The bucket verifier is the port's ``TorchBatchVerifier`` on the CPU
    (its plain twin), where the reference runs ``TpuBatchVerifier``."""
    from bdls_tpu_torch.consensus import TorchBatchVerifier

    net = make_cluster(4)
    node = net.nodes[0]
    signer = Signer.from_scalar(1001)
    env = signer.sign_payload(b"\x08\x01")
    env.sig_r = b"\x01" * 40  # 320-bit "signature"
    with pytest.raises(E.ConsensusError):
        node.receive_message(W.encode(env), 0.0)

    env2 = signer.sign_payload(b"\x08\x01")
    env2.pub_y = env2.pub_y + b"\x00\x00"  # 34-byte axis
    with pytest.raises(E.ConsensusError):
        node.receive_message(W.encode(env2), 0.0)

    # the TPU bucket verifier screens the same inputs to False lanes
    bad = signer.sign_payload(b"payload")
    bad.sig_s = b"\xff" * 33
    good = signer.sign_payload(b"payload")
    v = TorchBatchVerifier(buckets=(8,), device="cpu")
    assert v.verify_envelopes([good, bad]) == [True, False]


def test_decide_proof_resync_recovers_lossy_split():
    """The docs/ROBUSTNESS.md liveness edge, now closed: two nodes
    decide height 2 while the other two lose every ``<decide>`` — a
    2/2 split with no quorum on either side. The deciders must
    retransmit the decide (``_maybe_resync_decide``, triggered by
    straggler traffic at or below their decided height) so the
    stragglers catch up once the loss clears; nothing else in the
    protocol ever retransmits a decide."""
    net = make_cluster(4)
    for node in net.nodes:
        node.propose(b"h1")
    net.run_until(2.0)
    assert net.heights() == [1, 1, 1, 1]

    # loss window: nodes 2 and 3 drop every DECIDE — direct broadcast,
    # neighbour propagation, and resync-replayed copies alike
    def drop_decide(c, m, env):
        return m.type != W.MsgType.DECIDE

    for i in (2, 3):
        net.nodes[i]._cfg.message_validator = drop_decide

    for node in net.nodes:
        node.propose(b"h2")
    net.run_until(7.0)
    # the split stall: the deciders sit at 2 waiting for a quorum of 3
    # at height 3, the stragglers round-change forever at height 2
    assert sorted(net.heights()) == [1, 1, 2, 2]

    # loss clears — nothing new is proposed, so only the deciders'
    # straggler-triggered resync can deliver the missing decide
    for i in (2, 3):
        net.nodes[i]._cfg.message_validator = None
    t = 7.0
    while t < 40.0 and not all(h >= 2 for h in net.heights()):
        t += 1.0
        net.run_until(t)
    assert all(h >= 2 for h in net.heights()), net.heights()
    assert len({bytes(n.latest_state) for n in net.nodes}) == 1


@pytest.mark.parametrize("n,jitter,loss,crashes", [
    (4, 0.0, 0.0, 0),
    (7, 0.005, 0.02, 1),
    (10, 0.01, 0.05, 2),
    # the 13-node cell is the same code path at ~2x the 10-node cost;
    # it rides the slow tier so tier-1 keeps the 4/7/10 coverage
    pytest.param(13, 0.005, 0.02, 4, marks=pytest.mark.slow),
])
def test_scale_and_fault_matrix(n, jitter, loss, crashes):
    """SURVEY §4.2 matrix: participant counts with latency jitter,
    message loss, and up to t crashed nodes — the upstream engine's
    4→20+ participant failure/latency suite. Liveness: the honest
    majority keeps deciding; safety: one state per height."""
    t = (n - 1) // 3
    assert crashes <= t
    net = make_cluster(n, seed=n, jitter=jitter, loss=loss)
    for i in range(crashes):
        net.partitioned.add(n - 1 - i)
    alive = [node for i, node in enumerate(net.nodes)
             if i not in net.partitioned]
    decided: dict[int, set] = {}
    seen = {id(node): 0 for node in alive}
    tnow = 0.0
    while tnow < 240.0:
        for node in alive:
            node.propose(b"h%d" % (node.latest_height + 1))
        tnow += 1.0
        net.run_until(tnow)
        for node in alive:
            if node.latest_height > seen[id(node)]:
                seen[id(node)] = node.latest_height
                decided.setdefault(node.latest_height, set()).add(
                    bytes(node.latest_state))
        if min(seen.values()) >= 3:
            break
    assert min(seen.values()) >= 3, (n, jitter, loss, crashes)
    for h, states in decided.items():
        assert len(states) == 1, f"fork at height {h} (n={n})"
