"""Four of the port's ``OrdererNode``s over loopback TCP, on the CPU.

The reference's slow TCP test (``tests/test_registrar_node.py:
test_orderer_nodes_over_real_tcp``) on the port: four nodes in one
process, each with the port's host provider and
``verifier=CpuBatchVerifier()`` (without one the chains verify on the
card), exchange endpoints, join one channel and order 12 broadcast
transactions. Within a 60 s deadline every node's height reaches 2 or
more, the ledgers are byte-identical, every transaction is ordered once
and the cluster rejected no handshake. A late joiner, started two
blocks behind (one height behind, the engine's own decide message
closes the gap without a pull), catches up by pulling blocks over the
cluster and then commits blocks of its own. The node's consensus gauges are exported.
Every node is stopped in ``finally``.
"""

from __future__ import annotations

import time

import pytest

from bdls_tpu_torch.consensus import CpuBatchVerifier, Signer
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.models.orderer import OrdererNode
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.msgprocessor import (ErrBadSignature,
                                                  ErrPolicyViolation)
from bdls_tpu_torch.ordering.registrar import (make_channel_config,
                                               make_genesis)
from test_torch_registrar import tx_bytes

DEADLINE_S = 60.0
CHANNEL = "tcpchan"


def make_nodes(tmp_path, csp, n=4, base=7200):
    signers = [Signer.from_scalar(base + i) for i in range(n)]
    nodes = []
    try:
        for i, s in enumerate(signers):
            nodes.append(OrdererNode(signer=s,
                                     base_dir=str(tmp_path / f"node{i}"),
                                     csp=csp, verifier=CpuBatchVerifier()))
    except Exception:
        for node in nodes:
            node.stop()
        raise
    for a in nodes:
        for b in nodes:
            if a is not b:
                a.set_endpoint(b.identity, *b.address)
    genesis = make_genesis(make_channel_config(
        CHANNEL, [s.identity for s in signers], max_message_count=10,
        batch_timeout_s=0.15, writer_orgs=("org1",),
        consensus_latency_s=0.05))
    return nodes, genesis


def wait_mesh(nodes, deadline_s=30.0):
    """Every node connected to every other, twice half a second apart:
    a relay sent while the mesh forms is lost (both ends dial at once
    and each closes the older connection), and a transaction only one
    node holds is not ordered alone (Queue C, reference state)."""
    ids = {n.identity for n in nodes}
    deadline, seen = time.time() + deadline_s, 0
    while time.time() < deadline:
        if all(set(n.cluster.connected_peers()) >= ids - {n.identity}
               for n in nodes):
            seen += 1
            if seen == 2:
                return
        else:
            seen = 0
        time.sleep(0.5)
    raise AssertionError("the cluster mesh did not form: " + str(
        [len(n.cluster.connected_peers()) for n in nodes]))


def wait_heights(nodes, want, deadline):
    while time.time() < deadline:
        heights = [node.channel_height(CHANNEL) for node in nodes]
        if min(heights) >= want:
            return heights
        time.sleep(0.1)
    return [node.channel_height(CHANNEL) for node in nodes]


def common_ledger(nodes, height):
    raws = [[b.SerializeToString() for b in node.deliver(CHANNEL, 0,
                                                         height - 1)]
            for node in nodes]
    assert all(r == raws[0] for r in raws), "the ledgers differ"
    return raws[0]


def tx_ids(raws):
    ids = [pb.TxEnvelope.FromString(t).header.tx_id
           for raw in raws[1:] for t in pb.Block.FromString(raw)
           .data.transactions]
    assert len(ids) == len(set(ids)), "a transaction was ordered twice"
    return set(ids)


@pytest.mark.parametrize("provider", ("sw", "torch_cpu"))
def test_four_nodes_order_over_tcp(tmp_path, provider):
    csp = (SwCSP() if provider == "sw" else
           TorchCSP(device="cpu", kernel_field="sw", key_cache_size=0))
    nodes, genesis = make_nodes(tmp_path, csp)
    try:
        for node in nodes:
            node.join_channel(genesis)
            node.start()
        wait_mesh(nodes)
        for i in range(12):
            nodes[i % 4].broadcast(tx_bytes(i, channel=CHANNEL))
        with pytest.raises(ErrBadSignature):
            nodes[0].broadcast(tx_bytes(90, channel=CHANNEL, tamper=True))
        with pytest.raises(ErrPolicyViolation):
            nodes[1].broadcast(tx_bytes(91, channel=CHANNEL, org="org2"))
        heights = wait_heights(nodes, 2, time.time() + DEADLINE_S)
        assert min(heights) >= 2, f"no progress over TCP: {heights}"
        # wait for every transaction, then hold the ledgers equal
        deadline = time.time() + DEADLINE_S
        while time.time() < deadline:
            h = min(node.channel_height(CHANNEL) for node in nodes)
            if len(tx_ids(common_ledger(nodes, h))) == 12:
                break
            time.sleep(0.1)
        ids = tx_ids(common_ledger(nodes, h))
        assert ids == {f"tx-{i}" for i in range(12)}
        assert all(node.cluster.stats["auth_fail"] == 0 for node in nodes)
        node0 = nodes[0]
        assert node0._g_cluster.value((CHANNEL,)) == 4
        assert node0._g_block.value((CHANNEL,)) >= 1
        assert node0._g_active.value((CHANNEL,)) == 4
        assert [c.name for c in node0.list_channels()] == [CHANNEL]
    finally:
        for node in nodes:
            node.stop()
        if provider != "sw":
            csp.close()


def test_a_late_joiner_pulls_then_consents(tmp_path):
    nodes, genesis = make_nodes(tmp_path, SwCSP(), base=7300)
    late = nodes[3]
    try:
        for node in nodes[:3]:
            node.join_channel(genesis)
            node.start()
        wait_mesh(nodes)
        for i in range(20):
            nodes[i % 3].broadcast(tx_bytes(i, channel=CHANNEL))
        heights = wait_heights(nodes[:3], 3, time.time() + DEADLINE_S)
        assert min(heights) >= 3, heights
        late.join_channel(genesis)
        chain = late.registrar.chains[CHANNEL]
        pulled = []
        real = chain.receive_pulled_block

        def counted(block_bytes, now):
            ok = real(block_bytes, now)
            pulled.append(ok)
            return ok

        chain.receive_pulled_block = counted
        late.start()
        # a second wave, after the join: the heights it decides reach
        # the late joiner, which pulls the blocks it missed
        for i in range(20, 50):
            nodes[i % 3].broadcast(tx_bytes(i, channel=CHANNEL))
        deadline = time.time() + DEADLINE_S
        while time.time() < deadline:
            hs = [node.channel_height(CHANNEL) for node in nodes]
            if len(set(hs)) == 1 and len(tx_ids(common_ledger(
                    nodes, hs[0]))) == 50:
                break
            time.sleep(0.1)
        hs = [node.channel_height(CHANNEL) for node in nodes]
        assert len(set(hs)) == 1, hs
        assert tx_ids(common_ledger(nodes, hs[0])) == \
            {f"tx-{i}" for i in range(50)}
        assert any(pulled), "the late joiner pulled no block"
        assert sum(pulled) < hs[0] - 1, "every block came by pull"
    finally:
        for node in nodes:
            node.stop()


def test_phase_6k_rehearsed_on_the_cpu():
    """``chip_smoke.py:drive_orderer`` (phase 6k) at 120 transactions in
    40-tx blocks on ``SwCSP`` and ``CpuBatchVerifier``: the late joiner,
    the hostile broadcasts, the byte-equal ledgers, the AES known
    answers and the 32 MB frame, every check the card's run makes but
    its launches."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    row = chip_smoke.drive_orderer("cpu", n_tx=120, make_csp=SwCSP,
                                   verifier=CpuBatchVerifier(),
                                   max_message_count=40,
                                   batch_timeout_s=0.5)
    assert row["valid"] == 119 and row["hostile"] == {"bad_sig": 1,
                                                      "bad_org": 0}
    assert sum(b["txs"] for b in row["blocks"]) == 119
    assert row["late_joiner"]["pulled_blocks"] >= 1
    assert row["auth_fail"] == [0, 0, 0, 0]
    assert row["aes_gcm_max_frame"]["kat"] == 56
