"""The port's engine posts the reference engine's frames, byte for byte.

Two networks on the same ``VirtualNetwork`` seed, one of reference
engines (``bdls_tpu.consensus``), one of the port's
(``bdls_tpu_torch.consensus``), the same signer scalars, proposals and
drive: every frame either posts is logged as (virtual time, source,
destination, bytes), and the two logs must be equal, as must every
node's decided (height, round, state) at the end. That holds the engine,
the wire codec, the virtual network's seeded draws and the aggregate
mode's BLS votes and certificates against the reference at once.

The reference signs with OpenSSL's random nonce, so here its signer is a
test-local subclass of its ``Signer`` that signs with the port's
deterministic nonce (``bdls_tpu_torch.consensus.identity.sign_payload``)
and returns the reference's own ``wire_pb2`` envelope; the JAX package is
not touched. Both sides verify on the host (``CpuBatchVerifier``).

Settings: 4 nodes to 3 heights; 7 nodes with jitter 0.005, loss 0.02
and one crashed, to 3 heights; 4 nodes in aggregate mode (a BLS vote on
each <commit>, one certificate a <decide>) to 2 heights.
"""

from __future__ import annotations

import pytest

from bdls_tpu.consensus import Config as JConfig
from bdls_tpu.consensus import Consensus as JConsensus
from bdls_tpu.consensus import Signer as JSigner
from bdls_tpu.consensus import threshold as JTH
from bdls_tpu.consensus import wire_pb2
from bdls_tpu.consensus.ipc import VirtualNetwork as JNetwork
from bdls_tpu.consensus.verifier import CpuBatchVerifier as JCpu
from bdls_tpu_torch.consensus import Config, Consensus, CpuBatchVerifier, \
    Signer
from bdls_tpu_torch.consensus import threshold as TH
from bdls_tpu_torch.consensus.identity import sign_payload
from bdls_tpu_torch.consensus.ipc import VirtualNetwork
from bdls_tpu_torch.crypto.sw import KeyHandle


class DeterministicSigner(JSigner):
    """The reference's signer with the port's deterministic nonce."""

    def sign_payload(self, payload: bytes) -> wire_pb2.SignedEnvelope:
        d = self.private_key.private_numbers().private_value
        env = sign_payload(KeyHandle("secp256k1", d), payload)
        out = wire_pb2.SignedEnvelope()
        out.version, out.payload = env.version, env.payload
        out.pub_x, out.pub_y = env.pub_x, env.pub_y
        out.sig_r, out.sig_s = env.sig_r, env.sig_s
        return out


SIDES = {
    "reference": (DeterministicSigner, JConfig, JConsensus, JNetwork, JCpu,
                  JTH),
    "port": (Signer, Config, Consensus, VirtualNetwork, CpuBatchVerifier,
             TH),
}


def run(side: str, n: int, heights: int, seed: int, jitter=0.0, loss=0.0,
        crashed=(), aggregate=False):
    signer_cls, config, consensus, network, cpu, th = SIDES[side]
    signers = [signer_cls.from_scalar(1000 + i) for i in range(n)]
    participants = [s.identity for s in signers]
    net = network(seed=seed, latency=0.01, jitter=jitter, loss=loss)
    frames = []
    post = net.post

    def logged(src, dst, data):
        frames.append((net.now, src, dst, bytes(data)))
        post(src, dst, data)

    net.post = logged
    votes = [th.VoteSigner.from_seed(0xB100 + i) for i in range(n)]
    for i, s in enumerate(signers):
        kw = {}
        if aggregate:
            kw = dict(vote_mode="aggregate", vote_signer=votes[i],
                      vote_aggregator=th.ThresholdAggregator(
                          [v.pk for v in votes], 2 * ((n - 1) // 3) + 1))
        net.add_node(consensus(config(
            epoch=0.0, signer=s, participants=participants,
            state_compare=lambda a, b: (a > b) - (a < b),
            state_validate=lambda s_, h_: True, latency=0.05,
            verifier=cpu(), **kw)))
    net.connect_all()
    for i in crashed:
        net.partitioned.add(i)
    alive = [k for k in range(n) if k not in crashed]
    t = 0.0
    while min(net.heights()[k] for k in alive) < heights and t < 120.0:
        for k in alive:
            node = net.nodes[k]
            node.propose(b"h%d" % (node.latest_height + 1))
        t += 0.5
        net.run_until(t)
    states = [(node.latest_height, node.latest_round,
               bytes(node.latest_state or b"")) for node in net.nodes]
    return frames, states, net


SETTINGS = {
    "4_nodes": dict(n=4, heights=3, seed=4),
    "7_nodes_lossy_one_crashed": dict(n=7, heights=3, seed=7, jitter=0.005,
                                      loss=0.02, crashed=(6,)),
    "4_nodes_aggregate": dict(n=4, heights=2, seed=5, aggregate=True),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_port_posts_the_reference_frames(name):
    cfg = SETTINGS[name]
    ref_frames, ref_states, ref_net = run("reference", **cfg)
    frames, states, net = run("port", **cfg)
    alive = [k for k in range(cfg["n"]) if k not in cfg.get("crashed", ())]
    assert min(ref_net.heights()[k] for k in alive) >= cfg["heights"]
    assert len(frames) == len(ref_frames)
    for i, (got, want) in enumerate(zip(frames, ref_frames)):
        assert got == want, f"frame {i} of {len(frames)}"
    assert states == ref_states
    assert (net.tx_msgs, net.tx_bytes, net.dropped_msgs) == (
        ref_net.tx_msgs, ref_net.tx_bytes, ref_net.dropped_msgs)
    if cfg.get("aggregate"):
        # the decides carry certificates, not proof lists
        from bdls_tpu_torch.consensus import wire_codec as W

        decides = [W.decode_message(W.decode_envelope(f[3]).payload)
                   for f in frames]
        decides = [m for m in decides if m.type == W.MsgType.DECIDE]
        assert decides and all(m.commit_cert and not m.proof
                               for m in decides)
