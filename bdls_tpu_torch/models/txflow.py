"""The transaction flow as one deterministic assembly: endorse → order →
commit.

The reference's ``tests/test_gateway.py`` stack as a library, so that
the card's smoke run, the tests and a benchmark build the same network:
a :class:`~bdls_tpu_torch.models.peer.Gateway` endorsing on two orgs'
:class:`~bdls_tpu_torch.models.peer.PeerNode`\\ s, one BDLS
:class:`~bdls_tpu_torch.ordering.chain.Chain` a validator on a seeded
:class:`~bdls_tpu_torch.consensus.ipc.VirtualNetwork`, and each peer
pulling blocks from the chains' ledgers (:class:`ChainSource`) through
its ``BFTDeliverer`` into its ``Committer``. Everything runs on virtual
time, so a run is reproducible from its seeds and scalars.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from bdls_tpu_torch.consensus import Signer
from bdls_tpu_torch.consensus.ipc import VirtualNetwork
from bdls_tpu_torch.crypto.msp import Identity, LocalMSP
from bdls_tpu_torch.models.peer import Gateway, PeerNode
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import genesis_block
from bdls_tpu_torch.ordering.blockcutter import BatchConfig
from bdls_tpu_torch.ordering.chain import Chain
from bdls_tpu_torch.ordering.ledger import MemoryLedger
from bdls_tpu_torch.peer.validator import EndorsementPolicy

CHANNEL = "gwchan"
SIGNER_BASE = 8800
# (org, P-256 scalar) of the MSP's members; the first two are the peers
ORG_SCALARS = (("org1", 0xEE01), ("org2", 0xEE02), ("org3", 0xEE03))
CLIENT_ORG, CLIENT_SCALAR = "org1", 0xC0FE


class ChainSource:
    """An in-process ordering chain's ledger as a ``BlockSource``. Each
    ``get_block`` hands out a copy, as a deliver stream does: the
    committer writes its flags into the block it commits, and the
    orderer's ledger must keep its own bytes."""

    def __init__(self, chain: Chain):
        self.chain = chain

    def height(self) -> int:
        return self.chain.ledger.height()

    def get_block(self, n: int) -> Optional[pb.Block]:
        try:
            blk = self.chain.ledger.get(n)
        except Exception:
            return None
        return pb.Block.FromString(blk.SerializeToString())


def kv_put_contract(read, args):
    """A kv 'chaincode': args = [key, value] pairs flattened."""
    writes = []
    for i in range(0, len(args), 2):
        writes.append((args[i].decode(), args[i + 1]))
    return writes


def kv_increment_contract(read, args):
    key = args[0].decode()
    cur = read(key)
    val = int(cur or b"0") + 1
    return [(key, str(val).encode())]


@dataclass
class Stack:
    net: VirtualNetwork
    chains: list
    peers: list
    gateway: Gateway
    msp: LocalMSP
    genesis: pb.Block
    csp: object


def build_stack(csp, verifier=None, validators: int = 4,
                max_message_count: int = 10,
                batch_timeout: float = 0.2) -> Stack:
    """The reference's gateway stack over ``validators`` chains, on the
    reference test's network (seed 2, 10 ms links) and consensus latency
    (50 ms).

    ``csp`` serves the MSP, both peers and the gateway. Every chain
    shares ``verifier``; without one, each engine verifies on the card,
    and raises where there is none."""
    signers = [Signer.from_scalar(SIGNER_BASE + i) for i in range(validators)]
    participants = [s.identity for s in signers]
    net = VirtualNetwork(seed=2, latency=0.01)
    genesis = genesis_block(CHANNEL)
    chains = []
    for s in signers:
        ledger = MemoryLedger()
        ledger.append(genesis)
        chain = Chain(
            channel_id=CHANNEL, signer=s, participants=participants,
            ledger=ledger,
            batch_config=BatchConfig(max_message_count=max_message_count,
                                     batch_timeout=batch_timeout),
            verifier=verifier, latency=0.05,
        )
        net.add_node(chain)
        chains.append(chain)
    net.connect_all()

    sources = [ChainSource(c) for c in chains]
    msp = LocalMSP(csp)
    for org, scalar in ORG_SCALARS:
        msp.register(Identity(
            org=org, key=csp.key_from_scalar("P-256", scalar).public_key()))
    client = csp.key_from_scalar("P-256", CLIENT_SCALAR)
    msp.register(Identity(org=CLIENT_ORG, key=client.public_key()))
    peers = []
    for org, scalar in ORG_SCALARS[:2]:
        peer = PeerNode(
            channel_id=CHANNEL, csp=csp, org=org,
            signing_key=csp.key_from_scalar("P-256", scalar),
            genesis=genesis, orderer_sources=sources,
            policy=EndorsementPolicy(required=2), msp=msp,
        )
        peer.endorser.register_contract("kvput", kv_put_contract)
        peer.endorser.register_contract("incr", kv_increment_contract)
        peers.append(peer)
    gateway = Gateway(
        csp, client, CLIENT_ORG, peers,
        broadcast=lambda env: chains[0].submit(env, net.now),
        required_orgs=2,
    )
    return Stack(net, chains, peers, gateway, msp, genesis, csp)


def drive(net, peers, seconds: float = 20.0) -> None:
    """Run the network for ``seconds`` of virtual time, polling every
    peer's delivery each 0.5 virtual s."""
    t_end = net.now + seconds
    while net.now < t_end:
        net.run_until(net.now + 0.5)
        for p in peers:
            p.poll()


def drive_until(stack: Stack, height: int, max_virtual_s: float,
                max_wall_s: Optional[float] = None) -> bool:
    """Drive until every peer holds ``height`` blocks (genesis
    included), in the reference's steps of 0.5 virtual s; False if
    ``max_virtual_s`` of virtual time, or ``max_wall_s`` of the host
    clock, passes first."""
    t_end = stack.net.now + max_virtual_s
    wall_end = None if max_wall_s is None else (time.perf_counter()
                                                + max_wall_s)
    while True:
        if all(p.height() >= height for p in stack.peers):
            return True
        if stack.net.now >= t_end or (wall_end is not None
                                      and time.perf_counter() > wall_end):
            return False
        drive(stack.net, stack.peers, 0.5)

