"""The port's ordering service (``bdls_tpu_torch/ordering``) against the
JAX package, on the CPU.

- ``block``: header and data hashes, the signed tx digest, blocks and
  the genesis block, byte for byte; ``BlockCreator`` and the chain-link
  checks with the reference's messages;
- ``blockcutter``: the same batches on a seeded stream of messages;
- ``ledger``: ``MemoryLedger`` order, ``LedgerFactory``'s channels;
- ``chain``: four validators in each package on the same seeded virtual
  network, the reference's signing with the port's deterministic nonce
  (as ``tests/test_torch_engine_framelog.py`` does), through the
  reference's ordering scenarios: transactions from every node, a batch
  cut by its timer, a config transaction in a block of its own, a
  malformed envelope dropped, a partitioned node catching up by pulling
  blocks whose proofs ``wire_codec`` reads, a restart from a
  ``FileLedger``. Every ledger of the port holds the reference's bytes,
  consensus proofs included; pulled blocks without a valid proof are
  refused alike; a chain built without a verifier verifies on the card
  and raises here.

Every comparison is exact.
"""

from __future__ import annotations

import random

import pytest

from bdls_tpu.consensus import Signer as JSigner
from bdls_tpu.consensus import wire_pb2
from bdls_tpu.consensus.ipc import VirtualNetwork as JNetwork
from bdls_tpu.consensus.verifier import CpuBatchVerifier as JCpu
from bdls_tpu.ordering import block as JB
from bdls_tpu.ordering import blockcutter as JBC
from bdls_tpu.ordering import fabric_pb2 as jpb
from bdls_tpu.ordering import ledger as JLG
from bdls_tpu.ordering.chain import Chain as JChain
from bdls_tpu_torch.consensus import CpuBatchVerifier, Signer
from bdls_tpu_torch.consensus.identity import sign_payload
from bdls_tpu_torch.consensus.ipc import VirtualNetwork
from bdls_tpu_torch.crypto.sw import KeyHandle, SwCSP
from bdls_tpu_torch.ordering import block as B
from bdls_tpu_torch.ordering import blockcutter as BC
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering import ledger as LG
from bdls_tpu_torch.ordering.chain import Chain

SW = SwCSP()
CLIENT = SW.key_from_scalar("P-256", 0xA11CE)
CHANNEL = "testchannel"


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


def make_tx(i: int, config: bool = False) -> bytes:
    env = pb.TxEnvelope()
    env.header.type = pb.TxType.TX_CONFIG if config else pb.TxType.TX_NORMAL
    env.header.channel_id = CHANNEL
    env.header.tx_id = f"tx-{i}"
    env.header.timestamp_unix_ms = 1000 + i
    pub = CLIENT.public_key()
    env.header.creator_x = pub.x.to_bytes(32, "big")
    env.header.creator_y = pub.y.to_bytes(32, "big")
    env.header.creator_org = "org1"
    env.payload = f"payload-{i}".encode() * (1 + i % 3)
    r, s = SW.sign(CLIENT, B.tx_digest(env))
    env.sig_r = r.to_bytes(32, "big")
    env.sig_s = s.to_bytes(32, "big")
    return env.SerializeToString()


# ---- block, cutter, ledgers -------------------------------------------------

def test_block_helpers_match_reference():
    txs = [make_tx(i) for i in range(5)]
    assert B.data_hash(txs) == JB.data_hash(txs)
    for raw in txs + [make_tx(9, config=True)]:
        assert B.tx_digest(pb.TxEnvelope.FromString(raw)) == \
            JB.tx_digest(jpb.TxEnvelope.FromString(raw))
    for ch in ("c", "testchannel", "ünï"):
        g, jg = B.genesis_block(ch, b"cfg"), JB.genesis_block(ch, b"cfg")
        assert g.SerializeToString() == jg.SerializeToString()
        assert B.header_hash(g.header) == JB.header_hash(jg.header)
    g = B.genesis_block(CHANNEL)
    jg = JB.genesis_block(CHANNEL)
    creator, jcreator = B.BlockCreator(g.header), JB.BlockCreator(jg.header)
    blk, jblk = creator.create_next(txs), jcreator.create_next(txs)
    assert blk.SerializeToString() == jblk.SerializeToString()
    assert B.make_block(7, b"p" * 32, txs).SerializeToString() == \
        JB.make_block(7, b"p" * 32, txs).SerializeToString()
    creator.advance(blk)
    jcreator.advance(jblk)
    assert (creator.number, creator.prev_hash) == \
        (jcreator.number, jcreator.prev_hash)
    assert B.validate_chain_link(blk, g.header) is None

    def variants(mod, base, gen):
        out = []
        for field, value in (("number", 5), ("previous_hash", b"x"),
                             ("data_hash", b"y")):
            b = mod.Block()
            b.CopyFrom(base)
            setattr(b.header, field, value)
            out.append(b)
        empty = mod.Block()
        empty.CopyFrom(base)
        del empty.data.transactions[:]
        empty.header.data_hash = (B if mod is pb else JB).data_hash([])
        out.append(empty)
        return out

    got = [B.validate_chain_link(b, g.header) for b in variants(pb, blk, g)]
    want = [JB.validate_chain_link(b, jg.header)
            for b in variants(jpb, jblk, jg)]
    assert got == want and all(got)


def test_blockcutter_matches_reference_on_a_seeded_stream():
    rng = random.Random(19)
    cfg = dict(max_message_count=7, preferred_max_bytes=900,
               absolute_max_bytes=4000, batch_timeout=1.0)
    cut, jcut = BC.BlockCutter(BC.BatchConfig(**cfg)), \
        JBC.BlockCutter(JBC.BatchConfig(**cfg))
    for i in range(400):
        msg = bytes([i % 251]) * rng.choice([10, 50, 200, 950, 1200])
        assert cut.ordered(msg) == jcut.ordered(msg)
        if i % 37 == 0:
            assert cut.cut() == jcut.cut()
    assert cut.cut() == jcut.cut()
    assert BC.BatchConfig() == BC.BatchConfig(**{
        k: getattr(JBC.BatchConfig(), k) for k in cfg})


def test_ledgers_match_reference(tmp_path):
    mem = LG.MemoryLedger()
    with pytest.raises(LG.LedgerError):
        mem.append(B.make_block(1, b"", [b"x"]))
    mem.append(B.genesis_block(CHANNEL))
    assert mem.last_block().header.number == 0
    assert [b.header.number for b in mem.iterator()] == [0]
    with pytest.raises(LG.LedgerError):
        mem.get(4)
    views = []
    for mod in (LG, JLG):
        base = tmp_path / mod.__name__.replace(".", "_")
        fac = mod.LedgerFactory(str(base))
        fac.get_or_create("alpha").append(
            (pb if mod is LG else jpb).Block.FromString(
                B.genesis_block("alpha").SerializeToString()))
        (base / "beta.joinblock").write_bytes(b"")
        (base / "gamma").mkdir()
        views.append((fac.channel_ids(),
                      fac.get_or_create("alpha").height(),
                      (base / "alpha" / "blocks.seg").read_bytes()))
        assert fac.get_or_create("alpha") is fac.get_or_create("alpha")
        assert isinstance(mod.LedgerFactory().get_or_create("x"),
                          mod.MemoryLedger)
    assert views[0] == views[1]
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "blocks.seg").write_bytes(b"NOPE")
    with pytest.raises(LG.LedgerError):
        LG.FileLedger(str(bad))


# ---- the chain, in both packages --------------------------------------------

SIDES = {
    "reference": (DeterministicSigner, JNetwork, JChain, JCpu, JLG, jpb, JB),
    "port": (Signer, VirtualNetwork, Chain, CpuBatchVerifier, LG, pb, B),
}


def cluster(side, n=4, tmp_base=None, batch=None):
    signer_cls, network, chain_cls, cpu, lg, mod, blk = SIDES[side]
    signers = [signer_cls.from_scalar(5000 + i) for i in range(n)]
    participants = [s.identity for s in signers]
    net = network(seed=1, latency=0.01, jitter=0.002)
    chains = []
    for i, s in enumerate(signers):
        if tmp_base is None:
            ledger = lg.MemoryLedger()
        else:
            ledger = lg.FileLedger(f"{tmp_base}/{side}/node{i}/{CHANNEL}")
        ledger.append(blk.genesis_block(CHANNEL))
        chain = chain_cls(
            channel_id=CHANNEL, signer=s, participants=participants,
            ledger=ledger,
            batch_config=batch or (JBC if side == "reference" else BC)
            .BatchConfig(max_message_count=10, batch_timeout=0.2),
            verifier=cpu(), latency=0.05)
        net.add_node(chain)
        chains.append(chain)
    net.connect_all()
    return net, chains


def ledgers(chains):
    return [[c.ledger.get(i).SerializeToString() for i in range(c.height())]
            for c in chains]


def scenario_spread(side, tmp_path):
    net, chains = cluster(side)
    for i in range(25):
        chains[i % 4].submit(make_tx(i), net.now)
    chains[1].submit(b"\xff\xff not an envelope", net.now)
    chains[2].receive_message(b"\x07unknown tag", net.now)
    net.run_until(30.0)
    return net, chains


def scenario_timer(side, tmp_path):
    cfg = (JBC if side == "reference" else BC).BatchConfig(
        max_message_count=1000, batch_timeout=0.2)
    net, chains = cluster(side, batch=cfg)
    chains[0].submit(make_tx(0), net.now)
    net.run_until(10.0)
    return net, chains


def scenario_config(side, tmp_path):
    net, chains = cluster(side)
    for i in range(3):
        chains[0].submit(make_tx(i), net.now)
    chains[0].submit(make_tx(99, config=True), net.now)
    net.run_until(20.0)
    return net, chains


def scenario_file_ledger(side, tmp_path):
    net, chains = cluster(side, tmp_base=str(tmp_path))
    for i in range(5):
        chains[0].submit(make_tx(i), net.now)
    net.run_until(20.0)
    return net, chains


def scenario_catch_up(side, tmp_path):
    net, chains = cluster(side)
    net.partitioned.add(3)
    for wave in range(3):
        for i in range(3):
            chains[0].submit(make_tx(200 + wave * 3 + i), net.now)
        net.run_until(net.now + 8.0)
    assert chains[3].height() == 1
    net.partitioned.discard(3)
    for i in range(3):
        chains[0].submit(make_tx(300 + i), net.now)
    t = net.now
    while net.now < t + 40.0:
        net.run_until(net.now + 1.0)
        gap = chains[3].gap()
        if gap is not None:
            for num in range(gap[0], gap[1] + 1):
                raw = chains[0].ledger.get(num).SerializeToString()
                assert chains[3].receive_pulled_block(raw, net.now)
        if chains[3].height() >= chains[0].height() > 2:
            break
    return net, chains


SCENARIOS = {"spread": scenario_spread, "timer": scenario_timer,
             "config": scenario_config, "file_ledger": scenario_file_ledger,
             "catch_up": scenario_catch_up}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_chain_ledgers_match_reference_byte_for_byte(name, tmp_path):
    got = {}
    for side in ("reference", "port"):
        net, chains = SCENARIOS[name](side, tmp_path)
        got[side] = (ledgers(chains), [c.height() for c in chains],
                     [vars(c.metrics) for c in chains])
    assert got["port"] == got["reference"]
    port_ledgers, heights, _ = got["port"]
    assert min(heights) >= 2
    assert all(lg == port_ledgers[0][:len(lg)] for lg in port_ledgers)
    txs = [pb.TxEnvelope.FromString(t).header.tx_id
           for raw in port_ledgers[0][1:]
           for t in pb.Block.FromString(raw).data.transactions]
    assert len(txs) == len(set(txs))
    if name == "spread":
        assert len(txs) == 25
    if name == "config":
        for raw in port_ledgers[0][1:]:
            blk = pb.Block.FromString(raw)
            types = [pb.TxEnvelope.FromString(t).header.type
                     for t in blk.data.transactions]
            assert pb.TX_CONFIG not in types or types == [pb.TX_CONFIG]
    if name == "catch_up":
        assert heights[3] == heights[0] > 2


def test_restart_from_file_ledger_resumes_at_the_tip(tmp_path):
    net, chains = scenario_file_ledger("port", tmp_path)
    h0 = chains[0].height()
    assert h0 >= 2
    signers = [Signer.from_scalar(5000 + i) for i in range(4)]
    revived = Chain(
        channel_id=CHANNEL, signer=signers[0],
        participants=[s.identity for s in signers],
        ledger=LG.FileLedger(f"{tmp_path}/port/node0/{CHANNEL}"),
        verifier=CpuBatchVerifier(), latency=0.05)
    assert revived.height() == h0
    assert revived.engine.latest_height == h0 - 1


def test_pulled_blocks_need_a_valid_proof_in_both_packages():
    results = {}
    for side in ("reference", "port"):
        mod = SIDES[side][5]
        net, chains = cluster(side)
        for i in range(3):
            chains[0].submit(make_tx(400 + i), net.now)
        net.run_until(10.0)
        good = chains[0].ledger.get(1)
        stripped = mod.Block()
        stripped.CopyFrom(good)
        stripped.metadata.entries[2] = b""
        tampered = mod.Block()
        tampered.CopyFrom(good)
        tampered.data.transactions[0] = b"evil"
        forged = mod.Block()
        forged.CopyFrom(good)
        proof = bytearray(forged.metadata.entries[2])
        proof[-1] ^= 1                    # the leader's sig_s
        forged.metadata.entries[2] = bytes(proof)
        garbage = mod.Block()
        garbage.CopyFrom(good)
        garbage.metadata.entries[2] = b"\x0a\xff"
        out = []
        for blk in (stripped, tampered, forged, garbage, good):
            _, victims = cluster(side)
            out.append(victims[0].receive_pulled_block(
                blk.SerializeToString(), 0.0))
        _, victims = cluster(side)
        out.append(victims[0].receive_pulled_block(b"\xff", 0.0))
        out.append(victims[0].receive_pulled_block(
            chains[0].ledger.get(2).SerializeToString()
            if chains[0].height() > 2 else b"", 0.0))
        results[side] = (out, good.SerializeToString())
    assert results["port"] == results["reference"]
    assert results["port"][0][:5] == [False, False, False, False, True]


def test_state_validation_matches_reference():
    outs = {}
    for side in ("reference", "port"):
        _, chains = cluster(side)
        chain = chains[0]
        mod, blk = SIDES[side][5], SIDES[side][6]
        g = blk.genesis_block(CHANNEL)
        good = blk.make_block(1, blk.header_hash(g.header), [make_tx(1)])
        ahead = blk.make_block(3, b"q" * 32, [make_tx(2)])
        empty = blk.make_block(1, blk.header_hash(g.header), [])
        bad_hash = mod.Block()
        bad_hash.CopyFrom(good)
        bad_hash.header.data_hash = b"z" * 32
        outs[side] = [chain._validate_state(b.SerializeToString(), h)
                      for b, h in ((good, 1), (good, 2), (ahead, 3),
                                   (empty, 1), (bad_hash, 1))] + [
            chain._validate_state(b"\xff", 1)]
    assert outs["port"] == outs["reference"] == [True, False, True, False,
                                                 False, False]


def test_chain_without_a_verifier_verifies_on_the_card():
    """Without a ``verifier`` the engine verifies on the card, and there
    is none here."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would take it")
    signers = [Signer.from_scalar(5000 + i) for i in range(4)]
    ledger = LG.MemoryLedger()
    ledger.append(B.genesis_block(CHANNEL))
    with pytest.raises(RuntimeError, match="CUDA"):
        Chain(channel_id=CHANNEL, signer=signers[0],
              participants=[s.identity for s in signers], ledger=ledger)
