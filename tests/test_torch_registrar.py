"""The port's orderer channel plane against the JAX package, on the CPU:
``ordering/msgprocessor.py``, ``registrar.py``, ``follower.py`` and
``raft.py``.

Each scenario runs in both packages on the same seeded
``VirtualNetwork``, with the reference signing consensus messages by
the port's deterministic nonce (``DeterministicSigner``, as in
``tests/test_torch_ordering.py``) and the same transaction bytes (signed
once, by the port), and returns what it saw: ``ChannelInfo``s, the
exception classes by name, ledgers as bytes, Raft roles, terms, votes
and WAL bytes. The two must be equal. The scenarios are the
msgprocessor tests of ``tests/test_ordering.py:146-200``, every test of
``tests/test_registrar_node.py`` but its slow TCP test,
``tests/test_follower.py``, ``tests/test_eviction.py`` and
``tests/test_raft.py``. Then the port resumes what the reference's
registrar wrote to disk (``FileLedger`` directories and ``.joinblock``
files: a consenter channel, a follower channel, a join-block channel
with no block replicated yet) with the same heights, relations and
``deliver`` bytes. Both registrars are given a host ``verifier``:
without one the port's chains verify on the card.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import pytest

from bdls_tpu.consensus.ipc import VirtualNetwork as JNetwork
from bdls_tpu.consensus.verifier import CpuBatchVerifier as JCpu
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.ordering import block as JB
from bdls_tpu.ordering import blockcutter as JBC
from bdls_tpu.ordering import fabric_pb2 as jpb
from bdls_tpu.ordering import follower as JF
from bdls_tpu.ordering import ledger as JLG
from bdls_tpu.ordering import msgprocessor as JMP
from bdls_tpu.ordering import raft as JRaft
from bdls_tpu.ordering import registrar as JRG
from bdls_tpu_torch.consensus import CpuBatchVerifier, Signer
from bdls_tpu_torch.consensus.ipc import VirtualNetwork
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.ordering import block as B
from bdls_tpu_torch.ordering import blockcutter as BC
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering import follower as F
from bdls_tpu_torch.ordering import ledger as LG
from bdls_tpu_torch.ordering import msgprocessor as MP
from bdls_tpu_torch.ordering import raft as Raft
from bdls_tpu_torch.ordering import registrar as RG
from test_torch_ordering import DeterministicSigner

SW = SwCSP()
CLIENT = SW.key_from_scalar("P-256", 0xC11E47)

SIDES = {
    "reference": SimpleNamespace(
        Signer=DeterministicSigner, Net=JNetwork, cpu=JCpu, csp=JSwCSP(),
        RG=JRG, LG=JLG, MP=JMP, F=JF, Raft=JRaft, BC=JBC, B=JB, pb=jpb),
    "port": SimpleNamespace(
        Signer=Signer, Net=VirtualNetwork, cpu=CpuBatchVerifier,
        csp=SwCSP(), RG=RG, LG=LG, MP=MP, F=F, Raft=Raft, BC=BC, B=B,
        pb=pb),
}


# ---- transactions, made once by the port -------------------------------------

def tx_bytes(i: int, channel: str = "testchannel", org: str = "org1",
             payload: bytes = None, config: bytes = None,
             tamper: bool = False) -> bytes:
    """The reference test's ``make_tx`` shape; ``config`` makes a config
    transaction carrying that ``ChannelConfig``; ``tamper`` changes the
    payload after signing."""
    env = pb.TxEnvelope()
    env.header.type = pb.TxType.TX_CONFIG if config else pb.TxType.TX_NORMAL
    env.header.channel_id = channel
    env.header.tx_id = f"tx-{i}"
    pub = CLIENT.public_key()
    env.header.creator_x = pub.x.to_bytes(32, "big")
    env.header.creator_y = pub.y.to_bytes(32, "big")
    env.header.creator_org = org
    env.payload = config if config else (
        payload if payload is not None else b"payload-%d" % i)
    r, s = SW.sign(CLIENT, B.tx_digest(env))
    env.sig_r = r.to_bytes(32, "big")
    env.sig_s = s.to_bytes(32, "big")
    if tamper:
        env.payload = b"tampered"
    return env.SerializeToString()


def cfg_bytes(channel, consenters, **kw) -> bytes:
    return RG.make_channel_config(channel, consenters,
                                  **kw).SerializeToString()


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the class is compared
        return ("raised", type(exc).__name__)


def info(reg, ch):
    return outcome(lambda: dataclasses.astuple(reg.channel_info(ch)))


def ledger(reg, ch):
    return [b.SerializeToString() for b in reg.deliver(ch)]


def env_of(S, raw):
    return S.pb.TxEnvelope.FromString(raw)


def block_of(S, raw):
    return S.pb.Block.FromString(raw)


# ---- the reference tests' clusters -----------------------------------------------

def registrar_cluster(S, n=4, channels=("ch1",)):
    signers = [S.Signer.from_scalar(7000 + i) for i in range(n)]
    participants = [s.identity for s in signers]
    nets = {ch: S.Net(seed=5, latency=0.01) for ch in channels}
    regs = [S.RG.Registrar(signer=s, ledger_factory=S.LG.LedgerFactory(None),
                           csp=S.csp, verifier=S.cpu(), epoch=0.0)
            for s in signers]
    for ch in channels:
        genesis = block_of(S, S.RG.make_genesis(S.RG.make_channel_config(
            ch, participants, max_message_count=5, batch_timeout_s=0.2,
            writer_orgs=("org1",), consensus_latency_s=0.05,
        )).SerializeToString())
        for reg in regs:
            reg.join_channel(genesis)
        for reg in regs:
            nets[ch].add_node(reg.chains[ch])
        nets[ch].connect_all()
    return regs, nets, signers


def run_all(nets, t_end):
    for net in nets.values():
        net.run_until(t_end)


class RegistrarSource:
    """A member registrar's ledger as a BlockSource."""

    def __init__(self, reg, channel):
        self.reg, self.channel = reg, channel

    def height(self):
        return self.reg.channel_info(self.channel).height

    def get_block(self, n):
        blocks = list(self.reg.deliver(self.channel, n, n))
        return blocks[0] if blocks else None


# ---- msgprocessor (tests/test_ordering.py:146-200) ----------------------------

def sc_msgprocessor(S, tmp):
    def proc():
        return S.MP.StandardChannelProcessor(
            channel_id="testchannel", csp=S.csp,
            policy=S.MP.ChannelPolicy(writer_orgs=frozenset({"org1"})))

    out = [outcome(lambda: proc().process_normal_msg(env_of(S, tx_bytes(1)))),
           outcome(lambda: proc().process_normal_msg(
               env_of(S, tx_bytes(1, tamper=True)))),
           outcome(lambda: proc().process_normal_msg(
               env_of(S, tx_bytes(1, channel="other")))),
           outcome(lambda: proc().process_normal_msg(
               env_of(S, tx_bytes(1, org="evilorg")))),
           outcome(lambda: proc().process_normal_msg(
               env_of(S, tx_bytes(1, payload=b"")))),
           outcome(lambda: proc().process_config_msg(
               env_of(S, tx_bytes(1)))),
           outcome(lambda: proc().process_config_msg(env_of(
               S, tx_bytes(2, config=cfg_bytes("testchannel", []))))[1])]
    small = proc()
    small.absolute_max_bytes = 100
    out.append(outcome(lambda: small.process_normal_msg(
        env_of(S, tx_bytes(3)))))
    maint = proc()
    maint.maintenance = True
    out.append(outcome(lambda: maint.process_normal_msg(
        env_of(S, tx_bytes(4)))))
    envs = [env_of(S, tx_bytes(i, tamper=(i == 2))) for i in range(4)]
    bad_key = env_of(S, tx_bytes(5))
    bad_key.header.creator_y = b"\x01" * 32
    out.append(proc().batch_check_signatures(envs + [bad_key]))
    pol = S.MP.ChannelPolicy(writer_orgs=frozenset({"org1"}),
                             reader_orgs=frozenset({"org3"}))
    key = S.csp.key_import("P-256", CLIENT.public_key().x,
                           CLIENT.public_key().y)
    out.append((pol.allows("org1", key), pol.allows("org2", key),
                pol.allows_read("org3", key), pol.allows_read("org2", key),
                pol.reads_restricted, S.MP.ChannelPolicy().reads_restricted))
    return out


# ---- tests/test_registrar_node.py ------------------------------------------------

def sc_join_list_remove(S, tmp):
    regs, nets, signers = registrar_cluster(S, channels=("ch1", "ch2"))
    out = [[dataclasses.astuple(i) for i in regs[0].list_channels()]]
    cfg = S.RG.make_channel_config("ch1", [s.identity for s in signers])
    out.append(outcome(lambda: regs[0].join_channel(S.RG.make_genesis(cfg))))
    regs[0].remove_channel("ch2")
    out.append([dataclasses.astuple(i) for i in regs[0].list_channels()])
    out.append(info(regs[0], "ch2"))
    out.append(outcome(lambda: regs[0].remove_channel("ch2")))
    return out


def sc_broadcast_routes_and_orders_per_channel(S, tmp):
    regs, nets, _ = registrar_cluster(S, channels=("ch1", "ch2"))
    for i in range(4):
        regs[i % 4].broadcast(tx_bytes(i, channel="ch1"), nets["ch1"].now)
    regs[0].broadcast(tx_bytes(100, channel="ch2"), 0.0)
    run_all(nets, 15.0)
    return ([info(r, ch) for r in regs for ch in ("ch1", "ch2")],
            [ledger(r, ch) for r in regs for ch in ("ch1", "ch2")])


def sc_broadcast_rejects_invalid(S, tmp):
    regs, nets, _ = registrar_cluster(S)
    return [outcome(lambda: regs[0].broadcast(
                tx_bytes(0, channel="ch1", tamper=True), 0.0)),
            outcome(lambda: regs[0].broadcast(tx_bytes(0, channel="nochan"),
                                              0.0)),
            outcome(lambda: regs[0].broadcast(b"\xff\xff", 0.0)),
            outcome(lambda: regs[0].broadcast(
                tx_bytes(0, channel="ch1", org="org9"), 0.0)),
            outcome(lambda: regs[0].route_cluster_message("nochan", b"",
                                                          0.0))]


def sc_registrar_restart_resumes_channels(S, tmp):
    signers = [S.Signer.from_scalar(7100 + i) for i in range(4)]
    cfg = S.RG.make_channel_config("chp", [s.identity for s in signers])
    lf = S.LG.LedgerFactory(str(tmp))
    reg = S.RG.Registrar(signer=signers[0], ledger_factory=lf, csp=S.csp,
                         verifier=S.cpu())
    reg.join_channel(S.RG.make_genesis(cfg))
    out = [info(reg, "chp")]
    lf2 = S.LG.LedgerFactory(str(tmp))
    lf2.get_or_create("chp")
    reg2 = S.RG.Registrar(signer=signers[0], ledger_factory=lf2, csp=S.csp,
                          verifier=S.cpu())
    reg2.initialize()
    out += [info(reg2, "chp"), ledger(reg2, "chp")]
    return out


def sc_capability_gating(S, tmp):
    signers = [S.Signer.from_scalar(0x7C00 + i) for i in range(4)]
    ids = [s.identity for s in signers]
    out = []
    bad = S.RG.make_channel_config("c1", ids, consensus_type="raft")
    bad.capability_level = 1
    out.append(outcome(lambda: S.RG.check_capabilities(bad)))
    good = S.RG.make_channel_config("c1", ids, consensus_type="raft")
    out.append((good.capability_level, good.SerializeToString()))
    out.append(outcome(lambda: S.RG.check_capabilities(good)))
    future = S.RG.make_channel_config("c2", ids)
    future.capability_level = S.RG.SUPPORTED_CAPABILITY_LEVEL + 1
    reg = S.RG.Registrar(signer=signers[0],
                         ledger_factory=S.LG.LedgerFactory(None), csp=S.csp,
                         verifier=S.cpu())
    out.append(outcome(lambda: reg.join_channel(S.RG.make_genesis(future))))
    regs, nets, _ = registrar_cluster(S)
    newcfg = S.pb.ChannelConfig()
    newcfg.channel_id = "ch1"
    newcfg.capability_level = S.RG.SUPPORTED_CAPABILITY_LEVEL + 1
    regs[0].broadcast(tx_bytes(0, channel="ch1",
                               config=newcfg.SerializeToString()),
                      nets["ch1"].now)
    run_all(nets, 20.0)
    out.append([info(r, "ch1") for r in regs])
    out.append([r.check_evictions() for r in regs])
    out.append([info(r, "ch1") for r in regs])
    out.append(ledger(regs[0], "ch1"))
    return out


# ---- tests/test_follower.py and tests/test_eviction.py -----------------------

def follower_setup(S):
    regs, nets, signers = registrar_cluster(S)
    newcomer = S.Signer.from_scalar(7999)
    freg = S.RG.Registrar(signer=newcomer,
                          ledger_factory=S.LG.LedgerFactory(None),
                          csp=S.csp, verifier=S.cpu(), epoch=0.0)
    genesis = S.RG.make_genesis(S.RG.make_channel_config(
        "ch1", [s.identity for s in signers], max_message_count=5,
        batch_timeout_s=0.2, writer_orgs=("org1",),
        consensus_latency_s=0.05))
    return regs, nets, signers, freg, newcomer, genesis


def grow_tx(S, signers, extra, channel):
    return tx_bytes(0, channel=channel, config=cfg_bytes(
        channel, [s.identity for s in signers] + [extra.identity],
        max_message_count=5, batch_timeout_s=0.2, writer_orgs=("org1",),
        consensus_latency_s=0.05))


def sc_follower_replicates(S, tmp):
    regs, nets, signers, freg, _, genesis = follower_setup(S)
    out = [dataclasses.astuple(freg.join_channel(genesis))]
    for i in range(6):
        regs[i % 4].broadcast(tx_bytes(i, channel="ch1"), nets["ch1"].now)
    run_all(nets, 15.0)
    freg.add_follower_source("ch1", RegistrarSource(regs[0], "ch1"))
    out.append(freg.poll_followers())
    out += [info(freg, "ch1"), ledger(freg, "ch1"), ledger(regs[0], "ch1")]
    out.append(outcome(lambda: freg.add_follower_source("nochan", None)))
    return out


def sc_follower_refuses_broadcast(S, tmp):
    _, _, _, freg, _, genesis = follower_setup(S)
    freg.join_channel(genesis)
    return [outcome(lambda: freg.broadcast(tx_bytes(0, channel="ch1"), 0.0)),
            outcome(lambda: freg.join_channel(genesis))]


def sc_follower_activates_on_join_block(S, tmp):
    regs, nets, signers, freg, fsigner, genesis = follower_setup(S)
    freg.join_channel(genesis)
    freg.add_follower_source("ch1", RegistrarSource(regs[0], "ch1"))
    regs[0].broadcast(grow_tx(S, signers, fsigner, "ch1"), nets["ch1"].now)
    run_all(nets, 20.0)
    out = [info(regs[0], "ch1"), freg.poll_followers(), info(freg, "ch1")]
    out.append(("ch1" in freg.chains, "ch1" in freg.followers))
    out.append(freg.chains["ch1"].engine.participants)
    out.append(ledger(freg, "ch1"))
    return out


def _join_block(S, regs, raw_tx, channel):
    return next(b for b in regs[0].deliver(channel)
                if b.header.number > 0
                and raw_tx in list(b.data.transactions))


def sc_join_with_later_config_block(S, tmp):
    regs, nets, signers = registrar_cluster(S, channels=("jb",))
    new_signer = S.Signer.from_scalar(0x6E01)
    raw = grow_tx(S, signers, new_signer, "jb")
    regs[0].broadcast(raw, nets["jb"].now)
    run_all(nets, 20.0)
    join_block = _join_block(S, regs, raw, "jb")
    reg_new = S.RG.Registrar(signer=new_signer,
                             ledger_factory=S.LG.LedgerFactory(None),
                             csp=S.csp, verifier=S.cpu())
    out = [dataclasses.astuple(reg_new.join_channel(join_block))]
    reg_new.add_follower_source("jb", RegistrarSource(regs[0], "jb"))
    for _ in range(30):
        nets["jb"].run_until(nets["jb"].now + 1.0)
        reg_new.poll_followers()
        if "jb" in reg_new.chains:
            break
    out += [info(reg_new, "jb"), ledger(reg_new, "jb"),
            len(reg_new.chains["jb"].participants)]
    bad_block = S.pb.Block()
    bad_block.CopyFrom(join_block)
    bad_block.metadata.entries[0] = b"\x01"
    reg_bad = S.RG.Registrar(signer=S.Signer.from_scalar(0x6E02),
                             ledger_factory=S.LG.LedgerFactory(None),
                             csp=S.csp, verifier=S.cpu())
    reg_bad.join_channel(bad_block)
    reg_bad.add_follower_source("jb", RegistrarSource(regs[0], "jb"))
    for _ in range(10):
        nets["jb"].run_until(nets["jb"].now + 1.0)
        reg_bad.poll_followers()
    out += ["jb" in reg_bad.chains, info(reg_bad, "jb")]
    plain = S.pb.Block()
    plain.CopyFrom(join_block)
    plain.data.transactions[0] = tx_bytes(9, channel="jb")
    out.append(outcome(lambda: reg_bad.join_channel(plain)))
    out.append(outcome(lambda: S.RG.Registrar(
        signer=new_signer, ledger_factory=S.LG.LedgerFactory(None),
        csp=S.csp).join_channel(S.pb.Block())))
    return out


def sc_join_block_survives_pre_backfill_restart(S, tmp):
    regs, nets, signers = registrar_cluster(S, channels=("jr",))
    new_signer = S.Signer.from_scalar(0x6E11)
    raw = grow_tx(S, signers, new_signer, "jr")
    regs[0].broadcast(raw, nets["jr"].now)
    run_all(nets, 20.0)
    jb = _join_block(S, regs, raw, "jr")
    base = str(tmp / "joiner")
    S.RG.Registrar(signer=new_signer, ledger_factory=S.LG.LedgerFactory(base),
                   csp=S.csp, verifier=S.cpu()).join_channel(jb)
    reg2 = S.RG.Registrar(signer=new_signer,
                          ledger_factory=S.LG.LedgerFactory(base),
                          csp=S.csp, verifier=S.cpu())
    reg2.initialize()
    out = [info(reg2, "jr"), reg2.followers["jr"].join_block is not None]
    reg2.add_follower_source("jr", RegistrarSource(regs[0], "jr"))
    for _ in range(30):
        nets["jr"].run_until(nets["jr"].now + 1.0)
        reg2.poll_followers()
        if "jr" in reg2.chains:
            break
    out += [info(reg2, "jr"), ledger(reg2, "jr"),
            open(f"{base}/jr.joinblock", "rb").read()]
    return out


def sc_eviction(S, tmp):
    regs, nets, signers = registrar_cluster(S)
    newcfg = S.pb.ChannelConfig()
    newcfg.channel_id = "ch1"
    for s in signers[:3]:
        newcfg.consenters.add().identity = s.identity
    regs[0].broadcast(tx_bytes(0, channel="ch1",
                               config=newcfg.SerializeToString()),
                      nets["ch1"].now)
    run_all(nets, 20.0)
    out = [info(regs[3], "ch1"), regs[3].check_evictions(),
           info(regs[3], "ch1"), regs[0].check_evictions(),
           info(regs[0], "ch1"), ledger(regs[3], "ch1")]
    out.append([len(r.chains["ch1"].participants) for r in regs[:3]])
    return out


# ---- tests/test_raft.py -----------------------------------------------------------

def raft_cluster(S, n=3, tmp=None, seed=11):
    signers = [S.Signer.from_scalar(0x4A00 + i) for i in range(n)]
    participants = [s.identity for s in signers]
    net = S.Net(seed=seed, latency=0.005)
    genesis = block_of(S, S.RG.make_genesis(S.RG.make_channel_config(
        "raftchan", participants, consensus_type="raft")).SerializeToString())
    chains = []
    for i, s in enumerate(signers):
        lg = S.LG.MemoryLedger()
        lg.append(genesis)
        chain = S.Raft.RaftChain(
            channel_id="raftchan", signer=s, participants=participants,
            ledger=lg,
            batch_config=S.BC.BatchConfig(max_message_count=5,
                                          batch_timeout=0.1),
            latency=0.02, wal_path=str(tmp / f"wal{i}") if tmp else None)
        net.add_node(chain)
        chains.append(chain)
    net.connect_all()
    return net, chains, signers


def drive(net, seconds):
    net.run_until(net.now + seconds)


def leader_of(S, chains):
    leaders = [c for c in chains if c.role == S.Raft.LEADER]
    return leaders[-1] if leaders else None


def raft_state(chains):
    return [(c.role, c.term, c.voted_for, c.commit_index, c.height(),
             [c.ledger.get(i).SerializeToString()
              for i in range(c.height())], c.apply_error,
             vars(c.metrics)) for c in chains]


def sc_raft_election_and_replication(S, tmp):
    net, chains, _ = raft_cluster(S)
    drive(net, 5.0)
    out = [raft_state(chains)]
    ldr = leader_of(S, chains)
    for i in range(7):
        chains[(chains.index(ldr) + 1) % 3].submit(
            tx_bytes(i, channel="raftchan"), net.now)
    drive(net, 5.0)
    out.append(raft_state(chains))
    blk = chains[0].ledger.get(1)
    out.append(S.Raft._block_term(blk))
    follower = next(c for c in chains if c is not ldr)
    out.append(follower._last_log())
    return out


def sc_raft_leader_crash(S, tmp):
    net, chains, _ = raft_cluster(S, seed=13)
    drive(net, 5.0)
    ldr = leader_of(S, chains)
    chains[0].submit(tx_bytes(0, channel="raftchan"), net.now)
    drive(net, 3.0)
    out = [raft_state(chains)]
    dead = chains.index(ldr)
    net.partitioned.add(dead)
    drive(net, 8.0)
    alive = [c for i, c in enumerate(chains) if i != dead]
    new_ldr = leader_of(S, alive)
    new_ldr.submit(tx_bytes(1, channel="raftchan"), net.now)
    drive(net, 5.0)
    out.append(raft_state(chains))
    net.partitioned.discard(dead)
    drive(net, 8.0)
    out.append(raft_state(chains))
    return out


def sc_raft_relayed_tx_survives_leader_crash(S, tmp):
    net, chains, _ = raft_cluster(S, seed=17)
    drive(net, 5.0)
    dead = chains.index(leader_of(S, chains))
    followers = [c for i, c in enumerate(chains) if i != dead]
    tx = tx_bytes(42, channel="raftchan")
    for f in followers:
        f.submit(tx, net.now, relay=False)
    net.partitioned.add(dead)
    drive(net, 10.0)
    return [raft_state(chains),
            tx in [bytes(t) for t in followers[0].ledger.get(1)
                   .data.transactions]]


def sc_raft_wal(S, tmp):
    wal = S.Raft.RaftWAL(str(tmp / "w"))
    wal.save_hardstate(5, b"\x01" * 64)
    wal.save_entry(5, 3, b"block3")
    wal.save_entry(5, 4, b"block4")
    wal.save_truncate(4)
    wal.save_entry(6, 4, b"block4b")
    wal.close()
    out = [(tmp / "w").read_bytes(), S.Raft.RaftWAL(str(tmp / "w")).replay()]
    path = str(tmp / "t")
    wal = S.Raft.RaftWAL(path)
    wal.save_hardstate(2, None)
    wal.close()
    with open(path, "ab") as fh:
        fh.write(b"\xff\xff\xff\x7f")
    out += [S.Raft.RaftWAL(path).replay(), (tmp / "t").read_bytes()]
    wal = S.Raft.RaftWAL(str(tmp / "c"))
    wal.compact(3, 7, b"\x02" * 64, [(7, 3, b"a"), (7, 4, b"b")])
    out.append((tmp / "c").read_bytes())
    return out


def sc_raft_restart_from_wal(S, tmp):
    net, chains, signers = raft_cluster(S, tmp=tmp)
    drive(net, 5.0)
    voter = chains[1]
    term, voted = voter.term, voter.voted_for
    voter.close()
    wal_bytes = (tmp / "wal1").read_bytes()
    lg = S.LG.MemoryLedger()
    lg.append(voter.ledger.get(0))
    revived = S.Raft.RaftChain(
        channel_id="raftchan", signer=signers[1],
        participants=[s.identity for s in signers], ledger=lg,
        wal_path=str(tmp / "wal1"))
    return [term, voted, wal_bytes, revived.term, revived.voted_for,
            (tmp / "wal1").read_bytes()]


def sc_raft_registrar_selects_raft(S, tmp):
    signers = [S.Signer.from_scalar(0x4B00 + i) for i in range(3)]
    reg = S.RG.Registrar(signer=signers[0],
                         ledger_factory=S.LG.LedgerFactory(str(tmp)),
                         csp=S.csp, verifier=S.cpu())
    reg.join_channel(S.RG.make_genesis(S.RG.make_channel_config(
        "cftchan", [s.identity for s in signers], consensus_type="raft",
        writer_orgs=("org1",))))
    chain = reg.chains["cftchan"]
    return [type(chain).__name__, os.path.basename(chain.wal.path),
            info(reg, "cftchan"), chain.gap(),
            chain.receive_pulled_block(b"", 0.0)]


def sc_raft_new_node_catches_up(S, tmp):
    net, chains, signers = raft_cluster(S)
    drive(net, 5.0)
    ldr = leader_of(S, chains)
    for i in range(7):
        ldr.submit(tx_bytes(i, channel="raftchan"), net.now)
    drive(net, 3.0)
    new_signer = S.Signer.from_scalar(0x4A99)
    participants4 = [s.identity for s in signers] + [new_signer.identity]
    for c in chains:
        c.reconfigure(participants4, net.now)
    lg = S.LG.MemoryLedger()
    lg.append(chains[0].ledger.get(0))
    newcomer = S.Raft.RaftChain(
        channel_id="raftchan", signer=new_signer, participants=participants4,
        ledger=lg, batch_config=S.BC.BatchConfig(max_message_count=5,
                                                 batch_timeout=0.1),
        latency=0.02)
    net.add_node(newcomer)
    net.connect_all()
    drive(net, 5.0)
    out = [raft_state(chains + [newcomer])]
    ldr.submit(tx_bytes(100, channel="raftchan"), net.now)
    drive(net, 3.0)
    dead = chains.index(ldr)
    net.partitioned.add(dead)
    alive = [c for i, c in enumerate(chains) if i != dead] + [newcomer]
    for c in alive:
        c._election_deadline = net.now + 100.0
    newcomer._election_deadline = net.now
    drive(net, 8.0)
    newcomer.submit(tx_bytes(101, channel="raftchan"), net.now)
    drive(net, 5.0)
    out.append(raft_state(chains + [newcomer]))
    return out


def sc_raft_removed_node(S, tmp):
    net, chains, _ = raft_cluster(S, seed=17)
    drive(net, 5.0)
    ldr = leader_of(S, chains)
    others = [c for c in chains if c is not ldr]
    keep, dropped = [ldr, others[0]], others[1]
    for c in chains:
        c.reconfigure([c.identity for c in keep], net.now)
    net.partitioned.add(chains.index(dropped))
    ldr.submit(tx_bytes(50, channel="raftchan"), net.now)
    drive(net, 5.0)
    return [raft_state(chains), dropped.role]


def sc_raft_membership_grow(S, tmp):
    channel = "rch"
    signers = [S.Signer.from_scalar(0x4C00 + i) for i in range(3)]
    net = S.Net(seed=23, latency=0.01)
    genesis = S.RG.make_genesis(S.RG.make_channel_config(
        channel, [s.identity for s in signers], max_message_count=5,
        batch_timeout_s=0.2, writer_orgs=("org1",),
        consensus_latency_s=0.02, consensus_type="raft"))
    regs = []
    for s in signers:
        reg = S.RG.Registrar(signer=s, ledger_factory=S.LG.LedgerFactory(None),
                             csp=S.csp, verifier=S.cpu())
        reg.join_channel(genesis)
        regs.append(reg)
        net.add_node(reg.chains[channel])
    net.connect_all()
    net.run_until(5.0)
    new_signer = S.Signer.from_scalar(0x4C99)
    reg3 = S.RG.Registrar(signer=new_signer,
                          ledger_factory=S.LG.LedgerFactory(None), csp=S.csp,
                          verifier=S.cpu())
    out = [dataclasses.astuple(reg3.join_channel(genesis))]
    reg3.add_follower_source(channel, RegistrarSource(regs[0], channel))
    regs[0].broadcast(tx_bytes(0, channel=channel, config=cfg_bytes(
        channel, [s.identity for s in signers] + [new_signer.identity],
        max_message_count=5, batch_timeout_s=0.2, writer_orgs=("org1",),
        consensus_latency_s=0.02, consensus_type="raft")), net.now)
    for _ in range(30):
        net.run_until(net.now + 1.0)
        reg3.poll_followers()
        if channel in reg3.chains:
            break
    out.append([len(r.chains[channel].participants) for r in regs + [reg3]])
    out.append(type(reg3.chains[channel]).__name__)
    net.add_node(reg3.chains[channel])
    net.connect_all()
    regs[1].broadcast(tx_bytes(7, channel=channel), net.now)
    net.run_until(net.now + 5.0)
    out.append([info(r, channel) for r in regs + [reg3]])
    out.append([ledger(r, channel) for r in regs + [reg3]])
    return out


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, tmp_path):
    got = {}
    for side in ("reference", "port"):
        base = tmp_path / side
        base.mkdir()
        got[side] = SCENARIOS[name](SIDES[side], base)
    assert got["port"] == got["reference"]


# ---- state carried across: the port resumes the reference's disk -------------

def test_port_resumes_what_the_reference_registrar_wrote(tmp_path):
    S = SIDES["reference"]
    # the reference's cluster orders a block on "cons" and grows "jb"
    regs, nets, signers = registrar_cluster(S, channels=("cons", "jb"))
    for i in range(5):
        regs[0].broadcast(tx_bytes(i, channel="cons"), nets["cons"].now)
    newcomer = S.Signer.from_scalar(0x6E21)
    raw = grow_tx(S, signers, newcomer, "jb")
    regs[0].broadcast(raw, nets["jb"].now)
    run_all(nets, 20.0)
    join_block = _join_block(S, regs, raw, "jb")
    base = str(tmp_path / "node")
    # a consenter of "cons", written through its own ledger factory
    me = signers[1]
    lf = S.LG.LedgerFactory(base)
    reg = S.RG.Registrar(signer=me, ledger_factory=lf, csp=S.csp,
                         verifier=S.cpu())
    genesis = next(regs[1].deliver("cons", 0, 0))
    reg.join_channel(genesis)
    for blk in list(regs[1].deliver("cons"))[1:]:
        reg.chains["cons"].ledger.append(blk)
    # a follower of "fol" (the cluster's "cons" history under another
    # name is not possible: a follower replicates "cons2" from genesis)
    outsider = S.Signer.from_scalar(0x6E22)
    fol_regs, fol_nets, fol_signers = registrar_cluster(S, channels=("fol",))
    for i in range(5):
        fol_regs[0].broadcast(tx_bytes(10 + i, channel="fol"),
                              fol_nets["fol"].now)
    run_all(fol_nets, 15.0)
    out_lf = S.LG.LedgerFactory(str(tmp_path / "outsider"))
    out_reg = S.RG.Registrar(signer=outsider, ledger_factory=out_lf,
                             csp=S.csp, verifier=S.cpu())
    out_reg.join_channel(next(fol_regs[0].deliver("fol", 0, 0)))
    out_reg.add_follower_source("fol", RegistrarSource(fol_regs[0], "fol"))
    out_reg.poll_followers()
    # a join-block channel with no block replicated yet
    jb_lf = S.LG.LedgerFactory(str(tmp_path / "joiner"))
    jb_reg = S.RG.Registrar(signer=newcomer, ledger_factory=jb_lf,
                            csp=S.csp, verifier=S.cpu())
    jb_reg.join_channel(join_block)
    for r in (reg, out_reg, jb_reg):
        for ledger_ in r.ledger_factory._ledgers.values():
            getattr(ledger_, "close", lambda: None)()

    views = {}
    for side in ("reference", "port"):
        T = SIDES[side]
        got = []
        for signer_scalar, d in ((me, base),
                                 (outsider, str(tmp_path / "outsider")),
                                 (newcomer, str(tmp_path / "joiner"))):
            sg = T.Signer.from_scalar(_scalar(signer_scalar))
            r = T.RG.Registrar(signer=sg,
                               ledger_factory=T.LG.LedgerFactory(d),
                               csp=T.csp, verifier=T.cpu())
            r.initialize()
            chans = [dataclasses.astuple(i) for i in r.list_channels()]
            got.append((chans, {c[0]: ledger(r, c[0]) for c in chans}))
            for ledger_ in r.ledger_factory._ledgers.values():
                getattr(ledger_, "close", lambda: None)()
        views[side] = got
    assert views["port"] == views["reference"]
    (cons, _), (fol, _), (jbv, _) = views["port"]
    assert [c[3] for c in cons] == ["consenter"]
    assert cons[0][1] == regs[1].channel_info("cons").height >= 2
    assert [(c[0], c[3]) for c in fol] == [("fol", "follower")]
    assert fol[0][1] >= 2
    assert jbv == [("jb", 0, "onboarding", "follower", None)]


def _scalar(signer) -> int:
    return signer.private_key.private_numbers().private_value
