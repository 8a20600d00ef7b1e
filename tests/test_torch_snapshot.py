"""The port's peer snapshots (``bdls_tpu_torch/peer/snapshot.py``)
against the JAX package's ``bdls_tpu/peer/snapshot.py``, on the CPU.

- Two peers, one of each package, synced on the same block bytes (the
  reference test's ``make_chain``), write the same snapshot bytes.
- A snapshot written by either package loads in the other: the same
  header, anchor and records, and a peer bootstrapped from it holds the
  same height, state and versions, and no block before its anchor.
- A port peer bootstrapped from the reference's snapshot goes on
  committing from its anchor, through ``TorchCSP(device="cpu")`` (K7's
  plain twin), to the ledger and state the reference's peer reaches.
- A partial file, a file with a tail cut short, a missing header, a
  tampered anchor block and a height that disagrees with the anchor are
  refused by both with the same ``SnapshotError`` text.
"""

from __future__ import annotations

import json
import struct

import pytest
import torch

from bdls_tpu.crypto.msp import Identity as JIdentity
from bdls_tpu.crypto.msp import LocalMSP as JLocalMSP
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.models.peer import PeerNode as JPeerNode
from bdls_tpu.ordering import fabric_pb2 as jpb
from bdls_tpu.peer import snapshot as JS
from bdls_tpu.peer.validator import EndorsementPolicy as JPolicy
from bdls_tpu_torch.crypto.msp import Identity, LocalMSP
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.models.peer import PeerNode
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.peer import snapshot as S
from bdls_tpu_torch.peer.validator import EndorsementPolicy

from test_gossip import ListSource, make_chain

torch.set_num_threads(1)

SIDES = {"reference": (JSwCSP(), JLocalMSP, JIdentity, JPeerNode, JPolicy,
                       JS, jpb),
         "port": (SwCSP(), LocalMSP, Identity, PeerNode, EndorsementPolicy,
                  S, pb)}
RAW = [b.SerializeToString() for b in make_chain(4)]


def msp(side, csp=None):
    dflt, msp_cls, ident_cls = SIDES[side][:3]
    csp = csp or dflt
    m = msp_cls(csp)
    for scalar in (0xD001, 0xD002):                 # creator, endorser
        m.register(ident_cls(org="org1", key=csp.key_from_scalar(
            "P-256", scalar).public_key()))
    return m


def synced(side, limit=5):
    csp, _, _, peer_cls, pol_cls, _, mpb = SIDES[side]
    source = ListSource([mpb.Block.FromString(b) for b in RAW])
    source.limit = limit
    peer = peer_cls(channel_id="sec", csp=csp, org="org1",
                    signing_key=csp.key_from_scalar("P-256", 0xE001),
                    genesis=source.blocks[0], orderer_sources=[source],
                    policy=pol_cls(required=1), msp=msp(side))
    peer.poll()
    return peer, source


def bootstrap(side, path, source=(), csp=None):
    dflt, _, _, _, pol_cls, mod, _ = SIDES[side]
    csp = csp or dflt
    return mod.bootstrap_from_snapshot(
        path, csp, "org2", csp.key_from_scalar("P-256", 0xE002),
        orderer_sources=list(source), policy=pol_cls(required=1),
        msp=msp(side, csp))


def peer_state(peer):
    return (peer.height(),
            [(k, peer.state.get(k), peer.state.version(k))
             for k in peer.state.keys()],
            [None if peer.get_block(n) is None else
             peer.get_block(n).SerializeToString()
             for n in range(peer.height())])


def test_the_same_peer_state_writes_the_same_bytes(tmp_path):
    files = {}
    for side in SIDES:
        peer, _ = synced(side)
        path = tmp_path / f"{side}.snap"
        header = SIDES[side][5].export_snapshot(peer, str(path))
        files[side] = (header, path.read_bytes())
    assert files["port"] == files["reference"]
    assert files["port"][0]["height"] == 5


@pytest.mark.parametrize("writer", sorted(SIDES))
def test_a_snapshot_loads_in_the_other_package(writer, tmp_path):
    peer, _ = synced(writer)
    path = str(tmp_path / "snap")
    SIDES[writer][5].export_snapshot(peer, path)
    loaded, peers = {}, {}
    for side in SIDES:
        header, anchor, recs = SIDES[side][5].load_snapshot(path)
        loaded[side] = (header, anchor.SerializeToString(), recs)
        peers[side] = peer_state(bootstrap(side, path))
    assert loaded["port"] == loaded["reference"]
    assert peers["port"] == peers["reference"]
    height, state, blocks = peers["port"]
    assert height == 5 and blocks[:4] == [None] * 4 and blocks[4]
    assert state == peer_state(peer)[1]


def test_a_bootstrapped_port_peer_goes_on_committing(tmp_path):
    """The reference's peer writes the snapshot at height 4 (anchor block
    3); a port peer on K7's plain twin starts from it and commits block
    4."""
    ref_peer, _ = synced("reference", limit=4)
    path = str(tmp_path / "snap")
    JS.export_snapshot(ref_peer, path)
    source = ListSource([pb.Block.FromString(b) for b in RAW])
    source.limit = 5
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        newcomer = bootstrap("port", path, [source], csp=csp)
        assert newcomer.height() == 4
        assert newcomer.poll() == 1
    finally:
        csp.close()
    full, _ = synced("reference", limit=5)
    height, state, blocks = peer_state(newcomer)
    # block 3 is the anchor; the committer wrote the same flags into
    # block 4 as the reference's
    assert height == 5 and blocks[:3] == [None] * 3
    assert blocks[3:] == peer_state(full)[2][3:]
    assert [(k, v) for k, v, _ in state] == \
        [(k, v) for k, v, _ in peer_state(full)[1]]


def _records(raw):
    out, off = [], 0
    while off + 4 <= len(raw):
        (n,) = struct.unpack_from("<I", raw, off)
        out.append(json.loads(raw[off + 4:off + 4 + n]))
        off += 4 + n
    return out


def _frames(recs):
    out = b""
    for rec in recs:
        payload = json.dumps(rec).encode()
        out += struct.pack("<I", len(payload)) + payload
    return out


def _swap_anchor(recs):
    """Another block (the genesis) where the anchor was: it parses, and
    its header hash is not the one recorded."""
    recs[0]["last_block"] = RAW[0].hex()
    return recs


def _height(recs):
    recs[0]["height"] = 99
    return recs


CORRUPTIONS = {
    "cut_20_bytes": lambda raw: raw[:-20],
    "no_commit_marker": lambda raw: _frames(_records(raw)[:-1]),
    "header_only": lambda raw: _frames(_records(raw)[:1]),
    "no_header": lambda raw: _frames(_records(raw)[1:]),
    "tampered_anchor": lambda raw: _frames(_swap_anchor(_records(raw))),
    "height_disagrees": lambda raw: _frames(_height(_records(raw))),
    "trailing_byte": lambda raw: raw + b"\x01",
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corrupt_snapshots_are_refused_alike(name, tmp_path):
    peer, _ = synced("port", limit=2)
    path = tmp_path / "snap"
    S.export_snapshot(peer, str(path))
    path.write_bytes(CORRUPTIONS[name](path.read_bytes()))
    texts = {}
    for side in SIDES:
        mod = SIDES[side][5]
        with pytest.raises(mod.SnapshotError) as err:
            mod.load_snapshot(str(path))
        texts[side] = str(err.value)
    assert texts["port"] == texts["reference"]
