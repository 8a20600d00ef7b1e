"""A workload for the transaction flow, with hostile transactions.

Shared by ``chip_smoke.py`` (phase 6j) and the port's tests; it is not
part of ``bdls_tpu_torch``, because the library carries no code that
forges transactions. It drives a
:class:`~bdls_tpu_torch.models.txflow.Stack`.

:func:`plan` and :func:`submit_plan` make a workload of ``kvput``
transactions with explicit tx ids, about one in ``hostile_every``
of them hostile. A hostile transaction is built by hand, as
``Gateway.submit`` builds an envelope (:func:`hostile_envelope`):

- ``flipped_endorsement``: the second endorsement's ``sig_s`` has a bit
  flipped (``ENDORSEMENT_POLICY_FAILURE``);
- ``unknown_endorser``: the second endorsement comes from an org2 key
  the MSP does not know (``ENDORSEMENT_POLICY_FAILURE``);
- ``duplicate_txid``: an honest transaction that reuses the tx id of
  the one before it in the same block (``DUPLICATE_TXID``);
- ``bad_payload``: a creator-signed envelope whose payload is not an
  ``EndorsedAction`` (``BAD_PAYLOAD``).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Optional

from bdls_tpu_torch.models.peer import Gateway
from bdls_tpu_torch.models.txflow import CHANNEL, Stack
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import tx_digest
from bdls_tpu_torch.peer.endorser import Endorser
from bdls_tpu_torch.peer.validator import TxFlag

# an org2 key the MSP never registers
ROGUE_SCALAR = 0xBAD2

HOSTILE_FLAGS = {
    "flipped_endorsement": TxFlag.ENDORSEMENT_POLICY_FAILURE,
    "unknown_endorser": TxFlag.ENDORSEMENT_POLICY_FAILURE,
    "duplicate_txid": TxFlag.DUPLICATE_TXID,
    "bad_payload": TxFlag.BAD_PAYLOAD,
}
HOSTILE_KINDS = tuple(HOSTILE_FLAGS)
# length-delimited field 1 whose length runs past the end
BAD_PAYLOAD = b"\x0a\xff\xff\xff\xff\x0f"


@dataclass
class Planned:
    tx_id: str
    args: list
    kind: Optional[str] = None      # None: honest


@dataclass
class Submitted:
    """What a workload sent: each envelope's sha256 and its expected
    flag, the honest writes, and the host seconds of the submits."""

    expected: dict = field(default_factory=dict)
    writes: dict = field(default_factory=dict)
    order: list = field(default_factory=list)
    seconds: float = 0.0
    kinds: dict = field(default_factory=dict)


def plan(ntx: int, block_txs: int, hostile_every: int = 100,
         offset: int = 50) -> list[Planned]:
    """``ntx`` kvput transactions with explicit tx ids; the ones at
    ``i % hostile_every == offset`` hostile, the kinds in turn. A
    duplicate must share its block with the transaction it copies."""
    out = []
    n_hostile = 0
    for i in range(ntx):
        args = [f"key{i:06d}".encode(), f"value{i}".encode()]
        kind = None
        if hostile_every and i % hostile_every == offset:
            kind = HOSTILE_KINDS[n_hostile % len(HOSTILE_KINDS)]
            n_hostile += 1
        tx_id = f"tx{i:06d}"
        if kind == "duplicate_txid":
            if i % block_txs == 0:
                raise ValueError(f"tx {i} starts a block: no earlier tx "
                                 f"there to duplicate")
            tx_id = out[-1].tx_id
        out.append(Planned(tx_id, args, kind))
    return out


def _signed_envelope(gw: Gateway, tx_id: str,
                     payload: bytes) -> pb.TxEnvelope:
    env = pb.TxEnvelope()
    env.header.type = pb.TxType.TX_NORMAL
    env.header.channel_id = CHANNEL
    env.header.tx_id = tx_id
    pub = gw.client_key.public_key()
    env.header.creator_x = pub.x.to_bytes(32, "big")
    env.header.creator_y = pub.y.to_bytes(32, "big")
    env.header.creator_org = gw.client_org
    env.payload = payload
    r, s = gw.csp.sign(gw.client_key, tx_digest(env))
    env.sig_r = r.to_bytes(32, "big")
    env.sig_s = s.to_bytes(32, "big")
    return env


def hostile_envelope(stack: Stack, kind: str, args: list,
                     tx_id: str) -> bytes:
    """One hostile ``kvput`` transaction of ``kind`` (module docstring),
    built as ``Gateway.submit`` builds an envelope."""
    gw = stack.gateway
    if kind == "bad_payload":
        return _signed_envelope(gw, tx_id, BAD_PAYLOAD).SerializeToString()
    prop = gw._proposal(CHANNEL, "kvput", args)
    action = stack.peers[0].endorser.process_proposal(prop)
    if kind == "unknown_endorser":
        rogue = Endorser(stack.csp,
                         stack.csp.key_from_scalar("P-256", ROGUE_SCALAR),
                         stack.peers[1].org, stack.peers[1].state)
        rogue.endorse(action)
    else:
        second = stack.peers[1].endorser.process_proposal(prop)
        action.endorsements.extend(second.endorsements)
        if kind == "flipped_endorsement":
            e = action.endorsements[1]
            e.sig_s = e.sig_s[:-1] + bytes([e.sig_s[-1] ^ 1])
        elif kind != "duplicate_txid":
            raise ValueError(f"unknown hostile kind {kind!r}")
    return _signed_envelope(gw, tx_id,
                            action.SerializeToString()).SerializeToString()


def submit_plan(stack: Stack, txs: list[Planned]) -> Submitted:
    """Submit ``txs`` in order: honest ones through ``Gateway.submit``
    (its broadcast captured to learn the envelope's bytes), hostile ones
    built by hand and broadcast the same way."""
    out = Submitted()
    gw = stack.gateway
    sent = []
    real = gw.broadcast

    def capture(env: bytes) -> None:
        sent.append(env)
        real(env)

    gw.broadcast = capture
    t0 = time.perf_counter()
    try:
        for tx in txs:
            if tx.kind is None:
                gw.submit(CHANNEL, "kvput", tx.args, tx_id=tx.tx_id)
                flag = TxFlag.VALID
                for k in range(0, len(tx.args), 2):
                    out.writes[tx.args[k].decode()] = tx.args[k + 1]
            else:
                capture(hostile_envelope(stack, tx.kind, tx.args, tx.tx_id))
                flag = HOSTILE_FLAGS[tx.kind]
            h = hashlib.sha256(sent[-1]).digest()
            out.expected[h] = flag
            out.order.append(h)
            if tx.kind is not None:
                out.kinds[h] = tx.kind
    finally:
        gw.broadcast = real
    out.seconds = time.perf_counter() - t0
    return out
