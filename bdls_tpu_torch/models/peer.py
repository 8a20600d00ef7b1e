"""The peer node assembly + gateway client flow.

Reference parity: ``internal/peer/node/start.go`` (peer assembly:
committer, endorser, delivery, state) and ``internal/pkg/gateway``
(the v2.4 client gateway: evaluate / endorse / submit / commit-status).
Gossip-style dissemination is covered by peers exposing their block store
as a ``BlockSource`` to one another (anti-entropy pull, the role of
``gossip/state``).

The port's copy of ``bdls_tpu/models/peer.py``.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Optional, Sequence

from bdls_tpu_torch.crypto.csp import CSP
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import tx_digest
from bdls_tpu_torch.ordering.ledger import MemoryLedger, _LedgerBase
from bdls_tpu_torch.peer.committer import Committer, KVState
from bdls_tpu_torch.peer.deliverclient import BFTDeliverer, BlockSource
from bdls_tpu_torch.peer.endorser import Endorser, Proposal, sign_proposal
from bdls_tpu_torch.peer.validator import EndorsementPolicy, TxFlag


# sentinel for the one legitimate membership-free construction path
_NO_MSP = object()


class PeerNode:
    """An endorsing + committing peer for one channel.

    ``msp`` is mandatory: every reference-side identity check is
    unconditional (``msp/identities.go:170-199``), so a peer without
    membership validation must be an explicit, named construction —
    :meth:`without_membership` — never an accidental omission."""

    def __init__(
        self,
        channel_id: str,
        csp: CSP,
        org: str,
        signing_key,
        genesis: pb.Block,
        orderer_sources: Sequence[BlockSource],
        policy: Optional[EndorsementPolicy] = None,
        block_store: Optional[_LedgerBase] = None,
        state_path: Optional[str] = None,
        *,
        msp,
    ):
        if msp is None:
            raise ValueError(
                "PeerNode requires an MSP; membership checks are not "
                "optional (reference msp/identities.go:170-199). For a "
                "deliberately membership-free peer in tests, use "
                "PeerNode.without_membership(...)."
            )
        if msp is _NO_MSP:
            msp = None
        self.channel_id = channel_id
        self.csp = csp
        self.org = org
        self.msp = msp
        self.state = KVState(state_path)
        self.block_store = block_store or MemoryLedger()
        if self.block_store.height() == 0:
            self.block_store.append(genesis)
        from bdls_tpu_torch.peer.privdata import PvtStore

        self.pvt_store = PvtStore(
            state_path + ".pvt" if state_path else None
        )
        # proposal_hash -> {(collection, key): cleartext}: transient
        # payloads handed over by clients pre-commit (gossip/privdata's
        # transient store)
        self._transient: dict[bytes, dict] = {}
        self.committer = Committer(
            self.block_store, self.state, csp, policy, msp=msp,
            org=org, pvt_store=self.pvt_store,
            transient_lookup=self._transient_for,
            transient_purge=self._transient_purge,
        )
        self.endorser = Endorser(csp, signing_key, org, self.state,
                                 pvt_get=self.pvt_store.get)
        # the _lifecycle system chaincode is always installed (reference:
        # lifecycle is a built-in system chaincode on every peer)
        from bdls_tpu_torch.peer.lifecycle import (
            LIFECYCLE_CONTRACT,
            lifecycle_contract,
        )

        self.endorser.register_contract(LIFECYCLE_CONTRACT, lifecycle_contract)
        # gossip-only peers (reference: non-elected peers that receive
        # blocks via gossip/state-transfer) have no orderer sources
        self.deliverer: Optional[BFTDeliverer] = (
            BFTDeliverer(
                list(orderer_sources),
                on_block=self.committer.commit_block,
                start_height=self.block_store.height(),
            )
            if orderer_sources
            else None
        )
        self._commit_listeners: list[Callable[[pb.Block, list[TxFlag]], None]] = []

    # ---- private data collections (gossip/privdata parity) -------------
    def _transient_for(self, proposal_hash: bytes):
        own = self.endorser.transient.get(proposal_hash)
        if own is not None:
            return own
        return self._transient.get(proposal_hash)

    def _transient_purge(self, proposal_hash: bytes) -> None:
        """Drop transient cleartext once its tx commits (the reference
        purges the transient store at block commit)."""
        self._transient.pop(proposal_hash, None)
        self.endorser.transient.pop(proposal_hash, None)

    def stash_private(self, proposal_hash: bytes, payloads: dict) -> None:
        """Receive transient private payloads from a client (the
        reference's transient field -> transient store)."""
        self._transient[bytes(proposal_hash)] = dict(payloads)

    def serve_private(self, requester_org: str, contract: str,
                      collection: str, key: str):
        """Reconciliation server side: hand cleartext only to members of
        the collection (privdata pull's collection ACL)."""
        from bdls_tpu_torch.peer.lifecycle import ChaincodeDefinition, defs_key

        raw = self.state.get(defs_key(contract))
        if raw is None:
            return None
        orgs = ChaincodeDefinition.from_bytes(raw).collection_orgs(collection)
        if orgs is None or requester_org not in orgs:
            return None
        return self.pvt_store.get(contract, collection, key)

    def reconcile_private(self, peers) -> int:
        """Pull missing private data from other peers, verifying each
        value against its on-chain hash (privdata reconciler)."""
        fixed = 0
        for (blk, tx, contract, coll, key) in \
                self.pvt_store.missing_snapshot():
            for other in peers:
                if other is self:
                    continue
                value = other.serve_private(self.org, contract, coll, key)
                if value is not None and self.pvt_store.resolve_missing(
                        blk, tx, contract, coll, key, value):
                    fixed += 1
                    break
        return fixed

    def definition_at(self, name: str, block_num: int):
        """The chaincode definition in effect as of ``block_num`` — the
        reference's confighistory store answers exactly this for
        collection configs (core/ledger/confighistory); here definitions
        live in versioned state, so the answer is a history walk."""
        from bdls_tpu_torch.peer.lifecycle import ChaincodeDefinition, defs_key

        best = None
        for (blk, _tx), value in self.state.history(defs_key(name)):
            if blk <= block_num:
                best = value        # a None value is a delete tombstone
        return ChaincodeDefinition.from_bytes(best) if best else None

    @classmethod
    def without_membership(cls, *args, **kwargs) -> "PeerNode":
        """TEST-ONLY: build a peer with membership checking disabled.
        Named so the absence of an MSP is visible at every call site."""
        kwargs["msp"] = _NO_MSP
        return cls(*args, **kwargs)

    # ---- block flow ------------------------------------------------------
    def poll(self) -> int:
        """Pull and commit any newly available blocks."""
        if self.deliverer is None:
            return 0
        # gossip/state-transfer may have advanced the store while this
        # peer wasn't the delivery leader; the reference's blocksprovider
        # re-reads the ledger height before every request
        self.deliverer.next_number = max(
            self.deliverer.next_number, self.height()
        )
        return self.deliverer.poll()

    def height(self) -> int:
        return self.block_store.height()

    # peers are BlockSources for each other (gossip/state-transfer role)
    def get_block(self, number: int) -> Optional[pb.Block]:
        try:
            return self.block_store.get(number)
        except Exception:
            return None

    def tx_status(self, tx_id: str) -> Optional[TxFlag]:
        """Commit status of a transaction (gateway CommitStatus)."""
        for num in range(self.block_store.height() - 1, 0, -1):
            blk = self.block_store.get(num)
            flags = blk.metadata.entries[0] if blk.metadata.entries else b""
            for t, raw in enumerate(blk.data.transactions):
                env = pb.TxEnvelope()
                try:
                    env.ParseFromString(raw)
                except Exception:
                    continue
                if env.header.tx_id == tx_id:
                    if t < len(flags):
                        return TxFlag(flags[t])
                    return TxFlag.VALID
        return None


class Gateway:
    """Client gateway: endorse -> submit -> commit-status
    (internal/pkg/gateway flow) against in-process peers + an orderer
    broadcast function."""

    def __init__(
        self,
        csp: CSP,
        client_key,
        client_org: str,
        peers: Sequence[PeerNode],
        broadcast: Callable[[bytes], None],
        required_orgs: int = 1,
    ):
        self.csp = csp
        self.client_key = client_key
        self.client_org = client_org
        self.peers = list(peers)
        self.broadcast = broadcast
        self.required_orgs = required_orgs

    def evaluate(self, channel_id: str, contract: str, args: list[bytes]):
        """Query: simulate on one peer, return the write-set without
        ordering (gateway Evaluate)."""
        prop = self._proposal(channel_id, contract, args)
        action = self.peers[0].endorser.process_proposal(prop)
        return action.write_set

    def submit(self, channel_id: str, contract: str, args: list[bytes],
               tx_id: Optional[str] = None) -> str:
        """Endorse on enough orgs, assemble, sign, and broadcast
        (gateway Endorse + Submit)."""
        prop = self._proposal(channel_id, contract, args)
        action: Optional[pb.EndorsedAction] = None
        endorsed_orgs: set[str] = set()
        for peer in self.peers:
            if len(endorsed_orgs) >= self.required_orgs:
                break
            if peer.org in endorsed_orgs:
                continue
            result = peer.endorser.process_proposal(prop)
            if action is None:
                action = result
            else:
                if (
                    result.write_set.SerializeToString()
                    != action.write_set.SerializeToString()
                    or result.read_set.SerializeToString()
                    != action.read_set.SerializeToString()
                ):
                    # endorsements sign the (write_set, read_set, proposal)
                    # digest — divergent simulations (e.g. a peer lagging
                    # a block behind) are unmergeable; skip this peer and
                    # let another peer of the org endorse instead
                    continue
                action.endorsements.extend(result.endorsements)
            endorsed_orgs.add(peer.org)
        if action is None or len(endorsed_orgs) < self.required_orgs:
            raise RuntimeError("insufficient endorsements")

        # distribute transient private payloads — ONLY to peers whose
        # org belongs to each touched collection (handing cleartext to a
        # non-member would void the feature's confidentiality guarantee)
        payloads = None
        src_peer = None
        for peer in self.peers:
            p = peer.endorser.transient.get(bytes(action.proposal_hash))
            if p:
                payloads, src_peer = p, peer
                break
        if payloads:
            from bdls_tpu_torch.peer.lifecycle import (
                ChaincodeDefinition,
                defs_key,
            )

            raw = src_peer.state.get(defs_key(contract))
            definition = ChaincodeDefinition.from_bytes(raw) if raw else None
            for peer in self.peers:
                subset = {
                    (coll, k): v for (coll, k), v in payloads.items()
                    if definition is not None
                    and peer.org in (definition.collection_orgs(coll) or ())
                }
                if subset:
                    peer.stash_private(bytes(action.proposal_hash), subset)

        env = pb.TxEnvelope()
        env.header.type = pb.TxType.TX_NORMAL
        env.header.channel_id = channel_id
        env.header.tx_id = tx_id or hashlib.sha256(
            prop.digest() + str(time.time()).encode()
        ).hexdigest()[:32]
        pub = self.client_key.public_key()
        env.header.creator_x = pub.x.to_bytes(32, "big")
        env.header.creator_y = pub.y.to_bytes(32, "big")
        env.header.creator_org = self.client_org
        env.payload = action.SerializeToString()
        r, s = self.csp.sign(self.client_key, tx_digest(env))
        env.sig_r = r.to_bytes(32, "big")
        env.sig_s = s.to_bytes(32, "big")
        self.broadcast(env.SerializeToString())
        return env.header.tx_id

    def commit_status(
        self, tx_id: str, timeout: Optional[float] = None,
        poll: Optional[Callable[[], None]] = None,
    ) -> Optional[TxFlag]:
        """Wait for a commit flag on any peer (gateway CommitStatus)."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if poll is not None:
                poll()
            else:
                for p in self.peers:
                    p.poll()
            for p in self.peers:
                flag = p.tx_status(tx_id)
                if flag is not None:
                    return flag
            if deadline is not None and time.time() > deadline:
                return None
            if timeout is not None and timeout == 0.0:
                return None
            time.sleep(0.05)

    def _proposal(self, channel_id: str, contract: str, args) -> Proposal:
        return sign_proposal(
            self.csp,
            self.client_key,
            Proposal(
                channel_id=channel_id,
                contract=contract,
                args=list(args),
                creator_x=b"",
                creator_y=b"",
                creator_org=self.client_org,
            ),
        )
