"""Peer-side components: block delivery, transaction validation with
batched endorsement verification, and the kv committer
(reference: ``core/committer``, ``internal/pkg/peer/blocksprovider``,
``core/ledger/kvledger`` — reduced to the committed-block validation
pipeline that is BASELINE.json config 3).

The counterpart of ``bdls_tpu/peer`` on the port: ``lifecycle``,
``privdata``, ``validator``, ``committer``, ``endorser`` and
``deliverclient``. Gossip, discovery, membership, snapshots and the
chaincode runtime are not ported yet."""
