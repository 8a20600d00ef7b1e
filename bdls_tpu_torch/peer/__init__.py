"""Peer-side components: block delivery, transaction validation with
batched endorsement verification, and the kv committer
(reference: ``core/committer``, ``internal/pkg/peer/blocksprovider``,
``core/ledger/kvledger`` — reduced to the committed-block validation
pipeline that is BASELINE.json config 3).

The counterpart of ``bdls_tpu/peer`` on the port: ``lifecycle``,
``privdata``, ``validator``, ``committer``, ``endorser``,
``deliverclient``, the network plane (``gossip``, ``membership``,
``discovery``, ``snapshot``) and the out-of-process contract runtime
(``ccruntime``, ``ccshim``). This package imports nothing, so the
contract child (``python -S -m bdls_tpu_torch.peer.ccshim``) starts
without torch."""
