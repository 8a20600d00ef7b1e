"""The ordering-service node: registrar + cluster mesh + ticker.

The port's copy of ``bdls_tpu/models/orderer.py``. Two differences,
both the port's rule that nothing quietly leaves the card: a node built
without a ``csp`` takes :func:`~bdls_tpu_torch.crypto.factory.get_default`,
the card provider unless the process initialized another, and a node
built with ``verifier=None`` gets chains whose engines verify their
votes on the card (``ordering/chain.py``), where the reference's fall
back to its serial CPU verifier. On the CPU pass a ``csp`` and
``verifier=CpuBatchVerifier()``. The gRPC servers of the reference's
node (``models/server.py``) are not ported: the card's machine has no
grpcio.

Reference parity: ``orderer/common/server/main.go`` Main() assembly —
crypto provider, signer, ledger factory, registrar, cluster service,
tick-driven consensus (the reference's 20 ms update loop,
``orderer/consensus/bdls/chain.go:689-701``) — minus the hardcoded shims:
consenter endpoints come from channel config via ``connect_to``, identities
from the node's signer.

Thread model: network reader threads and the ticker all funnel through one
node lock; the consensus engines stay single-threaded underneath it
(the engine contract, doc.go:10-12).
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

from bdls_tpu_torch.consensus import Signer
from bdls_tpu_torch.consensus.verifier import BatchVerifier
from bdls_tpu_torch.comm.cluster import ClusterNode, ClusterPeer, CommError
from bdls_tpu_torch.crypto.csp import CSP
from bdls_tpu_torch.crypto.factory import get_default
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.chain import Chain
from bdls_tpu_torch.ordering.ledger import LedgerFactory
from bdls_tpu_torch.ordering.registrar import ChannelInfo, Registrar
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider

TICK_INTERVAL = 0.02  # the reference's 20 ms updateTick
RECONNECT_INTERVAL = 1.0


class OrdererNode:
    def __init__(
        self,
        signer: Signer,
        base_dir: Optional[str] = None,
        csp: Optional[CSP] = None,
        verifier: Optional[BatchVerifier] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics: Optional[MetricsProvider] = None,
    ):
        self.signer = signer
        self.identity = signer.identity
        self.csp = csp or get_default()
        self.lock = threading.RLock()
        self.ledger_factory = LedgerFactory(base_dir)
        self.registrar = Registrar(
            signer=signer,
            ledger_factory=self.ledger_factory,
            csp=self.csp,
            verifier=verifier,
            epoch=time.time(),
            on_chain_created=self._wire_chain,
        )
        self.cluster = ClusterNode(
            signer=signer,
            router=self._route_inbound,
            membership=self._is_member,
            host=host,
            port=port,
            pull_handler=self._serve_pull,
            block_sink=self._receive_pulled,
        )
        self.endpoints: dict[bytes, tuple[str, int]] = {}
        self._stop = threading.Event()
        self._ticker: Optional[threading.Thread] = None
        # consensus metrics surface (reference bdls/metrics.go gauges).
        # Passing the node a shared provider (the one the operations
        # server renders) lets the CSP's tpu_* instruments land on the
        # same /metrics exposition — see FactoryOpts.metrics.
        self.metrics = metrics or MetricsProvider()
        self._g_block = self.metrics.new_gauge(
            MetricOpts(namespace="consensus", subsystem="bdls",
                       name="committed_block_number", label_names=("channel",),
                       help="Latest committed block number.")
        )
        self._g_leader = self.metrics.new_gauge(
            MetricOpts(namespace="consensus", subsystem="bdls",
                       name="is_leader", label_names=("channel",),
                       help="1 if this node leads the current round.")
        )
        self._g_leader_id = self.metrics.new_gauge(
            MetricOpts(namespace="consensus", subsystem="bdls",
                       name="leader_id", label_names=("channel",),
                       help="Index of the current round leader.")
        )
        self._g_cluster = self.metrics.new_gauge(
            MetricOpts(namespace="consensus", subsystem="bdls",
                       name="cluster_size", label_names=("channel",),
                       help="Number of consenters on the channel.")
        )
        self._c_normal = self.metrics.new_gauge(
            MetricOpts(namespace="consensus", subsystem="bdls",
                       name="normal_proposals_received", label_names=("channel",),
                       help="Normal transactions accepted for ordering.")
        )
        self._c_config = self.metrics.new_gauge(
            MetricOpts(namespace="consensus", subsystem="bdls",
                       name="config_proposals_received", label_names=("channel",),
                       help="Config transactions accepted for ordering.")
        )
        # active-node tracker (reference etcdraft/tracker.go): consenters
        # with a live authenticated cluster connection right now
        self._g_active = self.metrics.new_gauge(
            MetricOpts(namespace="consensus", subsystem="bdls",
                       name="active_nodes", label_names=("channel",),
                       help="Consenters currently connected (incl. self).")
        )
        self.registrar.initialize()

    # ---- cluster wiring --------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        return self.cluster.host, self.cluster.port

    def set_endpoint(self, identity: bytes, host: str, port: int) -> None:
        """Record a consenter's address (from channel config / operator)."""
        if identity != self.identity:
            self.endpoints[identity] = (host, port)

    def _wire_chain(self, channel_id: str, chain: Chain) -> None:
        for ident in chain.participants:
            if ident != self.identity:
                chain.join(ClusterPeer(self.cluster, ident, channel_id))

    def _is_member(self, identity: bytes) -> bool:
        with self.lock:
            for chain in self.registrar.chains.values():
                if identity in chain.participants:
                    return True
        return not self.registrar.chains  # pre-join: accept, route drops

    def _route_inbound(self, channel: str, payload: bytes, from_id: bytes) -> None:
        with self.lock:
            try:
                self.registrar.route_cluster_message(channel, payload, time.time())
            except Exception:
                pass  # unknown channel / rejected message

    # ---- catch-up (cluster BlockPuller, reference bdls/util.go:129-171) --
    def _serve_pull(self, channel: str, start: int, end: int, from_id: bytes) -> None:
        MAX_BLOCKS = 64
        with self.lock:
            try:
                blocks = [
                    (b.header.number, b.SerializeToString())
                    for b in self.registrar.deliver(
                        channel, start, min(end, start + MAX_BLOCKS - 1)
                    )
                ]
            except Exception:
                return
        for number, raw in blocks:
            self.cluster.send_block(from_id, channel, number, raw)

    def _receive_pulled(
        self, channel: str, number: int, block_bytes: bytes, from_id: bytes
    ) -> None:
        with self.lock:
            chain = self.registrar.chains.get(channel)
            if chain is not None:
                chain.receive_pulled_block(block_bytes, time.time())

    def _request_catchup(self) -> None:
        with self.lock:
            gaps = [
                (cid, chain.gap(), list(chain.participants))
                for cid, chain in self.registrar.chains.items()
            ]
        for cid, gap, participants in gaps:
            if gap is None:
                continue
            for ident in participants:
                if ident != self.identity and self.cluster.request_blocks(
                    ident, cid, gap[0], gap[1]
                ):
                    break

    def _reconnect_missing(self) -> None:
        connected = set(self.cluster.connected_peers())
        for ident, (host, port) in list(self.endpoints.items()):
            if ident not in connected:
                try:
                    self.cluster.connect(ident, host, port, timeout=1.0)
                except (CommError, OSError):
                    pass

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._ticker is not None:
            return
        self._stop.clear()
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True)
        self._ticker.start()

    def _tick_loop(self) -> None:
        last_reconnect = 0.0
        while not self._stop.is_set():
            now = time.time()
            if now - last_reconnect > RECONNECT_INTERVAL:
                last_reconnect = now
                self._reconnect_missing()
                self._request_catchup()
            with self.lock:
                self.registrar.update(now)
                self._export_metrics()
            # outside the node lock: follower catch-up can touch slow
            # remote sources and must not stall broadcast/deliver
            self.registrar.poll_followers()
            self.registrar.check_evictions()
            time.sleep(TICK_INTERVAL)

    def _export_metrics(self) -> None:
        connected = set(self.cluster.connected_peers())
        for cid, chain in self.registrar.chains.items():
            m = chain.metrics
            self._g_block.set(m.committed_block_number, (cid,))
            self._g_leader.set(1.0 if m.is_leader else 0.0, (cid,))
            self._g_leader_id.set(m.leader_id, (cid,))
            self._g_cluster.set(m.cluster_size, (cid,))
            self._c_normal.set(m.normal_proposals_received, (cid,))
            self._c_config.set(m.config_proposals_received, (cid,))
            active = 1 + sum(
                1 for p in chain.participants
                if p != self.identity and p in connected
            )
            self._g_active.set(active, (cid,))

    def stop(self) -> None:
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=2.0)
            self._ticker = None
        self.cluster.close()

    # ---- client surface --------------------------------------------------
    def join_channel(self, genesis: pb.Block) -> ChannelInfo:
        with self.lock:
            return self.registrar.join_channel(genesis)

    def broadcast(self, env_bytes: bytes) -> None:
        with self.lock:
            self.registrar.broadcast(env_bytes, time.time())

    def deliver(
        self, channel_id: str, start: int = 0, stop: Optional[int] = None
    ) -> Iterator[pb.Block]:
        with self.lock:
            blocks = list(self.registrar.deliver(channel_id, start, stop))
        return iter(blocks)

    def channel_height(self, channel_id: str) -> int:
        with self.lock:
            return self.registrar.channel_info(channel_id).height

    def list_channels(self) -> list[ChannelInfo]:
        with self.lock:
            return self.registrar.list_channels()
