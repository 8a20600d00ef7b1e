"""``RemoteCSP`` — the node-side client for the verifyd sidecar fleet.

The port's copy of the socket tier of ``bdls_tpu/sidecar/remote_csp.py``
over the hand-written frame codec; it talks to the port's daemon and to
the reference's socket tier alike. The gRPC tier is not ported
(``transport="grpc"`` raises).

Implements the CSP SPI, so consensus (:class:`CspBatchVerifier`), the
committer, and policy evaluation swap onto the shared daemon with zero
call-site changes — the same property the provider boundary guaranteed
for the in-process TorchCSP. Key management, hashing, and signing stay on
the local ``sw`` provider (private keys never cross the wire); only
``verify_batch`` is forwarded.

The client is fleet-aware: ``endpoint`` may name N daemons
(comma-separated or a sequence), and every request routes by its key's
SKI over a shared consistent-hash ring (:mod:`bdls_tpu_torch.sidecar.router`)
so the replicas' pinned-key pools *partition* — aggregate cache
capacity scales linearly with replica count instead of N copies of the
same working set. Quorum-hinted (vote-lane) batches route *whole* to
one replica chosen by the batch's minimum SKI, which is
order-independent across nodes, so a round's votes co-locate and the
daemon's speculative quorum flush still fires.

Failure semantics (the part that makes a sidecar deployable):

- **never stall**: every remote call carries a deadline; a dead,
  hung, or unreachable daemon means those lanes re-verify on the local
  ``sw`` provider (``verifyd_client_fallbacks_total`` increments) —
  no request is ever lost, no caller ever blocks past
  ``request_timeout``;
- **failover re-hash**: with N>1 replicas, lanes homed on a dead
  replica re-route to the next live replica on the ring (deterministic
  across clients) before any sw fallback happens;
- **reconnect**: each replica channel redials independently with
  jittered, capped exponential backoff (``retry_backoff=(base, cap)``,
  ``retry_jitter`` fraction): when N tenants lose the same daemon they
  decorrelate instead of thundering back in lockstep. Every chosen
  delay is observed in ``verifyd_client_redial_backoff_seconds``;
- **rewarm before re-route**: when a replica comes back, the keys
  homed on its hash-ring range are re-warmed over the fresh session
  *before* verify traffic routes back to it, so the first post-restart
  buckets do not eat pinned-cache misses
  (``verifyd_client_rewarm_total`` counts the keys re-sent);
- **deadline + traceparent propagation**: each request carries the
  caller's W3C span context, so the daemon's ``verifyd.request`` spans
  join the node's trace (queue-wait and kernel time show up inside the
  round trace even though they happened in another process).
"""

from __future__ import annotations

import logging
import random
import socket
import threading
import time
from typing import Optional, Sequence, Union

from bdls_tpu_torch.crypto.csp import CSP, PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.sidecar import verifyd_codec as codec
from bdls_tpu_torch.sidecar import wire
from bdls_tpu_torch.sidecar.router import HashRing, affinity_ski
from bdls_tpu_torch.sidecar.verifyd import pick_transport
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider

_LOG = logging.getLogger("bdls_tpu_torch.remote_csp")


class _Pending:
    __slots__ = ("event", "verdict", "error")

    def __init__(self):
        self.event = threading.Event()
        self.verdict = None  # VerifyBatchResponse | VerifyBlockResponse
        self.error: Optional[str] = None


class _SocketSession:
    """One connected socket + reader thread."""

    def __init__(self, endpoint: str, timeout: float, on_frame, on_close):
        host, _, port = endpoint.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                        timeout=timeout)
        sock.settimeout(None)
        self._sock = sock
        self._wlock = threading.Lock()
        self._on_frame = on_frame
        self._on_close = on_close
        self._closed = False
        threading.Thread(target=self._read_loop, daemon=True,
                         name="remote-csp-read").start()

    def send(self, frame: codec.Frame) -> None:
        data = wire.encode_frame(frame)
        with self._wlock:
            self._sock.sendall(data)

    def _read_loop(self) -> None:
        try:
            while True:
                self._on_frame(wire.recv_frame(self._sock))
        except Exception:  # noqa: BLE001 — any read error = session down
            pass
        finally:
            self.close()
            self._on_close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # wakes the reader thread blocked in recv, then frees the fd
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _Brownout:
    """Per-endpoint brownout circuit breaker.

    Walks REMOTE -> MIXED -> LOCAL on *consecutive* overload signals
    (SHED verdicts, client deadline expiries) and probes back up
    half-open. In MIXED only firehose-class batches are kept local —
    vote-class (quorum-hinted) batches always ride the remote path; in
    LOCAL everything is kept local. After the hold-down (the daemon's
    ``retry_after_ms`` hint, decorrelated with the owner's jitter RNG)
    one probe batch is let through; its outcome decides between
    re-promotion (one tier per success) and a fresh hold-down.
    """

    REMOTE, MIXED, LOCAL = 0, 1, 2
    TIER_NAMES = ("REMOTE", "MIXED", "LOCAL")

    def __init__(self, owner: "RemoteCSP"):
        self._owner = owner
        self._lock = threading.Lock()
        self.tier = self.REMOTE
        self._consec = 0
        self._hold_until = 0.0
        self._probing = False
        self.demotions = 0
        self.promotions = 0

    @property
    def tier_name(self) -> str:
        return self.TIER_NAMES[self.tier]

    def allow(self, is_vote: bool) -> bool:
        """Admission for one batch on this endpoint's remote path."""
        with self._lock:
            if self.tier == self.REMOTE:
                return True
            if self.tier == self.MIXED and is_vote:
                return True
            # demoted class: blocked until the hold-down lapses, then
            # exactly one half-open probe rides the remote path
            if (not self._probing
                    and time.monotonic() >= self._hold_until):
                self._probing = True
                return True
            return False

    def record_ok(self) -> None:
        with self._lock:
            self._consec = 0
            if self._probing:
                self._probing = False
                if self.tier:
                    self.tier -= 1
                    self.promotions += 1

    def record_overload(self, retry_after_ms: float = 0.0) -> None:
        """One shed or deadline signal from this endpoint."""
        owner = self._owner
        hold = max(retry_after_ms / 1000.0, owner.retry_backoff[0])
        if owner.brownout_hold is not None:
            hold = owner.brownout_hold
        elif owner.retry_jitter:
            hold *= 1.0 + owner._jitter_rng.uniform(
                -owner.retry_jitter, owner.retry_jitter)
        with self._lock:
            self._probing = False
            self._consec += 1
            if (self._consec >= owner.brownout_threshold
                    and self.tier < self.LOCAL):
                self.tier += 1
                self.demotions += 1
                self._consec = 0
            self._hold_until = time.monotonic() + hold

    def probe_aborted(self) -> None:
        """The admitted call died for a non-overload reason
        (disconnect) — release the probe slot without judging it."""
        with self._lock:
            self._probing = False

    def snapshot(self) -> dict:
        with self._lock:
            return {"tier": self.tier_name, "demotions": self.demotions,
                    "promotions": self.promotions}


class _Channel:
    """Per-replica connection state: one session, one pending table,
    one independent redialer. All channels of a :class:`RemoteCSP`
    share the parent's metric instruments (one client, N replicas)."""

    def __init__(self, owner: "RemoteCSP", endpoint: str):
        self.owner = owner
        self.endpoint = endpoint
        self._lock = threading.Lock()
        self._session = None
        self._seq = 0
        self._pending: dict[int, _Pending] = {}
        self._stats_cb = None
        self._warmstate_cb = None
        self._redialing = False
        self.closed = False
        self.brownout = _Brownout(owner)

    # ---- session management ----------------------------------------------
    @property
    def connected(self) -> bool:
        with self._lock:
            return self._session is not None

    @property
    def routable(self) -> bool:
        """Worth routing lanes here: connected, or never failed / ready
        for a fresh bounded dial. A channel in redial backoff is not."""
        with self._lock:
            return self._session is not None or not self._redialing

    def _connect(self):
        return _SocketSession(self.endpoint, self.owner.connect_timeout,
                              self._on_frame, self._on_session_closed)

    def get_session(self, dial: bool = True):
        """Current session; with ``dial``, one bounded connect attempt
        when none exists (first use / after the redialer gave way)."""
        with self._lock:
            if self._session is not None or self.closed:
                return self._session
            if not dial or self._redialing:
                return None
        try:
            session = self._connect()
        except Exception:  # noqa: BLE001 — unreachable daemon
            self._spawn_redialer()
            return None
        with self._lock:
            if self.closed:
                session.close()
                return None
            self._session = session
        self.owner._channel_state_changed()
        return session

    def _on_session_closed(self) -> None:
        with self._lock:
            self._session = None
            pending = list(self._pending.values())
            self._pending.clear()
        self.owner._channel_state_changed()
        for p in pending:
            p.error = "session closed"
            p.event.set()
        if not self.closed:
            self._spawn_redialer()

    def _spawn_redialer(self) -> None:
        with self._lock:
            if self._redialing or self.closed:
                return
            self._redialing = True
        threading.Thread(target=self._redial_loop, daemon=True,
                         name="remote-csp-redial").start()

    def _redial_loop(self) -> None:
        owner = self.owner
        delay, cap = owner.retry_backoff
        try:
            while not self.closed and not owner._closed:
                # clamp the deterministic step to the cap, then
                # decorrelate: N clients that lost the same daemon
                # spread over [step*(1-j), step*(1+j)] instead of
                # hammering in lockstep
                step = min(delay, cap)
                if owner.retry_jitter:
                    step *= 1.0 + owner._jitter_rng.uniform(
                        -owner.retry_jitter, owner.retry_jitter)
                owner._h_redial_backoff.observe(step)
                time.sleep(step)
                delay = min(delay * 2, cap)
                try:
                    session = self._connect()
                except Exception:  # noqa: BLE001 — keep backing off
                    continue
                # rewarm this replica's hash range BEFORE publishing the
                # session: the first post-restart verify buckets find
                # their keys already pinned
                owner._rewarm_channel(self, session)
                with self._lock:
                    if self.closed:
                        session.close()
                        return
                    self._session = session
                owner._channel_state_changed()
                owner._c_reconnects.add()
                _LOG.info("reconnected to verifyd at %s", self.endpoint)
                return
        finally:
            with self._lock:
                self._redialing = False

    def _on_frame(self, frame: codec.Frame) -> None:
        kind, msg = frame.kind, frame.msg
        if kind == "stats_resp":
            with self._lock:
                cb = self._stats_cb
            if cb is not None:
                cb(msg.json)
            return
        if kind == "warm_state_resp":
            with self._lock:
                cb = self._warmstate_cb
            if cb is not None:
                cb(msg)
            return
        if kind not in ("verdict", "block_verdict"):
            return  # warm_resp is fire-and-forget here
        with self._lock:
            p = self._pending.pop(msg.seq, None)
        if p is not None:
            p.verdict = msg
            p.event.set()

    def next_seq(self) -> tuple[int, _Pending]:
        with self._lock:
            self._seq += 1
            seq = self._seq
            pend = _Pending()
            self._pending[seq] = pend
        return seq, pend

    def drop_pending(self, seq: int) -> None:
        with self._lock:
            self._pending.pop(seq, None)

    def close(self) -> None:
        self.closed = True
        with self._lock:
            session, self._session = self._session, None
        if session is not None:
            session.close()


def _parse_endpoints(endpoint: Union[str, Sequence[str]]) -> list[str]:
    if isinstance(endpoint, str):
        parts = [p.strip() for p in endpoint.split(",")]
    else:
        parts = [str(p).strip() for p in endpoint]
    eps = [p for p in parts if p]
    if not eps:
        raise ValueError("RemoteCSP needs at least one endpoint")
    # dedupe, order-preserving (ring routing itself is order-blind)
    seen: dict[str, None] = {}
    for e in eps:
        seen.setdefault(e)
    return list(seen)


class RemoteCSP(CSP):
    """CSP that forwards ``verify_batch`` to a fleet of verifyd
    daemons, key-affinity-routed over a consistent-hash ring."""

    def __init__(
        self,
        endpoint: Union[str, Sequence[str]],
        transport: str = "auto",
        tenant: str = "default",
        request_timeout: float = 5.0,
        connect_timeout: float = 1.0,
        retry_backoff: tuple[float, float] = (0.05, 2.0),
        retry_jitter: float = 0.5,
        brownout_threshold: int = 3,
        brownout_hold: Optional[float] = None,
        metrics: Optional[MetricsProvider] = None,
        tracer: Optional[tracing.Tracer] = None,
    ):
        self.endpoints = tuple(_parse_endpoints(endpoint))
        # single-endpoint attribute kept for logs/back-compat callers
        self.endpoint = (self.endpoints[0] if len(self.endpoints) == 1
                         else ",".join(self.endpoints))
        self.transport = pick_transport(transport)
        self.tenant = tenant
        self.request_timeout = request_timeout
        self.connect_timeout = connect_timeout
        self.retry_backoff = retry_backoff
        # +/- fraction applied to each backoff step (0 disables): the
        # thundering-herd guard for N tenants redialing one daemon
        self.retry_jitter = max(0.0, min(1.0, retry_jitter))
        # brownout breaker knobs: this many CONSECUTIVE
        # shed/deadline signals demote an endpoint one tier
        # (REMOTE -> MIXED -> LOCAL); brownout_hold pins the half-open
        # hold-down (None = honor the daemon's retry_after_ms hint with
        # decorrelated jitter)
        self.brownout_threshold = max(1, int(brownout_threshold))
        self.brownout_hold = brownout_hold
        self._jitter_rng = random.Random()
        self._sw = SwCSP()
        self.metrics = metrics or MetricsProvider()
        self.tracer = tracer or tracing.GLOBAL
        self._closed = False
        self.ring = HashRing(self.endpoints)
        self._channels = {ep: _Channel(self, ep) for ep in self.endpoints}
        # every key ever warmed, by SKI: the rewarm source of truth for
        # replicas coming back from a restart (satellite: drain the
        # returning replica's hash range before routing traffic to it)
        self._warm_lock = threading.Lock()
        self._warmed: dict[bytes, PublicKey] = {}
        # last snapshot path a daemon's WarmState offered —
        # introspection for the chaos runner / tests
        self.last_handoff_snapshot: Optional[str] = None
        # quorum-size tag forwarded on every verify frame:
        # routes this tenant's batches to the daemon's vote lane and
        # arms its speculative flush at that occupancy
        self.quorum_lanes = 0
        self._c_requests = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", subsystem="client", name="requests_total",
            help="Verify batches attempted against the sidecar."))
        self._c_remote = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", subsystem="client", name="remote_total",
            help="Verify batches answered by the sidecar."))
        self._c_fallbacks = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", subsystem="client", name="fallbacks_total",
            label_names=("reason",),
            help="Batches degraded to the local sw provider, by cause "
                 "(disconnected | deadline | quota | shed | brownout | "
                 "error). Unlabeled reads sum across reasons."))
        self._c_reconnects = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", subsystem="client", name="reconnects_total",
            help="Successful redials after a lost session."))
        self._c_rewarm = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", subsystem="client", name="rewarm_total",
            help="Keys CONFIRMED warm on a returning replica's hash "
                 "range before verify traffic was routed back to it "
                 "(re-sent + already warm via the daemon's handoff "
                 "state)."))
        self._c_rewarm_sent = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", subsystem="client",
            name="rewarm_sent_total",
            help="Keys actually re-transmitted during a reconnect "
                 "rewarm (the warm-handoff path makes this 0: the "
                 "successor restored them from its snapshot)."))
        self._c_rewarm_skipped = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", subsystem="client",
            name="rewarm_skipped_total",
            help="Reconnect rewarms skipped because the daemon's "
                 "WarmState already listed the key (snapshot restore / "
                 "surviving residency)."))
        self._g_connected = self.metrics.new_gauge(MetricOpts(
            namespace="verifyd", subsystem="client", name="connected",
            help="Number of replica sessions currently up."))
        self._h_rtt = self.metrics.new_histogram(MetricOpts(
            namespace="verifyd", subsystem="client", name="rtt_seconds",
            help="Round-trip time of remote verify batches."))
        self._h_redial_backoff = self.metrics.new_histogram(MetricOpts(
            namespace="verifyd", subsystem="client",
            name="redial_backoff_seconds",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0),
            help="Jittered backoff slept before each redial attempt "
                 "(thundering-herd decorrelation after a daemon loss)."))

    # ---- delegation (keys stay local) ------------------------------------
    def key_gen(self, curve: str, rng=None):
        return self._sw.key_gen(curve, rng)

    def key_from_scalar(self, curve: str, d: int):
        return self._sw.key_from_scalar(curve, d)

    def key_import(self, curve: str, x: int, y: int) -> PublicKey:
        return self._sw.key_import(curve, x, y)

    def hash(self, data: bytes, algo: str = "sha256") -> bytes:
        return self._sw.hash(data, algo)

    def sign(self, key_handle, digest: bytes):
        return self._sw.sign(key_handle, digest)

    # ---- fleet state ------------------------------------------------------
    @property
    def connected(self) -> bool:
        return any(ch.connected for ch in self._channels.values())

    def replica_connected(self, endpoint: str) -> bool:
        """Whether the session to one specific replica is up (the
        fleet chaos controller's restart latch)."""
        ch = self._channels.get(endpoint)
        return ch is not None and ch.connected

    def _channel_state_changed(self) -> None:
        self._g_connected.set(
            sum(1 for ch in self._channels.values() if ch.connected))

    def _routable_endpoints(self) -> list[str]:
        """Endpoints worth offering to the ring's failover walk right
        now: connected, or not currently in redial backoff (those get
        one bounded dial attempt when lanes land on them)."""
        return [ep for ep, ch in self._channels.items() if ch.routable]

    @staticmethod
    def _req_ski(r) -> bytes:
        """SKI for routing — the same digest the daemon's key-table
        cache slots by, computed from either request flavor."""
        ski = getattr(r, "ski", None)
        if callable(ski):
            try:
                return ski()
            except Exception:  # noqa: BLE001 — malformed wire lane
                return b""
        try:
            return r.key.ski()
        except Exception:  # noqa: BLE001 — screened invalid later
            return b""

    # ---- the forwarded verify path ---------------------------------------
    def verify(self, req: VerifyRequest) -> bool:
        return self.verify_batch([req])[0]

    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> list[bool]:
        if not reqs:
            return []
        reqs = list(reqs)
        self._c_requests.add()
        if len(self._channels) == 1:
            ch = next(iter(self._channels.values()))
            out, why = self._send_via(ch, reqs)
            return out if out is not None else self._fallback(reqs, why)
        if self.quorum_lanes:
            return self._verify_affine(reqs)
        return self._verify_partitioned(reqs)

    def _verify_affine(self, reqs: list) -> list[bool]:
        """Vote-lane path: the WHOLE quorum batch rides one replica so
        the daemon's speculative flush sees every lane of the round.
        The replica is chosen by the batch's minimum SKI — identical on
        every node holding the same committee, whatever the lane
        order — with the ring's deterministic failover walk on death."""
        pivot = affinity_ski(self._req_ski(r) for r in reqs)
        why = "disconnected"
        for _ in range(len(self._channels)):
            alive = self._routable_endpoints()
            ep = self.ring.lookup(pivot, alive)
            if ep is None:
                break
            out, why = self._send_via(self._channels[ep], reqs)
            if out is not None:
                return out
            if why in ("shed", "brownout", "deadline", "quota"):
                # overload verdicts are endpoint-local backpressure, not
                # a dead replica: don't hammer the next ring member with
                # the same storm — degrade this batch locally
                break
            # channel just failed its dial/send: it is now redialing
            # and drops out of the routable set, so the next lookup
            # walks to the ring's next live replica
        return self._fallback(reqs, why)

    def _verify_partitioned(self, reqs: list) -> list[bool]:
        """Firehose path: lanes partition across replicas by SKI, so
        each replica only ever sees (and pins) its own arc of the key
        space. Sub-batches dispatch concurrently; lanes homed on a
        replica that dies mid-call re-hash to the next live one."""
        skis = [self._req_ski(r) for r in reqs]
        results: list[Optional[bool]] = [None] * len(reqs)
        remaining = list(range(len(reqs)))
        whys = ["disconnected"]
        for _ in range(len(self._channels)):
            if not remaining:
                break
            alive = self._routable_endpoints()
            if not alive:
                break
            parts = self.ring.partition([skis[i] for i in remaining],
                                        alive)
            jobs = []  # (endpoint, global lane indices)
            for ep, local in parts.items():
                if not ep:
                    continue  # no live home — retry next pass/fallback
                jobs.append((ep, [remaining[j] for j in local]))
            if not jobs:
                break
            outs: list[Optional[list[bool]]] = [None] * len(jobs)

            def run(j: int) -> None:
                ep, idxs = jobs[j]
                verdicts, why = self._send_via(self._channels[ep],
                                               [reqs[i] for i in idxs])
                outs[j] = verdicts
                if verdicts is None:
                    whys.append(why)

            if len(jobs) == 1:
                run(0)
            else:
                threads = [threading.Thread(target=run, args=(j,),
                                            name="remote-csp-fanout")
                           for j in range(1, len(jobs))]
                for t in threads:
                    t.start()
                run(0)
                for t in threads:
                    t.join()
            failed: list[int] = []
            for j, (_, idxs) in enumerate(jobs):
                verdicts = outs[j]
                if verdicts is None:
                    failed.extend(idxs)
                    continue
                for i, v in zip(idxs, verdicts):
                    results[i] = v
            remaining = failed
            if remaining and all(
                    w in ("shed", "brownout", "deadline", "quota")
                    for w in whys[1:]):
                # overload, not replica death: the failed lanes' homes
                # are alive and saturated — re-hashing would just shed
                # again on the next pass, so degrade them locally now
                break
        if remaining:
            lanes = [reqs[i] for i in remaining]
            for i, v in zip(remaining, self._fallback(lanes, whys[-1])):
                results[i] = v
        return [bool(v) for v in results]

    def _send_via(self, ch: _Channel,
                  reqs: list) -> tuple[Optional[list[bool]], str]:
        """One batch over one replica channel. Returns
        ``(verdicts, reason)``; verdicts ``None`` means the channel
        could not answer, with the classified reason (``disconnected`` |
        ``deadline`` | ``quota`` | ``shed`` | ``brownout`` | ``error``)
        — the caller decides between failover and sw fallback. Shed and
        deadline outcomes feed the endpoint's brownout breaker."""
        is_vote = self.quorum_lanes > 0
        if not ch.brownout.allow(is_vote):
            return None, "brownout"
        session = ch.get_session()
        if session is None:
            ch.brownout.probe_aborted()
            return None, "disconnected"
        seq, pend = ch.next_seq()
        msg = codec.VerifyBatchRequest(
            seq=seq, tenant=self.tenant,
            deadline_ms=self.request_timeout * 1000.0,
            lane_hint=self.quorum_lanes)
        frame = codec.Frame(verify=msg)
        # the request carries the CLIENT span's context (not merely the
        # enclosing round's), so the daemon's verifyd.request stitches as
        # a child of verifyd.client_verify across the process boundary
        cspan = self.tracer.span("verifyd.client_verify",
                                 attrs={"n": len(reqs), "seq": seq,
                                        "replica": ch.endpoint})
        msg.traceparent = cspan.traceparent()
        for r in reqs:
            wire32 = getattr(r, "wire32", None)
            if wire32 is not None:
                qx, qy, rr, ss, ee = wire32()
            else:
                try:
                    qx = r.key.x.to_bytes(32, "big")
                    qy = r.key.y.to_bytes(32, "big")
                    rr = r.r.to_bytes(32, "big")
                    ss = r.s.to_bytes(32, "big")
                    ee = r.digest
                except (OverflowError, ValueError):
                    # out-of-range values can't be wire-encoded; an
                    # over-long field makes the daemon screen the lane
                    # invalid, same verdict the local screen would give
                    qx = qy = rr = ss = b"\0" * 33
                    ee = b"\0" * 32
            msg.lanes.append(codec.VerifyLane(
                curve=getattr(r, "curve", None) or r.key.curve,
                pub_x=qx, pub_y=qy, digest=ee, sig_r=rr, sig_s=ss))

        t0 = time.perf_counter()
        with cspan:
            try:
                session.send(frame)
            except Exception:  # noqa: BLE001 — send failed, session dead
                session.close()
                ch.drop_pending(seq)
                ch.brownout.probe_aborted()
                return None, "disconnected"
            if not pend.event.wait(self.request_timeout):
                ch.drop_pending(seq)
                # an unanswered deadline is an overload signal too: a
                # saturated daemon and a dead one look the same to the
                # waiting caller, and both should brown the tier down
                ch.brownout.record_overload()
                return None, "deadline"
        if pend.verdict is None:
            ch.brownout.probe_aborted()
            return None, "disconnected"
        if pend.verdict.shed:
            ch.brownout.record_overload(pend.verdict.retry_after_ms)
            return None, "shed"
        if pend.verdict.error:
            err = pend.verdict.error
            if "quota" in err:
                ch.brownout.probe_aborted()
                return None, "quota"
            if "deadline" in err:
                # server-side expiry: the daemon queued past our budget
                ch.brownout.record_overload()
                return None, "deadline"
            ch.brownout.probe_aborted()
            return None, "error"
        ch.brownout.record_ok()
        self._h_rtt.observe(time.perf_counter() - t0)
        self._c_remote.add()
        v = pend.verdict.verdicts
        return ([bool(v[i >> 3] >> (i & 7) & 1) if (i >> 3) < len(v)
                 else False
                 for i in range(len(reqs))], "")

    # ---- the block lane -------------------------------------------------
    def verify_block(self, req) -> "list":
        """Forward one whole-block verify to the daemon's block lane —
        raw messages cross the wire; the daemon's fused program hashes,
        verifies, and tallies policies in one device launch. A block
        routes WHOLE to one replica (it is indivisible), chosen by the
        lanes' affinity SKI so repeated blocks over the same endorser
        set land on the replica already holding those keys pinned. Any
        failure degrades to the local host reference path — same
        never-stall contract as ``verify_batch``."""
        from bdls_tpu_torch.crypto import blocklane

        self._c_requests.add()
        why = "disconnected"
        if len(self._channels) == 1:
            ch = next(iter(self._channels.values()))
            out, why = self._send_block_via(ch, req)
            if out is not None:
                return out
        else:
            pivot = affinity_ski(self._lane_ski(ln) for ln in req.lanes)
            for _ in range(len(self._channels)):
                alive = self._routable_endpoints()
                ep = self.ring.lookup(pivot, alive)
                if ep is None:
                    break
                out, why = self._send_block_via(self._channels[ep], req)
                if out is not None:
                    return out
                if why in ("shed", "brownout", "deadline", "quota"):
                    break
        label = (why if why in self._FALLBACK_REASONS else "disconnected")
        self._c_fallbacks.add(1, (label,))
        with self.tracer.span("verifyd.client_block_fallback",
                              attrs={"lanes": len(req.lanes),
                                     "txs": req.ntx, "cause": why[:120],
                                     "outcome": ("shed" if label == "shed"
                                                 else "fallback")}):
            return blocklane.verify_block_host(self._sw.verify_batch, req)

    @staticmethod
    def _lane_ski(ln) -> bytes:
        """Routing SKI from a block lane's wire key fields (the same
        digest ``PublicKey.ski()`` yields for in-range keys)."""
        import hashlib

        if len(ln.qx) > 32 or len(ln.qy) > 32:
            return b""  # screened invalid later; routing is moot
        return hashlib.sha256(b"\x04" + ln.qx.rjust(32, b"\0")
                              + ln.qy.rjust(32, b"\0")).digest()

    def _send_block_via(self, ch: _Channel, req):
        """One block over one replica channel; mirrors
        :meth:`_send_via`'s classified-reason contract, but the verdict
        decodes to per-tx int32 flags instead of a lane bitmap."""
        import numpy as np

        if not ch.brownout.allow(False):  # block = firehose-class
            return None, "brownout"
        session = ch.get_session()
        if session is None:
            ch.brownout.probe_aborted()
            return None, "disconnected"
        seq, pend = ch.next_seq()
        msg = codec.VerifyBlockRequest(
            seq=seq, tenant=self.tenant,
            deadline_ms=self.request_timeout * 1000.0, curve=req.curve,
            norgs=max(1, int(req.norgs)))
        frame = codec.Frame(verify_block=msg)
        cspan = self.tracer.span("verifyd.client_verify_block",
                                 attrs={"lanes": len(req.lanes),
                                        "txs": req.ntx, "seq": seq,
                                        "replica": ch.endpoint})
        msg.traceparent = cspan.traceparent()
        msg.lanes = [codec.BlockLaneMsg(
            msg=ln.msg, pub_x=ln.qx, pub_y=ln.qy, sig_r=ln.r, sig_s=ln.s,
            tx=max(0, int(ln.tx)), org=max(0, int(ln.org)))
            for ln in req.lanes]
        msg.policies = [codec.BlockPolicyMsg(
            required=max(0, int(p.required)),
            orgs=[int(o) for o in p.orgs]) for p in req.policies]

        t0 = time.perf_counter()
        with cspan:
            try:
                session.send(frame)
            except Exception:  # noqa: BLE001 — send failed, session dead
                session.close()
                ch.drop_pending(seq)
                ch.brownout.probe_aborted()
                return None, "disconnected"
            if not pend.event.wait(self.request_timeout):
                ch.drop_pending(seq)
                ch.brownout.record_overload()
                return None, "deadline"
        if pend.verdict is None:
            ch.brownout.probe_aborted()
            return None, "disconnected"
        if pend.verdict.shed:
            ch.brownout.record_overload(pend.verdict.retry_after_ms)
            return None, "shed"
        if pend.verdict.error:
            err = pend.verdict.error
            if "quota" in err:
                ch.brownout.probe_aborted()
                return None, "quota"
            if "deadline" in err:
                ch.brownout.record_overload()
                return None, "deadline"
            ch.brownout.probe_aborted()
            return None, "error"
        flags = np.frombuffer(bytes(pend.verdict.flags),
                              dtype=np.uint8).astype(np.int32)
        if len(flags) != req.ntx:
            ch.brownout.probe_aborted()
            return None, "error"
        ch.brownout.record_ok()
        self._h_rtt.observe(time.perf_counter() - t0)
        self._c_remote.add()
        return flags, ""

    _FALLBACK_REASONS = ("disconnected", "deadline", "quota", "shed",
                         "brownout", "error")

    def _fallback(self, reqs: list, reason: str) -> list[bool]:
        """Local re-verify: the sidecar being down never loses a
        request and never stalls a node. The
        ``{reason}`` label splits overload (shed/brownout/deadline)
        from outage (disconnected) so the SLO objectives can tell them
        apart; unlabeled counter reads still sum across reasons."""
        label = (reason if reason in self._FALLBACK_REASONS
                 else "disconnected")
        self._c_fallbacks.add(1, (label,))
        # outcome tag: "shed" pins the trace in the tail sampler's
        # always-retained shed class; everything else is "fallback"
        with self.tracer.span("verifyd.client_fallback",
                              attrs={"n": len(reqs),
                                     "cause": reason[:120],
                                     "outcome": ("shed" if label == "shed"
                                                 else "fallback")}):
            return self._sw.verify_batch(reqs)

    def set_quorum_hint(self, lanes: int) -> None:
        """Tag future verify frames with the committee's quorum size
        (2t+1): the daemon routes them to its vote lane and flushes
        speculatively at that occupancy. 0 clears the tag. Same SPI as
        :meth:`TpuCSP.set_quorum_hint`, so ``CspBatchVerifier`` sets it
        blind to which provider backs it."""
        self.quorum_lanes = max(0, int(lanes or 0))

    def brownout_snapshot(self) -> dict[str, dict]:
        """Per-endpoint brownout tier + transition counts (the chaos
        runner's storm record reads this)."""
        return {ep: ch.brownout.snapshot()
                for ep, ch in self._channels.items()}

    # ---- key warmup forwarding -------------------------------------------
    def warm_keys(self, keys: Sequence[PublicKey],
                  wait: bool = False) -> None:
        """Forward consenter/endorser warmup hints, fanned out along
        the hash ring: each key warms ONLY its home replica, so the
        fleet's pinned tables partition the committee instead of each
        pinning all of it. Best-effort: a key whose home replica is
        down is remembered and re-sent when that replica reconnects
        (the rewarm drain)."""
        homed: dict[str, list[PublicKey]] = {}
        with self._warm_lock:
            for k in keys:
                try:
                    ski = k.ski()
                except Exception:  # noqa: BLE001 — unencodable key
                    continue
                self._warmed[ski] = k
                ep = self.ring.lookup(ski)
                if ep is not None:
                    homed.setdefault(ep, []).append(k)
        for ep, group in homed.items():
            session = self._channels[ep].get_session()
            if session is not None:
                self._send_warm_frames(session, group)

    def _send_warm_frames(self, session, keys: Sequence[PublicKey]) -> int:
        """Encode + send WarmKeys frames over an already-open session;
        returns how many keys were actually sent."""
        by_curve: dict[str, list[bytes]] = {}
        for k in keys:
            try:
                raw = k.x.to_bytes(32, "big") + k.y.to_bytes(32, "big")
            except (OverflowError, ValueError):
                continue
            by_curve.setdefault(k.curve, []).append(raw)
        sent = 0
        for curve, pubs in by_curve.items():
            frame = codec.Frame(warm=codec.WarmKeysRequest(
                tenant=self.tenant, curve=curve, pubs=pubs))
            try:
                session.send(frame)
            except Exception:  # noqa: BLE001 — warmup is a hint
                break
            sent += len(pubs)
        return sent

    def _rewarm_channel(self, ch: _Channel, session) -> None:
        """Drain the warm-key backlog for a returning replica's hash
        range over its fresh session, BEFORE the session is published
        for verify traffic (reconnect perf fix: no post-restart
        pinned-cache miss storm).

        Warm handoff: the channel first asks the daemon for
        its WarmState — keys the successor already restored from its
        predecessor's pinned-table snapshot are SKIPPED, so a handoff
        restart re-transmits nothing (``rewarm_sent_total`` stays 0)
        while ``rewarm_total`` still counts every key confirmed warm."""
        with self._warm_lock:
            mine = [k for ski, k in self._warmed.items()
                    if self.ring.lookup(ski) == ch.endpoint]
        if not mine:
            return
        state = self._warm_state_via(ch, session)
        already = state.get("pubs", set()) if state else set()
        need, skipped = [], 0
        for k in mine:
            try:
                raw = k.x.to_bytes(32, "big") + k.y.to_bytes(32, "big")
            except (OverflowError, ValueError):
                continue
            if (k.curve, raw) in already:
                skipped += 1
            else:
                need.append(k)
        sent = self._send_warm_frames(session, need) if need else 0
        if sent:
            self._c_rewarm_sent.add(sent)
        if skipped:
            self._c_rewarm_skipped.add(skipped)
        covered = sent + skipped
        if covered:
            self._c_rewarm.add(covered)
            _LOG.info("rewarmed %d keys on %s before re-route (%d sent, %d "
                      "already warm via handoff)", covered, ch.endpoint,
                      sent, skipped)

    def _warm_state_via(self, ch: _Channel, session) -> Optional[dict]:
        """Fire-and-collect WarmState query over a not-yet-published
        session (the :meth:`_stats_via` idiom). Returns ``{"pubs":
        {(curve, 64-byte X||Y)}, "snapshot_path": str}`` or None (old
        daemon / timeout / dead session — caller falls back to a full
        rewarm, never fails the reconnect)."""
        holder: dict = {}
        ev = threading.Event()

        def collect(resp) -> None:
            try:
                pubs = set()
                for wk in resp.warmed:
                    for raw in wk.pubs:
                        pubs.add((wk.curve, bytes(raw)))
                holder["pubs"] = pubs
                holder["snapshot_path"] = resp.snapshot_path
            finally:
                ev.set()

        with ch._lock:
            ch._warmstate_cb = collect
        try:
            frame = codec.Frame(warm_state_req=codec.WarmStateRequest(
                tenant=self.tenant))
            session.send(frame)
            if not ev.wait(self.request_timeout):
                return None
        except Exception:  # noqa: BLE001 — session died mid-request
            return None
        finally:
            with ch._lock:
                ch._warmstate_cb = None
        if holder.get("snapshot_path"):
            self.last_handoff_snapshot = holder["snapshot_path"]
        return holder or None

    def stats(self) -> Optional[dict]:
        """Daemon-side coalescer/dispatcher stats from the first
        reachable replica (None if none). Stats replies carry no seq,
        so this is fire-and-collect with a short wait."""
        for ep in self.endpoints:
            out = self._stats_via(self._channels[ep])
            if out is not None:
                return out
        return None

    def fleet_stats(self) -> dict[str, Optional[dict]]:
        """Per-replica stats keyed by endpoint (None for unreachable
        replicas) — the fleet bench's partition-proof source."""
        return {ep: self._stats_via(self._channels[ep])
                for ep in self.endpoints}

    def _stats_via(self, ch: _Channel) -> Optional[dict]:
        session = ch.get_session()
        if session is None:
            return None
        import json

        holder: dict = {}
        ev = threading.Event()

        def collect(blob: str) -> None:
            try:
                holder.update(json.loads(blob))
            finally:
                ev.set()

        with ch._lock:
            ch._stats_cb = collect
        try:
            frame = codec.Frame(kind="stats_req")
            session.send(frame)
            ev.wait(self.request_timeout)
        except Exception:  # noqa: BLE001 — session died mid-request
            return None
        finally:
            with ch._lock:
                ch._stats_cb = None
        return holder or None

    # ---- health / lifecycle ----------------------------------------------
    def healthy(self) -> bool:
        """The node stays healthy while the LOCAL fallback works; the
        connected gauge says whether the sidecar is being used."""
        return True

    def close(self) -> None:
        self._closed = True
        for ch in self._channels.values():
            ch.close()
