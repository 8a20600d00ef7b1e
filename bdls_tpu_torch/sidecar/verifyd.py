"""The ``verifyd`` daemon: many node processes, one provider on the card.

The port's copy of the socket tier of ``bdls_tpu/sidecar/verifyd.py``:
the ``Frame`` schema (:mod:`bdls_tpu_torch.sidecar.verifyd_codec`),
length-prefixed (:mod:`bdls_tpu_torch.sidecar.wire`), on an
``asyncio.start_server`` loop in a daemon thread. Lane bytes are
screened once by :func:`bdls_tpu_torch.crypto.marshal.from_wire_fields`
into byte-backed requests and handed to the cross-tenant
:class:`~bdls_tpu_torch.sidecar.coalescer.Coalescer`, whose flushes run
on a :class:`~bdls_tpu_torch.crypto.torch_provider.TorchCSP` (the
kernels on the card).

Left out: the gRPC tier (``transport="auto"`` resolves to ``"socket"``;
``"grpc"`` raises) and the operations endpoint with its flight recorder
(``ops_port`` must stay ``None``).

One difference from the reference, on purpose: :meth:`VerifydServer.stop`
closes every accepted connection and waits for the close before the
loop stops, so a client sees EOF at once and redials. The reference
cancels the connection tasks and stops the loop in one step; the
transports' closes are then never run, and its clients keep a dead
session until their requests time out.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
from typing import Optional, Sequence

from bdls_tpu_torch.crypto import marshal
from bdls_tpu_torch.crypto.csp import PublicKey
from bdls_tpu_torch.sidecar import verifyd_codec as codec
from bdls_tpu_torch.sidecar import wire
from bdls_tpu_torch.sidecar.coalescer import (BlockBatch, ClientBatch,
                                              Coalescer, QuotaExceeded, Shed)
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricsProvider

_LOG = logging.getLogger("bdls_tpu_torch.verifyd")

TRANSPORTS = ("auto", "grpc", "socket")
WIRE_CURVES = ("P-256", "secp256k1", "ed25519")
# how long stop() waits for one connection's close before aborting it
_CLOSE_WAIT_S = 1.0


def pick_transport(transport: str = "auto") -> str:
    """Resolve the tier: always the socket tier in the port. The gRPC
    tier is not ported (the card's machine has no grpcio)."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}")
    if transport == "grpc":
        raise ValueError("the gRPC tier is not ported; use transport="
                         "\"socket\" (or \"auto\")")
    return "socket"


def decode_lanes(lanes: Sequence[codec.VerifyLane]):
    """Ingress decode: wire lanes -> screened byte-backed requests
    (``None`` = invalid lane, verdict False). One shared screen —
    :func:`bdls_tpu_torch.crypto.marshal.from_wire_fields` — with the
    in-process verifiers."""
    out = []
    for lane in lanes:
        if lane.curve not in WIRE_CURVES:
            out.append(None)
            continue
        out.append(marshal.from_wire_fields(
            lane.curve, lane.pub_x, lane.pub_y,
            lane.sig_r, lane.sig_s, lane.digest))
    return out


class VerifydServer:
    """One daemon instance: socket listener + coalescer.

    ``csp`` defaults to the factory's ``"TORCH"`` provider (TorchCSP on
    the card, the key cache on, ``kernel_field`` or ``BDLS_TPU_KERNEL``)
    sharing this daemon's metrics registry and tracer; ``warmup=True``
    warms every (curve, bucket) before the listener starts. Tests inject
    a provider on the CPU."""

    def __init__(
        self,
        csp=None,
        host: str = "127.0.0.1",
        port: int = 0,
        ops_port: Optional[int] = None,
        transport: str = "auto",
        flush_interval: float = 0.002,
        tenant_quota: int = 65536,
        watermarks: Optional[Sequence[int]] = None,
        tenant_watermark: int = 0,
        kernel_field: Optional[str] = None,
        warmup: bool = False,
        metrics: Optional[MetricsProvider] = None,
        tracer: Optional[tracing.Tracer] = None,
        warm_snapshot: Optional[str] = None,
    ):
        if ops_port is not None:
            raise ValueError(
                "the operations endpoint (/metrics, /healthz, /debug/slo) "
                "and its flight recorder are not ported yet: ops_port must "
                "be None")
        self.metrics = metrics or MetricsProvider()
        self.tracer = tracer or tracing.Tracer()
        self.transport = pick_transport(transport)
        if csp is None:
            from bdls_tpu_torch.crypto.factory import FactoryOpts, get_csp

            csp = get_csp(FactoryOpts(
                default="TORCH",
                torch_kernel_field=kernel_field,
                metrics=self.metrics,
                tracer=self.tracer,
            ))
            if warmup:
                csp.warmup()
        self.csp = csp
        self.coalescer = Coalescer(
            csp,
            flush_interval=flush_interval,
            tenant_quota=tenant_quota,
            watermarks=watermarks,
            tenant_watermark=tenant_watermark,
            metrics=self.metrics,
            tracer=self.tracer,
        )
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        # the pairing lane's registered committees:
        # (tenant, committee id) -> ThresholdAggregator
        self._committees: dict = {}
        # warm handoff: the pinned-table snapshot this replica restores
        # at start and writes on drain, plus the warmed key set (curve ->
        # 64-byte X||Y pubs) it offers a successor or a reconnecting
        # client through WarmState frames
        self.warm_snapshot = warm_snapshot
        self._warm_pubs: dict[str, set] = {}
        self._warm_lock = threading.Lock()
        self.restored_keys = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._asyncio_server = None
        # the accepted connections' writers, closed by stop()
        self._writers: set = set()
        self._started = threading.Event()

    # ---- shared frame handling ------------------------------------------
    def handle_frame(self, frame: codec.Frame, reply) -> None:
        """Process one inbound frame; ``reply(Frame)`` must be
        thread-safe (called from coalescer flush workers)."""
        kind, msg = frame.kind, frame.msg
        if kind == "verify":
            self._handle_verify(msg, reply)
        elif kind == "verify_block":
            self._handle_verify_block(msg, reply)
        elif kind == "warm":
            self._handle_warm(msg, reply)
        elif kind == "cert_committee":
            self._handle_cert_committee(msg, reply)
        elif kind == "cert":
            self._handle_cert(msg, reply)
        elif kind == "stats_req":
            reply(codec.Frame(stats_resp=codec.StatsResponse(
                json=self.stats_json())))
        elif kind == "warm_state_req":
            resp = codec.WarmStateResponse()
            self._fill_warm_state(resp)
            reply(codec.Frame(warm_state_resp=resp))
        # unknown/empty frames are ignored (forward compatibility)

    def _handle_verify(self, req: codec.VerifyBatchRequest, reply) -> None:
        reqs = decode_lanes(req.lanes)

        def on_done(batch: ClientBatch) -> None:
            # a verdict error (deadline expiry etc.) is the client's
            # fallback-to-local signal
            reply(codec.Frame(verdict=codec.VerifyBatchResponse(
                seq=batch.seq, n=batch.n, verdicts=bytes(batch.verdicts),
                error=batch.error)))

        batch = ClientBatch(
            tenant=req.tenant or "default",
            seq=req.seq,
            reqs=reqs,
            reply=on_done,
            traceparent=req.traceparent,
            deadline_ms=req.deadline_ms,
            lane_hint=req.lane_hint,
            tracer=self.tracer,
        )
        try:
            self.coalescer.submit(batch)
        except Shed as exc:
            # overload backpressure, not an outage: the SHED verdict
            # carries the retry hint the client's brownout controller
            # honors; the outcome tag pins the trace in the shed class
            batch.span.set_attr("outcome", "shed")
            batch.span.end(error=str(exc))
            reply(codec.Frame(verdict=codec.VerifyBatchResponse(
                seq=req.seq, n=len(req.lanes), error=str(exc), shed=True,
                retry_after_ms=exc.retry_after_ms)))
        except QuotaExceeded as exc:
            batch.span.end(error=str(exc))
            reply(codec.Frame(verdict=codec.VerifyBatchResponse(
                seq=req.seq, n=len(req.lanes), error=str(exc))))

    def _handle_verify_block(self, req: codec.VerifyBlockRequest,
                             reply) -> None:
        """The block lane: one whole block's endorsement lanes — RAW
        messages, hashed on the card by the fused program — rides the
        coalescer's block lane to ``csp.verify_block``. The verdict
        frame carries one flag byte per tx."""
        from bdls_tpu_torch.crypto import blocklane

        def error_frame(error: str, shed: bool = False,
                        retry_after_ms: float = 0.0) -> codec.Frame:
            return codec.Frame(block_verdict=codec.VerifyBlockResponse(
                seq=req.seq, ntx=len(req.policies), error=error, shed=shed,
                retry_after_ms=retry_after_ms))

        if req.curve not in ("P-256", "secp256k1"):
            reply(error_frame(f"unknown curve {req.curve!r}"))
            return
        breq = blocklane.BlockVerifyRequest(
            curve=req.curve,
            lanes=[blocklane.BlockLane(
                msg=bytes(ln.msg), qx=bytes(ln.pub_x), qy=bytes(ln.pub_y),
                r=bytes(ln.sig_r), s=bytes(ln.sig_s),
                tx=int(ln.tx), org=int(ln.org)) for ln in req.lanes],
            policies=[blocklane.BlockPolicy(
                required=int(p.required),
                orgs=tuple(int(o) for o in p.orgs))
                for p in req.policies],
            norgs=max(1, int(req.norgs)),
        )

        def on_done(batch: BlockBatch) -> None:
            flags = (b"" if batch.flags is None
                     else bytes(int(f) & 0xFF for f in batch.flags))
            reply(codec.Frame(block_verdict=codec.VerifyBlockResponse(
                seq=batch.seq, ntx=batch.req.ntx, flags=flags,
                error=batch.error)))

        batch = BlockBatch(
            tenant=req.tenant or "default",
            seq=req.seq,
            req=breq,
            reply=on_done,
            traceparent=req.traceparent,
            deadline_ms=req.deadline_ms,
            tracer=self.tracer,
        )
        try:
            self.coalescer.submit_block(batch)
        except Shed as exc:
            batch.span.set_attr("outcome", "shed")
            batch.span.end(error=str(exc))
            reply(error_frame(str(exc), True, exc.retry_after_ms))
        except QuotaExceeded as exc:
            batch.span.end(error=str(exc))
            reply(error_frame(str(exc)))

    def stats_json(self) -> str:
        """Coalescer stats plus this replica's pinned-key residency: the
        ``key_cache`` block (capacity, per-curve SKIs) shows what a warm
        frame pinned here."""
        blob = json.loads(self.coalescer.stats_json())
        cache = getattr(self.csp, "key_cache", None)
        if cache is not None:
            kc = dict(cache.stats)
            skis = getattr(cache, "skis", None)
            if callable(skis):
                kc["skis"] = skis()
            blob["key_cache"] = kc
        return json.dumps(blob)

    def _handle_warm(self, req: codec.WarmKeysRequest, reply) -> None:
        warm = getattr(self.csp, "warm_keys", None)
        if warm is None:
            reply(codec.Frame(warm_resp=codec.WarmKeysResponse(
                error="provider has no key cache")))
            return
        keys = []
        for raw in req.pubs:
            if len(raw) != 64 or req.curve not in ("P-256", "secp256k1"):
                continue
            keys.append(PublicKey(
                curve=req.curve,
                x=int.from_bytes(raw[:32], "big"),
                y=int.from_bytes(raw[32:], "big"),
            ))
        if keys:
            warm(keys, wait=False)
            with self._warm_lock:
                pubs = self._warm_pubs.setdefault(req.curve, set())
                for k in keys:
                    pubs.add(k.x.to_bytes(32, "big")
                             + k.y.to_bytes(32, "big"))
        reply(codec.Frame(warm_resp=codec.WarmKeysResponse(
            accepted=len(keys))))

    # ---- warm handoff ----------------------------------------------------
    def _fill_warm_state(self, resp: codec.WarmStateResponse) -> None:
        """What this replica already holds warm: the per-curve key set
        (a reconnecting client rewarms only its delta) and the pinned
        snapshot path a co-located successor can bulk-restore."""
        with self._warm_lock:
            warm_pubs = {c: sorted(p) for c, p in self._warm_pubs.items()}
        for curve in sorted(warm_pubs):
            resp.warmed.append(codec.WarmKeysRequest(
                curve=curve, pubs=warm_pubs[curve]))
        if self.warm_snapshot and os.path.exists(self.warm_snapshot):
            resp.snapshot_path = self.warm_snapshot

    def _restore_warm_snapshot(self) -> int:
        """Boot-time restore: checked snapshot entries re-pin as one
        bulk device load; a missing or rejected snapshot boots cold.
        Restored keys join the offered warm set."""
        path = self.warm_snapshot
        cache = getattr(self.csp, "key_cache", None)
        if not path or cache is None or not os.path.exists(path):
            return 0
        from bdls_tpu_torch.ops import table_snapshot

        on_reject = getattr(self.csp, "_count_reject", None)
        try:
            entries = table_snapshot.load_pinned_snapshot(
                path, on_reject=on_reject)
            n = cache.restore(entries)
        except Exception:  # noqa: BLE001 — a bad snapshot never fails boot
            return 0
        with self._warm_lock:
            for e in entries:
                self._warm_pubs.setdefault(e["curve"], set()).add(
                    e["x"].to_bytes(32, "big") + e["y"].to_bytes(32, "big"))
        self.restored_keys = n
        return n

    def _write_warm_snapshot(self) -> int:
        """Drain-time snapshot of the resident pinned set (best effort),
        the handoff the successor restores."""
        cache = getattr(self.csp, "key_cache", None)
        if (not self.warm_snapshot or cache is None
                or not hasattr(cache, "snapshot_to")):
            return 0
        try:
            return cache.snapshot_to(self.warm_snapshot)
        except Exception:  # noqa: BLE001 — drain must never fail on this
            return 0

    # ---- the pairing lane ------------------------------------------------
    def _handle_cert_committee(self, req: codec.CertCommitteeRequest,
                               reply) -> None:
        """Register a committee for certificate verification: the BLS
        validator pubkeys (wire points, structurally validated) plus
        the quorum. Certificates name the committee by id."""
        from bdls_tpu_torch.consensus import threshold as TH

        def resp(**kw) -> None:
            reply(codec.Frame(cert_committee_resp=codec.CertCommitteeResponse(
                **kw)))

        pks = []
        for raw in req.pks:
            try:
                pt = TH.deserialize_point(bytes(raw))
            except ValueError:
                pt = None
            if pt is None or not TH.valid_point(pt):
                resp(error="invalid pubkey point")
                return
            pks.append(pt)
        if not pks or not (0 < req.quorum <= len(pks)):
            resp(error="bad committee shape")
            return
        self._committees[(req.tenant or "default", req.committee)] = \
            TH.ThresholdAggregator(pks, int(req.quorum))
        resp(registered=len(pks))

    def _handle_cert(self, req: codec.CertBatchRequest, reply) -> None:
        """Verify a certificate batch against a registered committee:
        one pairing equation per certificate whatever the committee's
        size, batched through the provider's pairing lane (K9)."""
        from bdls_tpu_torch.consensus import threshold as TH

        out = codec.VerifyBatchResponse(seq=req.seq, n=len(req.certs))
        agg = self._committees.get((req.tenant or "default", req.committee))
        if agg is None:
            out.error = "unknown committee"
            reply(codec.Frame(verdict=out))
            return
        certs = [TH.deserialize_certificate(bytes(raw)) for raw in req.certs]
        sentinel = TH.QuorumCertificate(b"\0" * 32, (), None)
        lanes = [c if c is not None else sentinel for c in certs]
        verify = getattr(self.csp, "verify_certificates", None)
        if verify is None:
            from bdls_tpu_torch.ops import bls_kernel as K

            verify = K.verify_certificates
        oks = verify(lanes, [agg] * len(lanes))
        bitmap = bytearray((len(oks) + 7) // 8)
        for i, (c, ok) in enumerate(zip(certs, oks)):
            if c is not None and ok:
                bitmap[i >> 3] |= 1 << (i & 7)
        out.verdicts = bytes(bitmap)
        reply(codec.Frame(verdict=out))

    # ---- asyncio socket tier --------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        outq: "asyncio.Queue[Optional[bytes]]" = asyncio.Queue()
        self._writers.add(writer)

        def reply(frame: codec.Frame) -> None:
            # flush workers call this from provider threads
            data = wire.encode_frame(frame)
            loop.call_soon_threadsafe(outq.put_nowait, data)

        async def drain() -> None:
            while True:
                data = await outq.get()
                if data is None:
                    return
                writer.write(data)
                await writer.drain()

        drainer = asyncio.ensure_future(drain())
        try:
            while True:
                frame = await wire.read_frame(reader)
                self.handle_frame(frame, reply)
        except wire.OversizedFrame as exc:
            # the codec drained the payload, so the stream is still
            # framed: answer with an explicit error frame and close
            # cleanly — the client logs a classified fallback instead of
            # entering a bare reconnect loop
            reply(codec.Frame(verdict=codec.VerifyBatchResponse(error=(
                f"oversized frame ({exc.length} bytes > "
                f"{wire.MAX_FRAME}); split the batch"))))
            # let the drainer write the error frame before teardown;
            # scheduled the same way reply() is so FIFO order holds
            loop.call_soon_threadsafe(outq.put_nowait, None)
            try:
                await drainer
            except (Exception, asyncio.CancelledError):  # noqa: BLE001
                pass
        except (wire.WireError, codec.DecodeError, ConnectionError):
            pass
        finally:
            drainer.cancel()
            try:
                await drainer
            except (Exception, asyncio.CancelledError):  # noqa: BLE001
                pass
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            self._asyncio_server = await asyncio.start_server(
                self._serve_conn, self.host, self._requested_port)
            self.port = self._asyncio_server.sockets[0].getsockname()[1]
            self._started.set()

        try:
            loop.run_until_complete(boot())
            loop.run_forever()
        finally:
            if self._asyncio_server is not None:
                self._asyncio_server.close()
            loop.close()

    async def _shutdown(self) -> None:
        """Stop listening, close every accepted connection and wait for
        each close (the transports' sockets are shut on this loop), then
        let the connection handlers finish and stop the loop."""
        if self._asyncio_server is not None:
            self._asyncio_server.close()
        writers = list(self._writers)
        for w in writers:
            w.close()
        for w in writers:
            try:
                await asyncio.wait_for(w.wait_closed(), _CLOSE_WAIT_S)
            except (Exception, asyncio.TimeoutError):  # noqa: BLE001
                # a peer that does not read: drop its buffered bytes
                w.transport.abort()
        tasks = [t for t in asyncio.all_tasks()
                 if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        asyncio.get_running_loop().stop()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "VerifydServer":
        self._restore_warm_snapshot()
        self._loop_thread = threading.Thread(
            target=self._run_loop, daemon=True, name="verifyd-loop")
        self._loop_thread.start()
        if not self._started.wait(10.0):
            raise RuntimeError("verifyd listener failed to start")
        _LOG.info("verifyd up: transport=%s listen=%s:%s", self.transport,
                  self.host, self.port)
        return self

    def stop(self) -> None:
        self._write_warm_snapshot()
        if self._loop is not None:
            loop, self._loop = self._loop, None
            try:
                asyncio.run_coroutine_threadsafe(self._shutdown(), loop)
            except RuntimeError:
                pass
            if self._loop_thread is not None:
                self._loop_thread.join(timeout=5.0)
                self._loop_thread = None
        self.coalescer.close()

    def close_csp(self) -> None:
        """Shut the owned provider down too (CLI exit path)."""
        close = getattr(self.csp, "close", None)
        if close is not None:
            close()
