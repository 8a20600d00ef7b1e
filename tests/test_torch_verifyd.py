"""The port's verifyd daemon and client, on the CPU.

The port's copies of the daemon cases of ``tests/test_sidecar.py`` and
the client cases of ``tests/test_overload.py`` (brownout, the shed round
trip, the oversized frame), the warm handoff of
``tests/test_coldstart.py`` and the certificate lane of
``tests/test_committee_growth.py``, run on the port's ``VerifydServer``
and ``RemoteCSP`` over ``TorchCSP(device="cpu", kernel_field="sw")``
(the integer ECDSA as the provider: real signatures, real verdicts).
Among them the three the reference fails (daemon death and reconnect,
fleet failover, fleet rewarm; its ``stop()`` leaves every accepted
connection open): the port's ``stop()`` closes them, and a raw socket
sees EOF at once. Then interop both ways, the reference's client
against the port's daemon and the port's client against the
reference's daemon (``TpuCSP(kernel_field="sw")``), each through
verify, the vote lane, the block lane, warm, stats, a shed and an
oversized frame; four tenants' concurrent vote flushes over the K3
ring of one (curve, bucket); the plain fold twin through the daemon at
bucket 8; the factory's ``"REMOTE"`` and the CLI.
"""

from __future__ import annotations

import functools
import hashlib
import os
import random
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import blocklane, vectors
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.factory import FactoryOpts, get_csp
from bdls_tpu_torch.crypto.sw import SwCSP, ecdsa_verify
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import ecdsa
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.sidecar import verifyd_codec as codec
from bdls_tpu_torch.sidecar import wire
from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP, _Brownout
from bdls_tpu_torch.sidecar.router import affinity_ski
from bdls_tpu_torch.sidecar.verifyd import (VerifydServer, decode_lanes,
                                            pick_transport)
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricsProvider

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SW = SwCSP()


# ---- harness ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _signed(curve: str, i: int):
    """The i-th seeded (public key, digest, r, s) of a curve."""
    rng = np.random.default_rng([0x5eed, i, len(curve)])
    key = SW.key_gen(curve, rng)
    digest = SW.hash(b"verifyd lane %d" % i)
    r, s = SW.sign(key, digest)
    return key.public_key(), digest, r, s


def _req(curve: str, i: int, want: bool) -> VerifyRequest:
    pub, digest, r, s = _signed(curve, i)
    return VerifyRequest(pub, digest if want else SW.hash(b"forged"), r, s)


def _batch(curve: str, start: int, want: list) -> list:
    return [_req(curve, start + j, w) for j, w in enumerate(want)]


def _provider(**kw) -> TorchCSP:
    kw.setdefault("device", "cpu")
    kw.setdefault("kernel_field", "sw")
    kw.setdefault("buckets", (8, 32, 128))
    kw.setdefault("key_cache_size", 0)
    return TorchCSP(**kw)


@pytest.fixture
def loopback():
    """In-process port daemons over a CPU provider; all stopped after."""
    made = []

    def make(flush_interval=0.01, tenant_quota=65536, key_cache_size=0,
             port=0, csp=None, **kw):
        metrics = MetricsProvider()
        tracer = tracing.Tracer()
        if csp is None:
            csp = _provider(key_cache_size=key_cache_size, metrics=metrics,
                            tracer=tracer)
        srv = VerifydServer(csp=csp, transport="socket", port=port,
                            flush_interval=flush_interval,
                            tenant_quota=tenant_quota, metrics=metrics,
                            tracer=tracer, **kw)
        srv.start()
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.stop()
        srv.close_csp()


def _ep(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def _drive(endpoint, tenant, reqs, **kw):
    client = RemoteCSP(endpoint, transport="socket", tenant=tenant, **kw)
    try:
        return client.verify_batch(reqs)
    finally:
        client.close()


def _wait(cond, timeout=10.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ---- ingress and transport -------------------------------------------------

def test_decode_lanes_screens_curve_and_fields():
    from bdls_tpu_torch.crypto.csp import WireVerifyRequest

    good = codec.VerifyLane(curve="secp256k1", pub_x=b"\x01", pub_y=b"\x02",
                            sig_r=b"\x03", sig_s=b"\x04",
                            digest=b"\x05" * 32)
    ed = codec.VerifyLane(curve="ed25519", pub_x=b"\x01")
    lanes = decode_lanes([good, ed, codec.VerifyLane(curve="ed448"),
                          codec.VerifyLane(curve="P-256",
                                           pub_x=b"\x01" * 40)])
    assert isinstance(lanes[0], WireVerifyRequest)
    assert lanes[1].curve == "ed25519"
    assert lanes[2] is None and lanes[3] is None


def test_transport_tiers_and_the_missing_ops_endpoint():
    assert pick_transport("auto") == "socket"
    assert pick_transport("socket") == "socket"
    with pytest.raises(ValueError, match="gRPC"):
        pick_transport("grpc")
    with pytest.raises(ValueError):
        pick_transport("carrier-pigeon")
    with pytest.raises(ValueError, match="operations endpoint"):
        VerifydServer(csp=_provider(), ops_port=0)
    with pytest.raises(ValueError, match="gRPC"):
        RemoteCSP("127.0.0.1:1", transport="grpc")


# ---- cross-tenant coalescing + demux ---------------------------------------

def test_cross_tenant_coalescing_demux(loopback):
    # a window wide enough for three barrier-released tenants to meet in
    # one flush on a loaded machine
    srv = loopback(flush_interval=0.2)
    results = {}
    barrier = threading.Barrier(3)

    def drive(i):
        want = [(i + j) % 3 != 0 for j in range(10)]
        reqs = _batch("secp256k1", 100 * i, want)
        client = RemoteCSP(_ep(srv), transport="socket",
                           tenant=f"tenant-{i}")
        try:
            barrier.wait(10)
            results[i] = (client.verify_batch(reqs), want,
                          client._c_fallbacks.value())
        finally:
            client.close()

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 3
    for i, (got, want, fallbacks) in results.items():
        assert got == want, f"tenant {i} verdicts demuxed wrong"
        assert fallbacks == 0
    st = srv.coalescer.stats
    assert st["multi_tenant_buckets"] >= 1
    assert any(len(b["tenants"]) >= 2 for b in st["recent_buckets"])
    c = srv.metrics.find("verifyd_requests_total")
    assert c.value(("tenant-0",)) == 1 and c.value(("tenant-2",)) == 1


def test_mixed_curve_batches_split_buckets(loopback):
    srv = loopback(flush_interval=0.05)
    out = {}
    barrier = threading.Barrier(2)

    def drive(i, curve):
        want = [j % 2 == 0 for j in range(6)]
        client = RemoteCSP(_ep(srv), transport="socket", tenant=f"t{i}")
        try:
            barrier.wait(10)
            out[i] = (client.verify_batch(_batch(curve, 50 * i, want)), want)
        finally:
            client.close()

    ts = [threading.Thread(target=drive, args=(0, "P-256")),
          threading.Thread(target=drive, args=(1, "secp256k1"))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for i in (0, 1):
        assert out[i][0] == out[i][1]
    curves = {b["curve"] for b in srv.coalescer.stats["recent_buckets"]}
    assert curves == {"P-256", "secp256k1"}


def test_invalid_lane_rejected_remotely(loopback):
    srv = loopback()
    huge = VerifyRequest(key=PublicKey("secp256k1", 1 << 256, 2),
                         digest=b"\x00" * 32, r=3, s=1)
    good = _req("secp256k1", 7, True)
    assert _drive(_ep(srv), "t0", [good, huge, good]) == [True, False, True]
    assert srv.metrics.find(
        "verifyd_invalid_lanes_total").value(("t0",)) == 1


def test_tenant_quota_rejection_degrades_to_local(loopback, monkeypatch):
    srv = loopback(tenant_quota=4, flush_interval=0.2)
    client = RemoteCSP(_ep(srv), transport="socket", tenant="greedy")
    local_calls = []
    monkeypatch.setattr(
        client._sw, "verify_batch",
        lambda reqs: local_calls.append(len(reqs)) or [True] * len(reqs))
    try:
        out = client.verify_batch(_batch("secp256k1", 0, [True] * 8))
        assert out == [True] * 8
        assert local_calls == [8]
        assert client._c_fallbacks.value(("quota",)) == 1
        assert srv.metrics.find(
            "verifyd_quota_rejections_total").value(("greedy",)) == 1
    finally:
        client.close()


def test_quorum_hint_rides_wire_to_vote_lane(loopback):
    srv = loopback(flush_interval=2.0)
    client = RemoteCSP(_ep(srv), transport="socket", tenant="voter")
    try:
        want = [j % 3 != 0 for j in range(9)]
        reqs = _batch("secp256k1", 70, want)
        client.set_quorum_hint(len(reqs))
        t0 = time.perf_counter()
        assert client.verify_batch(reqs) == want
        wall = time.perf_counter() - t0
    finally:
        client.close()
    assert wall < 1.5, f"vote round trip waited the window: {wall:.2f}s"
    st = srv.coalescer.stats
    assert st["vote_lane_batches"] >= 1 and st["quorum_flushes"] >= 1
    assert any(b.get("tier") == "latency" for b in st["recent_buckets"])


def test_consensus_seam_over_the_wire(loopback):
    """``CspBatchVerifier(RemoteCSP)`` unchanged: the committee's 2t+1
    rides every frame's ``lane_hint``, the consenters warm the daemon's
    key cache through warm frames, and the round's envelopes (one forged,
    one from outside the committee, one with an overlong key field) come
    back with the integer ECDSA's verdicts from one quorum flush."""
    from bdls_tpu_torch.consensus.identity import identity_of_key, \
        sign_payload
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
        identity_keys

    rng = np.random.default_rng(77)
    keys = [SW.key_gen("secp256k1", rng) for _ in range(7)]
    envs = [sign_payload(k, b"<commit> height 3 from %d" % i)
            for i, k in enumerate(keys[:6])]
    envs[2].payload += b" (forged)"
    envs.append(sign_payload(SW.key_gen("secp256k1", rng), b"<commit>"))
    envs.append(sign_payload(keys[6], b"<commit> overlong"))
    envs[-1].pub_x = b"\x01" + envs[-1].pub_x
    want = [True, True, False, True, True, True, True, False]
    srv = loopback(flush_interval=2.0, key_cache_size=8)
    client = RemoteCSP(_ep(srv), transport="socket", tenant="seam")
    try:
        verifier = CspBatchVerifier(
            client, consenters=[identity_of_key(k) for k in keys])
        assert client.quorum_lanes == 5   # 2t + 1 of 7
        pinned = identity_keys([identity_of_key(k) for k in keys])
        assert _wait(lambda: all(srv.csp.key_cache.contains(k)
                                 for k in pinned))
        t0 = time.perf_counter()
        assert verifier.verify_envelopes(envs) == want
        assert time.perf_counter() - t0 < 1.5  # the quorum flush, not 2 s
        st = srv.coalescer.stats
        assert st["quorum_flushes"] == 1 and st["lanes"] == 7
        assert client._c_fallbacks.value() == 0
    finally:
        client.close()


# ---- daemon death, reconnect, and the repaired stop() ----------------------

def test_stop_closes_accepted_connections_at_once(loopback):
    srv = loopback()
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
    try:
        sock.sendall(wire.encode_frame(codec.Frame(kind="stats_req")))
        assert wire.recv_frame(sock).kind == "stats_resp"
        t0 = time.perf_counter()
        srv.stop()
        sock.settimeout(1.0)
        assert sock.recv(16) == b""  # EOF, not a timeout
        assert time.perf_counter() - t0 < 1.0
    finally:
        sock.close()


def test_fallback_on_daemon_death_and_reconnect(loopback, monkeypatch):
    srv = loopback(flush_interval=0.005)
    port = srv.port
    client = RemoteCSP(_ep(srv), transport="socket", tenant="node-1",
                       request_timeout=2.0, retry_backoff=(0.05, 0.2))
    local = []
    real = client._sw.verify_batch
    monkeypatch.setattr(client._sw, "verify_batch",
                        lambda reqs: local.append(len(reqs)) or real(reqs))
    try:
        want = [j % 2 == 1 for j in range(6)]
        reqs = _batch("secp256k1", 0, want)
        assert client.verify_batch(reqs) == want      # remote path
        assert client._c_fallbacks.value() == 0

        srv.stop()                                    # daemon dies
        t0 = time.perf_counter()
        assert client.verify_batch(reqs) == want      # local fallback
        assert time.perf_counter() - t0 < client.request_timeout + 1.0
        assert client._c_fallbacks.value(("disconnected",)) >= 1
        assert local, "fallback did not reach the local sw provider"

        srv2 = loopback(flush_interval=0.005, port=port)  # it returns
        assert _wait(lambda: client.connected), "client never redialed"
        assert client._c_reconnects.value() >= 1
        local.clear()
        assert client.verify_batch(reqs) == want      # remote again
        assert not local
        assert srv2.coalescer.stats["requests"] >= 1
    finally:
        client.close()


def test_unreachable_daemon_never_stalls(monkeypatch):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    client = RemoteCSP(f"127.0.0.1:{port}", transport="socket", tenant="t",
                       connect_timeout=0.2, request_timeout=1.0)
    monkeypatch.setattr(client._sw, "verify_batch",
                        lambda reqs: [True] * len(reqs))
    try:
        t0 = time.perf_counter()
        assert client.verify_batch([_req("secp256k1", 1, True)]) == [True]
        assert time.perf_counter() - t0 < 2.0
        assert client._c_fallbacks.value() == 1
    finally:
        client.close()


def test_traceparent_stitches_across_socket(loopback):
    srv = loopback(flush_interval=0.005)
    tracer = tracing.Tracer()
    client = RemoteCSP(_ep(srv), transport="socket", tenant="traced",
                       tracer=tracer)
    try:
        with tracer.span("client.round") as root:
            trace_id = root.trace_id
            client.verify_batch([_req("secp256k1", 3, True)])
        names = set()

        def joined():
            for tr in srv.tracer.completed():
                if tr["trace_id"] == trace_id:
                    names.update(s["name"] for s in tr["spans"])
            return "verifyd.request" in names

        assert _wait(joined, 5.0)
        assert "verifyd.queue_wait" in names
    finally:
        client.close()


def test_warm_keys_forwarded_to_daemon_cache(loopback):
    srv = loopback(key_cache_size=8)
    client = RemoteCSP(_ep(srv), transport="socket", tenant="warmer")
    try:
        cv = CURVES["secp256k1"]
        key = PublicKey("secp256k1", cv.gx, cv.gy)
        client.warm_keys([key])
        assert _wait(lambda: srv.csp.key_cache.contains(key))
        blob = client.stats()
        assert blob["key_cache"]["skis"]["secp256k1"] == [key.ski().hex()]
    finally:
        client.close()


# ---- fleet routing ---------------------------------------------------------

def _gen_points(n):
    """k*G for k = 1..n on secp256k1: real points the key cache takes."""
    return [SW.key_from_scalar("secp256k1", k).public_key()
            for k in range(1, n + 1)]


def test_parse_endpoints_variants():
    a = RemoteCSP("h1:1, h2:2,h1:1", transport="socket")
    try:
        assert a.endpoints == ("h1:1", "h2:2")
        assert a.endpoint == "h1:1,h2:2"
    finally:
        a.close()
    b = RemoteCSP(["h3:3"], transport="socket")
    try:
        assert b.endpoints == ("h3:3",) and b.endpoint == "h3:3"
    finally:
        b.close()
    with pytest.raises(ValueError):
        RemoteCSP("", transport="socket")


def test_fleet_partitioned_dispatch(loopback):
    srvs = [loopback(flush_interval=0.005) for _ in range(3)]
    eps = [_ep(s) for s in srvs]
    client = RemoteCSP(eps, transport="socket", tenant="fleet")
    try:
        want = [j % 4 != 0 for j in range(24)]
        reqs = _batch("secp256k1", 200, want)
        assert client.verify_batch(reqs) == want
        assert client._c_fallbacks.value() == 0
        expect = client.ring.partition([r.key.ski() for r in reqs], eps)
        assert "" not in expect
        for srv, ep in zip(srvs, eps):
            assert srv.coalescer.counts["lanes"] == len(expect.get(ep, []))
        assert sum(len(v) for v in expect.values()) == 24
    finally:
        client.close()


def test_fleet_failover_rehashes_to_live_replica(loopback):
    srvs = [loopback(flush_interval=0.005) for _ in range(2)]
    eps = [_ep(s) for s in srvs]
    client = RemoteCSP(eps, transport="socket", tenant="failover",
                       request_timeout=2.0, retry_backoff=(0.05, 0.2))
    try:
        want = [j % 3 != 1 for j in range(16)]
        reqs = _batch("secp256k1", 400, want)
        assert client.verify_batch(reqs) == want
        srvs[1].stop()
        assert client.verify_batch(reqs) == want       # re-hash, not sw
        assert client._c_fallbacks.value() == 0
        assert srvs[0].coalescer.counts["lanes"] >= 16
    finally:
        client.close()


def test_fleet_vote_lane_affinity(loopback):
    srvs = [loopback(flush_interval=2.0) for _ in range(2)]
    eps = [_ep(s) for s in srvs]
    client = RemoteCSP(eps, transport="socket", tenant="voter")
    try:
        want = [j % 5 != 2 for j in range(9)]
        reqs = _batch("secp256k1", 600, want)
        client.set_quorum_hint(len(reqs))
        t0 = time.perf_counter()
        assert client.verify_batch(reqs) == want
        assert time.perf_counter() - t0 < 1.5
        home = client.ring.lookup(affinity_ski(r.key.ski() for r in reqs))
        for srv, ep in zip(srvs, eps):
            assert srv.coalescer.counts["requests"] == (
                1 if ep == home else 0)
    finally:
        client.close()


def test_fleet_warm_keys_partition_and_rewarm(loopback):
    srvs = [loopback(flush_interval=0.005, key_cache_size=8)
            for _ in range(2)]
    eps = [_ep(s) for s in srvs]
    client = RemoteCSP(eps, transport="socket", tenant="warm",
                       retry_backoff=(0.05, 0.2))
    try:
        keys = _gen_points(6)
        homes = {k.ski(): client.ring.lookup(k.ski()) for k in keys}
        client.warm_keys(keys)

        def pinned(si):
            mine = [k for k in keys if homes[k.ski()] == eps[si]]
            assert _wait(lambda: all(srvs[si].csp.key_cache.contains(k)
                                     for k in mine)), f"replica {si}"
            return mine

        for si in (0, 1):
            mine = pinned(si)
            assert not any(srvs[si].csp.key_cache.contains(k)
                           for k in keys if k not in mine)
        victim = 0 if any(h == eps[0] for h in homes.values()) else 1
        port = srvs[victim].port
        srvs[victim].stop()
        assert _wait(lambda: not client.replica_connected(eps[victim]), 5)
        srvs[victim] = loopback(flush_interval=0.005, key_cache_size=8,
                                port=port)
        assert _wait(lambda: client.replica_connected(eps[victim]))
        assert client._c_rewarm.value() >= 1
        pinned(victim)
    finally:
        client.close()


def test_fleet_stats_per_replica(loopback):
    srvs = [loopback(flush_interval=0.005) for _ in range(2)]
    eps = [_ep(s) for s in srvs]
    client = RemoteCSP(eps, transport="socket", tenant="statsy")
    try:
        client.verify_batch(_batch("secp256k1", 800, [True] * 8))
        blob = client.fleet_stats()
        assert set(blob) == set(eps)
        assert sum(b["coalescer"]["lanes"] for b in blob.values() if b) == 8
    finally:
        client.close()


# ---- warm handoff ------------------------------------------------------------

def test_warm_state_handoff_resends_nothing(tmp_path):
    snap = str(tmp_path / "handoff.npz")
    keys = _gen_points(3)

    def make(port=0):
        return VerifydServer(csp=_provider(key_cache_size=8),
                             transport="socket", port=port,
                             flush_interval=0.001,
                             warm_snapshot=snap).start()

    a = make()
    metrics = MetricsProvider()
    client = RemoteCSP(f"127.0.0.1:{a.port}", transport="socket",
                       tenant="t", metrics=metrics, request_timeout=2.0,
                       retry_backoff=(0.02, 0.2))
    try:
        client.warm_keys(keys)
        assert _wait(lambda: len(a.csp.key_cache) == 3)
        port = a.port
        a.stop()  # writes the snapshot
        a.close_csp()
        assert os.path.exists(snap)
        b = make(port)
        try:
            assert b.restored_keys == 3
            assert _wait(lambda: client.replica_connected(
                f"127.0.0.1:{port}"), 15)
            assert metrics.find("verifyd_client_rewarm_total").value() == 3
            assert metrics.find(
                "verifyd_client_rewarm_skipped_total").value() == 3
            assert metrics.find(
                "verifyd_client_rewarm_sent_total").value() == 0
            assert client.last_handoff_snapshot == snap
        finally:
            b.stop()
            b.close_csp()
    finally:
        client.close()


# ---- overload: brownout, the shed round trip, the oversized frame ------------

class _Owner:
    retry_backoff = (0.05, 2.0)
    retry_jitter = 0.5
    brownout_hold = 600.0
    brownout_threshold = 2

    def __init__(self):
        self._jitter_rng = random.Random(42)


def test_brownout_walk_and_half_open_probe():
    b = _Brownout(_Owner())
    assert b.allow(is_vote=False)
    for _ in range(2):
        b.record_overload(100.0)
    assert b.tier_name == "MIXED" and b.demotions == 1
    assert b.allow(is_vote=True)
    assert not b.allow(is_vote=False)
    for _ in range(2):
        b.record_overload(100.0)
    assert b.tier_name == "LOCAL" and b.demotions == 2
    assert not b.allow(is_vote=True)
    b._hold_until = 0.0
    assert b.allow(is_vote=False)
    assert not b.allow(is_vote=True)
    b.record_ok()
    assert b.tier_name == "MIXED" and b.promotions == 1
    b._hold_until = 0.0
    assert b.allow(is_vote=False)
    b.probe_aborted()
    assert b.tier_name == "MIXED" and b.promotions == 1
    assert b.allow(is_vote=False)
    b.record_overload(100.0)
    assert b.tier_name == "MIXED"
    assert not b.allow(is_vote=False)
    b.record_ok()
    assert b.tier_name == "MIXED" and b.promotions == 1


def test_brownout_retry_jitter_bounds():
    owner = _Owner()
    owner.brownout_hold = None
    owner.brownout_threshold = 99
    b = _Brownout(owner)
    for _ in range(50):
        t0 = time.monotonic()
        b.record_overload(retry_after_ms=200.0)
        assert 0.2 * 0.5 - 1e-6 <= b._hold_until - t0 <= 0.2 * 1.5 + 1e-3
    t0 = time.monotonic()
    b.record_overload(retry_after_ms=1.0)
    assert 0.05 * 0.5 - 1e-6 <= b._hold_until - t0 <= 0.05 * 1.5 + 1e-3
    owner.brownout_hold = 1.25
    t0 = time.monotonic()
    b.record_overload(retry_after_ms=200.0)
    assert b._hold_until - t0 == pytest.approx(1.25, abs=1e-3)


def test_shed_wire_roundtrip_and_brownout(loopback):
    srv = loopback(flush_interval=0.02, tenant_watermark=4)
    srv.coalescer.vote_lane_max = 0
    client = RemoteCSP(_ep(srv), transport="socket", tenant="storm",
                       request_timeout=10.0, brownout_threshold=1,
                       brownout_hold=600.0)
    try:
        want = [i % 2 == 0 for i in range(8)]
        storm = _batch("P-256", 0, want)
        assert client.verify_batch(storm) == want  # shed, answered locally
        assert client._c_fallbacks.value(("shed",)) == 1
        shed = srv.metrics.find("verifyd_shed_total")
        assert shed.value(("storm", "tenant_watermark")) == 1
        assert srv.coalescer.counts["shed_batches"] == 1
        assert srv.coalescer.counts["shed_lanes"] == 8
        (tier,) = client.brownout_snapshot().values()
        assert tier["tier"] == "MIXED" and tier["demotions"] == 1
        assert client.verify_batch(storm) == want
        assert client._c_fallbacks.value(("brownout",)) == 1
        assert shed.value() == 1
        votes = _batch("P-256", 100, [i % 3 == 0 for i in range(8)])
        client.set_quorum_hint(8)
        assert client.verify_batch(votes) == [i % 3 == 0 for i in range(8)]
        assert client._c_fallbacks.value(("shed",)) == 1
        assert client._c_remote.value() == 1
        (tier,) = client.brownout_snapshot().values()
        assert tier["tier"] == "MIXED"
    finally:
        client.close()


def _oversized(port, wire_mod):
    """Send a frame one byte over the cap; return the error frame the
    daemon answers and whether the stream then ends."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        length = wire.MAX_FRAME + 1
        sock.sendall(struct.pack("<I", length))
        chunk = b"\x00" * (1 << 20)
        left = length
        while left:
            step = min(left, len(chunk))
            sock.sendall(chunk[:step])
            left -= step
        frame = wire_mod.recv_frame(sock)
        with pytest.raises(wire_mod.WireError):
            wire_mod.recv_frame(sock)
        return frame
    finally:
        sock.close()


def test_oversized_frame_error_reply_and_close(loopback):
    srv = loopback(flush_interval=0.02)
    frame = _oversized(srv.port, wire)
    assert "oversized" in frame.verdict.error
    assert str(wire.MAX_FRAME) in frame.verdict.error


def test_garbage_frame_drops_the_connection_not_the_daemon(loopback):
    srv = loopback()
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
    try:
        sock.sendall(struct.pack("<I", 4) + bytes.fromhex("0a02fffe"))
        sock.settimeout(2.0)
        assert sock.recv(16) == b""
    finally:
        sock.close()
    assert _drive(_ep(srv), "after", [_req("P-256", 1, True)]) == [True]


# ---- the certificate lane over the wire ------------------------------------

def test_cert_lane_register_and_verify(loopback, monkeypatch):
    from bdls_tpu_torch.consensus import threshold as th
    from bdls_tpu_torch.ops import bls_host

    monkeypatch.setenv("BDLS_CERT_BACKEND", "host")
    signers = [th.VoteSigner.from_seed(0xc0 + i) for i in range(4)]
    agg = th.ThresholdAggregator([s.pk for s in signers], quorum=3)
    digest = hashlib.sha256(b"verifyd cert lane").digest()
    cert = th.QuorumCertificate(digest, (0, 1, 2), bls_host.aggregate(
        [signers[i].sign_vote(digest) for i in range(3)]))
    wrong = th.QuorumCertificate(hashlib.sha256(b"forged").digest(),
                                 cert.signers, cert.agg_sig)
    srv = loopback()
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
    try:
        sock.sendall(wire.encode_frame(codec.Frame(
            cert_committee=codec.CertCommitteeRequest(
                tenant="t0", committee="c0", quorum=agg.quorum,
                pks=[th.serialize_point(pk) for pk in agg.pks]))))
        resp = wire.recv_frame(sock).cert_committee_resp
        assert resp.registered == 4 and not resp.error
        sock.sendall(wire.encode_frame(codec.Frame(cert=codec.CertBatchRequest(
            seq=7, tenant="t0", committee="c0",
            certs=[th.serialize_certificate(cert),
                   th.serialize_certificate(wrong), b"\xff" * 40]))))
        verdict = wire.recv_frame(sock).verdict
        assert verdict.seq == 7 and verdict.n == 3
        assert [bool(verdict.verdicts[0] >> i & 1) for i in range(3)] == [
            True, False, False]
        sock.sendall(wire.encode_frame(codec.Frame(cert=codec.CertBatchRequest(
            seq=8, tenant="t0", committee="nope",
            certs=[th.serialize_certificate(cert)]))))
        assert wire.recv_frame(sock).verdict.error == "unknown committee"
        sock.sendall(wire.encode_frame(codec.Frame(
            cert_committee=codec.CertCommitteeRequest(
                tenant="t0", committee="bad", quorum=9,
                pks=[th.serialize_point(signers[0].pk)]))))
        assert wire.recv_frame(sock).cert_committee_resp.error == \
            "bad committee shape"
    finally:
        sock.close()


# ---- interop both ways ------------------------------------------------------

def _ref_reqs(reqs):
    from bdls_tpu.crypto.csp import PublicKey as JPK
    from bdls_tpu.crypto.csp import VerifyRequest as JVR

    return [JVR(JPK(r.key.curve, r.key.x, r.key.y), r.digest, r.r, r.s)
            for r in reqs]


def _ref_block(req):
    from bdls_tpu.crypto import blocklane as jbl

    return jbl.BlockVerifyRequest(
        curve=req.curve,
        lanes=[jbl.BlockLane(msg=ln.msg, qx=ln.qx, qy=ln.qy, r=ln.r, s=ln.s,
                             tx=ln.tx, org=ln.org) for ln in req.lanes],
        policies=[jbl.BlockPolicy(required=p.required, orgs=p.orgs)
                  for p in req.policies], norgs=req.norgs)


def _interop(srv_port, client_cls, to_client, block_to_client,
             key_to_client, cache_has, daemon_counts, shed_daemon_port,
             wire_mod):
    """Verify, vote lane, block, warm, stats, shed and an oversized
    frame through one client class against one daemon; returns what the
    client saw."""
    ep = f"127.0.0.1:{srv_port}"
    client = client_cls(ep, transport="socket", tenant="interop",
                        request_timeout=20.0)
    try:
        want = [j % 4 != 2 for j in range(12)]
        mixed = (_batch("P-256", 900, want[:6])
                 + _batch("secp256k1", 906, want[6:]))
        assert client.verify_batch(to_client(mixed)) == want
        client.set_quorum_hint(9)
        votes = [j % 3 != 0 for j in range(9)]
        assert client.verify_batch(to_client(
            _batch("secp256k1", 920, votes))) == votes
        client.set_quorum_hint(0)
        assert daemon_counts()["quorum_flushes"] >= 1
        req = vectors.block_request("P-256", np.random.default_rng(31), 20,
                                    hostile=True)
        flags = client.verify_block(block_to_client(req))
        oracle = blocklane.verify_block_host(SW.verify_batch, req)
        assert [int(f) for f in flags] == [int(f) for f in oracle]
        assert daemon_counts()["block_flushes"] >= 1
        cv = CURVES["secp256k1"]
        key = PublicKey("secp256k1", cv.gx, cv.gy)
        client.warm_keys([key_to_client(key)])
        assert _wait(lambda: cache_has(key))
        blob = client.stats()
        assert blob["coalescer"]["lanes"] >= 21
        assert key.ski().hex() in blob["key_cache"]["skis"]["secp256k1"]
        assert client._c_fallbacks.value() == 0
    finally:
        client.close()
    shed_client = client_cls(f"127.0.0.1:{shed_daemon_port}",
                             transport="socket", tenant="storm")
    try:
        want = [j % 2 == 0 for j in range(8)]
        assert shed_client.verify_batch(to_client(
            _batch("P-256", 940, want))) == want
        assert shed_client._c_fallbacks.value(("shed",)) == 1
    finally:
        shed_client.close()
    frame = _oversized(srv_port, wire_mod)
    return frame


def test_reference_client_against_the_port_daemon(loopback):
    from bdls_tpu.crypto.csp import PublicKey as JPK
    from bdls_tpu.sidecar import wire as jwire
    from bdls_tpu.sidecar.remote_csp import RemoteCSP as JRemoteCSP

    srv = loopback(key_cache_size=8)
    shedder = loopback(tenant_watermark=4)
    shedder.coalescer.vote_lane_max = 0
    frame = _interop(
        srv.port, JRemoteCSP, _ref_reqs, _ref_block,
        lambda k: JPK(k.curve, k.x, k.y),
        lambda k: srv.csp.key_cache.contains(k),
        lambda: srv.coalescer.counts, shedder.port, jwire)
    assert "oversized" in frame.verdict.error


def test_port_client_against_the_reference_daemon():
    from bdls_tpu.crypto.csp import PublicKey as JPK
    from bdls_tpu.crypto.tpu_provider import TpuCSP
    from bdls_tpu.sidecar.verifyd import VerifydServer as JVerifydServer

    made = []
    try:
        for kw in ({}, {"tenant_watermark": 4}):
            d = JVerifydServer(
                csp=TpuCSP(kernel_field="sw", buckets=(8, 32, 128),
                           key_cache_size=8 if not kw else 0),
                transport="socket", ops_port=None, flush_interval=0.01,
                **kw).start()
            made.append(d)
        made[1].coalescer.vote_lane_max = 0
        frame = _interop(
            made[0].port, RemoteCSP, lambda reqs: reqs, lambda req: req,
            lambda k: k,
            lambda k: made[0].csp.key_cache.contains(
                JPK(k.curve, k.x, k.y)),
            lambda: made[0].coalescer.counts, made[1].port, wire)
        assert "oversized" in frame.verdict.error
    finally:
        for d in made:
            d.stop()
            d.close_csp()


# ---- concurrent vote flushes over one bucket's K3 ring ------------------------

def _lane_verdicts(curve: str, arrs, n: int) -> list[bool]:
    """The integer ECDSA over marshalled limbs (qx, qy, r, s, e)."""
    cols = [[sum(int(a[k, j]) << (16 * k) for k in range(a.shape[0]))
             for j in range(n)] for a in arrs]
    qx, qy, r, s, e = cols
    return [ecdsa_verify(curve, qx[j], qy[j], e[j].to_bytes(32, "big"),
                         r[j], s[j]) for j in range(n)]


def test_four_tenants_concurrent_vote_flushes_over_the_ring(
        loopback, monkeypatch):
    """Four flushes of the same (curve, bucket) at once, each blocked in
    its launch: two hold the bucket's two K3 slots, the third and fourth
    find none free and launch K1 eagerly, counted as no cold fallback;
    every verdict right."""
    gate = threading.Event()
    entered = {"slot": 0, "eager": 0}
    lock = threading.Lock()

    def slot_launch(self):
        with lock:
            entered["slot"] += 1
        gate.wait(30)
        ok = _lane_verdicts(self.curve.name, self.host.numpy(), self.size)
        return torch.tensor(ok)

    def eager(self, curve, size, arrs, slots=None, pools=None, n=None):
        warm = not gate.is_set() and entered["slot"] + entered["eager"] < 9
        if warm and self._rings:
            with lock:
                entered["eager"] += 1
            gate.wait(30)
        return torch.tensor(_lane_verdicts(curve, arrs, size))

    monkeypatch.setattr(ecdsa.LatencySlot, "launch", slot_launch)
    monkeypatch.setattr(TorchCSP, "_throughput_launch", eager)
    csp = _provider(kernel_field="fold", buckets=(8,))
    csp.warmup([("secp256k1", 8)])
    assert len(csp._ring_free[("secp256k1", 8)]) == 2
    srv = loopback(csp=csp, flush_interval=5.0)
    results = {}

    def tenant(i):
        want = [(i + j) % 3 != 0 for j in range(5)]
        client = RemoteCSP(_ep(srv), transport="socket", tenant=f"v{i}",
                           request_timeout=30.0)
        client.set_quorum_hint(5)
        try:
            results[i] = (client.verify_batch(
                _batch("secp256k1", 1000 + 10 * i, want)), want,
                client._c_fallbacks.value())
        finally:
            client.close()

    threads = []
    for i in range(4):
        t = threading.Thread(target=tenant, args=(i,))
        t.start()
        threads.append(t)
        # each tenant's batch is its own quorum flush, in the launch
        # before the next tenant sends
        assert _wait(lambda: entered["slot"] + entered["eager"] == i + 1)
    assert entered == {"slot": 2, "eager": 2}
    assert csp.stats["latency_cold_fallbacks"] == 0
    gate.set()
    for t in threads:
        t.join(30)
    for i, (got, want, fallbacks) in results.items():
        assert got == want and fallbacks == 0
    assert len(results) == 4
    st = srv.coalescer.stats
    assert st["quorum_flushes"] == 4 and st["verify_errors"] == 0
    assert csp.stats["latency_launches"] == 2
    assert csp.stats["latency_cold_fallbacks"] == 0
    assert len(csp._ring_free[("secp256k1", 8)]) == 2  # both given back


def test_plain_fold_twin_through_the_daemon_at_bucket_8(loopback):
    csp = _provider(kernel_field="fold", buckets=(8,), latency_max_lanes=0)
    srv = loopback(csp=csp, flush_interval=0.01)
    want = [True, False, True, True, False, True]
    assert _drive(_ep(srv), "fold", _batch("secp256k1", 1100, want)) == want
    assert csp.stats["runs"] == "plain" and csp.stats["batches"] == 1
    assert srv.coalescer.counts["verify_errors"] == 0


# ---- the factory and the CLI -------------------------------------------------

def test_factory_verify_endpoint_selects_remote_csp():
    csp = get_csp(FactoryOpts(default="TORCH",
                              verify_endpoint="127.0.0.1:1",
                              verify_transport="socket",
                              verify_tenant="org9"))
    assert isinstance(csp, RemoteCSP)
    assert csp.tenant == "org9" and csp.transport == "socket"
    csp.close()
    remote = get_csp(FactoryOpts(default="REMOTE",
                                 verify_endpoint="h1:1,h2:2"))
    assert isinstance(remote, RemoteCSP)
    assert remote.endpoints == ("h1:1", "h2:2") and remote.tenant == "default"
    remote.close()
    with pytest.raises(ValueError):
        get_csp(FactoryOpts(default="REMOTE"))


def test_cli_parser_takes_the_reference_flags():
    from bdls_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args([
        "verifyd", "--listen-host", "0.0.0.0", "--port", "7", "--transport",
        "socket", "--kernel", "mxu", "--flush-interval", "0.01",
        "--tenant-quota", "9", "--no-warmup", "--warm-snapshot", "s.npz"])
    assert args.fn.__name__ == "cmd_verifyd"
    assert (args.listen_host, args.port, args.transport, args.kernel,
            args.flush_interval, args.tenant_quota, args.no_warmup,
            args.warm_snapshot) == ("0.0.0.0", 7, "socket", "mxu", 0.01, 9,
                                    True, "s.npz")
    for bad in (["verifyd", "--transport", "grpc"],
                ["verifyd", "--ops-port", "1"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(bad)


def test_cli_fails_at_once_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "bdls_tpu_torch.cli.main", "verifyd",
         "--no-warmup"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 1, out
    assert "needs a CUDA device" in out.stderr
    assert out.stdout == ""
    assert time.monotonic() - t0 < 60
