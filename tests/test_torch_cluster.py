"""The port's cluster mesh (``bdls_tpu_torch/comm/cluster.py``) on the
CPU: the reference's security scenarios, its key agreement, and
handshakes with the reference's ``ClusterNode`` in both directions.

- The seven scenarios of ``tests/test_cluster_security.py`` on the
  port's ``ClusterNode`` and ``SecureChannel``: mutual authentication
  and frame flow, an impostor listener, a dialer that is not a member,
  a replayed handshake, a tampered and a replayed frame, and no
  plaintext on the wire.
- The port's secp256k1 ECDH (``crypto/sw.py``) against the
  ``cryptography`` package's on random key pairs, each side's share
  decoded by the other; shares off the curve, of the wrong length or
  prefix, with a coordinate at or above p, or at infinity are refused by
  both.
- A port dialer with a reference listener, and a reference dialer with
  a port listener: each completes the handshake and exchanges step
  frames both ways, a pull request and its response, and the sender's
  ``traceparent`` reaches the receiver's span.
- A sender whose peer has stopped reading does not block: frames queue
  for the connection's writer (the reference blocks, ROADMAP.md Queue
  C), and arrive in order once the peer reads again.
- Two nodes that dial each other at once keep the same connection on
  both sides, the one the smaller identity dialed, and retire the other
  without losing a frame queued on it (the reference keeps the newer on
  each side: ROADMAP.md Queue C); a send no connection takes is refused
  and counted, and a router that raises is counted and leaves the
  connection up.

Every socket operation has a timeout and every node is closed in
``finally``, so a hang fails its test.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import numpy as np
import pytest
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.serialization import (Encoding,
                                                          PublicFormat)

from bdls_tpu.comm import cluster as RC
from bdls_tpu.consensus import Signer as RSigner
from bdls_tpu.utils import tracing as rtracing
from bdls_tpu_torch.comm import comm_codec as cpb
from bdls_tpu_torch.comm.cluster import (ClusterNode, CommError,
                                         SecureChannel, _recv_plain,
                                         _send_plain)
from bdls_tpu_torch.consensus import Signer
from bdls_tpu_torch.crypto import sw
from bdls_tpu_torch.ops.curves import SECP256K1
from bdls_tpu_torch.utils import tracing

TIMEOUT = 5.0


def make_node(scalar, membership=None, mod=None, **kw):
    mod = mod or ClusterNode
    signer = (Signer if mod is ClusterNode else RSigner).from_scalar(scalar)
    inbox = []
    node = mod(
        signer=signer,
        router=lambda ch, payload, frm: inbox.append((ch, payload, frm)),
        membership=membership or (lambda ident: True),
        **kw,
    )
    return node, inbox


def wait_for(cond, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _pair():
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT)
    b.settimeout(TIMEOUT)
    return a, b


def _recv_n(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "connection closed"
        buf += chunk
    return buf


def _proxy():
    proxy = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    proxy.bind(("127.0.0.1", 0))
    proxy.listen(1)
    proxy.settimeout(TIMEOUT)
    return proxy, proxy.getsockname()[1]


# ---- the reference's seven security scenarios --------------------------------

def test_mutual_auth_and_frame_flow():
    a, _ = make_node(101)
    b, b_inbox = make_node(102)
    try:
        a.connect(b.identity, b.host, b.port, timeout=TIMEOUT)
        assert a.send(b.identity, "ch", b"hello")
        assert wait_for(lambda: b_inbox)
        assert b_inbox[0] == ("ch", b"hello", a.identity)
        assert a.stats["auth_fail"] == b.stats["auth_fail"] == 0
    finally:
        a.close()
        b.close()


def test_impostor_listener_rejected():
    a, _ = make_node(111)
    impostor, _ = make_node(112)
    expected = Signer.from_scalar(113).identity
    try:
        with pytest.raises(CommError, match="identity proof"):
            a.connect(expected, impostor.host, impostor.port,
                      timeout=TIMEOUT)
        assert expected not in a.connected_peers()
    finally:
        a.close()
        impostor.close()


def test_nonmember_dialer_rejected():
    allowed = Signer.from_scalar(121).identity
    a, _ = make_node(122)
    b, _ = make_node(123, membership=lambda ident: ident == allowed)
    try:
        with pytest.raises(CommError, match="auth rejected"):
            a.connect(b.identity, b.host, b.port, timeout=TIMEOUT)
        assert wait_for(lambda: b.stats["auth_fail"] == 1)
    finally:
        a.close()
        b.close()


def test_handshake_replay_rejected():
    a, _ = make_node(131)
    b, _ = make_node(132)
    captured = {}
    proxy, proxy_port = _proxy()

    def relay():
        client, _ = proxy.accept()
        client.settimeout(TIMEOUT)
        upstream = socket.create_connection((b.host, b.port),
                                            timeout=TIMEOUT)
        _send_plain(client, _recv_plain(upstream))
        req = _recv_plain(client)
        captured["auth"] = req
        _send_plain(upstream, req)
        hdr = _recv_n(upstream, 4)
        (ln,) = struct.unpack("<I", hdr)
        client.sendall(hdr + _recv_n(upstream, ln))
        client.close()
        upstream.close()

    t = threading.Thread(target=relay, daemon=True)
    t.start()
    raw = None
    try:
        a.connect(b.identity, "127.0.0.1", proxy_port, timeout=TIMEOUT)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive() and "auth" in captured
        raw = socket.create_connection((b.host, b.port), timeout=TIMEOUT)
        _recv_plain(raw)
        _send_plain(raw, captured["auth"])
        resp = _recv_plain(raw)
        assert resp.WhichOneof("kind") == "auth_resp"
        assert not resp.auth_resp.ok
        assert "nonce" in resp.auth_resp.error
    finally:
        if raw is not None:
            raw.close()
        proxy.close()
        a.close()
        b.close()


def test_frame_tamper_detected():
    left, right = _pair()
    back_l, back_r = _pair()
    try:
        k1, k2 = b"\x01" * 32, b"\x02" * 32
        tx = SecureChannel(left, send_key=k1, recv_key=k2)
        rx = SecureChannel(right, send_key=k2, recv_key=k1)
        frame = cpb.ClusterFrame()
        frame.step.channel = "ch"
        frame.step.payload = b"payload"
        tx.send(frame)
        assert rx.recv().step.payload == b"payload"
        tx.send(frame)
        hdr = _recv_n(right, 4)
        (ln,) = struct.unpack("<I", hdr)
        blob = bytearray(_recv_n(right, ln))
        blob[len(blob) // 2] ^= 0x01
        back_l.sendall(hdr + bytes(blob))
        rx2 = SecureChannel(back_r, send_key=k2, recv_key=k1)
        rx2._recv_ctr = 1
        with pytest.raises(CommError, match="authentication failed"):
            rx2.recv()
    finally:
        for s in (left, right, back_l, back_r):
            s.close()


def test_frame_replay_detected():
    left, right = _pair()
    feed_l, feed_r = _pair()
    try:
        k1, k2 = b"\x03" * 32, b"\x04" * 32
        tx = SecureChannel(left, send_key=k1, recv_key=k2)
        frame = cpb.ClusterFrame()
        frame.step.channel = "ch"
        frame.step.payload = b"once"
        tx.send(frame)
        hdr = _recv_n(right, 4)
        (ln,) = struct.unpack("<I", hdr)
        blob = _recv_n(right, ln)
        feed_l.sendall(hdr + blob + hdr + blob)
        rx2 = SecureChannel(feed_r, send_key=k2, recv_key=k1)
        assert rx2.recv().step.payload == b"once"
        with pytest.raises(CommError, match="authentication failed"):
            rx2.recv()
    finally:
        for s in (left, right, feed_l, feed_r):
            s.close()


def test_payload_not_on_wire_in_plaintext():
    a, _ = make_node(141)
    b, b_inbox = make_node(142)
    wiretap = []
    proxy, proxy_port = _proxy()
    stop = threading.Event()

    def relay():
        client, _ = proxy.accept()
        upstream = socket.create_connection((b.host, b.port),
                                            timeout=TIMEOUT)

        def pump(src, dst):
            src.settimeout(0.2)
            while not stop.is_set():
                try:
                    chunk = src.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    return
                wiretap.append(chunk)
                try:
                    dst.sendall(chunk)
                except OSError:
                    return

        pumps = [threading.Thread(target=pump, args=p, daemon=True)
                 for p in ((client, upstream), (upstream, client))]
        for p in pumps:
            p.start()
        for p in pumps:
            p.join(timeout=3 * TIMEOUT)
        client.close()
        upstream.close()

    t = threading.Thread(target=relay, daemon=True)
    t.start()
    try:
        secret = b"SECRET-CONSENSUS-PAYLOAD-0123456789"
        a.connect(b.identity, "127.0.0.1", proxy_port, timeout=TIMEOUT)
        assert a.send(b.identity, "ch", secret)
        assert wait_for(lambda: b_inbox)
        assert b_inbox[0][1] == secret
        assert not any(secret in chunk for chunk in wiretap)
    finally:
        stop.set()
        proxy.close()
        a.close()
        b.close()
        t.join(timeout=3 * TIMEOUT)


# ---- the key agreement --------------------------------------------------------

def _ref_pub(priv) -> bytes:
    return priv.public_key().public_bytes(Encoding.X962,
                                          PublicFormat.UncompressedPoint)


@pytest.mark.parametrize("seed", range(6))
def test_ecdh_matches_cryptography(seed):
    d = sw.ecdh_private("secp256k1")
    assert 0 < d < SECP256K1.fn.modulus
    mine = sw.ecdh_public("secp256k1", d)
    theirs = ec.generate_private_key(ec.SECP256K1())
    assert len(mine) == 65 and mine[0] == 4
    ref_view = ec.EllipticCurvePublicKey.from_encoded_point(
        ec.SECP256K1(), mine)
    assert _ref_pub_of(ref_view) == mine
    assert sw.ecdh_shared("secp256k1", d, _ref_pub(theirs)) == \
        theirs.exchange(ec.ECDH(), ref_view)
    # a fixed scalar gives the reference's encoding of d·G
    k = int.from_bytes(np.random.default_rng(seed).bytes(31), "big") + 1
    assert sw.ecdh_public("secp256k1", k) == _ref_pub(
        ec.derive_private_key(k, ec.SECP256K1()))


def _ref_pub_of(pub) -> bytes:
    return pub.public_bytes(Encoding.X962, PublicFormat.UncompressedPoint)


def _bad_shares() -> dict:
    p = SECP256K1.fp.modulus
    good = sw.ecdh_public("secp256k1", 12345)
    x = int.from_bytes(good[1:33], "big")
    y = int.from_bytes(good[33:], "big")

    def enc(x_, y_, prefix=b"\x04"):
        return prefix + x_.to_bytes(32, "big") + y_.to_bytes(32, "big")

    return {
        "off_curve": enc(x, (y + 1) % p),
        "infinity": b"\x00",
        "zeros": enc(0, 0),
        "x_at_p": enc(x + p, y) if x + p < 1 << 256 else enc(p, y),
        "y_above_p": enc(x, y + p) if y + p < 1 << 256 else enc(x, p + 1),
        "short": good[:-1],
        "long": good + b"\x00",
        "prefix": b"\x05" + good[1:],
        "compressed_length_bad": b"\x02" + good[1:],
        "empty": b"",
    }


@pytest.mark.parametrize("name", sorted(_bad_shares()))
def test_bad_shares_are_refused_by_both(name):
    share = _bad_shares()[name]
    with pytest.raises(ValueError):
        sw.ecdh_shared("secp256k1", 7, share)
    with pytest.raises(ValueError):
        ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256K1(), share)


# ---- interop with the reference's ClusterNode ---------------------------------

def _full_node(mod, scalar):
    signer = (Signer if mod is ClusterNode else RSigner).from_scalar(scalar)
    tr = tracing if mod is ClusterNode else rtracing
    seen = {"steps": [], "pulls": [], "blocks": [], "tp": []}

    def router(ch, payload, frm):
        seen["steps"].append((ch, payload, frm))
        seen["tp"].append(tr.GLOBAL.current_traceparent())

    node = mod(signer=signer, router=router, membership=lambda i: True,
               pull_handler=lambda ch, s, e, frm: seen["pulls"].append(
                   (ch, s, e, frm)),
               block_sink=lambda ch, n, blk, frm: seen["blocks"].append(
                   (ch, n, blk, frm)))
    return node, seen, tr


@pytest.mark.parametrize("dialer", ("port", "reference"))
def test_interop_with_the_reference_cluster(dialer):
    mods = {"port": ClusterNode, "reference": RC.ClusterNode}
    listener = "reference" if dialer == "port" else "port"
    a, a_seen, a_tr = _full_node(mods[dialer], 0x1D01)
    b, b_seen, b_tr = _full_node(mods[listener], 0x1D02)
    try:
        a.connect(b.identity, b.host, b.port, timeout=TIMEOUT)
        assert wait_for(lambda: a.identity in b.connected_peers())
        with a_tr.GLOBAL.span("test.send") as span:
            sent_tp = a_tr.GLOBAL.current_traceparent()
            assert a.send(b.identity, "ch", b"to-listener")
        assert sent_tp and span is not None
        assert wait_for(lambda: b_seen["steps"])
        assert b_seen["steps"] == [("ch", b"to-listener", a.identity)]
        # the receiver's span is a child in the sender's trace
        got_tp = b_seen["tp"][0]
        assert got_tp is not None
        assert got_tp.split("-")[1] == sent_tp.split("-")[1]
        assert b.send(a.identity, "ch", b"to-dialer")
        assert wait_for(lambda: a_seen["steps"])
        assert a_seen["steps"] == [("ch", b"to-dialer", b.identity)]
        assert a.request_blocks(b.identity, "ch", 3, 9)
        assert wait_for(lambda: b_seen["pulls"])
        assert b_seen["pulls"] == [("ch", 3, 9, a.identity)]
        block = bytes(range(256)) * 400
        assert b.send_block(a.identity, "ch", 3, block)
        assert wait_for(lambda: a_seen["blocks"])
        assert a_seen["blocks"] == [("ch", 3, block, b.identity)]
        # the port's node also counts refused sends and router errors
        for node in (a, b):
            extra = ({"send_refused": 0, "router_errors": 0}
                     if isinstance(node, ClusterNode) else {})
            assert node.stats == {"tx": 1, "rx": 1, "auth_fail": 0, **extra}
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("dialer", ("port", "reference"))
def test_impostor_rejected_across_packages(dialer):
    """A dialer of one package expecting identity X at a listener of the
    other that holds another key: the listener's proof fails."""
    mods = {"port": ClusterNode, "reference": RC.ClusterNode}
    errs = {"port": CommError, "reference": RC.CommError}
    listener = "reference" if dialer == "port" else "port"
    a, _ = make_node(0x1D11, mod=mods[dialer])
    b, _ = make_node(0x1D12, mod=mods[listener])
    try:
        with pytest.raises(errs[dialer], match="identity proof"):
            a.connect(Signer.from_scalar(0x1D13).identity, b.host, b.port,
                      timeout=TIMEOUT)
    finally:
        a.close()
        b.close()


def test_send_does_not_block_on_a_stalled_peer():
    """A peer whose reader is stuck (an orderer node's reader waits for
    its node lock) must not stall the sender: frames queue for the
    connection's writer, which the reference writes on the caller's
    thread (ROADMAP.md Queue C). Once the peer reads again, every frame
    arrives, in order."""
    release = threading.Event()
    got = []

    def stuck(ch, payload, frm):
        release.wait(3 * TIMEOUT)
        got.append(payload[:4])

    a, _ = make_node(0x1D21)
    b = ClusterNode(signer=Signer.from_scalar(0x1D22), router=stuck,
                    membership=lambda ident: True)
    try:
        a.connect(b.identity, b.host, b.port, timeout=TIMEOUT)
        assert wait_for(lambda: a.identity in b.connected_peers())
        frame = bytes(512 * 1024)
        t0 = time.time()
        for i in range(40):                     # 20 MB, above the buffers
            assert a.send(b.identity, "ch", i.to_bytes(4, "big") + frame)
        assert time.time() - t0 < TIMEOUT
        release.set()
        assert wait_for(lambda: len(got) == 40, timeout=6 * TIMEOUT)
        assert got == [i.to_bytes(4, "big") for i in range(40)]
        assert a.stats["tx"] == b.stats["rx"] == 40
    finally:
        release.set()
        a.close()
        b.close()


def _kept(x, y):
    """(local, remote) address of the connection ``x`` keeps to ``y``."""
    conn = x._conns.get(y.identity)
    try:
        return conn.sock.getsockname(), conn.sock.getpeername()
    except (AttributeError, OSError):
        return None


def test_a_simultaneous_dial_keeps_one_connection_on_both_sides():
    """20 rounds of two nodes dialing each other at once. Each side sends
    a relay as soon as its dial returns; every relay a side's ``send``
    took arrives, a refused one is counted, both sides end up holding
    the same connection, the one the smaller identity dialed, with the
    other closed, and a relay sent then arrives."""
    for rnd in range(20):
        a, a_in = make_node(0x1D31)
        b, b_in = make_node(0x1D32)
        try:
            start = threading.Barrier(2)
            took = {}

            def dial(x, y, tag):
                start.wait(TIMEOUT)
                x.connect(y.identity, y.host, y.port, timeout=TIMEOUT)
                took[tag] = x.send(y.identity, "ch", tag)

            threads = [threading.Thread(target=dial, args=(a, b, b"a->b")),
                       threading.Thread(target=dial, args=(b, a, b"b->a"))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(3 * TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            assert set(took) == {b"a->b", b"b->a"}
            small = min(a.identity, b.identity)
            assert wait_for(lambda: _kept(a, b) is not None
                            and _kept(b, a) is not None
                            and _kept(a, b) == _kept(b, a)[::-1]
                            and len(a._live) == len(b._live) == 1), rnd
            assert a._conns[b.identity].dialer == small
            assert b._conns[a.identity].dialer == small
            for x, inbox, tag in ((b, b_in, b"a->b"), (a, a_in, b"b->a")):
                if took[tag]:
                    assert wait_for(lambda: inbox), (rnd, tag)
                    assert inbox[0][1] == tag
            assert a.stats["send_refused"] + b.stats["send_refused"] == sum(
                not ok for ok in took.values())
            assert a.send(b.identity, "ch", b"after")
            assert b.send(a.identity, "ch", b"after")
            assert wait_for(lambda: a_in[-1:] and a_in[-1][1] == b"after"
                            and b_in[-1:] and b_in[-1][1] == b"after")
        finally:
            a.close()
            b.close()


def test_refused_sends_and_router_errors_are_counted():
    """No connection: ``send``, ``request_blocks`` and ``send_block`` are
    refused and counted. A router that raises is counted, and the next
    frame on the same connection still arrives."""
    seen = []

    def router(ch, payload, frm):
        if payload == b"bad":
            raise ValueError("rejected")
        seen.append(payload)

    a, _ = make_node(0x1D41)
    b = ClusterNode(signer=Signer.from_scalar(0x1D42), router=router,
                    membership=lambda ident: True)
    try:
        assert not a.send(b.identity, "ch", b"x")
        assert not a.request_blocks(b.identity, "ch", 1, 2)
        assert not a.send_block(b.identity, "ch", 1, b"blk")
        assert a.stats["send_refused"] == 3
        a.connect(b.identity, b.host, b.port, timeout=TIMEOUT)
        assert a.send(b.identity, "ch", b"bad")
        assert a.send(b.identity, "ch", b"good")
        assert wait_for(lambda: seen == [b"good"])
        assert b.stats["router_errors"] == 1 and b.stats["rx"] == 2
        assert a.identity in b.connected_peers()
    finally:
        a.close()
        b.close()
