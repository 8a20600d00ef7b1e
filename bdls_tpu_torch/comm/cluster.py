"""Identity-authenticated TCP cluster mesh between ordering nodes.

The port's copy of ``bdls_tpu/comm/cluster.py``, with the same
handshake, digests, key derivation and wire format, so a port node and
a reference node complete handshakes and exchange frames either way.
What the reference takes from the ``cryptography`` package, which the
card's machine lacks, comes from the port:

- the ephemeral secp256k1 ECDH and the X9.62 encoding with its on-curve
  check: :mod:`bdls_tpu_torch.crypto.sw` (``ecdh_private``,
  ``ecdh_public``, ``ecdh_shared``, ``decode_point``);
- the handshake signatures: :func:`_sign` signs with the port's
  ``Signer`` (a deterministic nonce, where the reference's OpenSSL draws
  a random one) and :func:`_verify` is the plain host ECDSA verify with
  no low-S rule, as OpenSSL's; handshakes are rare and stay on the host,
  as in the reference;
- AES-256-GCM: :class:`bdls_tpu_torch.comm.aead.AESGCM`, AES-NI host
  code.

The frames are :mod:`bdls_tpu_torch.comm.comm_codec`'s.

Wire: ``[u32 LE length][ClusterFrame protobuf]`` during the handshake,
then ``[u32 LE length][AES-256-GCM ciphertext]`` for every subsequent
frame; 32 MB cap (same cap as agent-tcp).

Handshake — mutual, replay-proof, with key agreement (SIGMA-shaped):

1. listener → dialer: ``AuthChallenge{nonce, eph_pub, sig}`` where sig
   is the listener's signature over (nonce ‖ eph_pub ‖ own identity).
   The dialer verifies it against the identity it intended to dial —
   an impostor endpoint cannot complete the handshake (the reference
   gets this property from mutually-authenticated TLS).
2. dialer → listener: ``AuthRequest`` signing (version ‖ timestamp ‖
   from ‖ to ‖ challenge nonce ‖ both ephemeral shares). The listener
   checks membership, freshness, nonce match, and the signature.
3. Both derive per-direction AES-256-GCM keys from the ephemeral ECDH
   secret and the handshake transcript. The listener's ``AuthResponse``
   is already encrypted — decrypting it is the dialer's key
   confirmation that the listener holds the ephemeral secret.

Every frame after the handshake is sealed with a per-direction counter
nonce: tampering, replay, reordering, or truncation fails the GCM tag
and drops the connection. A captured handshake cannot be replayed (fresh
nonce + fresh ephemerals per connection), and a passive observer sees
only ciphertext.

Threading: one reader thread per connection; all upcalls serialized by
the owner's lock (the engine is single-threaded by design — the caller
provides the mutex exactly as in the reference, doc.go:10-12).

One difference on purpose: each connection also has a writer thread,
and ``send``, ``request_blocks`` and ``send_block`` queue the frame for
it (at most :data:`SEND_QUEUE_FRAMES`; a full queue drops the
connection, which the owner redials) instead of sealing and writing it
on the caller's thread. The reference writes under its caller's lock,
and an orderer node calls it holding its node lock: once frames of
hundreds of KB fill the sockets' buffers, each node's sender blocks on
a peer whose reader waits for that peer's node lock, held by its own
blocked sender, and every node stops (ROADMAP.md Queue C).

Three more, so that a frame handed to a connection is not lost while the
mesh forms (ROADMAP.md Queue C):

- When both ends dial at once, each side holds two connections to the
  other. Both keep the one the smaller identity dialed (a redial by the
  same side replaces its predecessor); the reference keeps the newer on
  each side, so the two sides can keep different ones and close the
  other's.
- The connection left over is retired, not closed: its writer sends
  what was queued, then shuts the socket's write side, and its reader
  reads until the peer does the same. A peer that shuts its write side
  retires the connection here too. Only an error closes at once.
- ``send``, ``request_blocks`` and ``send_block`` return False where no
  connection takes the frame and count it (``stats["send_refused"]``);
  an exception from the router, the pull handler or the block sink is
  counted (``stats["router_errors"]``), logged once a type, and leaves
  the connection up, where the reference drops it.
"""

from __future__ import annotations

import hashlib
import logging
import os
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from bdls_tpu_torch.comm import comm_codec as cpb
from bdls_tpu_torch.comm.aead import AESGCM
from bdls_tpu_torch.consensus.identity import Signer
from bdls_tpu_torch.crypto import sw
from bdls_tpu_torch.crypto.framing import framed_digest
from bdls_tpu_torch.utils import tracing

MAX_FRAME = 32 * 1024 * 1024
AUTH_VERSION = 3  # v3: length-framed auth/hello digests
AUTH_PREFIX = b"BDLS_TPU_CLUSTER_AUTH"
HELLO_PREFIX = b"BDLS_TPU_CLUSTER_HELLO"
AUTH_MAX_SKEW_MS = 10 * 60 * 1000
# frames queued for one connection's writer before the connection is
# dropped as stuck
SEND_QUEUE_FRAMES = 4096
_CURVE = "secp256k1"
_SW = sw.SwCSP()
# a writer that takes this from its queue has sent everything before it:
# it shuts the socket's write side and stops
_RETIRE = object()
_LOG = logging.getLogger("bdls_tpu_torch.cluster")


class CommError(Exception):
    pass


class _PeerClosed(CommError):
    """The peer shut its side of the socket."""


def _auth_digest(req: cpb.AuthRequest, listener_eph: bytes) -> bytes:
    # every variable-length component is length-framed (crypto.framing):
    # unframed concatenation lets bytes shift between fields while the
    # digest stays identical.
    return framed_digest(
        AUTH_PREFIX + struct.pack("<Iq", req.version, req.timestamp_unix_ms),
        (req.from_id, req.to_id, req.session_nonce, req.eph_pub,
         listener_eph),
        algo="blake2b",
    )


def _hello_digest(nonce: bytes, eph_pub: bytes, listener_id: bytes) -> bytes:
    return framed_digest(HELLO_PREFIX, (nonce, eph_pub, listener_id),
                         algo="blake2b")


def _transcript(nonce: bytes, listener_eph: bytes, dialer_eph: bytes,
                dialer_id: bytes, listener_id: bytes) -> bytes:
    return framed_digest(
        b"", (nonce, listener_eph, dialer_eph, dialer_id, listener_id),
        algo="blake2b",
    )


def _sign(signer: Signer, digest: bytes) -> tuple[bytes, bytes]:
    r, s = _SW.sign(signer.key, digest)
    return r.to_bytes(32, "big"), s.to_bytes(32, "big")


def _verify(identity: bytes, sig_r: bytes, sig_s: bytes, digest: bytes) -> bool:
    """The host secp256k1 verify, both halves of s accepted (OpenSSL's
    rule); an identity that is not a curve point verifies nothing."""
    return sw.ecdsa_verify(
        _CURVE, int.from_bytes(identity[:32], "big"),
        int.from_bytes(identity[32:], "big"), digest,
        int.from_bytes(sig_r, "big"), int.from_bytes(sig_s, "big"))


def _ephemeral() -> tuple[int, bytes]:
    """A fresh ECDH scalar and its encoded share."""
    d = sw.ecdh_private(_CURVE)
    return d, sw.ecdh_public(_CURVE, d)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise _PeerClosed("connection closed")
        got += k
    return bytes(buf)


def _send_plain(sock: socket.socket, frame: cpb.ClusterFrame) -> None:
    raw = frame.SerializeToString()
    if len(raw) > MAX_FRAME:
        raise CommError("frame too large")
    sock.sendall(struct.pack("<I", len(raw)) + raw)


def _recv_plain(sock: socket.socket) -> cpb.ClusterFrame:
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    if length > MAX_FRAME:
        raise CommError(f"oversized frame {length}")
    frame = cpb.ClusterFrame()
    frame.ParseFromString(_recv_exact(sock, length))
    return frame


class SecureChannel:
    """AES-256-GCM framing over a socket with per-direction keys and
    implicit counter nonces. Counters enforce strict frame ordering:
    any tampered, replayed, dropped, or reordered frame fails the GCM
    tag and kills the connection."""

    def __init__(self, sock: socket.socket, send_key: bytes, recv_key: bytes):
        self._sock = sock
        self._send = AESGCM(send_key)
        self._recv = AESGCM(recv_key)
        self._send_ctr = 0
        self._recv_ctr = 0
        self._send_lock = threading.Lock()

    @staticmethod
    def derive_keys(
        secret: bytes, transcript: bytes
    ) -> tuple[bytes, bytes]:
        """(listener→dialer key, dialer→listener key)."""
        def kdf(label: bytes) -> bytes:
            return hashlib.blake2b(
                transcript + label, key=secret[:64], digest_size=32
            ).digest()

        return kdf(b"l2d"), kdf(b"d2l")

    def send(self, frame: cpb.ClusterFrame) -> None:
        raw = frame.SerializeToString()
        if len(raw) > MAX_FRAME:
            raise CommError("frame too large")
        with self._send_lock:
            nonce = self._send_ctr.to_bytes(12, "little")
            self._send_ctr += 1
            sealed = self._send.encrypt(nonce, raw, None)
            self._sock.sendall(struct.pack("<I", len(sealed)) + sealed)

    def recv(self) -> cpb.ClusterFrame:
        (length,) = struct.unpack("<I", _recv_exact(self._sock, 4))
        if length > MAX_FRAME + 16:
            raise CommError(f"oversized frame {length}")
        sealed = _recv_exact(self._sock, length)
        frame = self.unseal(sealed)
        if frame is None:
            raise CommError("frame authentication failed")
        return frame

    def unseal(self, sealed: bytes) -> Optional[cpb.ClusterFrame]:
        """Decrypt one already-read blob at the current receive position;
        None if authentication fails (counter NOT advanced)."""
        nonce = self._recv_ctr.to_bytes(12, "little")
        try:
            raw = self._recv.decrypt(nonce, sealed, None)
        except Exception:
            return None
        self._recv_ctr += 1
        frame = cpb.ClusterFrame()
        frame.ParseFromString(raw)
        return frame

    def close(self) -> None:
        try:
            self._sock.close()
        except Exception:
            pass


@dataclass(eq=False)
class _Conn:
    sock: socket.socket
    channel: SecureChannel
    identity: bytes
    addr: str
    dialer: bytes = b""
    outbox: queue.Queue = field(
        default_factory=lambda: queue.Queue(SEND_QUEUE_FRAMES))
    _ends: set = field(default_factory=set)
    _ends_lock: threading.Lock = field(default_factory=threading.Lock)

    def close(self) -> None:
        """Close the socket and stop the writer."""
        try:
            self.sock.close()
        except Exception:
            pass
        try:
            self.outbox.put_nowait(None)
        except queue.Full:
            pass  # the writer's send fails on the closed socket

    def retire(self) -> None:
        """Send what is queued, then shut the write side; the socket
        closes once the peer has shut its own (:meth:`ended`)."""
        try:
            self.outbox.put_nowait(_RETIRE)
        except queue.Full:
            self.close()

    def ended(self, end: str) -> bool:
        """``end`` ("read" or "write") is done; both done closes, and
        says so."""
        with self._ends_lock:
            self._ends.add(end)
            both = len(self._ends) == 2
        if both:
            self.close()
        return both


class ClusterNode:
    """One node's cluster endpoint: listener + authenticated outbound
    connections, with channel-tagged message routing."""

    def __init__(
        self,
        signer: Signer,
        router: Callable[[str, bytes, bytes], None],
        membership: Callable[[bytes], bool],
        host: str = "127.0.0.1",
        port: int = 0,
        pull_handler: Optional[Callable[[str, int, int, bytes], None]] = None,
        block_sink: Optional[Callable[[str, int, bytes, bytes], None]] = None,
        on_connect: Optional[Callable[[bytes], None]] = None,
    ):
        """router(channel, payload, from_identity); membership(identity)
        gates inbound auth (channel membership check, clusterservice.go
        VerifyAuthRequest); pull_handler(channel, start, end, from_id)
        serves catch-up block requests (BlockPuller server side);
        block_sink(channel, number, block_bytes, from_id) receives pulled
        blocks; on_connect(identity) runs each time a connection becomes
        the one frames to ``identity`` take."""
        self.signer = signer
        self.pull_handler = pull_handler
        self.block_sink = block_sink
        self.on_connect = on_connect
        self.identity = signer.identity
        self.router = router
        self.membership = membership
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()
        self._conns: dict[bytes, _Conn] = {}
        # every connection not yet closed, retired ones included
        self._live: set[_Conn] = set()
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._logged: set[type] = set()
        self.stats = {"tx": 0, "rx": 0, "auth_fail": 0, "send_refused": 0,
                      "router_errors": 0}
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    # ---- outbound --------------------------------------------------------
    def connect(self, identity: bytes, host: str, port: int,
                timeout: float = 5.0) -> None:
        """Dial a consenter: verify IT owns the identity we intended to
        reach (mutual auth), prove ours, agree on session keys."""
        sock = socket.create_connection((host, port), timeout=timeout)
        try:
            sock.settimeout(timeout)
            hello = _recv_plain(sock)
            if hello.WhichOneof("kind") != "auth_challenge":
                raise CommError("expected auth challenge")
            ch = hello.auth_challenge
            # the listener must prove ownership of the identity we dialed
            if not _verify(
                identity, ch.sig_r, ch.sig_s,
                _hello_digest(ch.nonce, ch.eph_pub, identity),
            ):
                raise CommError("listener failed identity proof")
            eph, eph_pub = _ephemeral()
            req = cpb.AuthRequest()
            req.version = AUTH_VERSION
            req.timestamp_unix_ms = int(time.time() * 1000)
            req.from_id = self.identity
            req.to_id = identity
            req.session_nonce = ch.nonce
            req.eph_pub = eph_pub
            req.sig_r, req.sig_s = _sign(
                self.signer, _auth_digest(req, ch.eph_pub)
            )
            frame = cpb.ClusterFrame()
            frame.auth.CopyFrom(req)
            _send_plain(sock, frame)

            secret = sw.ecdh_shared(_CURVE, eph, bytes(ch.eph_pub))
            k_l2d, k_d2l = SecureChannel.derive_keys(
                secret,
                _transcript(ch.nonce, ch.eph_pub, eph_pub,
                            self.identity, identity),
            )
            chan = SecureChannel(sock, send_key=k_d2l, recv_key=k_l2d)
            # success comes back encrypted (the listener's key
            # confirmation); a rejection comes back in plaintext since no
            # shared keys exist on a failed handshake
            (ln,) = struct.unpack("<I", _recv_exact(sock, 4))
            if ln > MAX_FRAME + 16:
                raise CommError(f"oversized frame {ln}")
            blob = _recv_exact(sock, ln)
            resp = chan.unseal(blob)
            if resp is None:
                plain = cpb.ClusterFrame()
                try:
                    plain.ParseFromString(blob)
                except Exception:
                    raise CommError("handshake response unreadable")
                if plain.WhichOneof("kind") == "auth_resp":
                    raise CommError(f"auth rejected: {plain.auth_resp.error}")
                raise CommError("handshake key confirmation failed")
            if resp.WhichOneof("kind") != "auth_resp" or not resp.auth_resp.ok:
                raise CommError(f"auth rejected: {resp.auth_resp.error}")
            sock.settimeout(None)
            self._register(identity, sock, chan, f"{host}:{port}",
                           dialer=self.identity)
        except Exception:
            sock.close()
            raise

    def send(self, identity: bytes, channel: str, payload: bytes) -> bool:
        frame = cpb.ClusterFrame()
        frame.step.channel = channel
        frame.step.payload = payload
        # propagate the sender's span context so the receiving process's
        # spans join this trace (see utils/tracing.py)
        tp = tracing.GLOBAL.current_traceparent()
        if tp is not None:
            frame.step.traceparent = tp
        if not self._enqueue(identity, frame):
            return False
        self.stats["tx"] += 1
        return True

    def _enqueue(self, identity: bytes, frame: cpb.ClusterFrame) -> bool:
        """Hand ``frame`` to the writer of ``identity``'s connection; no
        connection, or a full queue (which drops the connection), refuses
        it. Under the lock, so no frame follows a retirement into the
        queue."""
        with self._lock:
            conn = self._conns.get(identity)
            if conn is not None:
                try:
                    conn.outbox.put_nowait(frame)
                    return True
                except queue.Full:
                    pass
            self.stats["send_refused"] += 1
        if conn is not None:
            self._drop(identity, only=conn)
        return False

    def _write_loop(self, conn: _Conn) -> None:
        try:
            while True:
                frame = conn.outbox.get()
                if frame is None:
                    return
                if frame is _RETIRE:
                    conn.sock.shutdown(socket.SHUT_WR)
                    self._ended(conn, "write")
                    return
                conn.channel.send(frame)
        except Exception:
            self._drop(conn.identity, only=conn)

    def connected_peers(self) -> list[bytes]:
        with self._lock:
            return list(self._conns)

    # ---- inbound ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handshake_inbound, args=(sock, addr), daemon=True
            ).start()

    def _handshake_inbound(self, sock: socket.socket, addr) -> None:
        try:
            sock.settimeout(5.0)
            nonce = os.urandom(32)
            eph, eph_pub = _ephemeral()
            challenge = cpb.ClusterFrame()
            challenge.auth_challenge.nonce = nonce
            challenge.auth_challenge.eph_pub = eph_pub
            challenge.auth_challenge.sig_r, challenge.auth_challenge.sig_s = (
                _sign(self.signer, _hello_digest(nonce, eph_pub, self.identity))
            )
            _send_plain(sock, challenge)
            frame = _recv_plain(sock)
            err = self._check_auth(frame, nonce, eph_pub)
            if err:
                # rejection goes out in plaintext: no shared keys exist
                resp = cpb.ClusterFrame()
                resp.auth_resp.ok = False
                resp.auth_resp.error = err
                _send_plain(sock, resp)
                self.stats["auth_fail"] += 1
                sock.close()
                return
            req = frame.auth
            secret = sw.ecdh_shared(_CURVE, eph, bytes(req.eph_pub))
            k_l2d, k_d2l = SecureChannel.derive_keys(
                secret,
                _transcript(nonce, eph_pub, req.eph_pub,
                            req.from_id, self.identity),
            )
            chan = SecureChannel(sock, send_key=k_l2d, recv_key=k_d2l)
            resp = cpb.ClusterFrame()
            resp.auth_resp.ok = True
            chan.send(resp)
            sock.settimeout(None)
            self._register(req.from_id, sock, chan, f"{addr[0]}:{addr[1]}",
                           dialer=req.from_id)
        except Exception:
            sock.close()

    def _check_auth(
        self, frame: cpb.ClusterFrame, nonce: bytes, listener_eph: bytes
    ) -> Optional[str]:
        if frame.WhichOneof("kind") != "auth":
            return "expected auth frame"
        req = frame.auth
        if req.version != AUTH_VERSION:
            return "bad version"
        if req.session_nonce != nonce:
            return "challenge nonce mismatch"
        if req.to_id != self.identity:
            return "auth addressed to another node"
        skew = abs(int(time.time() * 1000) - req.timestamp_unix_ms)
        if skew > AUTH_MAX_SKEW_MS:
            return "stale auth timestamp"
        if not self.membership(req.from_id):
            return "unknown cluster member"
        if len(req.eph_pub) != 65:
            return "bad ephemeral share"
        if not _verify(
            req.from_id, req.sig_r, req.sig_s,
            _auth_digest(req, listener_eph),
        ):
            return "bad auth signature"
        return None

    def _register(
        self, identity: bytes, sock: socket.socket,
        channel: SecureChannel, addr: str, dialer: bytes,
    ) -> None:
        """Take a connection that finished its handshake. Of two to the
        same identity, both sides keep the one the smaller identity
        dialed; a redial by the same side replaces its predecessor. The
        other is retired: it still delivers what was queued on it and
        what the peer sends on it until the peer retires it too."""
        conn = _Conn(sock=sock, channel=channel, identity=identity,
                     addr=addr, dialer=dialer)
        with self._lock:
            if self._stopped.is_set():
                sock.close()
                return
            self._live.add(conn)
            old = self._conns.get(identity)
            keep = (old is None or old.dialer == dialer
                    or dialer == min(self.identity, identity))
            if keep:
                self._conns[identity] = conn
                if old is not None:
                    old.retire()
            else:
                conn.retire()
        threading.Thread(
            target=self._read_loop, args=(conn,), daemon=True
        ).start()
        threading.Thread(
            target=self._write_loop, args=(conn,), daemon=True
        ).start()
        if keep and self.on_connect is not None:
            self._upcall(self.on_connect, identity)

    def _upcall(self, fn, *args) -> None:
        """Run an owner's callback; an exception is counted and logged
        once a type, and the connection stays up."""
        try:
            fn(*args)
        except Exception as exc:  # noqa: BLE001 — the owner's fault, counted
            self.stats["router_errors"] += 1
            if type(exc) not in self._logged:
                self._logged.add(type(exc))
                _LOG.warning("cluster upcall %s raised %s: %s",
                             getattr(fn, "__name__", fn),
                             type(exc).__name__, exc)

    def request_blocks(self, identity: bytes, channel: str, start: int, end: int) -> bool:
        frame = cpb.ClusterFrame()
        frame.pull_req.channel = channel
        frame.pull_req.start = start
        frame.pull_req.end = end
        return self._enqueue(identity, frame)

    def send_block(self, identity: bytes, channel: str, number: int, block: bytes) -> bool:
        frame = cpb.ClusterFrame()
        frame.pull_resp.channel = channel
        frame.pull_resp.number = number
        frame.pull_resp.block = block
        return self._enqueue(identity, frame)

    def _read_loop(self, conn: _Conn) -> None:
        try:
            while not self._stopped.is_set():
                try:
                    frame = conn.channel.recv()
                except _PeerClosed:
                    # the peer shut its side: retire ours as well
                    self._retire(conn)
                    return
                kind = frame.WhichOneof("kind")
                if kind == "step":
                    self.stats["rx"] += 1
                    args = (frame.step.channel, frame.step.payload,
                            conn.identity)
                    if frame.step.traceparent:
                        with tracing.GLOBAL.span(
                            "cluster.step",
                            parent=frame.step.traceparent,
                            attrs={"channel": frame.step.channel},
                        ):
                            self._upcall(self.router, *args)
                    else:
                        self._upcall(self.router, *args)
                elif kind == "pull_req" and self.pull_handler is not None:
                    self._upcall(
                        self.pull_handler,
                        frame.pull_req.channel,
                        frame.pull_req.start,
                        frame.pull_req.end,
                        conn.identity,
                    )
                elif kind == "pull_resp" and self.block_sink is not None:
                    self._upcall(
                        self.block_sink,
                        frame.pull_resp.channel,
                        frame.pull_resp.number,
                        frame.pull_resp.block,
                        conn.identity,
                    )
        except Exception:
            self._drop(conn.identity, only=conn)

    def _retire(self, conn: _Conn) -> None:
        """The peer shut its write side: stop sending new frames on
        ``conn``, send what was queued, and shut ours."""
        with self._lock:
            if self._conns.get(conn.identity) is conn:
                del self._conns[conn.identity]
            conn.retire()
        self._ended(conn, "read")

    def _ended(self, conn: _Conn, end: str) -> None:
        if conn.ended(end):
            with self._lock:
                self._live.discard(conn)

    def _drop(self, identity: bytes, only: Optional[_Conn] = None) -> None:
        """Remove a connection and close it. With ``only`` set, remove it
        only if the registry still maps to that exact connection — a
        dying read loop must not tear down its identity's replacement
        connection."""
        with self._lock:
            conn = self._conns.get(identity)
            if conn is None or (only is not None and conn is not only):
                conn = None
            else:
                self._conns.pop(identity, None)
            for c in (conn, only):
                self._live.discard(c)
        if only is not None and only is not conn:
            only.close()
        if conn is not None:
            conn.close()

    def close(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except Exception:
            pass
        with self._lock:
            conns = list(self._live) + list(self._conns.values())
            self._conns.clear()
            self._live.clear()
        for c in conns:
            c.close()


class ClusterPeer:
    """Adapter presenting a cluster connection as the engine/chain
    PeerInterface for one channel."""

    def __init__(self, node: ClusterNode, identity: bytes, channel: str):
        self._node = node
        self._identity = identity
        self.channel = channel

    def remote_addr(self) -> str:
        return f"cluster://{self._identity.hex()[:16]}/{self.channel}"

    def identity(self) -> bytes:
        return self._identity

    def send(self, data: bytes) -> bool:
        """False where no connection took the frame (counted in the
        node's ``stats["send_refused"]``)."""
        return self._node.send(self._identity, self.channel, data)
