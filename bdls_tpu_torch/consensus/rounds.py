"""The round driver: N validators on the virtual network, one batch
verifier for all of them.

The port's copy of the drive in ``bench_consensus.py:69-217``, the only
way the reference drives 128 validators (``BASELINE.json`` config 4)
through one batch verifier. Before each tick's deliveries, every new
signed envelope the due frames carry (proofs embedded in
<lock>/<select>/<decide>/<resync> included, recursively) is verified in
one sidecar call and its verdict cached under :func:`_env_key`; the
engines' own ``verify_envelopes`` calls then answer from that shared
cache (:class:`CacheVerifier`). Consensus never waits on the sidecar
mid-round, so virtual round latency is the network's; what the card
changes is the wall time the verify work takes a height.

The same signer scalars (``0x5000 + i``), network seed (4), latencies
(engine 0.05 s, network 0.02 s) and tick (0.01 s) as the reference.
One difference, on purpose: the reference's :class:`CacheVerifier`
sends misses to a serial CPU verifier it makes itself
(``bench_consensus.py:125``); the port's takes its ``fallback`` from the
caller, so a run on the card passes the card's verifier and no envelope
is verified off the card. Misses are still counted. They are each
node's own messages: an engine hands its own broadcasts to itself
through its loopback queue at once, before any pre-pass has seen them
(``tests/test_torch_consensus_rounds.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from bdls_tpu_torch.consensus import wire_codec as W
from bdls_tpu_torch.consensus.engine import Config, Consensus
from bdls_tpu_torch.consensus.identity import Signer
from bdls_tpu_torch.consensus.ipc import VirtualNetwork

SIGNER_BASE = 0x5000
SEED = 4
ENGINE_LATENCY = 0.05
NET_LATENCY = 0.02
TICK = 0.01


def _env_key(env) -> bytes:
    return b"|".join((env.pub_x, env.pub_y, env.sig_r, env.sig_s,
                      env.version.to_bytes(4, "little"), env.payload))


def extract_envelopes(data: bytes, out: list, seen: set) -> None:
    """Collect an envelope and every embedded proof envelope, recursively
    (lock carries roundchanges; lock-release carries a lock; decide
    carries commits; resync replays any of them)."""
    try:
        env = W.decode_envelope(data)
    except W.DecodeError:
        return
    _extract_env_obj(env, out, seen)


def _extract_env_obj(env, out: list, seen: set) -> None:
    if not env.payload:
        return
    key = _env_key(env)
    if key in seen:
        # expanded when it was added (the key holds its payload), so
        # its proofs are in ``seen`` already: parsing it again would add
        # nothing (the reference parses it again)
        return
    seen.add(key)
    out.append(env)
    try:
        msg = W.decode_message(env.payload)
    except W.DecodeError:
        return
    for proof in msg.proof:
        _extract_env_obj(proof, out, seen)
    if msg.lock_release is not None:
        _extract_env_obj(msg.lock_release, out, seen)


class CacheVerifier:
    """Engine-facing verifier answering from the shared sidecar cache;
    misses go to the caller's ``fallback`` verifier and are counted."""

    def __init__(self, cache: dict, fallback):
        self.cache = cache
        self.fallback = fallback
        self.hits = 0
        self.misses = 0

    def verify_envelopes(self, envs: Sequence) -> list[bool]:
        out: list[Optional[bool]] = []
        missing = []
        for e in envs:
            v = self.cache.get(_env_key(e))
            if v is None:
                missing.append(e)
                out.append(None)
            else:
                self.hits += 1
                out.append(v)
        if missing:
            self.misses += len(missing)
            fb = iter(self.fallback.verify_envelopes(missing))
            out = [next(fb) if v is None else v for v in out]
        return out  # type: ignore[return-value]


def build_net(n: int, verifier_factory: Callable[[], object],
              latency: float = ENGINE_LATENCY,
              net_latency: float = NET_LATENCY,
              seed: int = SEED) -> VirtualNetwork:
    """net_latency deliberately exceeds the drive tick (0.01): a message
    posted in tick k always crosses a tick boundary before delivery, so
    the sidecar pre-pass sees every envelope before any engine does."""
    signers = [Signer.from_scalar(SIGNER_BASE + i) for i in range(n)]
    participants = [s.identity for s in signers]
    net = VirtualNetwork(seed=seed, latency=net_latency)
    for s in signers:
        cfg = Config(
            epoch=0.0,
            signer=s,
            participants=participants,
            state_compare=lambda a, b: (a > b) - (a < b),
            state_validate=lambda s_, h_: True,
            latency=latency,
            verifier=verifier_factory(),
        )
        net.add_node(Consensus(cfg))
    net.connect_all()
    return net


def run_rounds(net: VirtualNetwork, target_heights: int,
               sidecar=None, cache: Optional[dict] = None,
               tick: float = TICK, max_virtual_s: float = 600.0,
               max_wall_s: Optional[float] = None) -> dict:
    """Drive the network to ``target_heights`` decided heights.

    With ``sidecar``/``cache`` set, runs the pre-verification pass: before
    each tick's deliveries, new envelopes in deliverable messages are
    batch-verified into the cache (ONE sidecar call per tick).
    ``max_wall_s`` also stops the drive after that many host seconds
    (the reference has no such bound); the returned ``heights`` says how
    far it got.
    """
    seen: set = set()
    stats = {"batch_calls": 0, "batched_sigs": 0, "max_batch": 0,
             "wall_verify_s": 0.0}
    wall0 = time.perf_counter()
    v0 = net.now
    while min(net.heights()) < target_heights and net.now - v0 < max_virtual_s:
        if max_wall_s is not None and time.perf_counter() - wall0 > max_wall_s:
            break
        t_next = round(net.now + tick, 9)
        if sidecar is not None:
            batch: list = []
            # frame entries: (deliver_at, seq, dst, data, traceparent)
            for deliver_at, _, dst, data, *_rest in net.due_frames(t_next):
                if dst not in net.partitioned:
                    extract_envelopes(data, batch, seen)
            if batch:
                t = time.perf_counter()
                oks = sidecar.verify_envelopes(batch)
                stats["wall_verify_s"] += time.perf_counter() - t
                stats["batch_calls"] += 1
                stats["batched_sigs"] += len(batch)
                stats["max_batch"] = max(stats["max_batch"], len(batch))
                for env, ok in zip(batch, oks):
                    cache[_env_key(env)] = ok
        net.run_until(t_next, tick=tick)
        # keep proposals flowing (the firehose: always data to order)
        for node in net.nodes:
            node.propose(b"state-%d" % (node.latest_height + 1))
    stats["wall_s"] = time.perf_counter() - wall0
    stats["virtual_s"] = net.now - v0
    stats["heights"] = min(net.heights())
    return stats
