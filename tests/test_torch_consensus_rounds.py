"""The round driver on the port against ``bench_consensus.py``'s.

``bdls_tpu_torch.consensus.rounds`` is the port's copy of the drive that
runs N validators through one batch verifier (``bench_consensus.py:
69-217``). Held here against the reference, exactly:

- ``extract_envelopes`` collects the same envelopes, in the same order,
  with the same keys, from every frame of a run (and from malformed
  ones);
- ``run_rounds`` at 4 validators gives the reference's statistics
  (heights, virtual seconds, batch calls, batched signatures, largest
  batch, cache hits and misses) on the same seed, both sides signing
  with the port's deterministic nonce and verifying on the host;
- every miss is a node's own message: its engine hands its broadcasts
  to itself through its loopback queue before any pre-pass has seen
  them;
- the port's ``CacheVerifier`` sends misses to the fallback its caller
  gives (the reference's makes its own CPU verifier).
"""

from __future__ import annotations

import importlib
import random
import sys
from pathlib import Path

import pytest

from bdls_tpu_torch.consensus import CpuBatchVerifier
from bdls_tpu_torch.consensus import rounds as R
from bdls_tpu_torch.consensus import wire_codec as W
from bdls_tpu_torch.consensus.identity import identity_of

from test_torch_engine_framelog import DeterministicSigner

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bench():
    """The reference driver, its stack bound, signing deterministically."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    mod = importlib.import_module("bench_consensus")
    mod._import_stack()
    mod.Signer = DeterministicSigner
    return mod


def _port_run(n: int, heights: int, fallback_log=None):
    cache, cvs = {}, []

    def factory():
        fb = CpuBatchVerifier()
        if fallback_log is not None:
            log = []
            fallback_log.append(log)
            inner = fb

            class Logged:
                def verify_envelopes(self, envs):
                    log.extend(envs)
                    return inner.verify_envelopes(envs)

            fb = Logged()
        cv = R.CacheVerifier(cache, fb)
        cvs.append(cv)
        return cv

    net = R.build_net(n, factory)
    frames = []
    post = net.post
    net.post = lambda s, d, data: (frames.append(data), post(s, d, data))
    stats = R.run_rounds(net, heights, sidecar=CpuBatchVerifier(),
                         cache=cache)
    stats["cache_hits"] = sum(c.hits for c in cvs)
    stats["cache_misses"] = sum(c.misses for c in cvs)
    return net, stats, frames


def _ref_run(bench, n: int, heights: int):
    cache, cvs = {}, []

    def factory():
        cv = bench.CacheVerifier(cache)
        cvs.append(cv)
        return cv

    net = bench.build_net(n, factory)
    stats = bench.run_rounds(net, heights, sidecar=bench.CpuBatchVerifier(),
                             cache=cache)
    stats["cache_hits"] = sum(c.hits for c in cvs)
    stats["cache_misses"] = sum(c.misses for c in cvs)
    return net, stats


KEYS = ("heights", "virtual_s", "batch_calls", "batched_sigs", "max_batch",
        "cache_hits", "cache_misses")


@pytest.fixture(scope="module")
def port_run():
    log: list = []
    net, stats, frames = _port_run(4, 4, fallback_log=log)
    return net, stats, frames, log


def test_run_rounds_gives_the_reference_stats(bench, port_run):
    net, stats, _, _ = port_run
    ref_net, ref = _ref_run(bench, 4, 4)
    assert {k: stats[k] for k in KEYS} == {k: ref[k] for k in KEYS}
    assert stats["heights"] >= 4 and stats["batch_calls"] > 0
    assert [(n.latest_height, n.latest_state) for n in net.nodes] == [
        (n.latest_height, n.latest_state) for n in ref_net.nodes]


def test_misses_are_each_nodes_own_loopback_messages(port_run):
    net, stats, _, log = port_run
    assert stats["cache_misses"] == sum(len(m) for m in log) > 0
    for node, missed in zip(net.nodes, log):
        assert {identity_of(e.pub_x, e.pub_y) for e in missed} == {
            node.identity}


def _pb_bytes(pb_envs) -> list:
    return [e.SerializeToString() for e in pb_envs]


def test_extract_envelopes_equals_the_reference(bench, port_run):
    _, _, frames, _ = port_run
    rng = random.Random(18)
    # every frame, then a mutated copy of some: truncated, a byte flipped
    pool = list(frames)
    for data in rng.sample(frames, 60):
        i = rng.randrange(len(data))
        pool += [data[:i], data[:i] + bytes([data[i] ^ 0x5a]) + data[i + 1:]]
    pool += [b"", b"\x12\x00", b"\x12\x02\x4c\x00", b"\xff"]
    seen, ref_seen = set(), set()
    total = 0
    for data in pool:
        got, want = [], []
        R.extract_envelopes(data, got, seen)
        bench.extract_envelopes(data, want, ref_seen)
        assert [W.encode(e) for e in got] == _pb_bytes(want)
        assert seen == ref_seen
        total += len(got)
    assert total > 20


def test_cache_verifier_takes_the_callers_fallback():
    calls = []

    class Fallback:
        def verify_envelopes(self, envs):
            calls.append(len(envs))
            return [False] * len(envs)

    env = W.decode_envelope(b"\x08\x01\x12\x01\x61")
    other = W.decode_envelope(b"\x08\x01\x12\x01\x62")
    cv = R.CacheVerifier({R._env_key(env): True}, Fallback())
    assert cv.verify_envelopes([env, other, env]) == [True, False, True]
    assert (cv.hits, cv.misses, calls) == (2, 1, [1])
    with pytest.raises(TypeError):
        R.CacheVerifier({})  # no silent fallback


def test_driver_constants_are_the_reference_drive(bench):
    import inspect

    src = inspect.getsource(bench.build_net)
    assert "0x5000 + i" in src and R.SIGNER_BASE == 0x5000
    sig = inspect.signature(bench.build_net).parameters
    assert (sig["latency"].default, sig["net_latency"].default,
            sig["seed"].default) == (R.ENGINE_LATENCY, R.NET_LATENCY, R.SEED)
    assert inspect.signature(bench.run_rounds).parameters[
        "tick"].default == R.TICK
