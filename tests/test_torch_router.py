"""The port's verifyd fleet ring against the reference's.

``bdls_tpu_torch/sidecar/router.py`` must route every key as
``bdls_tpu/sidecar/router.py`` does, so the port's clients and the
reference's agree on each key's replica: owners, partitions and the
failover walk for seeded SKIs and endpoint sets, through adds and
removes, and the vote batch's affinity SKI.
"""

from __future__ import annotations

import hashlib
import random

import pytest

from bdls_tpu.sidecar import router as jrouter
from bdls_tpu_torch.sidecar import router


def _skis(rng: random.Random, n: int) -> list[bytes]:
    return [hashlib.sha256(rng.randbytes(16)).digest() for _ in range(n)]


def _endpoints(rng: random.Random, n: int) -> list[str]:
    return [f"10.0.{rng.randrange(256)}.{rng.randrange(256)}:"
            f"{rng.randrange(1024, 65536)}" for _ in range(n)]


def _same(ring, jring, skis, alive=None):
    assert ring.endpoints == jring.endpoints
    assert len(ring) == len(jring)
    assert ring._points == jring._points
    assert ring._owners == jring._owners
    for s in skis:
        assert ring.lookup(s, alive) == jring.lookup(s, alive)
    assert ring.partition(skis, alive) == jring.partition(skis, alive)


@pytest.mark.parametrize("n_eps,vnodes", [(1, 64), (2, 64), (3, 64),
                                          (5, 16), (8, 1), (4, 160)])
def test_owners_partitions_and_failover_match(n_eps, vnodes):
    rng = random.Random(f"ring-{n_eps}-{vnodes}")
    eps = _endpoints(rng, n_eps)
    skis = _skis(rng, 400) + [b"", b"\x00" * 32, b"\xff" * 32]
    ring = router.HashRing(eps, vnodes=vnodes)
    jring = jrouter.HashRing(eps, vnodes=vnodes)
    _same(ring, jring, skis)
    for k in range(n_eps + 1):
        alive = rng.sample(eps, k) + ["not-a-member:1"]
        _same(ring, jring, skis, alive)
    _same(ring, jring, skis, [])


def test_add_and_remove_keep_the_reference_routing():
    rng = random.Random("ring-churn")
    eps = _endpoints(rng, 6)
    ring, jring = router.HashRing(eps[:3]), jrouter.HashRing(eps[:3])
    skis = _skis(rng, 300)
    for step in range(12):
        ep = rng.choice(eps)
        if rng.random() < 0.5:
            ring.add(ep)
            jring.add(ep)
        else:
            ring.remove(ep)
            jring.remove(ep)
        _same(ring, jring, skis)
        alive = rng.sample(eps, rng.randrange(len(eps) + 1))
        _same(ring, jring, skis, alive)
    # insertion order never changes routing
    a = router.HashRing(list(reversed(eps)))
    assert a._points == jrouter.HashRing(eps)._points
    assert a._owners == jrouter.HashRing(eps)._owners


def test_affinity_ski_and_defaults_match():
    rng = random.Random("affinity")
    assert router.DEFAULT_VNODES == jrouter.DEFAULT_VNODES
    for n in (0, 1, 2, 85, 128):
        skis = _skis(rng, n)
        assert router.affinity_ski(skis) == jrouter.affinity_ski(skis)
        assert router.affinity_ski(reversed(skis)) == \
            router.affinity_ski(skis)
    with pytest.raises(ValueError):
        router.HashRing(["a:1"], vnodes=0)
    assert router.HashRing([]).lookup(b"x") is None
