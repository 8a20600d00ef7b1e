"""The port's verifyd coalescer against the reference's.

One seeded sequence of submits (tenants, lane counts, invalid lanes,
lane hints, deadlines, blocks) goes through the reference's
``Coalescer`` and the port's, each over the same stub provider, with
the flushes called by hand (one flush worker, no flusher thread, so
both run the same steps in the same order). At every step the two must
agree: admission (``Shed`` with its reason and ``retry_after_ms``,
``QuotaExceeded`` with its message), each batch's verdict bitmap and
error, each block's flags, the provider calls, and at the end
``counts``, ``bucket_ring`` and ``stats``. Then the reference's
admission cases (``tests/test_overload.py``: the watermarks, their
hysteresis, the tenant mark, votes never shed, the retry hint), run on
both sides.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from bdls_tpu.crypto import blocklane as jblocklane
from bdls_tpu.crypto import marshal as jmarshal
from bdls_tpu.sidecar import coalescer as jco
from bdls_tpu_torch.crypto import blocklane, marshal
from bdls_tpu_torch.sidecar import coalescer as co

SIDES = {"port": (co, marshal, blocklane),
         "reference": (jco, jmarshal, jblocklane)}
POISON = b"\xee" * 32  # a lane whose flush the stub provider fails


class StubCSP:
    """Verdict = the low bit of r's last byte; a lane with r = POISON
    fails its whole flush. A block's flags follow its shape; a block of
    3 txs fails."""

    buckets = (8, 32, 128)

    def __init__(self):
        self.calls = []

    def verify_batch(self, reqs):
        rs = [r.wire32()[2] for r in reqs]
        self.calls.append(("batch", [(r.curve, x[-1]) for r, x in
                                     zip(reqs, rs)]))
        if POISON in rs:
            raise RuntimeError("stub launch failed")
        return [bool(x[-1] & 1) for x in rs]

    def verify_block(self, req):
        self.calls.append(("block", req.curve, len(req.lanes), req.ntx))
        if req.ntx == 3:
            raise RuntimeError("stub block failed")
        return np.array([(len(req.lanes) + t) % 4 for t in range(req.ntx)],
                        dtype=np.int32)


def _lane(mod, rng: random.Random):
    """One wire lane: valid, invalid (a 33-byte field), or the poison."""
    roll = rng.random()
    curve = rng.choice(["P-256", "secp256k1"])
    r = POISON if roll < 0.01 else rng.randbytes(32)
    qx = rng.randbytes(33 if roll > 0.93 else 32)
    return mod.from_wire_fields(curve, qx, rng.randbytes(32), r,
                                rng.randbytes(32), rng.randbytes(32))


def _block(mod, rng: random.Random):
    ntx = rng.choice([1, 2, 3, 3, 5, 9])
    lanes = [mod.BlockLane(msg=rng.randbytes(40), qx=rng.randbytes(32),
                           qy=rng.randbytes(32), r=rng.randbytes(32),
                           s=rng.randbytes(32), tx=t % ntx, org=t % 3)
             for t in range(rng.choice([1, 4, 12, 30]))]
    return mod.BlockVerifyRequest(
        curve="P-256", lanes=lanes,
        policies=[mod.BlockPolicy(required=1, orgs=(0, 1))
                  for _ in range(ntx)], norgs=3)


def _steps(seed: str, n: int = 160) -> list:
    """The sequence, as plain data both sides rebuild their objects from."""
    rng = random.Random(seed)
    steps = []
    for i in range(n):
        roll = rng.random()
        if roll < 0.15:
            steps.append(("flush",))
        elif roll < 0.25:
            steps.append(("block", f"t{rng.randrange(4)}", i,
                          rng.choice([0.0, 1e-6, 1e9]), rng.random()))
        else:
            steps.append(("submit", f"t{rng.randrange(4)}", i,
                          rng.choice([1, 2, 5, 9, 30, 64, 150, 300]),
                          rng.choice([0, 0, 0, 5, 85]),
                          rng.choice([0.0, 0.0, 1e-6, 1e9]), rng.random()))
    steps.append(("flush",))
    return steps


def _run(side: str, steps: list, **kw) -> dict:
    comod, mmod, bmod = SIDES[side]
    csp = StubCSP()
    c = comod.Coalescer(csp, flush_interval=60.0, workers=1, **kw)
    c._ensure_flusher = lambda: None  # flushes only by hand
    replies: dict = {}
    outcomes = []

    def on_reply(b):
        if hasattr(b, "verdicts"):
            replies[("batch", b.tenant, b.seq)] = (
                bytes(b.verdicts), b.error.split(":")[0])
        else:
            flags = None if b.flags is None else [int(f) for f in b.flags]
            replies[("block", b.tenant, b.seq)] = (flags,
                                                   b.error.split(":")[0])

    try:
        for step in steps:
            if step[0] == "flush":
                c.flush()
                c._pool.submit(lambda: None).result(30)  # jobs done
                outcomes.append(("flush", dict(c.counts)))
                continue
            try:
                if step[0] == "submit":
                    _, tenant, seq, n, hint, deadline, lseed = step
                    lrng = random.Random(lseed)
                    c.submit(comod.ClientBatch(
                        tenant, seq, [_lane(mmod, lrng) for _ in range(n)],
                        on_reply, deadline_ms=deadline, lane_hint=hint))
                else:
                    _, tenant, seq, deadline, bseed = step
                    c.submit_block(comod.BlockBatch(
                        tenant, seq, _block(bmod, random.Random(bseed)),
                        on_reply, deadline_ms=deadline))
                outcomes.append(("ok",))
            except comod.Shed as exc:
                outcomes.append(("shed", exc.reason, exc.retry_after_ms,
                                 str(exc)))
            except comod.QuotaExceeded as exc:
                outcomes.append(("quota", str(exc)))
        return {"outcomes": outcomes, "replies": replies,
                "calls": csp.calls, "counts": dict(c.counts),
                "ring": list(c.bucket_ring), "stats": c.stats}
    finally:
        c.close()


CONFIGS = {
    "defaults": {},
    "watermarks": {"watermarks": (40, 120, 400), "vote_lane_max": 8},
    "tenant mark and quota": {"watermarks": (0, 200, 1000),
                              "tenant_watermark": 150, "tenant_quota": 400},
    "tight": {"watermarks": (5, 10, 64), "tenant_quota": 100,
              "vote_lane_max": 0, "flush_lanes": 16},
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_seeded_sequence_matches_the_reference(config):
    steps = _steps(f"coalescer-{config}")
    got = _run("port", steps, **CONFIGS[config])
    want = _run("reference", steps, **CONFIGS[config])
    for i, (a, b) in enumerate(zip(got["outcomes"], want["outcomes"])):
        assert a == b, (i, steps[i], a, b)
    assert got["replies"] == want["replies"]
    assert got["calls"] == want["calls"]
    assert got["counts"] == want["counts"]
    assert got["ring"] == want["ring"]
    assert got["stats"] == want["stats"]
    # the sequence reached what it is for
    kinds = {o[0] for o in got["outcomes"]}
    assert "ok" in kinds and "flush" in kinds
    if config != "defaults":
        assert "shed" in kinds
    if "tenant_quota" in CONFIGS[config]:
        assert "quota" in kinds
    assert got["counts"]["deadline_expirations"] > 0
    assert got["counts"]["verify_errors"] > 0
    assert got["counts"]["block_verify_errors"] > 0
    # a hinted vote lane armed its occupancy trigger before a flush
    assert got["counts"]["quorum_flushes"] > 0
    assert got["counts"]["multi_tenant_buckets"] > 0


# ---- the reference's admission cases (tests/test_overload.py), both sides ---

class _NullCSP:
    buckets = (8,)

    def verify_batch(self, reqs):
        return [True] * len(reqs)


@pytest.fixture(params=sorted(SIDES))
def side(request):
    comod = SIDES[request.param][0]
    made = []

    def make(**kw):
        kw.setdefault("flush_interval", 5.0)
        kw.setdefault("flush_lanes", 1 << 10)
        kw.setdefault("vote_lane_max", 0)
        c = comod.Coalescer(_NullCSP(), **kw)
        made.append(c)
        return c

    def batch(tenant, seq, lanes, lane_hint=0):
        return comod.ClientBatch(tenant, seq, [object()] * lanes,
                                 reply=lambda b: None, lane_hint=lane_hint)

    yield comod, make, batch
    for c in made:
        c.close()


def test_watermark_validation(side):
    comod, _, _ = side
    for marks in ((8, 4, 64), (4, 65, 64), (-1, 4, 64)):
        with pytest.raises(ValueError):
            comod.Coalescer(_NullCSP(), watermarks=marks)


def test_tenant_watermark_boundary(side):
    comod, make, batch = side
    c = make(tenant_watermark=8)
    c.submit(batch("greedy", 0, 8))
    with pytest.raises(comod.Shed) as exc:
        c.submit(batch("greedy", 1, 1))
    assert exc.value.reason == "tenant_watermark"
    assert exc.value.retry_after_ms > 0
    c.submit(batch("other", 0, 8))
    assert c.counts["shed_batches"] == 1 and c.counts["shed_lanes"] == 1
    shed = c.metrics.find("verifyd_shed_total")
    assert shed.value(("greedy", "tenant_watermark")) == 1
    assert shed.value(("other", "tenant_watermark")) == 0


def test_high_watermark_is_strict_and_hysteretic(side):
    comod, make, batch = side
    c = make(watermarks=(4, 8, 64))
    c.submit(batch("t", 0, 8))
    c.submit(batch("t", 1, 1))
    with pytest.raises(comod.Shed) as exc:
        c.submit(batch("t", 2, 1))
    assert exc.value.reason == "high_watermark"
    with c._lock:
        c._pending_lanes = 5
    with pytest.raises(comod.Shed):
        c.submit(batch("t", 3, 1))
    with c._lock:
        c._pending_lanes = 4
    c.submit(batch("t", 4, 1))
    assert not c._shedding


def test_hard_watermark_overrides_hysteresis(side):
    comod, make, batch = side
    c = make(watermarks=(4, 8, 16))
    with pytest.raises(comod.Shed) as exc:
        c.submit(batch("t", 0, 20))
    assert exc.value.reason == "hard_watermark"
    c.submit(batch("t", 1, 16))
    with pytest.raises(comod.Shed) as exc:
        c.submit(batch("t", 2, 1))
    assert exc.value.reason == "hard_watermark"


def test_vote_lanes_never_shed(side):
    comod, make, batch = side
    c = make(vote_lane_max=4, watermarks=(0, 0, 0))
    c.submit(batch("t", 0, 4))
    c.submit(batch("t", 1, 16, lane_hint=16))
    with pytest.raises(comod.Shed):
        c.submit(batch("t", 2, 5))
    assert c.counts["vote_lane_batches"] == 2
    assert c.counts["shed_batches"] == 1


def test_shed_retry_after_tracks_depth(side):
    comod, make, batch = side
    c = make(watermarks=(4, 8, 64), flush_lanes=16)
    c.submit(batch("t", 0, 9))
    with pytest.raises(comod.Shed) as exc:
        c.submit(batch("t", 1, 1))
    assert exc.value.retry_after_ms == pytest.approx(5000.0 * (1 + 9 / 16))


def test_instruments_carry_the_reference_names():
    names = {}
    for key, (comod, _, _) in SIDES.items():
        c = comod.Coalescer(_NullCSP())
        names[key] = sorted(i.opts.fqname() for i in c.metrics.instruments())
        c.close()
    assert names["port"] == names["reference"]
    assert "verifyd_shed_total" in names["port"]
