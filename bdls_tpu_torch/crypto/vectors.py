"""Seeded verify lanes for parity checks: valid, tampered and hostile.

The same lanes drive the CPU parity tests (port vs JAX package vs
OpenSSL) and ``chip_smoke.py`` (CUDA kernel vs plain version on the
card). Every value comes from a ``numpy.random.Generator``, so a seed
names a batch. Each lane is ``(qx, qy, r, s, digest, label)``; the
kernel-level verdict (no low-S policy) is what :func:`expected` gives.
:func:`block_request` makes whole-block requests for the block lane;
their oracle is ``blocklane.verify_block_host`` over ``SwCSP``.
"""

from __future__ import annotations

import hashlib
from dataclasses import replace

from bdls_tpu_torch.crypto.blocklane import BlockLane, BlockPolicy, \
    BlockVerifyRequest
from bdls_tpu_torch.crypto.sw import SwCSP, _mul_add, ecdsa_verify
from bdls_tpu_torch.ops.curves import CURVES

_SW = SwCSP()


def _digest(rng) -> bytes:
    return hashlib.sha256(rng.bytes(16)).digest()


def _sqrt_mod(a: int, p: int):
    """Square root mod p (p ≡ 3 mod 4 for both curves' base fields)."""
    y = pow(a, (p + 1) // 4, p)
    return y if y * y % p == a % p else None


def signed_lanes(curve: str, n: int, rng) -> list[tuple]:
    """n valid signatures under fresh keys (low-S, as SwCSP signs)."""
    out = []
    for i in range(n):
        key = _SW.key_gen(curve, rng)
        d = _digest(rng)
        r, s = _SW.sign(key, d)
        pub = key.public_key()
        out.append((pub.x, pub.y, r, s, d, "valid"))
    return out


def _point_with_x(curve: str, x: int) -> tuple[int, int]:
    """The first curve point with x-coordinate >= x."""
    cv = CURVES[curve]
    p = cv.fp.modulus
    while True:
        y = _sqrt_mod(x ** 3 + cv.a * x + cv.b, p)
        if y is not None:
            return x, y
        x += 1


def forged_lane(curve: str, q: tuple[int, int], rng) -> tuple:
    """A lane that verifies under the public point q without its private
    key: pick u1, u2, take R = u1·G + u2·q, then r = x(R) mod n,
    s = r/u2 and e = u1·s (the textbook chosen-digest construction)."""
    cv = CURVES[curve]
    n = cv.fn.modulus
    u1 = int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1
    u2 = int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1
    rx = _mul_add(cv, u1, (cv.gx, cv.gy), u2, q)[0]
    r = rx % n
    s = r * pow(u2, -1, n) % n
    return (q[0], q[1], r, s, (u1 * s % n).to_bytes(32, "big"), "forged")


def forged_rn_lane(curve: str, rng) -> tuple:
    """A lane whose R has x(R) in [n, p), so it verifies only through the
    ``X == (r + n)·Z`` branch: pick R and u1, u2, then solve for the key
    Q = u2^-1·(R - u1·G) and the signature r = x(R) - n, s = r/u2,
    e = u1·s."""
    cv = CURVES[curve]
    p, n = cv.fp.modulus, cv.fn.modulus
    x, y = _point_with_x(
        curve, n + int.from_bytes(rng.bytes(8), "big") % min(p - n, 1 << 60))
    r = x - n
    u1 = int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1
    u2 = int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1
    diff = _mul_add(cv, 1, (x, y), n - u1, (cv.gx, cv.gy))   # R - u1·G
    q = _mul_add(cv, pow(u2, -1, n), diff)
    s = r * pow(u2, -1, n) % n
    e = u1 * s % n
    return (q[0], q[1], r, s, e.to_bytes(32, "big"), "forged r+n")


def mixed_lanes(curve: str, rng, n_valid: int = 4) -> list[tuple]:
    """Valid, tampered and hostile lanes for one curve."""
    cv = CURVES[curve]
    p, n = cv.fp.modulus, cv.fn.modulus
    good = signed_lanes(curve, max(n_valid, 2), rng)
    qx, qy, r, s, d, _ = good[0]
    ox, oy = good[1][0], good[1][1]
    forged = forged_rn_lane(curve, rng)
    small = forged_lane(curve, _point_with_x(curve, 2), rng)
    lanes = list(good)
    lanes += [
        (qx, qy, r, s, _digest(rng), "tampered digest"),
        (qx, qy, (r + 1) % n, s, d, "tampered r"),
        (qx, qy, r, (s + 1) % n, d, "tampered s"),
        (ox, oy, r, s, d, "tampered key"),
        (qx, qy, 0, s, d, "r = 0"),
        (qx, qy, n, s, d, "r = n"),
        (qx, qy, (1 << 256) - 1, s, d, "r = 2^256-1"),
        (qx, qy, r, 0, d, "s = 0"),
        (qx, qy, r, n, d, "s = n"),
        (qx, qy, r, (1 << 256) - 1, d, "s = 2^256-1"),
        (p, qy, r, s, d, "Qx = p"),
        (qx, p, r, s, d, "Qy = p"),
        small,
        (small[0] + p,) + small[1:5] + ("Qx + p, same point mod p",),
        (0, 0, r, s, d, "Q = (0, 0)"),
        (qx, (qy + 1) % p, r, s, d, "Q off curve"),
        (qx, qy, r, n - s, d, "high-S twin"),
        forged,
        forged[:4] + (_digest(rng), "forged r+n, tampered digest"),
        (forged[0], forged[1], forged[2] + n, forged[3], forged[4],
         "forged, r + n given"),
    ]
    for e_bytes in (b"\xff" * 32, b"\0" * 32):
        key = _SW.key_gen(curve, rng)
        pub = key.public_key()
        rr, ss = _SW.sign(key, e_bytes)
        lanes.append((pub.x, pub.y, rr, ss, e_bytes, "extreme digest"))
    return lanes


def expected(curve: str, lanes) -> list[bool]:
    """Kernel-level verdicts (no low-S policy) from the integer ECDSA."""
    return [ecdsa_verify(curve, qx, qy, d, r, s)
            for qx, qy, r, s, d, _ in lanes]


def columns(lanes) -> tuple[list[int], ...]:
    """Lanes -> the five int columns (qx, qy, r, s, e)."""
    return tuple(list(c) for c in zip(*[
        (qx, qy, r, s, int.from_bytes(d, "big"))
        for qx, qy, r, s, d, _ in lanes]))


def pad_to(lanes, size: int) -> list[tuple]:
    """Pad by repeating lanes from the front (to a multiple of size)."""
    k = -len(lanes) % size
    return list(lanes) + [lanes[i % len(lanes)] for i in range(k)]


def _b32(v: int) -> bytes:
    return v.to_bytes(32, "big")


def block_request(curve: str, rng, ntx: int, *, norgs: int = 4,
                  msg_len: tuple = (200, 1000),
                  hostile: bool = False) -> BlockVerifyRequest:
    """A block of ``ntx`` txs, each endorsed twice over one shared
    preimage of a seeded length in ``msg_len`` (tx 0 takes the longest),
    by keys of two different orgs out of ``norgs`` (two endorsers an
    org); every policy is 2-of-any. Every 97th tx from tx 5 has its second endorsement
    tampered.

    ``hostile`` mixes in, from tx 1 on: 10 tampered signatures, 5
    high-S twins, 2 lanes with a 33-byte field (screened as filler), r
    and s out of [1, n), a key off the curve, 3 txs with a single
    endorsement, a policy counting only an org outside the universe
    (the committer's sentinel), a tx endorsed twice by one org, a 3-org
    tx under a 2-of-{0, 1} policy, and messages of 0 bytes and at the
    SHA-256 padding boundaries."""
    cv = CURVES[curve]
    n, p = cv.fn.modulus, cv.fp.modulus
    keys = [[_SW.key_gen(curve, rng) for _ in range(2)]
            for _ in range(norgs)]
    lo, hi = msg_len
    lens = [hi] + [int(v) for v in rng.integers(lo, hi + 1, ntx - 1)]
    if hostile:
        for t, ln in zip(range(1, 9), (0, 55, 56, 63, 64, 119, 120, 1015)):
            lens[t] = ln

    def endorse(key, msg, t, org):
        r, s = _SW.sign(key, hashlib.sha256(msg).digest())
        pub = key.public_key()
        return BlockLane(msg, _b32(pub.x), _b32(pub.y), _b32(r), _b32(s),
                         t, org)

    lanes, policies = [], []
    for t in range(ntx):
        msg = rng.bytes(lens[t])
        orgs = [t % norgs, (t + 1) % norgs]
        pol = BlockPolicy(required=2)
        if hostile and t == 20:
            orgs = [0, 0]                          # one org twice
        elif hostile and t == 21:
            orgs = [0, 1, 2]
            pol = BlockPolicy(required=2, orgs=(0, 1))
        elif hostile and t == 22:
            pol = BlockPolicy(required=1, orgs=(norgs,))   # sentinel
        elif hostile and t in (23, 24, 25):
            orgs = orgs[:1]                        # under-endorsed
        ends = [endorse(keys[o][j % 2], msg, t, o)
                for j, o in enumerate(orgs)]
        if t % 97 == 5 and len(ends) > 1:
            ends[1] = replace(ends[1], r=_b32(
                int.from_bytes(ends[1].r, "big") ^ 1))
        lanes += ends
        policies.append(pol)
    if hostile:
        def edit(i, **kw):
            lanes[i] = replace(lanes[i], **kw)

        def val(i, f):
            return int.from_bytes(getattr(lanes[i], f), "big")

        # lanes 2 t and 2 t + 1 belong to tx t for t < 20
        for i in range(10):                        # tampered
            edit(2 + i, s=_b32(val(2 + i, "s") ^ (1 << i)))
        for i in range(5):                         # high-S twins
            edit(14 + i, s=_b32(n - val(14 + i, "s")))
        edit(19, r=b"\0" + lanes[19].r)           # 33 bytes: screened
        edit(20, qx=b"\0" + lanes[20].qx)
        edit(21, r=_b32(n))
        edit(22, r=_b32(0))
        edit(23, s=_b32(n))
        edit(24, s=_b32(0))
        edit(25, qy=_b32((val(25, "qy") + 1) % p))  # off the curve
    return BlockVerifyRequest(curve, lanes, policies, norgs=norgs)
