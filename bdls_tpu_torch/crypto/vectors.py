"""Seeded verify lanes for parity checks: valid, tampered and hostile.

The same lanes drive the CPU parity tests (port vs JAX package vs
OpenSSL) and ``chip_smoke.py`` (CUDA kernel vs plain version on the
card). Every value comes from a ``numpy.random.Generator``, so a seed
names a batch. Each lane is ``(qx, qy, r, s, digest, label)``; the
kernel-level verdict (no low-S policy) is what :func:`expected` gives.
:func:`block_request` makes whole-block requests for the block lane;
their oracle is ``blocklane.verify_block_host`` over ``SwCSP``.

Ed25519 lanes have the same shape, ``(ax, ay, r, s, msg, label)``: the
affine public key, R's RFC 8032 encoding as a big-endian int (as
``SwCSP.sign`` returns it), the scalar S and the message. Their
verdict is :func:`ed25519_expected` (the RFC 8032 oracle,
cofactorless), and :func:`ed25519_rows` gives the kernel's six scalars.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import replace

from bdls_tpu_torch.crypto.blocklane import BlockLane, BlockPolicy, \
    BlockVerifyRequest
from bdls_tpu_torch.crypto.sw import SwCSP, _mul_add, ecdsa_verify
from bdls_tpu_torch.ops import ed25519 as ed
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


def ladder_lanes(curve: str, rng) -> list[tuple]:
    """Lanes at the edges of the dual ladder, beyond :func:`mixed_lanes`:
    R at infinity (Q = d·G and e = -r·d, so u1·G = -u2·Q), a valid lane
    whose u1·G and u2·Q are one point (e = r·d, s = 2rd/k, R = k·G: the
    chains meet in a doubling), and on secp256k1 valid lanes whose u2
    splits into a second GLV half of each sign."""
    from bdls_tpu_torch.ops import glv

    cv = CURVES[curve]
    n = cv.fn.modulus
    g = (cv.gx, cv.gy)

    def scalar() -> int:
        return int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1

    d = scalar()
    q = _mul_add(cv, d, g)
    r, s = scalar(), scalar()
    out = [(*q, r, s, (-r * d % n).to_bytes(32, "big"), "R at infinity")]
    while True:
        k = scalar()
        r = _mul_add(cv, k, g)[0] % n
        if r:
            break
    out.append((*q, r, 2 * r * d * pow(k, -1, n) % n,
                (r * d % n).to_bytes(32, "big"), "u1·G = u2·Q, valid"))
    if curve == "secp256k1":
        # k2 takes either sign; k1 came out >= 0 on each of a million
        # random scalars
        want = {False, True}
        while want:
            lane = signed_lanes(curve, 1, rng)[0]
            u2 = lane[2] * pow(lane[3], -1, n) % n
            neg = glv.decompose_host(u2)[1] < 0
            if neg in want:
                want.discard(neg)
                sign = "<" if neg else ">="
                out.append(lane[:5] + (f"GLV half k2 {sign} 0",))
    return out


def select_lanes(curve: str, rng) -> list[tuple]:
    """Lanes whose windowed ladder (K4's) takes each exceptional select:
    s = 1, so u1 = e and u2 = r, and one digit a shared by r and e.
    - Q = G, e = r: the Q entry and the G entry of a window are one point
      (P == Q in the reference's G mixed addition);
    - Q = -G, e = r: they cancel (P == -Q), and R is at infinity;
    - Q = 16·G, r's digits (0, a, ...) and e's (a, 0, ...): after window
      1's doublings the accumulator is 16a·G, the Q entry a·Q, one point
      (P == Q in the Q-entry addition); Q = -16·G: they cancel."""
    cv = CURVES[curve]
    n = cv.fn.modulus
    g = (cv.gx, cv.gy)

    def neg(pt):
        return (pt[0], (-pt[1]) % cv.fp.modulus)

    r = int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1
    a = int(rng.integers(1, 16))
    rest = int.from_bytes(rng.bytes(31), "big")
    r2 = (a << 248) | (rest >> 4)            # digits 0, a, ...
    e2 = (a << 252) | (rest >> 8)            # digits a, 0, ...
    g16 = _mul_add(cv, 16, g)
    return [
        (*g, r, 1, _b32(r), "Q = G, e = r: Q entry == G entry"),
        (*neg(g), r, 1, _b32(r), "Q = -G, e = r: R at infinity"),
        (*g16, r2, 1, _b32(e2), "Q = 16·G: acc == Q entry"),
        (*neg(g16), r2, 1, _b32(e2), "Q = -16·G: acc == -Q entry"),
    ]


def zero_byte_lanes(curve: str, rng) -> list[tuple]:
    """Valid lanes under one fresh key whose u1 = e/s has zero bytes, so
    that the pinned sum adds G entries at infinity: u1 with its lowest,
    highest and some middle bytes 0, and u1 = 0 (e = 0, R = u2·Q). Made
    as :func:`forged_lane` makes its lane: R = u1·G + u2·Q, r = x(R) mod
    n, s = r/u2, e = u1·s."""
    cv = CURVES[curve]
    n = cv.fn.modulus
    g = (cv.gx, cv.gy)

    def scalar() -> int:
        return int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1

    q = _mul_add(cv, scalar(), g)
    holes = sum(0xFF << (8 * j) for j in (0, 1, 7, 16, 17, 30, 31))
    out = []
    for label, u1 in (("u1 with zero bytes", scalar() & ~holes),
                      ("u1 = 0", 0)):
        while True:
            u2 = scalar()
            r = _mul_add(cv, u1, g, u2, q)[0] % n
            if r:
                break
        s = r * pow(u2, -1, n) % n
        out.append((*q, r, s, (u1 * s % n).to_bytes(32, "big"), label))
    return out


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


# ---------------------------------------------------------------- Ed25519

# RFC 8032 §7.1 TEST 1-3: (seed, pub, msg, sig), hex
RFC8032_VECTORS = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def _ed_lane(pub: tuple, sig: bytes, msg: bytes, label: str) -> tuple:
    return (pub[0], pub[1], int.from_bytes(sig[:32], "big"),
            int.from_bytes(sig[32:], "little"), msg, label)


def rfc8032_lanes() -> list[tuple]:
    """The three RFC 8032 §7.1 vectors as lanes (all valid)."""
    out = []
    for i, (_seed, pk, msg, sig) in enumerate(RFC8032_VECTORS):
        pk, msg, sig = (bytes.fromhex(x) for x in (pk, msg, sig))
        out.append(_ed_lane(ed.decompress(pk), sig, msg,
                            f"RFC 8032 TEST {i + 1}"))
    return out


def ed25519_signed_lanes(n: int, rng, msg: bytes = None) -> list[tuple]:
    """n valid signatures under fresh seeded keys, over ``msg`` or a
    seeded 32-byte message each."""
    out = []
    for _ in range(n):
        seed = rng.bytes(32)
        m = rng.bytes(32) if msg is None else msg
        out.append(_ed_lane(ed.public_point(seed), ed.sign(seed, m), m,
                            "valid"))
    return out


@functools.lru_cache(maxsize=None)
def ed25519_torsion8() -> tuple[int, int]:
    """A point of order 8 ([L]·P for a point P of the full group whose
    [L]·P has order 8)."""
    y = 2
    while True:
        pt = ed.decompress(y.to_bytes(32, "little"))
        if pt is not None:
            t = ed._affine(ed._ext_mul(ed.L, pt))
            if ed._affine(ed._ext_mul(4, t)) != (0, 1):
                return t
        y += 1


def _signed_with(a: int, prefix: bytes, pub: tuple, msg: bytes,
                 r_point=None) -> bytes:
    """An RFC 8032 signature by secret scalar ``a`` under the claimed
    public point ``pub`` (which may differ from a·B by a torsion point),
    with R = r·B unless ``r_point`` (the nonce's point) is given."""
    r = ed._sha512_mod_l(prefix, msg)
    R = ed.pt_mul(r, (ed.GX, ed.GY))
    if r_point is not None:
        R = ed.pt_add(R, r_point)
    r_enc = ed.compress(*R)
    k = ed.challenge(r_enc, ed.compress(*pub), msg)
    return r_enc + ((r + k * a) % ed.L).to_bytes(32, "little")


def _msg_with_k(pub: tuple, r_of, rng, want_zero: bool,
                modulus: int) -> bytes:
    """A seeded message whose challenge k is (or is not) ≡ 0 mod
    ``modulus`` under the public point ``pub``; ``r_of(msg)`` gives R's
    encoding."""
    while True:
        m = rng.bytes(32)
        k = ed.challenge(r_of(m), ed.compress(*pub), m)
        if (k % modulus == 0) == want_zero:
            return m


def ed25519_mixed_lanes(rng, n_valid: int = 4) -> list[tuple]:
    """Valid, tampered and hostile Ed25519 lanes: the RFC 8032 vectors,
    seeded signatures, tampered message / R / S / key, S = L - 1, L and
    2^256 - 1, A off the curve or out of range, non-canonical R (y >= p),
    R with x = 0 and the sign bit set, an R that does not decompress,
    the identity as A (and as R), small-order A and torsion components
    in A and R (cofactorless: k·T must vanish), and the long-message
    lanes of the digest screen (64 bytes; 48 bytes with 40 leading
    zeros)."""
    P, L = ed.P, ed.L
    lanes = rfc8032_lanes() + ed25519_signed_lanes(max(n_valid, 2), rng)
    ax, ay, r, s, m, _ = lanes[3]
    ox, oy, orr = lanes[4][0], lanes[4][1], lanes[4][2]
    t8 = ed25519_torsion8()
    seed = rng.bytes(32)
    a, prefix = ed.secret_expand(seed)
    A = ed.pt_mul(a, (ed.GX, ed.GY))
    A_t = ed.pt_add(A, t8)
    # a valid signature whose R carries a torsion component
    m_r = rng.bytes(32)
    bad_r = _signed_with(a, prefix, A, m_r, r_point=t8)
    # torsion in A: valid iff 8 | k
    def r_of(msg):
        return _signed_with(a, prefix, A_t, msg)[:32]

    m0 = _msg_with_k(A_t, r_of, rng, True, 8)
    m1 = _msg_with_k(A_t, r_of, rng, False, 8)
    # small-order A (order 8 and order 2): [S]B == R iff k·A vanishes
    sb = int.from_bytes(rng.bytes(32), "little") % L
    R_s = ed.compress(*ed.pt_mul(sb, (ed.GX, ed.GY)))
    def fixed_r(_msg):
        return R_s

    m8 = _msg_with_k(t8, fixed_r, rng, True, 8)
    m8x = _msg_with_k(t8, fixed_r, rng, False, 8)
    m2 = _msg_with_k((0, P - 1), fixed_r, rng, True, 2)
    m2x = _msg_with_k((0, P - 1), fixed_r, rng, False, 2)
    r_int = int.from_bytes(R_s, "big")
    # an encoding whose x^2 has no square root
    y = 3
    while ed.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    undecodable = int.from_bytes(y.to_bytes(32, "little"), "big")

    def enc_int(v: int) -> int:
        return int.from_bytes(v.to_bytes(32, "little"), "big")

    lanes += [
        (ax, ay, r, s, m + b"!", "tampered message"),
        (ax, ay, orr, s, m, "tampered R"),
        (ax, ay, r, (s + 1) % L, m, "tampered S"),
        (ox, oy, r, s, m, "tampered key"),
        (ax, ay, r, L - 1, m, "S = L - 1"),
        (ax, ay, r, L, m, "S = L"),
        (ax, ay, r, s + L, m, "S + L (same S mod L)"),
        (ax, ay, r, (1 << 256) - 1, m, "S = 2^256 - 1"),
        (ax, (ay + 1) % P, r, s, m, "A off curve"),
        (ax + P, ay, r, s, m, "Ax + p, same point mod p"),
        (ax, P, r, s, m, "Ay = p"),
        (ax, ay, enc_int(P + 1), s, m, "R non-canonical, y = p + 1"),
        (ax, ay, enc_int(1 | (1 << 255)), s, m, "R x = 0 with sign bit 1"),
        (ax, ay, undecodable, s, m, "R does not decompress"),
        (0, 1, r_int, sb, m, "A = identity, [S]B == R"),
        (0, 1, enc_int(1), 0, m, "A = R = identity, S = 0"),
        (0, 1, r_int, (sb + 1) % L, m, "A = identity, tampered S"),
        _ed_lane(A, bad_r, m_r, "torsion in R"),
        _ed_lane(A_t, _signed_with(a, prefix, A_t, m0), m0,
                 "torsion in A, 8 | k"),
        _ed_lane(A_t, _signed_with(a, prefix, A_t, m1), m1,
                 "torsion in A, 8 does not divide k"),
        (t8[0], t8[1], r_int, sb, m8, "A of order 8, 8 | k"),
        (t8[0], t8[1], r_int, sb, m8x, "A of order 8, 8 does not divide k"),
        (0, P - 1, r_int, sb, m2, "A of order 2, k even"),
        (0, P - 1, r_int, sb, m2x, "A of order 2, k odd"),
    ]
    key = ed.public_point((7).to_bytes(32, "little"))
    for msg in (b"a" * 32, b"b" * 64, b"\0" * 40 + b"c" * 8):
        lanes.append(_ed_lane(key, ed.sign((7).to_bytes(32, "little"), msg),
                              msg, f"{len(msg)}-byte message"))
    return lanes


def ed25519_k_rows(rng) -> list[tuple]:
    """Kernel rows ``(ax, ay, rx, ry, s, k, label)`` whose k is chosen,
    not hashed, at the edges of K8's signed digits of w = k + 0x88…8:
    k = 0 and k = 5 (the top digits 0), the largest k with carry nibble
    0 (w = 2^256 - 1, every digit 7), the smallest with carry 1 (w =
    2^256, every digit -8) and k = 2^256 - 1. Each is valid (S = r +
    k·a mod L, A = a·B, R = r·B) and once with S tampered; then a torsion
    component in A with carry 1, 8 | k (valid) and 8 not dividing k."""
    L, B = ed.L, (ed.GX, ed.GY)
    w0 = sum(8 << (4 * i) for i in range(64))
    top = 1 << 256
    a, _ = ed.secret_expand(rng.bytes(32))
    A = ed.pt_mul(a, B)
    A_t = ed.pt_add(A, ed25519_torsion8())
    cases = [(A, 0, "k = 0"), (A, 5, "k = 5, top digits 0"),
             (A, top - 1 - w0, "carry 0, every digit 7"),
             (A, top - w0, "carry 1, every digit -8"),
             (A, top - 1, "k = 2^256 - 1"),
             (A_t, top - 8, "torsion in A, carry 1, 8 | k"),
             (A_t, top - 1, "torsion in A, carry 1, 8 does not divide k")]
    rows = []
    for pub, k, label in cases:
        r = int.from_bytes(rng.bytes(32), "little") % L
        R = ed.pt_mul(r, B)
        s = (r + k * a) % L
        rows.append((pub[0], pub[1], R[0], R[1], s, k, label))
        if pub is A:
            rows.append((pub[0], pub[1], R[0], R[1], (s + 1) % L, k,
                         label + ", tampered S"))
    return rows


def ed25519_row_expected(rows) -> list[bool]:
    """The RFC 8032 equation on kernel rows with k as it is (not reduced
    mod L): S < L, the coordinates < p and on the curve, [S]B == R +
    [k]A."""
    out = []
    for ax, ay, rx, ry, s, k, *_ in rows:
        ok = (s < ed.L and max(ax, ay, rx, ry) < ed.P
              and ed.on_curve(ax, ay) and ed.on_curve(rx, ry))
        if ok:
            kA = ed._affine(ed._ext_mul(k, (ax, ay)))
            ok = ed.pt_add((rx, ry), kA) == ed.pt_mul(s, (ed.GX, ed.GY))
        out.append(ok)
    return out


def ed25519_rows(lanes) -> list[tuple]:
    """Lanes -> the kernel's six scalars each (``ed25519.ed25519_lane``)."""
    return [ed.ed25519_lane(x, y, r.to_bytes(32, "big"), s, m)
            for x, y, r, s, m, _ in lanes]


def ed25519_expected(lanes) -> list[bool]:
    """Kernel-level verdicts from the RFC 8032 oracle (no digest
    screen)."""
    memo = {}
    out = []
    for x, y, r, s, m, _ in lanes:
        key = (x, y, r, s, m)
        if key not in memo:
            memo[key] = ed.verify_affine(x, y, r.to_bytes(32, "big"), s, m)
        out.append(memo[key])
    return out
