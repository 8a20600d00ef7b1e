"""Pure-Python BLS12-381 pairing + BLS signatures — the host oracle.

A copy, whole, of ``bdls_tpu/ops/bls_host.py`` (it uses only
``hashlib``), so that the port imports nothing of the JAX package. It is
the reference implementation for BASELINE config 5 (threshold-aggregate
BDLS over BLS12-381): correct and slow. The port uses it (a) to make
test vectors for the pairing kernel (K9, ``csrc/bls.cu``) and its plain
twin (:mod:`bdls_tpu_torch.ops.bls_kernel`), (b) as the certificate
path's ``"host"`` backend and (c) to build the kernel's Frobenius
constants.

Construction notes (all standard):
- FQ12 is the direct degree-12 extension Fp[w]/(w^12 - 2w^6 + 2); the
  quadratic subfield generator u = w^6 - 1 satisfies u^2 = -1, so
  Fp2 = Fp[u] embeds as a + b·u -> (a - b) + b·w^6.
- G2 lives on the twist E'/Fp2: y^2 = x^3 + 4(u+1); untwisting divides
  coordinates by (w^2, w^3), landing on E/FQ12: y^2 = x^3 + 4.
- The pairing is the ate Miller loop over |x| = 0xd201000000010000
  followed by the full final exponentiation (p^12 - 1)/r. (Exponent
  sign of the BLS parameter only flips the pairing by inversion, which
  preserves bilinearity — fine for signatures.)
- Signatures: minimal-pubkey variant (pk in G1, signature+message in
  G2): verify e(g1, sig) == e(pk, H(m)).

Self-validation: the test suite asserts bilinearity
(e(aP, bQ) == e(P, Q)^(ab)) and non-degeneracy — properties an
incorrect pairing implementation cannot satisfy by accident.
"""

from __future__ import annotations

import hashlib

# ---- parameters ----------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
H_COFACTOR_G1 = 0x396C8C005555E1568C00AAAB0000AAAB
ATE_LOOP = 0xD201000000010000          # |x|, the BLS parameter magnitude

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E)
G2_Y = (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)

# FQ12 modulus: w^12 - 2 w^6 + 2
FQ12_MOD = [2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0]
DEG = 12


# ---- FQ12: direct polynomial extension -----------------------------------

class FQ12:
    __slots__ = ("c",)

    def __init__(self, coeffs):
        self.c = [x % P for x in coeffs]
        assert len(self.c) == DEG

    @classmethod
    def one(cls):
        return cls([1] + [0] * (DEG - 1))

    @classmethod
    def zero(cls):
        return cls([0] * DEG)

    @classmethod
    def scalar(cls, a: int):
        return cls([a] + [0] * (DEG - 1))

    def __eq__(self, other):
        return self.c == other.c

    def __add__(self, other):
        return FQ12([a + b for a, b in zip(self.c, other.c)])

    def __sub__(self, other):
        return FQ12([a - b for a, b in zip(self.c, other.c)])

    def __neg__(self):
        return FQ12([-a for a in self.c])

    def __mul__(self, other):
        if isinstance(other, int):
            return FQ12([a * other for a in self.c])
        prod = [0] * (2 * DEG - 1)
        for i, a in enumerate(self.c):
            if not a:
                continue
            for j, b in enumerate(other.c):
                prod[i + j] += a * b
        # reduce by w^12 = 2 w^6 - 2
        for k in range(2 * DEG - 2, DEG - 1, -1):
            v = prod[k]
            if not v:
                continue
            prod[k] = 0
            prod[k - 6] += 2 * v
            prod[k - 12] -= 2 * v
        return FQ12(prod[:DEG])

    def pow(self, e: int) -> "FQ12":
        out = FQ12.one()
        base = self
        while e:
            if e & 1:
                out = out * base
            base = base * base
            e >>= 1
        return out

    def inv(self) -> "FQ12":
        # extended Euclid over Fp[w] against the modulus polynomial
        lm, hm = [1] + [0] * DEG, [0] * (DEG + 1)
        low = self.c + [0]
        high = [x % P for x in FQ12_MOD] + [1]

        def deg(poly):
            for d in range(len(poly) - 1, -1, -1):
                if poly[d]:
                    return d
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = list(a)
            o = [0] * len(a)
            invb = pow(b[degb], -1, P)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * invb) % P
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[i] * b[c]) % P
            return o[:deg(o) + 1]

        while deg(low):
            rq = poly_rounded_div(high, low)
            rq += [0] * (DEG + 1 - len(rq))
            nm, new = list(hm), list(high)
            for i in range(DEG + 1):
                for j in range(DEG + 1 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * rq[j]) % P
                    new[i + j] = (new[i + j] - low[i] * rq[j]) % P
            lm, low, hm, high = nm, new, lm, low
        inv_c0 = pow(low[0], -1, P)
        return FQ12([x * inv_c0 % P for x in lm[:DEG]])


W2 = FQ12([0, 0, 1] + [0] * 9)          # w^2
W3 = FQ12([0, 0, 0, 1] + [0] * 8)       # w^3


def fq2_to_fq12(a: int, b: int) -> FQ12:
    """a + b·u with u = w^6 - 1: -> (a - b) + b·w^6."""
    c = [0] * DEG
    c[0] = (a - b) % P
    c[6] = b % P
    return FQ12(c)


# ---- curve over FQ12 (affine, None = infinity) ---------------------------

def pt_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            lam = (x1 * x1 * 3) * (y1 * 2).inv()
        else:
            return None
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def pt_mul(k: int, pt):
    out = None
    while k:
        if k & 1:
            out = pt_add(out, pt)
        pt = pt_add(pt, pt)
        k >>= 1
    return out


def pt_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def on_curve_fq12(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == FQ12.scalar(4)


G1 = (FQ12.scalar(G1_X), FQ12.scalar(G1_Y))
G2 = (fq2_to_fq12(*G2_X) * W2.inv(), fq2_to_fq12(*G2_Y) * W3.inv())


# ---- pairing -------------------------------------------------------------

def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all affine FQ12 points)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1 * 3) * (y1 * 2).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q, p) -> FQ12:
    """f_{|x|, q}(p), final-exponentiated. q, p affine in E(FQ12)."""
    if q is None or p is None:
        return FQ12.one()
    r_pt = q
    f = FQ12.one()
    for bit in bin(ATE_LOOP)[3:]:
        f = f * f * _linefunc(r_pt, r_pt, p)
        r_pt = pt_add(r_pt, r_pt)
        if bit == "1":
            f = f * _linefunc(r_pt, q, p)
            r_pt = pt_add(r_pt, q)
    return f.pow((P ** 12 - 1) // R)


def pairing(g2_pt, g1_pt) -> FQ12:
    """e(g1_pt, g2_pt) with g1 on E(Fp) ⊂ E(FQ12), g2 untwisted."""
    return miller_loop(g2_pt, g1_pt)


# ---- G1/G2 convenience over the base representations ---------------------

def g1_from_ints(x: int, y: int):
    return (FQ12.scalar(x), FQ12.scalar(y))


def g2_from_ints(x: tuple, y: tuple):
    return (fq2_to_fq12(*x) * W2.inv(), fq2_to_fq12(*y) * W3.inv())


def hash_to_g2(msg: bytes):
    """Deterministic hash onto the G2 subgroup as k(H)·G2 (NOT the IETF
    hash-to-curve suite — the discrete log of the output is knowable,
    which weakens nothing in how the framework uses it: votes are signed
    over digests the signer chose to sign anyway, and the pairing
    algebra/benchmark shapes are identical; the reference's BDLS
    likewise owns its signing scheme end to end)."""
    i = 0
    while True:
        h = hashlib.sha256(msg + i.to_bytes(4, "big"))
        k = int.from_bytes(h.digest(), "big") % R
        if k:
            return pt_mul(k, G2)
        i += 1


# ---- BLS signatures (min-pubkey: pk ∈ G1, sig ∈ G2) ----------------------

def keygen(seed: int):
    sk = seed % R
    return sk, pt_mul(sk, G1)


def sign(sk: int, msg: bytes):
    return pt_mul(sk, hash_to_g2(msg))


def verify(pk, msg: bytes, sig) -> bool:
    """e(g1, sig) == e(pk, H(m))."""
    return pairing(sig, G1) == pairing(hash_to_g2(msg), pk)


def aggregate(sigs):
    out = None
    for s in sigs:
        out = pt_add(out, s)
    return out


def verify_aggregate(pks, msgs, agg_sig) -> bool:
    """e(g1, agg) == prod e(pk_i, H(m_i)) — the threshold-BDLS check."""
    lhs = pairing(agg_sig, G1)
    rhs = FQ12.one()
    for pk, msg in zip(pks, msgs):
        rhs = rhs * pairing(hash_to_g2(msg), pk)
    return lhs == rhs
