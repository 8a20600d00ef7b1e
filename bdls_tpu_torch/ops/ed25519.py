"""Batched Ed25519 (RFC 8032) verification: host oracle, plain twin, K8.

The counterpart of ``bdls_tpu/ops/ed25519.py``, in three parts:

- **The host half**, copied from the reference: the RFC 8032 oracle
  (``pt_add``, ``pt_mul``, ``on_curve``, ``compress``, ``decompress``,
  ``challenge``, ``secret_expand``, ``public_key``, ``public_point``,
  ``sign``, ``verify_host``, ``verify_affine``) and the ingress that
  turns a lane into the kernel's six scalars (``ed25519_lane``,
  ``decode_lane``, ``lanes_to_limbs``), with ``hashlib.sha512`` only.
  ``pt_mul`` computes the reference's function in extended coordinates
  with one inversion at the end (the reference inverts at every
  addition), so signing and the oracle take milliseconds, not a third
  of a second.
- **The plain twin** :func:`verify_ed25519` over the port's plain field
  (:mod:`bdls_tpu_torch.ops.fold`, modulus 2^255 - 19), with the
  contract of ``ed25519.py:verify_ed25519``: six ``(16, B)`` 16-bit-limb
  arrays ``(ax, ay, rx, ry, s, k)`` in, a ``(B,)`` bool verdict out.
- **The kernel** (K8, ``csrc/ed25519.cu``: a thread group a lane over
  ``csrc/edwards_group.cuh``; the mxu build the same body with each
  round's products in one K5 call of the warp) and its launch wrappers.
  Where the limb tensors lie decides what runs: on a CUDA device the
  hand-written kernel, on the current stream and not synchronised (a
  build or launch error raises; there is no fallback); on the CPU the
  plain twin. ``LAUNCHES_ED25519`` counts launches of the kernel.

Verification equation (RFC 8032 §5.1.7, the cofactorless variant):

    [S]B + [k](-A) == R,   k = SHA-512(enc(R) || enc(A) || M) mod L

compared projectively (X == x_R·Z and Y == y_R·Z). All mod-L work stays
on the host: k arrives reduced and S is only range-checked (S < L). The
ladder: ``[k](-A)`` takes 66 signed 4-bit digits from a per-lane
[0..8]·(-A) table in 33 steps of 2 × (4 doublings + one add); ``[S]B``
takes S's 32 bytes from 32 positioned tables tab[j][d] = (d·2^{8j})·B
(affine, t = xy, Z = 1) into a second accumulator that is never doubled.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from bdls_tpu_torch.ops import _build, ecdsa, fold
from bdls_tpu_torch.ops.curves import ED25519, EdwardsCurve
from bdls_tpu_torch.ops.fields import ints_to_limb_array
from bdls_tpu_torch.ops.fold import FE, fe_const, fe_zero, fold_ctx, \
    from_limbs16, is_zero_mod, norm
from bdls_tpu_torch.ops.proj import TorchField
from bdls_tpu_torch.ops.verify_fold import _bytes, _ints_to_u32, _limbs16, \
    _lookup, _signed_digits, _u32_to_ints
from bdls_tpu_torch.utils.device import DeviceLike, resolve_device

P = ED25519.fp.modulus
L = ED25519.order
D = ED25519.d
GX, GY = ED25519.gx, ED25519.gy

LAUNCHES_ED25519 = {"ed25519": 0}
# K8 from its mxu build (K5's product), counted apart
LAUNCHES_ED25519_MXU = {"ed25519": 0}
# the limb engine per kernel field, as the reference's ENGINES
# (bdls_tpu/ops/ed25519.py:82): mont16 has no Edwards program of its own
ENGINES = {"fold": "vpu", "mxu": "mxu", "mont16": "vpu"}
_COUNTS = {"vpu": LAUNCHES_ED25519, "mxu": LAUNCHES_ED25519_MXU}


# ----------------------------------------------------------- host oracle

def _inv(x: int) -> int:
    return pow(x, P - 2, P)


def pt_add(Pt, Qt):
    """Affine twisted-Edwards addition (complete; identity = (0, 1))."""
    x1, y1 = Pt
    x2, y2 = Qt
    dxy = D * x1 % P * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + x2 * y1) * _inv((1 + dxy) % P) % P
    y3 = (y1 * y2 + x1 * x2) * _inv((1 - dxy) % P) % P
    return x3, y3


def _ext_add(p1, p2):
    """Extended (X, Y, Z, T) addition, a = -1 (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D * t1 * t2 % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def _ext_mul(k: int, pt):
    """[k]·(x, y) in extended coordinates, double-and-add, MSB first."""
    x, y = pt
    base = (x, y, 1, x * y % P)
    acc = (0, 1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _ext_add(acc, acc)
        if bit == "1":
            acc = _ext_add(acc, base)
    return acc


def _affine(ext):
    zi = _inv(ext[2])
    return ext[0] * zi % P, ext[1] * zi % P


def pt_mul(k: int, Pt):
    """[k]·Pt (k reduced mod L first when k >= L, as the reference)."""
    return _affine(_ext_mul(k % L if k >= L else k, Pt))


def on_curve(x: int, y: int) -> bool:
    return (y * y - x * x - 1 - D * x % P * x % P * y % P * y) % P == 0


def compress(x: int, y: int) -> bytes:
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decompress(enc: bytes):
    """RFC 8032 §5.1.3 point decoding -> (x, y) or None."""
    if len(enc) != 32:
        return None
    v = int.from_bytes(enc, "little")
    sign, y = v >> 255, v & ((1 << 255) - 1)
    if y >= P:
        return None
    u = (y * y - 1) % P
    w = (D * y * y + 1) % P            # never 0: d is a non-square
    x2 = u * _inv(w) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x, y


def _sha512_mod_l(*chunks: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(chunks)).digest(),
                          "little") % L


def challenge(r_enc: bytes, a_enc: bytes, msg: bytes) -> int:
    """k = SHA-512(enc(R) || enc(A) || M) mod L."""
    return _sha512_mod_l(r_enc, a_enc, msg)


def secret_expand(seed: bytes):
    """RFC 8032 §5.1.5: seed -> (clamped scalar a, prefix)."""
    if len(seed) != 32:
        raise ValueError("Ed25519 seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(seed: bytes) -> bytes:
    a, _ = secret_expand(seed)
    return compress(*pt_mul(a, (GX, GY)))


def public_point(seed: bytes):
    a, _ = secret_expand(seed)
    return pt_mul(a, (GX, GY))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6 -> 64-byte signature enc(R) || enc(S)."""
    a, prefix = secret_expand(seed)
    a_enc = compress(*pt_mul(a, (GX, GY)))
    r = _sha512_mod_l(prefix, msg)
    r_enc = compress(*pt_mul(r, (GX, GY)))
    s = (r + challenge(r_enc, a_enc, msg) * a) % L
    return r_enc + s.to_bytes(32, "little")


def verify_host(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """RFC 8032 §5.1.7 (cofactorless): the oracle the kernel and its
    plain twin are held against."""
    if len(sig) != 64:
        return False
    A = decompress(pub)
    R = decompress(sig[:32])
    s = int.from_bytes(sig[32:], "little")
    if A is None or R is None or s >= L:
        return False
    k = challenge(sig[:32], pub, msg)
    return pt_add(R, pt_mul(k, A)) == pt_mul(s, (GX, GY))


def verify_affine(x: int, y: int, r_enc: bytes, s: int, msg: bytes) -> bool:
    """Host verify over the wire form the rest of the stack carries:
    affine pubkey (x, y) + RFC-encoded R + scalar S (the ``sw``
    provider's Ed25519 verify; same decode rules as the kernel)."""
    if not (0 <= x < P and 0 <= y < P) or not on_curve(x, y):
        return False
    R = decompress(r_enc)
    if R is None or not 0 <= s < L:
        return False
    k = challenge(r_enc, compress(x, y), msg)
    return pt_add(R, pt_mul(k, (x, y))) == pt_mul(s, (GX, GY))


def ed25519_lane(x: int, y: int, r_enc: bytes, s: int, msg: bytes):
    """Wire-form lane (affine pub, RFC R encoding, scalar S, message)
    -> the six kernel scalars. The pubkey passes through as is (the
    kernel's own on-curve check rejects an off-curve (x, y)); only R
    must decompress on the host."""
    if not (0 <= x < P and 0 <= y < P and 0 <= s < (1 << 256)):
        return (0, 0, 0, 0, 0, 0)
    R = decompress(r_enc)
    if R is None:
        return (0, 0, 0, 0, 0, 0)
    return (x, y, R[0], R[1], s, challenge(r_enc, compress(x, y), msg))


def decode_lane(a_enc: bytes, r_enc: bytes, s: int, msg: bytes):
    """Wire ingress: one (pub, R, S, M) lane -> the six kernel scalars
    (ax, ay, rx, ry, s, k). Undecodable points map to all-zero coords,
    which fail the in-kernel on-curve check — no separate mask."""
    A = decompress(a_enc)
    R = decompress(r_enc)
    if A is None or R is None or not 0 <= s < (1 << 256):
        return (0, 0, 0, 0, 0, 0)
    return (A[0], A[1], R[0], R[1], s, challenge(r_enc, a_enc, msg))


def lanes_to_limbs(rows) -> list[np.ndarray]:
    """Batch of decode_lane tuples -> the six (16, B) limb arrays."""
    cols = list(zip(*rows)) if rows else [[]] * 6
    return [ints_to_limb_array(list(c)) for c in cols]


# ------------------------------------------------------ the B byte tables

@functools.lru_cache(maxsize=None)
def b_tables_positioned() -> np.ndarray:
    """The 32 positioned byte tables of the base point, tab[j][d] =
    (d·2^{8j})·B, as ``(32, 256, 3, 8)`` uint32 canonical limbs of
    (x, y, t = xy) with implicit Z = 1; entry 0 is the identity
    (0, 1, 0). The same integers as the reference's
    ``_b_tables_positioned`` (``ed25519.py:278``)."""
    ext, base = [], (GX, GY)
    for _ in range(32):
        b = (base[0], base[1], 1, base[0] * base[1] % P)
        acc = (0, 1, 1, 0)
        for _d in range(256):
            ext.append(acc)
            acc = _ext_add(acc, b)
        for _ in range(8):
            base = pt_add(base, base)
    # one inversion for all 8192 Z (Montgomery's trick)
    pre, run = [], 1
    for e in ext:
        pre.append(run)
        run = run * e[2] % P
    inv = _inv(run)
    xs, ys, ts = [0] * len(ext), [0] * len(ext), [0] * len(ext)
    for i in range(len(ext) - 1, -1, -1):
        zi = inv * pre[i] % P
        inv = inv * ext[i][2] % P
        x, y = ext[i][0] * zi % P, ext[i][1] * zi % P
        xs[i], ys[i], ts[i] = x, y, x * y % P
    tab = np.stack([_ints_to_u32(c) for c in (xs, ys, ts)], axis=1)
    tab = tab.reshape(32, 256, 3, 8)
    tab.setflags(write=False)
    return tab


@functools.lru_cache(maxsize=None)
def b_tables_cached() -> np.ndarray:
    """:func:`b_tables_positioned` in the form K8 adds it, ``(32, 256,
    3, 8)`` uint32 canonical limbs of (y - x, y + x, 2d·t) mod p (t =
    xy); entry 0, the identity, is (1, 1, 0)."""
    x, y, t = (_u32_to_ints(np.ascontiguousarray(b_tables_positioned()[
        :, :, c])) for c in range(3))
    cols = ([(b - a) % P for a, b in zip(x, y)],
            [(a + b) % P for a, b in zip(x, y)],
            [2 * D * v % P for v in t])
    tab = np.stack([_ints_to_u32(c) for c in cols], axis=1)
    tab = tab.reshape(32, 256, 3, 8)
    tab.setflags(write=False)
    return tab


@functools.lru_cache(maxsize=None)
def device_b_table(device: torch.device) -> torch.Tensor:
    """:func:`b_tables_cached` as ``(32, 256, 3, 8)`` int32 bit patterns
    on ``device``: what K8 reads, in plain form (both engines' builds)."""
    return torch.from_numpy(
        b_tables_cached().view(np.int32).copy()).to(device)


@functools.lru_cache(maxsize=None)
def _b_limbs16(device: torch.device) -> torch.Tensor:
    """The B tables as (32, 256, 3, 16) int64 16-bit limbs (plain twin)."""
    return torch.as_tensor(_limbs16(b_tables_positioned()), device=device)


# ------------------------------------------------------------ plain twin

class Ext:
    """Extended twisted-Edwards coordinates (X : Y : Z : T), T = XY/Z."""

    __slots__ = ("x", "y", "z", "t")

    def __init__(self, x, y, z, t):
        self.x, self.y, self.z, self.t = x, y, z, t

    def coords(self):
        return self.x, self.y, self.z, self.t


def ed_add(f, k2d: FE, Pt: Ext, Qt: Ext) -> Ext:
    """Unified extended addition, a = -1 (add-2008-hwcd-3): complete for
    all inputs here since -1 is a square mod p and d is not."""
    A = f.mul(f.sub(Pt.y, Pt.x), f.sub(Qt.y, Qt.x))
    B = f.mul(f.add(Pt.y, Pt.x), f.add(Qt.y, Qt.x))
    C = f.mul(f.mul(Pt.t, k2d), Qt.t)
    Dv = f.mul_small(f.mul(Pt.z, Qt.z), 2)
    E = f.sub(B, A)
    Fv = f.sub(Dv, C)
    G = f.add(Dv, C)
    H = f.add(B, A)
    return Ext(f.mul(E, Fv), f.mul(G, H), f.mul(Fv, G), f.mul(E, H))


def ed_dbl(f, Pt: Ext) -> Ext:
    """Extended doubling, a = -1 (dbl-2008-hwcd). F and H are negated
    relative to the EFD listing: all four outputs flip sign, which is
    the same projective point with a consistent T."""
    A = f.sqr(Pt.x)
    B = f.sqr(Pt.y)
    C = f.mul_small(f.sqr(Pt.z), 2)
    E = f.sub(f.sqr(f.add(Pt.x, Pt.y)), f.add(A, B))     # 2XY
    G = f.sub(B, A)
    Fn = f.sub(C, G)
    Hn = f.add(A, B)
    return Ext(f.mul(E, Fn), f.mul(G, Hn), f.mul(Fn, G), f.mul(E, Hn))


def _normed(fpc, pt: Ext) -> Ext:
    return Ext(*(norm(fpc, c) for c in pt.coords()))


def _build_lane_table(fpc, f, k2d, nax: FE, ay: FE, nat: FE, one, zero):
    """[0..8]·(-A) per lane (entry 0 = the identity), stacked ``(9, 18,
    B)`` per coordinate, and the limb bound of the stack."""
    e1 = _normed(fpc, Ext(nax, ay, one, nat))
    entries = [Ext(zero, one, one, zero), e1]
    acc = ed_dbl(f, e1)
    entries.append(_normed(fpc, acc))
    for _ in range(6):
        entries.append(_normed(fpc, ed_add(f, k2d, entries[-1], e1)))
    lb = max(c.lb for e in entries for c in e.coords())
    tabs = [torch.stack([fold._pad_to(getattr(e, c).v, fold.L_NORM)
                         for e in entries]) for c in ("x", "y", "z", "t")]
    return tabs, lb


def ed_dual_ladder(fpc, kc, sc, nax: FE, ay: FE, nat: FE) -> Ext:
    """[k](-A) + [S]B over canonical (16, B) scalars kc, sc.

    accq rides the doubling chain for the per-lane (-A) table (66
    signed 4-bit digits, MSB first, two a step); accb collects the
    position-absolute adds of S's 32 bytes and is never doubled."""
    like = ay.v
    f = TorchField(fpc, like)
    one = norm(fpc, fe_const(fpc, 1, like))
    zero = fe_zero(like)
    k2d = fe_const(fpc, 2 * D % P, like)
    tabs, lbq = _build_lane_table(fpc, f, k2d, nax, ay, nat, one, zero)

    mag, neg = _signed_digits(kc)                   # (66, B) LSB first
    sb = _bytes(sc)                                 # (33, B) LSB first
    btab = _b_limbs16(like.device)

    def a_addend(i):
        x, y, z, t = (FE(_lookup(tb, mag[i]), lbq) for tb in tabs)
        # -(x, y, z, t) = (-x, y, z, -t)
        x_neg = fold.sub(fpc, zero, x)
        t_neg = fold.sub(fpc, zero, t)
        return Ext(fold.select(neg[i], x_neg, x), y, z,
                   fold.select(neg[i], t_neg, t))

    def b_addend(j):
        g = btab[j][sb[j]]                          # (B, 3, 16)
        x, y, t = (FE(g[:, c].T, 1 << 16) for c in range(3))
        return Ext(x, y, one, t)

    accq = Ext(zero, one, one, zero)
    accb = Ext(zero, one, one, zero)
    for k in range(33):
        for h in range(2):
            for _ in range(4):
                accq = ed_dbl(f, accq)
            accq = ed_add(f, k2d, accq, a_addend(65 - 2 * k - h))
        accq = _normed(fpc, accq)
        if k < 32:
            accb = _normed(fpc, ed_add(f, k2d, accb, b_addend(k)))
    return _normed(fpc, ed_add(f, k2d, accq, accb))


def _on_curve_fe(fpc, x: FE, y: FE, like) -> torch.Tensor:
    """-x^2 + y^2 == 1 + d x^2 y^2 as a per-lane predicate."""
    x2 = fold.sqr(fpc, x)
    y2 = fold.sqr(fpc, y)
    lhs = fold.sub(fpc, y2, x2)
    rhs = fold.add(norm(fpc, fe_const(fpc, 1, like)),
                   fold.mul(fpc, fe_const(fpc, D, like),
                            fold.mul(fpc, x2, y2)))
    return is_zero_mod(fpc, fold.sub(fpc, lhs, rhs))


def verify_ed25519(curve: EdwardsCurve, ax16, ay16, rx16, ry16, s16,
                   k16) -> torch.Tensor:
    """All inputs (16, B) 16-bit-limb tensors; returns (B,) bool.

    ax/ay, rx/ry: the decompressed affine A and R (host ingress); s the
    raw scalar S; k the host-reduced challenge. The checks: S < L; both
    points' coordinates < p, both on the curve (undecodable lanes arrive
    as zero coordinates and fail it); [S]B + [k](-A) == R, projectively."""
    fpc = fold_ctx(curve.fp.modulus)
    p = curve.fp.modulus
    ax16, ay16, rx16, ry16, s16, k16 = (
        t.to(torch.int64) & 0xFFFF
        for t in (ax16, ay16, rx16, ry16, s16, k16))

    s_ok = fold.lt_const(s16, curve.order)
    a_rng = fold.lt_const(ax16, p) & fold.lt_const(ay16, p)
    r_rng = fold.lt_const(rx16, p) & fold.lt_const(ry16, p)

    ax, ay, rx, ry = (from_limbs16(a) for a in (ax16, ay16, rx16, ry16))
    like = ay.v
    a_curve = _on_curve_fe(fpc, ax, ay, like)
    r_curve = _on_curve_fe(fpc, rx, ry, like)

    # -A = (-ax, ay), t = (-ax)·ay
    nax = fold.sub(fpc, fe_zero(like), ax)
    nat = fold.mul(fpc, nax, ay)
    u = ed_dual_ladder(fpc, k16, s16, nax, ay, nat)

    ok_x = is_zero_mod(fpc, fold.sub(fpc, u.x, fold.mul(fpc, rx, u.z)))
    ok_y = is_zero_mod(fpc, fold.sub(fpc, u.y, fold.mul(fpc, ry, u.z)))
    return s_ok & a_rng & r_rng & a_curve & r_curve & ok_x & ok_y


# ------------------------------------------------------------- launches

def verify_ed25519_cuda(ax, ay, rx, ry, s, k, *,
                        engine: str = "vpu") -> torch.Tensor:
    """Launch K8 over six contiguous ``(16, B)`` int32 CUDA tensors on
    one device, from the ``engine``'s build ("mxu": K8 with K5's
    product); returns the ``(B,)`` bool verdict (not yet
    synchronised)."""
    arrs = (ax, ay, rx, ry, s, k)
    dev = ax.device
    B = ax.shape[1]
    for a in arrs:
        if (a.device != dev or a.dtype != torch.int32 or a.dim() != 2
                or a.shape != (16, B) or not a.is_contiguous()):
            raise ValueError("verify_ed25519_cuda takes six contiguous "
                             "(16, B) int32 tensors on one CUDA device")
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    btab = device_b_table(dev)
    lib = _build.lib(engine)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_verify_ed25519(*(a.data_ptr() for a in arrs),
                                     btab.data_ptr(), out.data_ptr(), B,
                                     ecdsa.block_threads(engine), stream)
    _build.check(rc, f"bdls_verify_ed25519[{engine}](B={B})")
    with _build.count_lock:
        _COUNTS[engine]["ed25519"] += 1
    return out.view(torch.bool)


def launch_verify(arrs, *, device: DeviceLike = None,
                  field: str = "fold") -> torch.Tensor:
    """Start one verify over the six pre-marshaled ``(16, B)`` limb
    arrays ``(ax, ay, rx, ry, s, k)`` (numpy ``uint32`` or tensors) on
    ``device`` (default ``cuda``), on the engine :data:`ENGINES` gives
    ``field``. Returns the ``(B,)`` bool tensor; on the card it is not
    yet synchronised."""
    dev = resolve_device(device)
    engine = ecdsa.engine_for(field, ENGINES)
    ts = [_build.as_int32(a, dev) for a in arrs]
    if dev.type == "cuda":
        return verify_ed25519_cuda(*ts, engine=engine)
    with fold.mul_backend(engine):
        return verify_ed25519(ED25519, *ts)


def verify_limbs(arrs, *, device: DeviceLike = None,
                 field: str = "fold") -> np.ndarray:
    """Synchronous verify over pre-marshaled limb arrays."""
    return launch_verify(arrs, device=device, field=field).cpu().numpy()


def verify_batch(pubs, sigs, msgs, *, device: DeviceLike = None,
                 field: str = "fold") -> np.ndarray:
    """Host-facing batch verify: 32-byte pubs, 64-byte sigs, messages.
    Decodes and hashes on the host, verifies on ``device`` (default
    ``cuda``). Returns (B,) bool."""
    rows = [decode_lane(p_, s_[:32], int.from_bytes(s_[32:], "little"), m)
            for p_, s_, m in zip(pubs, sigs, msgs)]
    return verify_limbs(lanes_to_limbs(rows), device=device, field=field)
