"""Batched Edwards-curve / ristretto255 point arithmetic on the device.

Points are extended homogeneous coordinates stored as (..., 4, 23) int32
limb arrays (X, Y, Z, T rows; see :mod:`.field` for the limb format).  The
unified add-2008-hwcd-3 formulas (a = -1) are branch-free and handle
identity/doubling uniformly, which is exactly what a SIMD machine wants:
every lane does the same 8 multiplies regardless of its operands.

This module powers the hot paths of the proof engine (SURVEY.md S7 stage 3):
vector commitments, the inner-product argument's generator folds, and the
verifier's single mega-MSM, plus batched Elligator for deriving the 819200
`BulletproofGens` on device.  The host oracle is
:mod:`bulletproofs_r1cs_gadgets_tpu.core.ristretto`.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..utils.constants import (
    P,
    D,
    SQRT_M1,
    ONE_MINUS_D_SQ,
    D_MINUS_ONE_SQ,
    SQRT_AD_MINUS_ONE,
)
from .field import FP, STORE, int_to_limbs, limbs_to_int
from ..core.ristretto import RistrettoPoint

D2_INT = (2 * D) % P

# device constants (broadcast as needed)
_D2 = jnp.asarray(int_to_limbs(D2_INT))
_D = jnp.asarray(int_to_limbs(D))
_SQRT_M1 = jnp.asarray(int_to_limbs(SQRT_M1))
_ONE_MINUS_D_SQ = jnp.asarray(int_to_limbs(ONE_MINUS_D_SQ))
_D_MINUS_ONE_SQ = jnp.asarray(int_to_limbs(D_MINUS_ONE_SQ))
_SQRT_AD_MINUS_ONE = jnp.asarray(int_to_limbs(SQRT_AD_MINUS_ONE))


# ------------------------------------------------------------- host codecs
def _ints_to_limbs_vec(vals: list[int]) -> np.ndarray:
    """Vectorised int -> 23x12-bit limb conversion: bytes -> uint16 words ->
    per-limb shifts (pure numpy; the per-element Python loop was the single
    largest host cost in proving before this)."""
    buf = b"".join(v.to_bytes(36, "little") for v in vals)  # 276 bits + slack
    words = np.frombuffer(buf, np.uint8).reshape(len(vals), 36)
    w = words.astype(np.int32)
    out = np.empty((len(vals), STORE), dtype=np.int32)
    for i in range(STORE):
        bit = 12 * i
        byte, r = bit // 8, bit % 8
        val = (
            w[:, byte]
            | (w[:, byte + 1] << 8)
            | (w[:, byte + 2] << 16)
        )
        out[:, i] = (val >> r) & 0xFFF
    return out


def points_to_device(points: list[RistrettoPoint]) -> jnp.ndarray:
    coords = []
    for pt in points:
        coords.extend((pt.X, pt.Y, pt.Z, pt.T))
    limbs = _ints_to_limbs_vec(coords)
    return jnp.asarray(limbs.reshape(len(points), 4, STORE))


def points_from_device(arr) -> list[RistrettoPoint]:
    a = np.asarray(arr)
    flat = a.reshape(-1, 4, a.shape[-1])
    return [
        RistrettoPoint(
            limbs_to_int(row[0]) % P,
            limbs_to_int(row[1]) % P,
            limbs_to_int(row[2]) % P,
            limbs_to_int(row[3]) % P,
        )
        for row in flat
    ]


def identity_points(shape) -> jnp.ndarray:
    """(..., 4, STORE) array of identity points (0, 1, 1, 0)."""
    out = np.zeros((4, STORE), dtype=np.int32)
    out[1, 0] = 1
    out[2, 0] = 1
    base = jnp.asarray(out)
    return jnp.broadcast_to(base, tuple(shape) + (4, STORE)).copy() if shape else base


# --------------------------------------------------------------- group law
def point_add(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Unified extended-coordinate addition (add-2008-hwcd-3, a = -1)."""
    X1, Y1, Z1, T1 = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    X2, Y2, Z2, T2 = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    A = FP.mul(Y1 - X1, Y2 - X2)
    B = FP.mul(Y1 + X1, Y2 + X2)
    C = FP.mul(FP.mul(T1, T2), jnp.broadcast_to(_D2, T1.shape))
    Dv = FP.scale_small(FP.mul(Z1, Z2), 2)
    E = B - A
    F = Dv - C
    G = Dv + C
    H = B + A
    return jnp.stack(
        [FP.mul(E, F), FP.mul(G, H), FP.mul(F, G), FP.mul(E, H)], axis=-2
    )


def point_double(p: jnp.ndarray) -> jnp.ndarray:
    """dbl-2008-hwcd (a = -1): 4M + 4S."""
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    A = FP.square(X1)
    B = FP.square(Y1)
    C = FP.scale_small(FP.square(Z1), 2)
    H = FP.add(A, B)
    E = H - FP.square(X1 + Y1)
    G = A - B
    F = C + G
    return jnp.stack(
        [FP.mul(E, F), FP.mul(G, H), FP.mul(F, G), FP.mul(E, H)], axis=-2
    )


def point_neg(p: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack(
        [-p[..., 0, :], p[..., 1, :], p[..., 2, :], -p[..., 3, :]], axis=-2
    )


def point_select(cond, p, q):
    """cond ? p : q, cond shaped (...)."""
    c = cond
    while c.ndim < p.ndim:
        c = c[..., None]
    return jnp.where(c, p, q)


# ---------------------------------------------------- scalar multiplication
def scalar_mul_bits(points: jnp.ndarray, bits: jnp.ndarray) -> jnp.ndarray:
    """Per-point scalar multiplication.

    points: (N, 4, STORE); bits: (N, 253) int32, LSB-first.
    Double-and-add over a lax.scan (MSB -> LSB), fully vectorised across N.
    """
    nbits = bits.shape[-1]
    ident = identity_points(points.shape[:-2])

    def body(acc, i):
        bit = bits[..., nbits - 1 - i]
        acc = point_double(acc)
        addend = point_select(bit > 0, points, jnp.broadcast_to(
            identity_points(()), points.shape))
        acc = point_add(acc, addend)
        return acc, None

    acc, _ = lax.scan(body, ident, jnp.arange(nbits))
    return acc


def scalar_mul_shared(points: jnp.ndarray, scalar_int: int) -> jnp.ndarray:
    """Multiply every point by the SAME (host-known) scalar.  The bit
    pattern is static, so only the 1-bits cost an add (used by the IPP
    generator folds where u is a per-round transcript challenge)."""
    k = scalar_int
    if k == 0:
        return jnp.broadcast_to(
            identity_points(()), points.shape
        )
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = point_double(acc)
        if bit == "1":
            acc = points if acc is None else point_add(acc, points)
    return acc


def tree_reduce(points: jnp.ndarray) -> jnp.ndarray:
    """Sum N points (N, 4, STORE) -> (4, STORE) via log2(N) halving rounds."""
    n = points.shape[0]
    # pad to power of two with identities
    pow2 = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if pow2 != n:
        pad = jnp.broadcast_to(identity_points(()), (pow2 - n, 4, STORE))
        points = jnp.concatenate([points, pad], axis=0)
    while points.shape[0] > 1:
        half = points.shape[0] // 2
        points = point_add(points[:half], points[half:])
    return points[0]


# ------------------------------------------------------------ sqrt / hash
_P58_EXP = (P - 5) // 8


def sqrt_ratio(u: jnp.ndarray, v: jnp.ndarray):
    """Batched SQRT_RATIO_M1: returns (was_square (...,) bool, root).

    Exactness: comparisons are done on canonical residues obtained via a
    final mul-by-one reduction and host-free canonical check using the
    difference-is-zero test through one more reduction round; see
    _canonical_eq below.
    """
    v3 = FP.mul(FP.square(v), v)
    v7 = FP.mul(FP.square(v3), v)
    r = FP.mul(FP.mul(u, v3), FP.pow_const(FP.mul(u, v7), _P58_EXP))
    check = FP.mul(v, FP.square(r))
    u_neg = FP.neg(u)
    correct = _eq_mod(check, u)
    flipped = _eq_mod(check, u_neg)
    flipped_i = _eq_mod(check, FP.mul(u_neg, jnp.broadcast_to(_SQRT_M1, u.shape)))
    r = jnp.where(
        (flipped | flipped_i)[..., None],
        FP.mul(r, jnp.broadcast_to(_SQRT_M1, r.shape)),
        r,
    )
    r = _abs_fe(r)
    return correct | flipped, r


def _eq_mod(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a == b mod P (batched, exact)."""
    return FP.eq(a, b)


def _is_negative_fe(a: jnp.ndarray) -> jnp.ndarray:
    """dalek IS_NEGATIVE: LSB of the canonical encoding."""
    can = FP.canonicalize(a)
    return (can[..., 0] & 1) == 1


def _abs_fe(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(_is_negative_fe(a)[..., None], FP.neg(a), a)


def elligator_map(t: jnp.ndarray) -> jnp.ndarray:
    """Batched RFC 9496 MAP: (..., STORE) field elems -> (..., 4, STORE)."""
    shape = t.shape
    one = jnp.broadcast_to(FP.constant(1), shape)
    sqrt_m1 = jnp.broadcast_to(_SQRT_M1, shape)
    d_c = jnp.broadcast_to(_D, shape)
    r = FP.mul(sqrt_m1, FP.square(t))
    u = FP.mul(FP.add(r, one), jnp.broadcast_to(_ONE_MINUS_D_SQ, shape))
    v = FP.mul(FP.neg(one) - FP.mul(r, d_c), FP.add(r, d_c))
    was_square, s = sqrt_ratio(u, v)
    s_prime = FP.neg(_abs_fe(FP.mul(s, t)))
    s = jnp.where(was_square[..., None], s, s_prime)
    c = jnp.where(was_square[..., None], FP.neg(one), r)
    n = FP.mul(FP.mul(c, FP.sub(r, one)), jnp.broadcast_to(_D_MINUS_ONE_SQ, shape)) - v
    ss = FP.square(s)
    w0 = FP.scale_small(FP.mul(s, v), 2)
    w1 = FP.mul(n, jnp.broadcast_to(_SQRT_AD_MINUS_ONE, shape))
    w2 = FP.sub(one, ss)
    w3 = FP.add(one, ss)
    return jnp.stack(
        [FP.mul(w0, w3), FP.mul(w2, w1), FP.mul(w1, w3), FP.mul(w0, w2)],
        axis=-2,
    )


def from_uniform_bytes_batch(seeds: list[bytes]) -> list[RistrettoPoint]:
    """Batched dalek ``RistrettoPoint::from_uniform_bytes`` for generator
    derivation (SHAKE-256 chains, ``core/pedersen.py``)."""
    n = len(seeds)
    r1 = [int.from_bytes(s[:32], "little") & ((1 << 255) - 1) for s in seeds]
    r2 = [int.from_bytes(s[32:], "little") & ((1 << 255) - 1) for s in seeds]
    t = FP.to_device(r1 + r2)
    mapped = jax.jit(elligator_map)(t)
    summed = jax.jit(point_add)(mapped[:n], mapped[n:])
    return points_from_device(summed)
