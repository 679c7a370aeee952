"""Batched big-integer field arithmetic on the device (jax.numpy, compiled
by XLA).

Design (SURVEY.md S7 "hard parts (a)": bigint modular mul on 32-bit integer
lanes without 64-bit multiplies):

* A field element is a vector of ``STORE = 23`` signed int32 limbs in radix
  2^12, *balanced*: after normalisation every |limb| <= 2^11 (+1), so
  subtraction needs no borrow chains and the whole representation is
  symmetric under negation.  23 limbs (276 bits of span) over the 253-bit
  primes leave enough headroom that normalisation never overflows the top
  limb - values stay *lazily reduced* (congruent mod the prime, magnitude
  < 2^253-ish); canonicalisation to [0, m) happens host-side at codec
  boundaries only.
* Multiplication is a schoolbook limb convolution: |products| <= 2^22 and
  anti-diagonal sums < 23 * 2^22 < 2^27 are exact in int32: 12-bit limbs
  keep every intermediate in an int32 lane with no 64-bit multiply.
* Reduction folds the product at a *limb-aligned* power of the radix:
  - mod L = 2^252 + c (scalar field): 2^252 is limb 21, and
    2^252 == -c (mod L) with c ~ 2^124.4 an 11-limb constant.
  - mod P = 2^255 - 19 (curve field): 2^264 is limb 22, and
    2^264 == 19 * 2^9 = 9728 (mod P), a single-limb constant.
  Folds repeat until the value provably fits the store; interleaved balanced
  carry rounds ((x + 2^11) >> 12 arithmetic shift) keep coefficients small.
* Why not Montgomery: its per-digit dependency chain serialises each lane;
  fold reduction is two short convolutions, fully parallel across the batch
  and across limbs.

All public functions operate on (..., 23) int32 arrays and are
jit/vmap/shard_map-compatible (static shapes, no data-dependent control
flow).  Exponentiation uses ``lax.scan`` over a static bit array so the
compiled graph stays one-round-sized.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..utils.constants import P, L

LIMB_BITS = 12
RADIX = 1 << LIMB_BITS
HALF = RADIX >> 1
STORE = 23  # stored limbs per element (276-bit span)


# --------------------------------------------------------------- host codecs
def int_to_limbs(x: int, n: int = STORE) -> np.ndarray:
    """Non-negative int -> unbalanced 12-bit limbs (a valid lazy form)."""
    assert 0 <= x < (1 << (LIMB_BITS * n)), "value exceeds limb capacity"
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & (RADIX - 1)
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs) -> int:
    """Signed limb vector -> Python int (may be negative / unreduced)."""
    arr = np.asarray(limbs)
    return sum(int(arr[..., i]) << (LIMB_BITS * i) for i in range(arr.shape[-1]))


def ints_to_limbs(xs, n: int = STORE) -> np.ndarray:
    out = np.zeros((len(xs), n), dtype=np.int32)
    for j, x in enumerate(xs):
        out[j] = int_to_limbs(x, n)
    return out


# ----------------------------------------------------------- device helpers
def _carry(x: jnp.ndarray, extend: bool = True) -> jnp.ndarray:
    """One balanced carry round; optionally extends length by 1 limb so the
    outgoing carry is never dropped."""
    carry = (x + HALF) >> LIMB_BITS
    rem = x - (carry << LIMB_BITS)
    lead = [(0, 0)] * (x.ndim - 1)
    if extend:
        return jnp.pad(rem, lead + [(0, 1)]) + jnp.pad(carry, lead + [(1, 0)])
    return rem + jnp.pad(carry[..., :-1], lead + [(1, 0)])


def _conv(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Limb convolution (..., n) x (..., m) -> (..., n+m-1), int32-exact for
    balanced inputs.

    The (n, m) product matrix is skewed so that row i starts at column i
    (pad each row by n zeros, flatten, drop the last n, reshape to width
    n+m-1); a column sum then gives the anti-diagonal sums.  A handful of
    ops per multiply keeps traced graphs, and so compile times, small."""
    n = a.shape[-1]
    m = b.shape[-1]
    if m == 1:
        return a * b
    terms = a[..., :, None] * b[..., None, :]  # (..., n, m)
    lead = terms.shape[:-2]
    skew = jnp.pad(terms, [(0, 0)] * (terms.ndim - 1) + [(0, n)])
    skew = skew.reshape(lead + (n * (m + n),))[..., : n * (m + n - 1)]
    return skew.reshape(lead + (n, m + n - 1)).sum(axis=-2)


class LimbField:
    """Vectorised arithmetic mod ``modulus`` on (..., STORE) int32 arrays."""

    def __init__(self, modulus: int, fold_limb: int, fold_value: int):
        """``radix^fold_limb == fold_value (mod modulus)`` with |fold_value|
        small enough that its limb count keeps conv sums in int32."""
        self.modulus = modulus
        self.fold_limb = fold_limb
        assert (1 << (LIMB_BITS * fold_limb)) % modulus == fold_value % modulus
        sign = -1 if fold_value < 0 else 1
        mags = int_to_limbs(abs(fold_value), STORE)
        nz = int(np.max(np.nonzero(mags)[0])) + 1 if np.any(mags) else 1
        self._fold_const = jnp.asarray(sign * mags[:nz], dtype=jnp.int32)

    # -- codecs ------------------------------------------------------------
    def to_device(self, xs) -> jnp.ndarray:
        return jnp.asarray(ints_to_limbs([x % self.modulus for x in xs]))

    def to_ints(self, limbs) -> list[int]:
        arr = np.asarray(limbs)
        flat = arr.reshape(-1, arr.shape[-1])
        return [limbs_to_int(row) % self.modulus for row in flat]

    def constant(self, x: int) -> jnp.ndarray:
        return jnp.asarray(int_to_limbs(x % self.modulus))

    def zeros(self, shape) -> jnp.ndarray:
        return jnp.zeros(tuple(shape) + (STORE,), dtype=jnp.int32)

    # -- reduction ---------------------------------------------------------
    def _fold_once(self, x: jnp.ndarray) -> jnp.ndarray:
        """lo + fold_const * hi at the fold boundary; shrinks long arrays."""
        fl = self.fold_limb
        lo = x[..., :fl]
        hi = x[..., fl:]
        prod = _conv(
            hi,
            jnp.broadcast_to(
                self._fold_const, hi.shape[:-1] + self._fold_const.shape
            ),
        )
        width = max(STORE, prod.shape[-1], fl)
        def pad_to(v):
            return jnp.pad(
                v, [(0, 0)] * (v.ndim - 1) + [(0, width - v.shape[-1])]
            )
        return pad_to(lo) + pad_to(prod)

    def _reduce(self, x: jnp.ndarray) -> jnp.ndarray:
        """Bring an arbitrary-length convolution result back to STORE limbs,
        balanced.  Static loop: every [carry, carry, fold] strictly shrinks
        the value; two cleanup folds handle the tail limbs above the
        boundary, after which limbs >= fold_limb are provably zero."""
        while x.shape[-1] > STORE:
            x = _carry(_carry(x))
            x = self._fold_once(x)
        for _ in range(2):  # tail cleanup: hi is tiny but maybe nonzero
            x = _carry(_carry(x))
            x = self._fold_once(x)
        x = _carry(_carry(_carry(x)))
        # value now < radix^fold_limb * (1 + eps): top limbs beyond STORE are 0
        return x[..., :STORE]

    # -- ring ops ----------------------------------------------------------
    def add(self, a, b):
        return self._reduce(a + b)

    def sub(self, a, b):
        return self._reduce(a - b)

    def neg(self, a):
        return -a

    def mul(self, a, b):
        return self._reduce(_conv(a, b))

    def square(self, a):
        return self.mul(a, a)

    def scale_small(self, a, k: int):
        """Multiply by a small integer constant |k| < 2^15."""
        return self._reduce(a * jnp.int32(k))

    def add_nored(self, a, b):
        """Unreduced add for short chains feeding a mul: caller must keep
        total |limb| < 2^15 (e.g. at most ~16 chained adds)."""
        return a + b

    # -- powers ------------------------------------------------------------
    def pow_const(self, a, e: int):
        """a^e for a fixed exponent via lax.scan over the bit string
        (MSB-first), keeping the compiled graph one-round-sized."""
        if e == 0:
            return jnp.broadcast_to(self.constant(1), a.shape)
        bits = jnp.asarray(
            [int(b) for b in bin(e)[2:]], dtype=jnp.int32
        )  # MSB first

        def body(acc, bit):
            acc = self.square(acc)
            acc = jnp.where(bit > 0, self.mul(acc, a), acc)
            return acc, None

        one = jnp.broadcast_to(self.constant(1), a.shape)
        acc, _ = lax.scan(body, one, bits)
        return acc

    def inv(self, a):
        """Fermat inverse; inv(0) == 0 (dalek semantics)."""
        return self.pow_const(a, self.modulus - 2)

    def batch_inv(self, a):
        """Montgomery-trick batch inversion over the leading axis would need
        masking for zeros; the Fermat pow is branch-free and parallel, so we
        simply use it (same asymptotic cost on saturated vector lanes)."""
        return self.inv(a)

    def select(self, cond, a, b):
        c = cond
        while c.ndim < a.ndim:
            c = c[..., None]
        return jnp.where(c, a, b)

    # -- canonicalisation (device-side, exact) -----------------------------
    def canonicalize(self, a) -> jnp.ndarray:
        """Unique representative in [0, modulus) as unbalanced 12-bit limbs.

        |lazy value| < 2^264 < 2^13 * modulus, so one conditional
        +2^13*modulus fixes any negative and a binary descent of conditional
        subtractions lands in [0, modulus).  Branch-free."""
        x = self._reduce(a)
        big = (1 << 13) * self.modulus
        x = jnp.where(
            value_is_negative(x)[..., None], x + _const_limbs_of(big), x
        )
        k = 1 << 13
        while k >= 1:
            km = k * self.modulus
            x = jnp.where(
                value_ge(x, km)[..., None], x - _const_limbs_of(km), x
            )
            k //= 2
        return to_unbalanced(x)

    def to_bits(self, a, nbits: int = 253) -> jnp.ndarray:
        """Canonical LSB-first bit matrix (..., nbits) of lazy elements."""
        can = self.canonicalize(a)  # (..., STORE) unsigned 12-bit limbs
        positions = np.arange(nbits)
        limb_idx = positions // LIMB_BITS
        bit_idx = positions % LIMB_BITS
        limbs = can[..., limb_idx]
        return (limbs >> jnp.asarray(bit_idx, dtype=jnp.int32)) & 1

    def eq(self, a, b) -> jnp.ndarray:
        return jnp.all(self.canonicalize(a - b) == 0, axis=-1)


# -------------------------------------------------- value-level helpers
def _const_limbs_of(v: int) -> jnp.ndarray:
    return jnp.asarray(int_to_limbs(v, STORE))


def to_unbalanced(a: jnp.ndarray) -> jnp.ndarray:
    """Balanced limbs -> unique unsigned 12-bit limbs for values in
    [0, 2^276): sequential borrow propagation (scan over the 23 limbs)."""

    def body(carry, limb):
        total = limb + carry
        lo = total & jnp.int32(RADIX - 1)
        return (total - lo) >> LIMB_BITS, lo

    _, lo = lax.scan(
        body,
        jnp.zeros(a.shape[:-1], dtype=jnp.int32),
        jnp.moveaxis(a, -1, 0),
    )
    return jnp.moveaxis(lo, 0, -1)


def value_is_negative(a: jnp.ndarray) -> jnp.ndarray:
    """Sign of the represented value (carry-propagated top sign)."""

    def body(carry, limb):
        total = limb + carry
        lo = total & jnp.int32(RADIX - 1)
        return (total - lo) >> LIMB_BITS, lo

    carry, _ = lax.scan(
        body,
        jnp.zeros(a.shape[:-1], dtype=jnp.int32),
        jnp.moveaxis(a, -1, 0),
    )
    return carry < 0


def value_ge(a: jnp.ndarray, v: int) -> jnp.ndarray:
    """value(a) >= v for |value| < 2^276."""
    return ~value_is_negative(a - _const_limbs_of(v))


# Scalar field Z/L: 2^252 (limb 21) == -c with c = L - 2^252 (11 limbs).
FQ = LimbField(L, 21, -(L - (1 << 252)))
# Curve base field Z/P: 2^264 (limb 22) == 19 * 2^9 = 9728 (1 limb).
FP = LimbField(P, 22, 19 << 9)
