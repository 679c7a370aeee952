"""Scalar field Z/L (host side).

API-compatible stand-in for ``curve25519_dalek::scalar::Scalar`` as used by
the reference gadgets (``from(u64)``, ``from_bits``, ``from_bytes_mod_order``,
``reduce``, ``invert`` with ``invert(0) == 0`` - probed by the reference at
``/root/reference/src/scalar_utils.rs:304-308`` - ``random``, arithmetic ops,
32-byte little-endian codec).

Host values are arbitrary-precision ints reduced mod L; the batched/device
representation used by the device compute path lives in
:mod:`bulletproofs_r1cs_gadgets_tpu.ops.field` (23 x 12-bit limb arrays) with
exact conversions both ways.

Non-canonical values: dalek's ``Scalar::from_bits`` stores raw 255-bit strings
without reducing; the reference relies on this only via ``reduce()``-then-use
patterns (``scalar_utils.rs:26-31,65``), so we track the raw int and reduce on
arithmetic, matching observable behaviour.
"""

from __future__ import annotations

import secrets
from ..utils.constants import L


class Scalar:
    """An element of the prime field of order L (Ristretto group order)."""

    __slots__ = ("v",)

    def __init__(self, value: int):
        # canonical representative; use from_bits for non-canonical carriers
        self.v = value % L if (value >= L or value < 0) else value

    # --- constructors ------------------------------------------------------
    @staticmethod
    def zero() -> "Scalar":
        return Scalar(0)

    @staticmethod
    def one() -> "Scalar":
        return Scalar(1)

    @staticmethod
    def from_u64(x: int) -> "Scalar":
        assert 0 <= x < 2**64
        return Scalar(x)

    @staticmethod
    def from_bytes_mod_order(b: bytes) -> "Scalar":
        assert len(b) == 32
        return Scalar(int.from_bytes(b, "little"))

    @staticmethod
    def from_bytes_mod_order_wide(b: bytes) -> "Scalar":
        assert len(b) == 64
        return Scalar(int.from_bytes(b, "little"))

    @staticmethod
    def from_bits(b: bytes) -> "NonReducedScalar":
        assert len(b) == 32
        return NonReducedScalar(int.from_bytes(b, "little") & ((1 << 255) - 1))

    @staticmethod
    def from_int(x: int) -> "Scalar":
        return Scalar(x)

    @staticmethod
    def random(rng=None) -> "Scalar":
        if rng is None:
            return Scalar.from_bytes_mod_order_wide(secrets.token_bytes(64))
        return Scalar.from_bytes_mod_order_wide(rng.bytes(64))

    # --- codecs ------------------------------------------------------------
    def to_bytes(self) -> bytes:
        return self.v.to_bytes(32, "little")

    as_bytes = to_bytes

    def reduce(self) -> "Scalar":
        return Scalar(self.v)

    def byte(self, i: int) -> int:
        """Index into the canonical little-endian encoding (dalek's ``l[i]``,
        used by the 4-ary SMT gadget, ``gadget_vsmt_4.rs:227``)."""
        return (self.v >> (8 * i)) & 0xFF

    # --- arithmetic --------------------------------------------------------
    # Non-Scalar operands return NotImplemented so that Variable /
    # LinearCombination reflected operators take over (gadget-code sugar).
    def __add__(self, other):
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar(self.v + other.v)

    def __sub__(self, other):
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar(self.v - other.v)

    def __mul__(self, other):
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar(self.v * other.v)

    def __neg__(self) -> "Scalar":
        return Scalar(-self.v)

    def invert(self) -> "Scalar":
        """Multiplicative inverse; invert(0) == 0 like dalek (Fermat pow)."""
        return Scalar(pow(self.v, L - 2, L))

    def __pow__(self, e: int) -> "Scalar":
        return Scalar(pow(self.v, e, L))

    # --- comparisons / hashing --------------------------------------------
    def __eq__(self, other) -> bool:
        return isinstance(other, Scalar) and self.v == other.v

    def __hash__(self) -> int:
        return hash(self.v)

    def __repr__(self) -> str:
        return f"Scalar(0x{self.v:064x})"

    def is_zero(self) -> bool:
        return self.v == 0


class NonReducedScalar(Scalar):
    """Raw 255-bit value as produced by dalek's ``Scalar::from_bits``.

    Carries an unreduced representative; ``reduce()`` canonicalises.  Only the
    codec paths of the reference touch these (``scalar_utils.rs:65,165-167``).
    """

    def __init__(self, value: int):  # bypass reduction
        assert 0 <= value < (1 << 255)
        self.v = value

    def to_bytes(self) -> bytes:
        return self.v.to_bytes(32, "little")

    def reduce(self) -> Scalar:
        return Scalar(self.v)


def batch_invert(xs: list[Scalar]) -> list[Scalar]:
    """Montgomery batch inversion; zeros invert to zero (dalek semantics)."""
    n = len(xs)
    prefix = [Scalar.one()] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x if x.v != 0 else prefix[i]
    inv_all = prefix[n].invert()
    out = [Scalar.zero()] * n
    for i in range(n - 1, -1, -1):
        if xs[i].v != 0:
            out[i] = prefix[i] * inv_all
            inv_all = inv_all * xs[i]
    return out


def exp_iter(base: Scalar, n: int) -> list[Scalar]:
    """[1, base, base^2, ..., base^(n-1)]"""
    out = [Scalar.one()]
    for _ in range(n - 1):
        out.append(out[-1] * base)
    return out


def inner_product(a: list[Scalar], b: list[Scalar]) -> Scalar:
    assert len(a) == len(b)
    acc = 0
    for x, y in zip(a, b):
        acc += x.v * y.v
    return Scalar(acc)
