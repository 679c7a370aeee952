"""Device-op correctness vs host oracles (CPU backend, XLA path).

The field and curve programs here are the ones XLA compiles for the GPU;
heavier compiles are marked slow.
"""

import random

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from bulletproofs_r1cs_gadgets_tpu.ops.field import (
    FQ,
    FP,
    STORE,
    limbs_to_int,
)
from bulletproofs_r1cs_gadgets_tpu.utils.constants import L, P
from bulletproofs_r1cs_gadgets_tpu.core.scalar import Scalar
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
    RistrettoPoint,
    multiscalar_mul,
)

rnd = random.Random(7)


@pytest.mark.parametrize("F,m", [(FQ, L), (FP, P)])
def test_field_ring_ops_exact(F, m):
    xs = [rnd.randrange(m) for _ in range(32)] + [0, 1, m - 1, m - 2]
    ys = [rnd.randrange(m) for _ in range(32)] + [m - 1, 1, 0, m - 1]
    a, b = F.to_device(xs), F.to_device(ys)
    assert F.to_ints(jax.jit(F.mul)(a, b)) == [(x * y) % m for x, y in zip(xs, ys)]
    assert F.to_ints(jax.jit(F.add)(a, b)) == [(x + y) % m for x, y in zip(xs, ys)]
    assert F.to_ints(jax.jit(F.sub)(a, b)) == [(x - y) % m for x, y in zip(xs, ys)]
    assert F.to_ints(F.neg(a)) == [(-x) % m for x in xs]


@pytest.mark.parametrize("F,m", [(FQ, L), (FP, P)])
def test_field_adversarial_limbs(F, m):
    # extreme balanced limb patterns (max magnitude both signs)
    adv = np.full((4, STORE), 2**11, dtype=np.int32)
    adv[1] = -(2**11)
    adv[2, ::2] = -(2**11)
    adv[3, 0] = 2**11 + 1
    advj = jnp.asarray(adv)
    got = F.to_ints(jax.jit(F.mul)(advj, advj))
    assert got == [(limbs_to_int(r) ** 2) % m for r in adv]


def test_field_chained_ops():
    m = L
    xs = [rnd.randrange(m) for _ in range(16)]
    ys = [rnd.randrange(m) for _ in range(16)]
    a, b = FQ.to_device(xs), FQ.to_device(ys)
    mul, add = jax.jit(FQ.mul), jax.jit(FQ.add)
    acc, accint = a, list(xs)
    for _ in range(8):
        acc = add(mul(acc, b), a)
        accint = [(v * y + x) % m for v, x, y in zip(accint, xs, ys)]
    assert FQ.to_ints(acc) == accint


def test_field_canonicalize_and_bits():
    xs = [0, 1, L - 1, rnd.randrange(L)]
    a = FQ.to_device(xs)
    neg = FQ.sub(FQ.to_device([0] * 4), a)  # -x as lazy negative values
    canon = jax.jit(FQ.canonicalize)(neg)
    got = [
        sum(int(row[i]) << (12 * i) for i in range(STORE)) for row in np.asarray(canon)
    ]
    assert got == [(-x) % L for x in xs]
    bits = np.asarray(jax.jit(lambda v: FQ.to_bits(v, 253))(a))
    for x, row in zip(xs, bits):
        assert sum(int(b) << i for i, b in enumerate(row)) == x


@pytest.mark.slow
@pytest.mark.parametrize("F,m", [(FQ, L), (FP, P)])
def test_field_inverse(F, m):
    xs = [rnd.randrange(m) for _ in range(8)] + [0, 1, m - 1]
    a = F.to_device(xs)
    got = F.to_ints(jax.jit(F.inv)(a))
    assert got == [pow(x, m - 2, m) for x in xs]


@pytest.mark.slow
def test_curve_ops_match_host():
    from bulletproofs_r1cs_gadgets_tpu.ops import curve as C

    B = RistrettoPoint.basepoint()
    pts = [B.scalar_mul(Scalar(rnd.randrange(1, 10**30))) for _ in range(8)]
    qts = [B.scalar_mul(Scalar(rnd.randrange(1, 10**30))) for _ in range(8)]
    dp, dq = C.points_to_device(pts), C.points_to_device(qts)
    got = C.points_from_device(jax.jit(C.point_add)(dp, dq))
    assert all(g == p + q for g, p, q in zip(got, pts, qts))
    got = C.points_from_device(jax.jit(C.point_double)(dp))
    assert all(g == p.double() for g, p in zip(got, pts))
    # unified add handles identity
    ident = jnp.broadcast_to(C.identity_points(()), dp.shape)
    got = C.points_from_device(jax.jit(C.point_add)(dp, ident))
    assert all(g == p for g, p in zip(got, pts))
    # reduction
    total = C.points_from_device(jax.jit(C.tree_reduce)(dp))[0]
    acc = RistrettoPoint.identity()
    for p in pts:
        acc = acc + p
    assert total == acc


@pytest.mark.slow
def test_scalar_mul_bits_and_elligator():
    import secrets

    from bulletproofs_r1cs_gadgets_tpu.ops import curve as C

    B = RistrettoPoint.basepoint()
    pts = [B.scalar_mul(Scalar(rnd.randrange(1, 10**30))) for _ in range(8)]
    dp = C.points_to_device(pts)
    ks = [rnd.randrange(2**253) for _ in range(8)]
    bits = np.zeros((8, 253), dtype=np.int32)
    for i, k in enumerate(ks):
        for j in range(253):
            bits[i, j] = (k >> j) & 1
    got = C.points_from_device(
        jax.jit(C.scalar_mul_bits)(dp, jnp.asarray(bits))
    )
    assert all(
        g == p.scalar_mul(Scalar(k)) for g, p, k in zip(got, pts, ks)
    )
    seeds = [secrets.token_bytes(64) for _ in range(4)]
    got = C.from_uniform_bytes_batch(seeds)
    assert all(
        g == RistrettoPoint.from_uniform_bytes(s) for g, s in zip(got, seeds)
    )


@pytest.mark.slow
def test_device_poseidon_matches_host():
    from bulletproofs_r1cs_gadgets_tpu.gadgets.poseidon import (
        PoseidonParams,
        Poseidon_permutation,
        SboxType,
    )
    from bulletproofs_r1cs_gadgets_tpu.ops.poseidon import DevicePoseidon

    params = PoseidonParams(6, 4, 4, 8)
    dev = DevicePoseidon(params, sbox="cube")
    inputs = [[Scalar(rnd.randrange(L)) for _ in range(6)] for _ in range(4)]
    state = FQ.to_device([s.v for row in inputs for s in row]).reshape(4, 6, STORE)
    out = dev.permute(state)
    got = FQ.to_ints(out)
    exp = []
    for row in inputs:
        exp.extend(s.v for s in Poseidon_permutation(row, params, SboxType.Cube))
    assert got == exp
