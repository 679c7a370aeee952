"""DeviceBackend MSM and generator folds against the host oracles, through
the real XLA path with small compiled shapes (chunk 32, tail chunk 2,
window 2) so every chunk boundary is reachable on the CPU."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest

from bulletproofs_r1cs_gadgets_tpu import PedersenGens, Scalar
from bulletproofs_r1cs_gadgets_tpu.core import scvec
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import multiscalar_mul
from bulletproofs_r1cs_gadgets_tpu.ops.backend import (
    DeviceBackend,
    _bits_rows,
)
from bulletproofs_r1cs_gadgets_tpu.ops.curve import (
    points_from_device,
    points_to_device,
)
from bulletproofs_r1cs_gadgets_tpu.ops.msm import scalars_to_digits
from bulletproofs_r1cs_gadgets_tpu.utils.constants import L

CHUNK = 32


@functools.lru_cache(maxsize=None)
def _points(n):
    B = PedersenGens.default().B
    return [B.scalar_mul(Scalar(3 * i + 2)) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _backend():
    return DeviceBackend(min_device_n=1, chunk=CHUNK, window=2, fold_chunk=8)


def _scalars(n, seed):
    rnd = random.Random(seed)
    return [Scalar(rnd.randrange(L)) for _ in range(n)]


# n: a lone point; a tail below chunk/2 (tail chunks of 2); exactly
# chunk/2; just above chunk/2 (one padded full chunk); one full chunk; a
# full chunk plus a 1-point tail; two chunks plus a short tail
@pytest.mark.parametrize("n", [1, 5, 16, 17, 32, 33, 70])
def test_msm_matches_host_at_chunk_boundaries(n):
    sc = _scalars(n, seed=n)
    got = _backend().msm(scvec.from_scalars(sc), _points(n))
    assert got == multiscalar_mul(sc, _points(n))


def test_msm_chunk_of_odd_size():
    """One compiled chunk whose size is not a power of two (identity-padded
    before the halving rounds)."""
    from bulletproofs_r1cs_gadgets_tpu.ops.msm import msm_chunk_impl

    sc = _scalars(5, seed=55)
    out = msm_chunk_impl(
        points_to_device(_points(5)),
        jnp.asarray(scalars_to_digits(scvec.from_scalars(sc), 2)),
        window=2,
    )
    assert points_from_device(out[None])[0] == multiscalar_mul(sc, _points(5))


@pytest.mark.parametrize(
    "case", ["zeros", "L_minus_1", "mixed_edges", "scalar_list"]
)
def test_msm_edge_scalars(case):
    n = 9
    if case == "zeros":
        sc = [Scalar(0)] * n
    elif case == "L_minus_1":
        sc = [Scalar(L - 1)] * n
    else:
        sc = _scalars(n, seed=99)
        sc[0], sc[3], sc[7] = Scalar(0), Scalar(L - 1), Scalar(1)
    arg = sc if case == "scalar_list" else scvec.from_scalars(sc)
    got = _backend().msm(arg, _points(n))
    assert got == multiscalar_mul(sc, _points(n))


def test_msm_below_threshold_runs_on_host():
    be = DeviceBackend(min_device_n=64, chunk=CHUNK, window=2)
    sc = _scalars(5, seed=5)
    assert be.msm(scvec.from_scalars(sc), _points(5)) == multiscalar_mul(
        sc, _points(5)
    )


@pytest.mark.parametrize("window", [1, 2, 4, 8])
def test_scalars_to_digits_recompose(window):
    ints = [0, 1, L - 1] + [s.v for s in _scalars(5, seed=window)]
    digits = scalars_to_digits(scvec.from_ints(ints), window)
    assert digits.shape == (len(ints), -(-253 // window))
    assert np.array_equal(digits, scalars_to_digits(ints, window))
    for x, row in zip(ints, digits):
        assert sum(int(d) << (window * i) for i, d in enumerate(row)) == x


def test_bits_rows_recompose():
    ints = [0, 1, L - 1] + [s.v for s in _scalars(5, seed=3)]
    bits = _bits_rows(scvec.from_ints(ints))
    assert bits.shape == (len(ints), 253)
    for x, row in zip(ints, bits):
        assert sum(int(b) << i for i, b in enumerate(row)) == x


@pytest.mark.parametrize("scalars", ["shared", "per_element"])
def test_generator_fold_matches_host(scalars):
    """One IPP fold: s_l[i] * left[i] + s_r[i] * right[i], over 11 points
    (two fold chunks of 8, the second padded)."""
    n = 11
    pts = _points(2 * n)
    left, right = points_to_device(pts[:n]), points_to_device(pts[n:])
    if scalars == "shared":
        u = _scalars(1, seed=11)[0]
        s_l, s_r = [u.invert()] * n, [u] * n
        got = _backend()._fold(left, right, u.invert(), u)
    else:
        s_l, s_r = _scalars(n, seed=12), _scalars(n, seed=13)
        got = _backend()._fold(
            left, right, scvec.from_scalars(s_l), scvec.from_scalars(s_r)
        )
    want = [
        pts[i].scalar_mul(s_l[i]) + pts[n + i].scalar_mul(s_r[i])
        for i in range(n)
    ]
    assert points_from_device(got) == want
    assert got.shape == (n,) + left.shape[1:]
    assert isinstance(got, jnp.ndarray)
