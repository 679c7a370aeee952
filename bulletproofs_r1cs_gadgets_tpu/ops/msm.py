"""Multi-scalar multiplication as a plain jax.numpy program.

The MSM is the dominant cost of Bulletproofs proving and verification
(SURVEY.md CS-1: ">95% of wall time").  This version is a *dense windowed
double-and-add*: every point walks its own scalar in lock-step across the
batch, then log2(N) halving rounds sum the per-point results.  Work is
O(N * 253/w * (w dbl + 1 add)) with a w-bit window; the per-point multiple
d * P_i comes from a 2^w-entry table by a gather.  It is exact (int32 limb
arithmetic only) and XLA compiles it for any backend; a bucket (Pippenger)
MSM would need fewer additions per point.

* Chunking bounds the live table memory (2^w * chunk * 368 B) and the
  number of compiled shapes: a full ``chunk`` and a ``chunk // 16`` tail
  shape.  Tails are padded with (identity, zero-scalar) pairs, which the
  unified formulas absorb.

Correctness oracles: ``core.ristretto.multiscalar_mul`` (host Pippenger) and
the C++ ``NativeBackend``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core import scvec
from .field import STORE
from .curve import point_add, point_double, identity_points

WINDOW = 4  # bits per window
CHUNK = 1 << 14  # points per large device chunk (tails: CHUNK // 16)


def scalars_to_digits(scalars, window: int = WINDOW) -> np.ndarray:
    """(N, ceil(253/window)) uint8 window digits, least-significant first.

    Accepts a ``core.scvec`` (N, 4) u64 array or a list of ints (reduced
    mod L).  The split is a vectorised bit-field view of the little-endian
    bytes, with no per-scalar Python loop."""
    assert window in (1, 2, 4, 8), "window must divide 8"
    if not isinstance(scalars, np.ndarray):
        scalars = scvec.from_ints(scalars)
    nwin = (253 + window - 1) // window
    n = scalars.shape[0]
    b = np.ascontiguousarray(scalars, dtype="<u8").view(np.uint8)
    b = b.reshape(n, 32)
    per = 8 // window
    mask = (1 << window) - 1
    out = np.empty((n, 32 * per), dtype=np.uint8)
    for k in range(per):
        out[:, k::per] = (b >> (window * k)) & mask
    return out[:, :nwin]


def msm_chunk_impl(
    points: jnp.ndarray, digits: jnp.ndarray, window: int = WINDOW
) -> jnp.ndarray:
    """MSM over one chunk: points (N,4,S), digits (N,W) -> (4,S) sum.

    Windowed double-and-add, most significant window first; the addend
    d * P_i is gathered from the table [0, P, 2P, ..., (2^w - 1)P].
    ``window`` trades table size against doubling count; the CPU tests use
    w=2 to keep XLA compiles short."""
    n = points.shape[0]
    ident = jnp.broadcast_to(identity_points(()), points.shape)

    def next_multiple(prev, _):
        nxt = point_add(prev, points)
        return nxt, nxt

    # a scan keeps one point_add in the compiled graph, not 2^w - 2
    _, multiples = lax.scan(next_multiple, points, None, (1 << window) - 2)
    table = jnp.concatenate(
        [ident[None], points[None], multiples], axis=0
    )  # (2^w, N, 4, S)

    nwin = digits.shape[-1]

    def body(acc, w):
        # acc: (N, 4, S) running per-point accumulator
        for _ in range(window):
            acc = point_double(acc)
        d = digits[:, nwin - 1 - w].astype(jnp.int32)  # (N,)
        addend = jnp.take_along_axis(table, d[None, :, None, None], axis=0)
        return point_add(acc, addend[0]), None

    acc, _ = lax.scan(body, ident, jnp.arange(nwin))

    # sum the per-point results: log2(N) rounds of acc[i] += acc[i + h],
    # h halving, in one fixed-shape loop (one point_add in the compiled
    # graph instead of log2(N), at log2(N) x N additions instead of N)
    size = 1 << (n - 1).bit_length()
    if size != n:
        acc = jnp.concatenate([acc, ident[: size - n]], axis=0)

    def halve(k, a):
        return point_add(a, jnp.roll(a, -(size >> (k + 1)), axis=0))

    acc = lax.fori_loop(0, size.bit_length() - 1, halve, acc)
    return acc[0]


_msm_chunk = jax.jit(msm_chunk_impl, static_argnames="window")
_add = jax.jit(point_add)


def _pad_chunk(points: jnp.ndarray, digits: np.ndarray, size: int):
    n = points.shape[0]
    if n == size:
        return points, jnp.asarray(digits)
    pad_pts = jnp.broadcast_to(identity_points(()), (size - n, 4, STORE))
    points = jnp.concatenate([points, pad_pts], axis=0)
    digits = np.concatenate(
        [digits, np.zeros((size - n, digits.shape[1]), dtype=digits.dtype)],
        axis=0,
    )
    return points, jnp.asarray(digits)


def msm_device(
    scalars, points_dev: jnp.ndarray, chunk: int = CHUNK,
    window: int = WINDOW,
) -> jnp.ndarray:
    """Full MSM: host scalars x device points -> device point (4, STORE).

    ``scalars`` is a (n, 4) u64 ``scvec`` array or a list of ints.  Work is
    split into ``chunk``-sized pieces; a remainder of at most chunk/2 runs
    in ``chunk // 16`` pieces, so two shapes are compiled per window."""
    digits = scalars_to_digits(scalars, window)
    n = digits.shape[0]
    assert points_dev.shape[0] == n
    if n == 0:
        return identity_points(())
    small = max(1, chunk // 16)
    acc = None
    off = 0
    while off < n:
        size = chunk if n - off > chunk // 2 else small
        hi = min(off + size, n)
        pts, digs = _pad_chunk(points_dev[off:hi], digits[off:hi], size)
        part = _msm_chunk(pts, digs, window=window)
        acc = part if acc is None else _add(acc, part)
        off = hi
    return acc
