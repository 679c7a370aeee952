"""Device backend for the proof engine.

The Prover/Verifier/IPP accept an optional ``backend``; this one runs the
MSM-heavy steps as plain jax.numpy programs (:mod:`.curve`, :mod:`.msm`)
that XLA compiles for the accelerator:

* ``phase_commitments`` - the prover's A_I1/A_O1/S1 vector commitments.
* ``ipp_create`` - the inner-product argument: L/R MSMs and the generator
  folds run on device; only the 64-byte transcript exchange (append L, R;
  draw u) round-trips to the host.
* ``msm`` / ``msm_gens`` - the verifier's single combined MSM.

Scalar-side folds (sizes n, n/2, ...) stay on the host in the C++ ``scvec``
layer: they are O(n) modmuls against the device's O(n * 253) point work.
Circuits below ``min_device_n`` points run entirely on the host, where
device dispatch overhead would dominate.

Generator vectors are uploaded once per (gens, capacity) and cached.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

import numpy as np

from ..core import scvec
from ..core.ristretto import RistrettoPoint, multiscalar_mul
from ..core.ipp import InnerProductProof, _skip_domain_sep
from .curve import (
    point_add,
    point_double,
    point_select,
    identity_points,
    points_to_device,
    points_from_device,
)
from .msm import CHUNK, WINDOW, msm_device

from ..utils.config import DEFAULT_CONFIG

MIN_DEVICE_N = DEFAULT_CONFIG.engine.min_device_n
FOLD_CHUNK = 1 << 10  # points per compiled generator-fold call


def _rows(x) -> np.ndarray:
    """Scalars as (n, 4) u64 ``scvec`` rows (arrays pass through)."""
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x)
    return scvec.from_scalars(list(x))


def _bits_rows(rows: np.ndarray) -> np.ndarray:
    """(n, 4) u64 scalar rows -> (n, 253) uint8 LSB-first bit matrix (one
    vectorised byte-view unpack)."""
    b = np.ascontiguousarray(rows, dtype="<u8").view(np.uint8)
    bits = np.unpackbits(b.reshape(len(rows), 32), axis=1, bitorder="little")
    return bits[:, :253]


def _bits_arr(s) -> np.ndarray:
    """(253,) LSB-first bits of one scalar (a Scalar or an int)."""
    return _bits_rows(scvec.scalar_to_row(s)[None])[0]


@jax.jit
def fold_points(
    left: jnp.ndarray,
    right: jnp.ndarray,
    u_inv_bits: jnp.ndarray,
    u_bits: jnp.ndarray,
) -> jnp.ndarray:
    """Strauss-style joint fold: u_inv * left + u * right, one shared
    doubling chain for both scalars (bits LSB-first, shape (253,))."""
    both = point_add(left, right)
    nbits = u_bits.shape[0]

    def body(acc, i):
        bit_l = u_inv_bits[nbits - 1 - i]
        bit_r = u_bits[nbits - 1 - i]
        acc = point_double(acc)
        ident = jnp.broadcast_to(identity_points(()), left.shape)
        addend = point_select(
            (bit_l > 0) & (bit_r > 0),
            both,
            point_select(
                bit_l > 0, left, point_select(bit_r > 0, right, ident)
            ),
        )
        return point_add(acc, addend), None

    ident = jnp.broadcast_to(identity_points(()), left.shape)
    acc, _ = lax.scan(body, ident, jnp.arange(nbits))
    return acc


@jax.jit
def _fold_with_scalars_jit(left, right, bits_l, bits_r):
    """Per-element double-scalar fold with distinct scalars (the first IPP
    round folds the outer G/H factors in): bits (n, 253) LSB-first."""
    nbits = bits_l.shape[-1]

    def body(acc, i):
        acc = point_double(acc)
        ident = jnp.broadcast_to(identity_points(()), left.shape)
        add_l = point_select(bits_l[:, nbits - 1 - i] > 0, left, ident)
        add_r = point_select(bits_r[:, nbits - 1 - i] > 0, right, ident)
        return point_add(point_add(acc, add_l), add_r), None

    ident = jnp.broadcast_to(identity_points(()), left.shape)
    acc, _ = lax.scan(body, ident, jnp.arange(nbits))
    return acc


def _pad_points_to(arr: jnp.ndarray, size: int) -> jnp.ndarray:
    n = arr.shape[0]
    if n == size:
        return arr
    pad = jnp.broadcast_to(identity_points(()), (size - n, 4, arr.shape[-1]))
    return jnp.concatenate([arr, pad], axis=0)


def _run_fold(jit_fn, size: int, left, right, *bit_args):
    """Apply a per-element fold in ``size``-shaped pieces; a bit argument
    is either shared (253,) or per element (n, 253)."""
    n = left.shape[0]
    outs = []
    for off in range(0, n, size):
        hi = min(off + size, n)
        bits = []
        for b in bit_args:
            if b.ndim == 1:
                bits.append(b)
            else:
                pad = np.zeros((size - (hi - off), b.shape[1]), b.dtype)
                bits.append(jnp.asarray(np.concatenate([b[off:hi], pad])))
        outs.append(jit_fn(
            _pad_points_to(left[off:hi], size),
            _pad_points_to(right[off:hi], size),
            *bits,
        )[: hi - off])
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


class DeviceBackend:
    """Routes the engine's heavy vector math to the device.

    ``chunk`` and ``window`` shape the compiled MSM (see :mod:`.msm`),
    ``fold_chunk`` the compiled generator fold; the defaults are the
    production shapes, and tests pass small ones to keep CPU compiles
    short."""

    def __init__(
        self,
        min_device_n: int = MIN_DEVICE_N,
        chunk: int = CHUNK,
        window: int = WINDOW,
        fold_chunk: int = FOLD_CHUNK,
    ):
        self.min_device_n = min_device_n
        self.chunk = chunk
        self.window = window
        self.fold_chunk = fold_chunk
        self._gens_cache: dict = {}

    # ------------------------------------------------------------- helpers
    def _gens_device(self, gens_share, n: int, which: str) -> jnp.ndarray:
        key = (id(gens_share._gens), which)
        cached = self._gens_cache.get(key)
        if cached is None or cached.shape[0] < n:
            limbs = (
                gens_share.G_limbs(n) if which == "G"
                else gens_share.H_limbs(n)
            )
            cached = jnp.asarray(limbs)
            self._gens_cache[key] = cached
        return cached[:n]

    def _msm_dev(self, rows: np.ndarray, dev: jnp.ndarray) -> jnp.ndarray:
        """Device MSM hook; ShardedMsmBackend overrides this to partition
        the point axis over a mesh (parallel/sharded_backend.py)."""
        return msm_device(rows, dev, self.chunk, self.window)

    def _fold(self, left, right, s_left, s_right) -> jnp.ndarray:
        """s_left[i] * left[i] + s_right[i] * right[i]; the scalars are
        either one Scalar each (shared by every element) or (n, 4) rows."""
        if isinstance(s_left, np.ndarray):
            return _run_fold(
                _fold_with_scalars_jit, self.fold_chunk, left, right,
                _bits_rows(s_left), _bits_rows(s_right),
            )
        return _run_fold(
            fold_points, self.fold_chunk, left, right,
            jnp.asarray(_bits_arr(s_left)), jnp.asarray(_bits_arr(s_right)),
        )

    def msm(self, scalars, points: list[RistrettoPoint]) -> RistrettoPoint:
        if len(scalars) < self.min_device_n:
            if isinstance(scalars, np.ndarray):
                scalars = scvec.to_scalars(scalars)
            return multiscalar_mul(scalars, points)
        return points_from_device(
            self._msm_dev(_rows(scalars), points_to_device(points))
        )[0]

    # ------------------------------------------------------ batched variants
    # Loop fallbacks so any backend accepts batch jobs;
    # BatchShardedBackend overrides these with SPMD dispatch.
    def phase_commitments_batch(self, jobs: list[tuple]) -> list[tuple]:
        return [self.phase_commitments(*job) for job in jobs]

    def ipp_create_batch(self, jobs: list[tuple]) -> list:
        return [self.ipp_create(*job) for job in jobs]

    def msm_gens(
        self, scalars, head_points, gens_share, padded_n, tail_points
    ) -> RistrettoPoint:
        """Verifier combined MSM with the generator segment read from the
        device cache."""
        nh, nt = len(head_points), len(tail_points)
        total = nh + 2 * padded_n + nt
        if total < self.min_device_n:
            pts = (
                head_points
                + gens_share.G(padded_n)
                + gens_share.H(padded_n)
                + tail_points
            )
            if isinstance(scalars, np.ndarray):
                scalars = scvec.to_scalars(scalars)
            return multiscalar_mul(scalars, pts)
        dev = jnp.concatenate(
            [
                points_to_device(head_points),
                self._gens_device(gens_share, padded_n, "G"),
                self._gens_device(gens_share, padded_n, "H"),
                points_to_device(tail_points),
            ],
            axis=0,
        )
        return points_from_device(self._msm_dev(_rows(scalars), dev))[0]

    # -------------------------------------------------- prover commitments
    def phase_commitments(
        self, gens_share, a_L, a_R, a_O, s_L, s_R,
        i_blinding, o_blinding, s_blinding, B_blinding, offset,
    ):
        n = len(a_L)
        if n < self.min_device_n:
            G = gens_share.G(offset + n)[offset:]
            H = gens_share.H(offset + n)[offset:]
            a_L, a_R, a_O, s_L, s_R = (
                scvec.to_scalars(_rows(v)) for v in (a_L, a_R, a_O, s_L, s_R)
            )
            A_I = multiscalar_mul(
                [i_blinding] + a_L + a_R, [B_blinding] + G + H
            ).compress()
            A_O = multiscalar_mul([o_blinding] + a_O, [B_blinding] + G).compress()
            S = multiscalar_mul(
                [s_blinding] + s_L + s_R, [B_blinding] + G + H
            ).compress()
            return A_I, A_O, S

        G_dev = self._gens_device(gens_share, offset + n, "G")[offset:]
        H_dev = self._gens_device(gens_share, offset + n, "H")[offset:]
        B_dev = points_to_device([B_blinding])
        GH = jnp.concatenate([B_dev, G_dev, H_dev], axis=0)

        def rows(blinding, *vecs):
            return np.concatenate(
                [scvec.scalar_to_row(blinding)[None]] + [_rows(v) for v in vecs]
            )

        A_I = self._msm_dev(rows(i_blinding, a_L, a_R), GH)
        A_O = self._msm_dev(
            rows(o_blinding, a_O), jnp.concatenate([B_dev, G_dev], axis=0)
        )
        S = self._msm_dev(rows(s_blinding, s_L, s_R), GH)
        pts = points_from_device(jnp.stack([A_I, A_O, S], axis=0))
        return pts[0].compress(), pts[1].compress(), pts[2].compress()

    # ------------------------------------------------------------------ IPP
    def ipp_create(
        self, transcript, Q, G_factors, H_factors, gens_share, padded_n,
        a, b,
    ) -> InnerProductProof:
        """The dalek schedule (round-1 folds carry the outer G/H factors,
        later rounds fold by the bare challenge), as in
        ``InnerProductProof.create``."""
        n = padded_n
        if n < self.min_device_n:
            G_factors, H_factors, a, b = (
                scvec.to_scalars(_rows(v)) for v in (G_factors, H_factors, a, b)
            )
            return InnerProductProof.create(
                _skip_domain_sep(transcript), Q, G_factors, H_factors,
                gens_share.G(n), gens_share.H(n), a, b,
            )

        a, b, GF, HF = (_rows(v) for v in (a, b, G_factors, H_factors))
        G = self._gens_device(gens_share, n, "G")
        H = self._gens_device(gens_share, n, "H")
        Q_dev = points_to_device([Q])
        L_vec: list[bytes] = []
        R_vec: list[bytes] = []
        first = True
        while n != 1:
            n //= 2
            a_L, a_R = a[:n], a[n:]
            b_L, b_R = b[:n], b[n:]
            c_L = scvec.scalar_to_row(scvec.inner(a_L, b_R))[None]
            c_R = scvec.scalar_to_row(scvec.inner(a_R, b_L))[None]
            if first:
                sc_L = [scvec.mul(a_L, GF[n:]), scvec.mul(b_R, HF[:n]), c_L]
                sc_R = [scvec.mul(a_R, GF[:n]), scvec.mul(b_L, HF[n:]), c_R]
            else:
                sc_L = [a_L, b_R, c_L]
                sc_R = [a_R, b_L, c_R]
            L_pt = self._msm_dev(
                np.concatenate(sc_L),
                jnp.concatenate([G[n:], H[:n], Q_dev], axis=0),
            )
            R_pt = self._msm_dev(
                np.concatenate(sc_R),
                jnp.concatenate([G[:n], H[n:], Q_dev], axis=0),
            )
            L_c, R_c = (
                p.compress() for p in points_from_device(jnp.stack([L_pt, R_pt]))
            )
            L_vec.append(L_c)
            R_vec.append(R_c)
            transcript.append_point(b"L", L_c)
            transcript.append_point(b"R", R_c)
            u = transcript.challenge_scalar(b"u")
            u_inv = u.invert()
            a = scvec.axpby(a_L, u, a_R, u_inv)
            b = scvec.axpby(b_L, u_inv, b_R, u)
            if first:
                # fold the outer G/H factors in (one-off per-element scalars)
                G = self._fold(G[:n], G[n:], scvec.scale(GF[:n], u_inv),
                               scvec.scale(GF[n:], u))
                H = self._fold(H[:n], H[n:], scvec.scale(HF[:n], u),
                               scvec.scale(HF[n:], u_inv))
                first = False
            else:
                G = self._fold(G[:n], G[n:], u_inv, u)
                H = self._fold(H[:n], H[n:], u, u_inv)
        return InnerProductProof(
            L_vec, R_vec,
            scvec.row_to_scalar(a[0]), scvec.row_to_scalar(b[0]),
        )
