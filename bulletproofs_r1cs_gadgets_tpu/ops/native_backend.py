"""Single-core native (C++) CPU backend — the Rust-engine stand-in.

Implements the same backend interface as :class:`.backend.DeviceBackend`
(``phase_commitments`` / ``ipp_create`` / ``msm`` / ``msm_gens``) but routes
every MSM, generator fold and scalar-mul to the single-threaded C++ group
layer in ``native/bptpu_native.cpp`` (51-bit-limb field arithmetic and
extended-coordinate formulas matching curve25519-dalek's serial backend,
Pippenger with dalek's window policy, wNAF-5 double-scalar folds).

Two roles:

1. **A real CPU prover** for deployments without an accelerator — orders of
   magnitude faster than the pure-Python host path.
2. **The measured single-core baseline proxy** (BASELINE.md): the
   reference's engine (`lovesh/bulletproofs` fork of dalek,
   ``Cargo.toml:22-26``) is optimized native 64-bit code with exactly these
   algorithms, so this backend's end-to-end prove time on the CS-2 circuit
   is a defensible stand-in for single-core Rust throughput — measured on
   the same machine, same circuit, no conversion-factor hand-waving.
   ``bench.py`` divides the device rate by this rate to emit ``vs_baseline``.

Proof bytes are identical to the host path's (same Fiat-Shamir schedule;
pinned by ``tests/test_native_backend.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.scalar import Scalar
from ..core import scvec
from ..core.ipp import InnerProductProof
from ..core.ristretto import RistrettoPoint

try:
    from ..native import _native as _NATIVE
except Exception:  # pragma: no cover
    _NATIVE = None


def native_available() -> bool:
    return _NATIVE is not None


def _pts_to_raw(points: list[RistrettoPoint]) -> np.ndarray:
    """Point list -> (n, 128) uint8 raw extended coords (32 B LE each)."""
    out = np.empty((len(points), 128), dtype=np.uint8)
    for i, pt in enumerate(points):
        out[i] = np.frombuffer(
            pt.X.to_bytes(32, "little") + pt.Y.to_bytes(32, "little")
            + pt.Z.to_bytes(32, "little") + pt.T.to_bytes(32, "little"),
            dtype=np.uint8,
        )
    return out


def _raw_to_pt(raw: bytes | np.ndarray) -> RistrettoPoint:
    b = bytes(raw)
    return RistrettoPoint(
        int.from_bytes(b[0:32], "little"),
        int.from_bytes(b[32:64], "little"),
        int.from_bytes(b[64:96], "little"),
        int.from_bytes(b[96:128], "little"),
    )


def _gens_raw_u8(arr: np.ndarray) -> np.ndarray:
    """(n, 4, 16) uint16 gens storage -> (n, 128) uint8 view (LE)."""
    a = np.ascontiguousarray(arr, dtype="<u2")
    return a.view(np.uint8).reshape(arr.shape[0], 128)


_U8P = ctypes.POINTER(ctypes.c_uint8)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _rows(scalars) -> np.ndarray:
    if isinstance(scalars, np.ndarray):
        return np.ascontiguousarray(scalars)
    return scvec.from_scalars(list(scalars))


class NativeBackend:
    """C++ CPU backend (see module docstring).

    ``threads=1`` (default) is the measured single-core baseline proxy;
    ``threads=N`` (or 0 = all cores minus one) parallelizes the MSMs and
    IPP folds across cores for production CPU proving — the C calls
    release the GIL, so a plain thread pool scales.  Proof bytes are
    identical either way (partial-sum association only)."""

    def __init__(self, min_device_n: int = 1, threads: int = 1):
        assert _NATIVE is not None, "native library unavailable"
        import os as _os

        self.min_device_n = min_device_n
        self._lib = _NATIVE._lib
        self.threads = threads if threads > 0 else max(
            1, (_os.cpu_count() or 2) - 1
        )
        self._pool = None
        if self.threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.threads)

    def _split(self, n: int) -> list[tuple[int, int]]:
        t = min(self.threads, max(1, n // 2048))
        bounds = [n * i // t for i in range(t + 1)]
        return [(bounds[i], bounds[i + 1]) for i in range(t)]

    # ------------------------------------------------------------- MSM atoms
    def _msm_raw(self, rows: np.ndarray, coords: np.ndarray
                 ) -> RistrettoPoint:
        """One Pippenger MSM over contiguous (n,4) u64 rows and (n,128)
        uint8 coords (threaded over point ranges when threads > 1)."""
        n = len(rows)
        assert coords.shape[0] == n
        rows = np.ascontiguousarray(rows)
        coords = np.ascontiguousarray(coords)
        spans = self._split(n) if self._pool is not None else [(0, n)]
        if len(spans) == 1:
            out = np.empty(128, dtype=np.uint8)
            self._lib.ge_msm(scvec._ptr(rows), _ptr(coords), n, _ptr(out))
            return _raw_to_pt(out)

        def part(span):
            lo, hi = span
            out = np.empty(128, dtype=np.uint8)
            self._lib.ge_msm(
                scvec._ptr(rows[lo:hi]), _ptr(coords[lo:hi]), hi - lo,
                _ptr(out),
            )
            return _raw_to_pt(out)

        acc = RistrettoPoint.identity()
        for pt in self._pool.map(part, spans):
            acc = acc + pt
        return acc

    def _msm_segments(self, segs) -> RistrettoPoint:
        """Sum of per-segment MSMs (avoids concatenating big gens arrays;
        the lost cross-segment bucket sharing is a few thousand adds)."""
        acc = RistrettoPoint.identity()
        for rows, coords in segs:
            if len(rows) == 0:
                continue
            acc = acc + self._msm_raw(rows, coords)
        return acc

    def _fold_vec(self, var: bool, L, R, sL, sR, out, n: int) -> None:
        """out[i] = sL(*)L[i] + sR(*)R[i] over raw-coords views (threaded
        row ranges; rows are independent, so in-place out=L stays safe)."""
        fn = self._lib.ge_fold_vec_var if var else self._lib.ge_fold_vec
        spans = self._split(n) if self._pool is not None else [(0, n)]

        def run(span):
            lo, hi = span
            fn(
                _ptr(L[lo:hi]), _ptr(R[lo:hi]),
                scvec._ptr(sL[lo:hi] if var else sL),
                scvec._ptr(sR[lo:hi] if var else sR),
                _ptr(out[lo:hi]), hi - lo,
            )

        if len(spans) == 1:
            run(spans[0])
        else:
            list(self._pool.map(run, spans))

    def _scalar_mul(self, point_raw: np.ndarray, s: Scalar) -> RistrettoPoint:
        out = np.empty(128, dtype=np.uint8)
        self._lib.ge_scalar_mul_vec(
            _ptr(np.ascontiguousarray(point_raw)),
            scvec._ptr(scvec.from_scalars([s])),
            _ptr(out),
            1,
        )
        return _raw_to_pt(out)

    # ------------------------------------------------------------- MSM API
    def msm(self, scalars, points: list[RistrettoPoint]) -> RistrettoPoint:
        return self._msm_raw(_rows(scalars), _pts_to_raw(points))

    def msm_gens(
        self, scalars, head_points, gens_share, padded_n, tail_points
    ) -> RistrettoPoint:
        nh = len(head_points)
        rows = _rows(scalars)
        return self._msm_segments([
            (rows[:nh], _pts_to_raw(head_points)),
            (rows[nh : nh + padded_n], _gens_raw_u8(gens_share.G_raw(padded_n))),
            (rows[nh + padded_n : nh + 2 * padded_n],
             _gens_raw_u8(gens_share.H_raw(padded_n))),
            (rows[nh + 2 * padded_n :], _pts_to_raw(tail_points)),
        ])

    # -------------------------------------------------- prover commitments
    def phase_commitments(
        self, gens_share, a_L, a_R, a_O, s_L, s_R,
        i_blinding, o_blinding, s_blinding, B_blinding, offset,
    ):
        n = len(a_L)
        G = _gens_raw_u8(gens_share.G_raw(offset + n))[offset:]
        H = _gens_raw_u8(gens_share.H_raw(offset + n))[offset:]
        bb = _pts_to_raw([B_blinding])
        one = lambda s: scvec.from_scalars([s])
        A_I = self._msm_segments([
            (one(i_blinding), bb), (_rows(a_L), G), (_rows(a_R), H),
        ]).compress()
        A_O = self._msm_segments([
            (one(o_blinding), bb), (_rows(a_O), G),
        ]).compress()
        S = self._msm_segments([
            (one(s_blinding), bb), (_rows(s_L), G), (_rows(s_R), H),
        ]).compress()
        return A_I, A_O, S

    # ------------------------------------------------------------------ IPP
    def ipp_create(
        self, transcript, Q, G_factors, H_factors, gens_share, padded_n,
        a, b,
    ) -> InnerProductProof:
        """Mirror of :meth:`..core.ipp.InnerProductProof.create` (the dalek
        schedule: round-1 folds carry the outer G/H factors, later rounds
        fold by the bare challenge) with C++ MSMs and folds."""
        n = padded_n
        a = _rows(a).copy()
        b = _rows(b).copy()
        GF = _rows(G_factors)
        HF = _rows(H_factors)
        G = _gens_raw_u8(gens_share.G_raw(n)).copy()
        H = _gens_raw_u8(gens_share.H_raw(n)).copy()
        q_raw = _pts_to_raw([Q])

        L_vec: list[bytes] = []
        R_vec: list[bytes] = []
        first = True
        while n != 1:
            n //= 2
            a_L, a_R = a[:n], a[n:]
            b_L, b_R = b[:n], b[n:]
            c_L = scvec.inner(a_L, b_R)
            c_R = scvec.inner(a_R, b_L)
            if first:
                sG_L = scvec.mul(a_L, GF[n : 2 * n])
                sH_L = scvec.mul(b_R, HF[:n])
                sG_R = scvec.mul(a_R, GF[:n])
                sH_R = scvec.mul(b_L, HF[n : 2 * n])
            else:
                sG_L, sH_L, sG_R, sH_R = a_L, b_R, a_R, b_L
            L = self._msm_segments([
                (sG_L, G[n : 2 * n]), (sH_L, H[:n]),
            ]) + self._scalar_mul(q_raw, c_L)
            R = self._msm_segments([
                (sG_R, G[:n]), (sH_R, H[n : 2 * n]),
            ]) + self._scalar_mul(q_raw, c_R)
            L_c = L.compress()
            R_c = R.compress()
            L_vec.append(L_c)
            R_vec.append(R_c)
            transcript.append_point(b"L", L_c)
            transcript.append_point(b"R", R_c)
            u = transcript.challenge_scalar(b"u")
            u_inv = u.invert()
            a = scvec.axpby(a_L, u, a_R, u_inv)
            b = scvec.axpby(b_L, u_inv, b_R, u)
            if first:
                # per-element fold scalars (outer factors fold in here)
                fG_L = scvec.scale(GF[:n], u_inv)
                fG_R = scvec.scale(GF[n : 2 * n], u)
                fH_L = scvec.scale(HF[:n], u)
                fH_R = scvec.scale(HF[n : 2 * n], u_inv)
                self._fold_vec(True, G[:n], G[n : 2 * n], fG_L, fG_R,
                               G[:n], n)
                self._fold_vec(True, H[:n], H[n : 2 * n], fH_L, fH_R,
                               H[:n], n)
                first = False
            else:
                u_row = scvec.from_scalars([u])
                ui_row = scvec.from_scalars([u_inv])
                self._fold_vec(False, G[:n], G[n : 2 * n], ui_row, u_row,
                               G[:n], n)
                self._fold_vec(False, H[:n], H[n : 2 * n], u_row, ui_row,
                               H[:n], n)
        return InnerProductProof(
            L_vec, R_vec,
            scvec.row_to_scalar(a[0]), scvec.row_to_scalar(b[0]),
        )
