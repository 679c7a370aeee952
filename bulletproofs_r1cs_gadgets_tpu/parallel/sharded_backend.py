"""Multi-device MSM sharding: a proof-engine backend whose every device MSM
partitions the point axis over a ``jax.sharding.Mesh``.

This is the tensor-parallel axis of SURVEY.md §2b N10: the same
``Prover.prove`` / ``Verifier.verify`` calls that run on one device route
their phase commitments, IPP L/R MSMs and the verifier combined MSM through
``shard_map`` — each device computes a windowed partial MSM over its point
shard, the (4, 23)-limb partial sums ride one ``all_gather``, and the
handful of partials fold locally (point addition is not a ``psum``-able
monoid over int32 lanes, so the gather+fold costs a few hundred bytes and
log-n adds).

Built on the XLA-composed kernels (:mod:`..ops.msm`), so the identical
code runs on a ``--xla_force_host_platform_device_count`` CPU mesh and on a
mesh of GPUs.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PSpec

from ..core.ipp import InnerProductProof
from ..ops.backend import DeviceBackend, _bits_rows, _fold_with_scalars_jit
from ..ops.field import STORE
from ..ops.curve import point_add, identity_points, points_from_device
from ..ops.msm import _add, msm_chunk_impl, scalars_to_digits


@jax.jit
def _fold_batch(left, right, bits_l, bits_r):
    """Batched double-scalar generator fold: (B, n, 4, S) stacks folded
    with per-job per-element scalar bits (B, n, 253)."""
    return jax.vmap(_fold_with_scalars_jit)(left, right, bits_l, bits_r)


class ShardedMsmBackend(DeviceBackend):
    """DeviceBackend with the point axis of every MSM sharded over a mesh.

    ``mesh`` must have the named axis ``axis`` (default ``"points"``); all
    other backend behaviour (host fallbacks for small circuits, generator
    caching, IPP folds) is inherited.

    Every MSM is dispatched as identity-padded fixed-size chunks so the
    ``shard_map`` graph compiles for exactly ONE shape regardless of the
    proof's MSM size schedule (the prover + IPP + verifier mega-MSM span
    ~10 distinct sizes; per-shape XLA compiles would dominate CPU-mesh
    test time and cold starts alike).  ``window`` sizes the in-kernel
    multiple table: 4 by default; the CPU mesh tests pass 2 to keep the
    compiled graph small.
    """

    def __init__(self, mesh: Mesh, axis: str = "points", **kw):
        """``kw``: the DeviceBackend shape arguments (``min_device_n``,
        ``chunk``, ``window``, ``fold_chunk``)."""
        super().__init__(**kw)
        chunk, window = self.chunk, self.window
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        assert chunk % self.n_shards == 0

        def sharded_msm(points, digits):
            # per-shard partial over the local point slice
            part = msm_chunk_impl(points, digits, window)  # (4, STORE)
            parts = jax.lax.all_gather(part, axis)  # (n_shards, 4, STORE)
            total = parts[0]
            for i in range(1, self.n_shards):
                total = point_add(total, parts[i])
            return total

        self._sharded_msm = jax.jit(
            jax.shard_map(
                sharded_msm,
                mesh=mesh,
                in_specs=(PSpec(axis), PSpec(axis)),
                out_specs=PSpec(),
                check_vma=False,
            )
        )

    def _msm_dev(self, scalars, dev: jnp.ndarray) -> jnp.ndarray:
        n = dev.shape[0]
        digits = scalars_to_digits(scalars, self.window)
        nwin = digits.shape[1]
        # identity-pad the point axis to a multiple of the chunk size
        # (zero digits select the identity, so padding is free) and
        # dispatch per chunk: one compiled shard_map shape serves every
        # MSM in the engine.
        m = -(-n // self.chunk) * self.chunk
        if m != n:
            pad_pts = jnp.broadcast_to(
                identity_points(()), (m - n, 4, STORE)
            )
            dev = jnp.concatenate([dev, pad_pts], axis=0)
            digits = np.concatenate(
                [digits, np.zeros((m - n, nwin), dtype=digits.dtype)]
            )
        digits = jnp.asarray(digits)
        total = None
        for off in range(0, m, self.chunk):
            part = self._sharded_msm(
                dev[off : off + self.chunk],
                digits[off : off + self.chunk],
            )
            total = part if total is None else _add(total, part)
        return total


class BatchShardedBackend(ShardedMsmBackend):
    """Two-axis SPMD proving over a ``(batch, points)`` mesh: B independent
    same-shape proofs ride the ``batch`` axis as pure data parallelism (no
    collectives — proofs share nothing), while each proof's MSMs partition
    their point axis over ``points`` with the inherited all_gather+fold.

    This composes the two axes of SURVEY.md §2b N10a + N10b.  Per IPP
    round the device computes all B L/R pairs in one SPMD dispatch; the
    B Fiat-Shamir transcripts advance on the host between rounds (64
    bytes per proof per round — the same host/device split as the
    single-proof path).

    Jobs must share one circuit shape (same padded_n and generator set);
    heterogeneous batches fall back to the sequential per-job path.
    """

    def __init__(self, mesh: Mesh, batch_axis: str = "batch", **kw):
        super().__init__(mesh, **kw)
        self.batch_axis = batch_axis
        self.n_batch = mesh.shape[batch_axis]

        def msm_b(points, digits):
            # local shards: points (Bl, nl, 4, S), digits (Bl, nl, W)
            part = jax.vmap(
                lambda p, d: msm_chunk_impl(p, d, self.window)
            )(points, digits)  # (Bl, 4, S)
            parts = jax.lax.all_gather(part, self.axis)  # (ps, Bl, 4, S)
            total = parts[0]
            for i in range(1, self.n_shards):
                total = point_add(total, parts[i])
            return total

        self._sharded_msm_batch = jax.jit(
            jax.shard_map(
                msm_b,
                mesh=mesh,
                in_specs=(
                    PSpec(batch_axis, self.axis),
                    PSpec(batch_axis, self.axis),
                ),
                out_specs=PSpec(batch_axis),
                check_vma=False,
            )
        )

    # ------------------------------------------------------------ helpers
    def _msm_dev_batch(
        self, digits_b: np.ndarray, points_b: jnp.ndarray
    ) -> jnp.ndarray:
        """B same-size MSMs in one SPMD dispatch series: digits_b
        (B, n, W) uint8, points_b (B, n, 4, STORE) -> (B, 4, STORE)."""
        B, n = digits_b.shape[0], digits_b.shape[1]
        m = -(-n // self.chunk) * self.chunk
        if m != n:
            pad_pts = jnp.broadcast_to(
                identity_points(()), (B, m - n, 4, STORE)
            )
            points_b = jnp.concatenate([points_b, pad_pts], axis=1)
            digits_b = np.concatenate(
                [digits_b,
                 np.zeros((B, m - n, digits_b.shape[2]), digits_b.dtype)],
                axis=1,
            )
        digits_b = jnp.asarray(digits_b)
        total = None
        for off in range(0, m, self.chunk):
            part = self._sharded_msm_batch(
                points_b[:, off : off + self.chunk],
                digits_b[:, off : off + self.chunk],
            )
            total = part if total is None else _add(total, part)
        return total

    def _digits_rows(self, rows_list: list) -> np.ndarray:
        """B scalar vectors — (n, 4) u64 arrays (vectorized digit split)
        or lists of Scalars/ints — -> (B, n, W) window digits."""
        out = []
        for rows in rows_list:
            if not isinstance(rows, np.ndarray):
                rows = [s.v if hasattr(s, "v") else int(s) for s in rows]
            out.append(scalars_to_digits(rows, self.window))
        return np.stack(out)

    @staticmethod
    def _jobs_uniform(ns: list, genses: list) -> bool:
        return len(set(ns)) == 1 and len({id(g) for g in genses}) == 1

    # ----------------------------------------------------- batched phase 1
    def phase_commitments_batch(self, jobs: list[tuple]) -> list[tuple]:
        from ..core import scvec as _scvec

        def rows(x):
            return (
                np.ascontiguousarray(x) if isinstance(x, np.ndarray)
                else _scvec.from_scalars(list(x))
            )

        norm = []
        for job in jobs:
            (gens_share, a_L, a_R, a_O, s_L, s_R,
             i_b, o_b, s_b, B_blinding, offset) = job
            norm.append((gens_share, rows(a_L), rows(a_R), rows(a_O),
                         rows(s_L), rows(s_R), i_b, o_b, s_b, B_blinding,
                         offset))
        ns = [len(j[1]) for j in norm]
        if (
            not self._jobs_uniform(ns, [j[0]._gens for j in norm])
            or any(j[10] != 0 for j in norm)
            or ns[0] < self.min_device_n
            or len(norm) % self.n_batch != 0
        ):
            return [self.phase_commitments(*job) for job in jobs]
        n = ns[0]
        B = len(norm)
        gens_share = norm[0][0]
        G_dev = self._gens_device(gens_share, n, "G")
        H_dev = self._gens_device(gens_share, n, "H")
        GH_b = jnp.broadcast_to(
            jnp.concatenate([G_dev, H_dev], axis=0)[None],
            (B, 2 * n, 4, STORE),
        )
        G_b = jnp.broadcast_to(G_dev[None], (B, n, 4, STORE))
        AI_b = self._msm_dev_batch(
            self._digits_rows(
                [np.concatenate([j[1], j[2]]) for j in norm]
            ),
            GH_b,
        )
        AO_b = self._msm_dev_batch(self._digits_rows([j[3] for j in norm]),
                                   G_b)
        S_b = self._msm_dev_batch(
            self._digits_rows(
                [np.concatenate([j[4], j[5]]) for j in norm]
            ),
            GH_b,
        )
        AI = points_from_device(AI_b)
        AO = points_from_device(AO_b)
        S = points_from_device(S_b)
        out = []
        for j, (gens_share, *_rest) in enumerate(norm):
            _, _, _, _, _, _, i_b, o_b, s_b, Bb, _ = norm[j]
            out.append((
                (AI[j] + Bb.scalar_mul(i_b)).compress(),
                (AO[j] + Bb.scalar_mul(o_b)).compress(),
                (S[j] + Bb.scalar_mul(s_b)).compress(),
            ))
        return out

    # --------------------------------------------------------- batched IPP
    def ipp_create_batch(self, jobs: list[tuple]) -> list:
        """All per-round scalar math runs on the C++ scvec layer over
        (n, 4) u64 arrays — no per-element Python list comprehensions:
        folds are ``scvec.axpby``/``scvec.mul``, digit splits use the vectorized byte-view path, and the fold-bit
        matrices come from one ``np.unpackbits`` per vector."""
        from ..core import scvec as _scvec

        def rows(x):
            return (
                np.ascontiguousarray(x) if isinstance(x, np.ndarray)
                else _scvec.from_scalars(list(x))
            )

        norm = [
            (t, Q, rows(gf), rows(hf), gens_share, padded_n, rows(a),
             rows(b))
            for (t, Q, gf, hf, gens_share, padded_n, a, b) in
            (job[:8] for job in jobs)
        ]
        ns = [j[5] for j in norm]
        if (
            not self._jobs_uniform(ns, [j[4]._gens for j in norm])
            or ns[0] < self.min_device_n
            or len(norm) % self.n_batch != 0
        ):
            return [self.ipp_create(*job) for job in jobs]
        n = ns[0]
        B = len(norm)
        gens_share = norm[0][4]
        # per-job generator stacks (every job folds with its own challenges)
        G_dev = self._gens_device(gens_share, n, "G")
        H_dev = self._gens_device(gens_share, n, "H")
        G_b = jnp.broadcast_to(G_dev[None], (B, n, 4, STORE))
        H_b = jnp.broadcast_to(H_dev[None], (B, n, 4, STORE))
        st = [
            {"t": t, "Q": Q, "gf": gf, "hf": hf, "a": a, "b": b,
             "L": [], "R": []}
            for (t, Q, gf, hf, _gs, _n, a, b) in norm
        ]
        first = True
        while n != 1:
            n //= 2
            # host: this round's MSM scalars + Q coefficients per job
            scL_rows, scR_rows, cLs, cRs = [], [], [], []
            for s in st:
                a_L, a_R = s["a"][:n], s["a"][n:]
                b_L, b_R = s["b"][:n], s["b"][n:]
                cLs.append(_scvec.inner(a_L, b_R))
                cRs.append(_scvec.inner(a_R, b_L))
                if first:
                    gf, hf = s["gf"], s["hf"]
                    scL_rows.append(np.concatenate([
                        _scvec.mul(a_L, gf[n : 2 * n]),
                        _scvec.mul(b_R, hf[:n]),
                    ]))
                    scR_rows.append(np.concatenate([
                        _scvec.mul(a_R, gf[:n]),
                        _scvec.mul(b_L, hf[n : 2 * n]),
                    ]))
                else:
                    scL_rows.append(np.concatenate([a_L, b_R]))
                    scR_rows.append(np.concatenate([a_R, b_L]))
                s["halves"] = (a_L, a_R, b_L, b_R)
            # device: all B L and R points in two SPMD dispatch series
            ptsL_b = jnp.concatenate([G_b[:, n:], H_b[:, :n]], axis=1)
            ptsR_b = jnp.concatenate([G_b[:, :n], H_b[:, n:]], axis=1)
            L_b = self._msm_dev_batch(self._digits_rows(scL_rows), ptsL_b)
            R_b = self._msm_dev_batch(self._digits_rows(scR_rows), ptsR_b)
            L_pts = points_from_device(L_b)
            R_pts = points_from_device(R_b)
            # host: transcripts advance independently; collect fold bits
            bits_gl, bits_gr, bits_hl, bits_hr = [], [], [], []
            for j, s in enumerate(st):
                L_c = (L_pts[j] + s["Q"].scalar_mul(cLs[j])).compress()
                R_c = (R_pts[j] + s["Q"].scalar_mul(cRs[j])).compress()
                s["L"].append(L_c)
                s["R"].append(R_c)
                s["t"].append_point(b"L", L_c)
                s["t"].append_point(b"R", R_c)
                u = s["t"].challenge_scalar(b"u")
                u_inv = u.invert()
                a_L, a_R, b_L, b_R = s["halves"]
                s["a"] = _scvec.axpby(a_L, u, a_R, u_inv)
                s["b"] = _scvec.axpby(b_L, u_inv, b_R, u)
                if first:
                    gf, hf = s["gf"], s["hf"]
                    gl = _scvec.scale(gf[:n], u_inv)
                    gr = _scvec.scale(gf[n : 2 * n], u)
                    hl = _scvec.scale(hf[:n], u)
                    hr = _scvec.scale(hf[n : 2 * n], u_inv)
                else:
                    gl = np.tile(_scvec.scalar_to_row(u_inv), (n, 1))
                    gr = np.tile(_scvec.scalar_to_row(u), (n, 1))
                    hl, hr = gr, gl
                bits_gl.append(_bits_rows(gl))
                bits_gr.append(_bits_rows(gr))
                bits_hl.append(_bits_rows(hl))
                bits_hr.append(_bits_rows(hr))
            # device: fold all B generator stacks in one batched dispatch
            G_b = _fold_batch(
                G_b[:, :n], G_b[:, n:],
                jnp.asarray(np.stack(bits_gl)), jnp.asarray(np.stack(bits_gr)),
            )
            H_b = _fold_batch(
                H_b[:, :n], H_b[:, n:],
                jnp.asarray(np.stack(bits_hl)), jnp.asarray(np.stack(bits_hr)),
            )
            first = False
        return [
            InnerProductProof(
                s["L"], s["R"],
                _scvec.row_to_scalar(s["a"][0]),
                _scvec.row_to_scalar(s["b"][0]),
            )
            for s in st
        ]
