"""Batched Poseidon permutation on the device.

The native/circuit Poseidon pair lives in ``gadgets/poseidon.py`` (host,
reference-exact); this module is the *throughput* path: thousands of
independent permutations per call, e.g. bulk sparse-Merkle-tree node hashing
(SURVEY.md CS-5) and batched witness generation.

State is (batch, width, 23) FQ limbs (see ops/field.py).  The round loop is
a ``lax.scan`` over a precomputed (rounds, width, 23) round-key array with a
static full/partial round mask, so the compiled graph is one round long.
Cube S-box only costs 2 muls; the inverse S-box needs a 252-step Fermat
ladder per round (it is what the reference uses for all trees - the batch
axis is what makes it pay on the device).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .field import FQ, STORE, int_to_limbs
from ..gadgets.poseidon_params import PoseidonParams


class DevicePoseidon:
    """Compiled batched permutation for fixed parameters."""

    def __init__(self, params: PoseidonParams, sbox: str = "inverse"):
        assert sbox in ("cube", "inverse")
        self.params = params
        self.sbox = sbox
        self.width = params.width
        total = params.get_total_rounds()
        rk = np.zeros((total, self.width, STORE), dtype=np.int32)
        for r in range(total):
            for i in range(self.width):
                rk[r, i] = int_to_limbs(params.round_keys[r * self.width + i].v)
        self._round_keys = jnp.asarray(rk)
        mds = np.zeros((self.width, self.width, STORE), dtype=np.int32)
        for i in range(self.width):
            for j in range(self.width):
                mds[i, j] = int_to_limbs(params.MDS_matrix[i][j].v)
        self._mds = jnp.asarray(mds)
        # full-round mask per round (1 = all lanes get the S-box)
        fb, pr, fe = (
            params.full_rounds_beginning,
            params.partial_rounds,
            params.full_rounds_end,
        )
        self._full_mask = jnp.asarray(
            [1] * fb + [0] * pr + [1] * fe, dtype=jnp.int32
        )
        self._permute = jax.jit(self._permute_impl)

    def _sbox_apply(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.sbox == "cube":
            return FQ.mul(FQ.square(x), x)
        return FQ.inv(x)

    def _permute_impl(self, state: jnp.ndarray) -> jnp.ndarray:
        width = self.width

        def round_fn(st, inputs):
            keys, full = inputs  # (width, STORE), scalar
            st = FQ.add(st, jnp.broadcast_to(keys, st.shape))
            sboxed = self._sbox_apply(st)
            # full round: sbox everywhere; partial: only last lane
            last_only = jnp.concatenate(
                [st[..., : width - 1, :], sboxed[..., width - 1 :, :]], axis=-2
            )
            st = jnp.where(full > 0, sboxed, last_only)
            # MDS: st'[i] = sum_j M[i][j] * st[j]
            prod = FQ.mul(
                self._mds[None, ...],  # (1, w, w, S)
                st[..., None, :, :],  # (B, 1, w, S)
            )  # (B, w, w, S)
            st = prod.sum(axis=-2)
            st = FQ._reduce(st)
            return st, None

        out, _ = lax.scan(round_fn, state, (self._round_keys, self._full_mask))
        return out

    def permute(self, state: jnp.ndarray) -> jnp.ndarray:
        """(batch, width, STORE) -> same, one full permutation."""
        return self._permute(state)

    # convenience: batched 2:1 hash (input layout of gadget_poseidon.rs:428)
    def hash_2(self, xl: jnp.ndarray, xr: jnp.ndarray) -> jnp.ndarray:
        b = xl.shape[0]
        zero = jnp.zeros((b, STORE), dtype=jnp.int32)
        pad = jnp.broadcast_to(FQ.constant(101), (b, STORE))
        state = jnp.stack([zero, xl, xr, pad, zero, zero], axis=1)
        return self.permute(state)[:, 1, :]

    def hash_4(self, x: jnp.ndarray) -> jnp.ndarray:
        """x: (batch, 4, STORE) -> (batch, STORE)."""
        b = x.shape[0]
        zero = jnp.zeros((b, 1, STORE), dtype=jnp.int32)
        pad = jnp.broadcast_to(FQ.constant(101), (b, 1, STORE))
        state = jnp.concatenate([zero, x, pad], axis=1)
        return self.permute(state)[:, 1, :]
