"""Sharded proving pipeline building blocks.

``proving_step`` is the computational heart of batched proving expressed
as one jittable function over the REAL flagship primitives:

* witness transform — a batched Poseidon Merkle-path recompute (width 6,
  rounds 4+140+4: the VSMT-2 hash geometry of ``models/vsmt2.py`` /
  reference ``gadget_vsmt_2.rs``) folding each proof's leaf up its path
  with ``DevicePoseidon.hash_2``.  The cube S-box variant (reference
  ``SboxType::Cube``) is used here: the inverse S-box's 253-step Fermat
  ladder is serial per round (~50 s per tiny batch on a CPU mesh), while
  cube is 2 muls — the proving stack itself (bench stages 2-4) runs the
  inverse S-box end-to-end;
* partial MSM — a points-sharded commitment partial whose per-device
  partial sums are combined with an all-gather and local group additions
  (point addition is not a ``psum``-able monoid over int32 lanes, but the
  4x23-limb partials are tiny).

``make_sharded_step(mesh)`` wraps it in ``shard_map`` with
  witness:  P('batch')          (dp: each shard hashes its own proofs)
  points:   P('points')         (tensor-parallel MSM shard)
  bits:     P('points')
and a ``psum`` over the batch axis for the digest checksum, exercising
both mesh axes and both collective types.  ``tests/test_parallel.py``
checks the step against the host Poseidon + MSM oracles on the 8-device
CPU mesh; ``__graft_entry__.entry`` returns the single-device step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as PSpec

from ..ops.field import FQ, STORE
from ..ops.curve import scalar_mul_bits, tree_reduce, point_add
from ..ops.poseidon import DevicePoseidon
from ..gadgets.poseidon_params import PoseidonParams

_HASHER = None


def flagship_hasher() -> DevicePoseidon:
    """The VSMT-2 hash geometry (width 6, rounds 4+140+4) with the cube
    S-box (see module docstring) as a batched device permutation; built
    once per process."""
    global _HASHER
    if _HASHER is None:
        _HASHER = DevicePoseidon(PoseidonParams(6, 4, 4, 140), sbox="cube")
    return _HASHER


def witness_transform(witness: jnp.ndarray) -> jnp.ndarray:
    """Batched Merkle-path recompute: (B, W, STORE) FQ limbs — per proof,
    lane 0 is the leaf and lanes 1..W-1 the path nodes — folded with the
    real Poseidon 2:1 hash: acc <- H(acc, node_i).  Returns (B, STORE)
    root digests.  This is the witness side of a VSMT-2 membership proof
    batch (models/vsmt2.py:35-158)."""
    h = flagship_hasher()
    acc = witness[:, 0, :]
    for i in range(1, witness.shape[1]):
        acc = h.hash_2(acc, witness[:, i, :])
    return acc


def partial_msm(points: jnp.ndarray, bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 4, STORE) x (N, nbits) -> (4, STORE) partial commitment."""
    return tree_reduce(scalar_mul_bits(points, bits))


def proving_step(witness, points, bits):
    """Single-device reference step (also the __graft_entry__ forward fn)."""
    digest = witness_transform(witness)
    commitment = partial_msm(points, bits)
    return digest, commitment


def make_sharded_step(mesh):
    """Full step over the mesh: dp witness hashing + tp MSM + collectives."""
    flagship_hasher()  # construct eagerly: its constant arrays must not be
    # created inside the shard_map trace (they would leak as tracers)

    def step(witness, points, bits):
        # dp: per-shard witness digests, then a batch-axis psum checksum
        digest = witness_transform(witness)
        checksum = lax.psum(jnp.sum(digest, axis=0), "batch")

        # tp: per-shard partial MSM, all-gather partials, fold locally
        part = partial_msm(points, bits)
        parts = lax.all_gather(part, "points")  # (n_shards, 4, STORE)
        total = parts[0]
        for i in range(1, parts.shape[0]):
            total = point_add(total, parts[i])
        return digest, checksum, total

    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(
                PSpec("batch"),
                PSpec("points"),
                PSpec("points"),
            ),
            out_specs=(
                PSpec("batch"),
                PSpec(),
                PSpec(),
            ),
            check_vma=False,
        )
    )
