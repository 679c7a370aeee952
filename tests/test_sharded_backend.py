"""Sharded-MSM backend on the virtual 8-device CPU mesh: real proofs, not
toy MSMs.

Every device MSM of the prover AND verifier is partitioned over the mesh's
``points`` axis; results must verify and also match the host backend's
byte-level Fiat-Shamir schedule (same circuit, same witness, different
blinding — so we check verification, not proof bytes).
"""

import numpy as np
import jax
import pytest

from bulletproofs_r1cs_gadgets_tpu import (
    BulletproofGens,
    PedersenGens,
    Prover,
    Scalar,
    Transcript,
    Verifier,
)
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import multiscalar_mul
from bulletproofs_r1cs_gadgets_tpu.gadgets.bound_check import (
    gen_proof_of_bounded_num,
    verify_proof_of_bounded_num,
)
from bulletproofs_r1cs_gadgets_tpu.parallel.mesh import make_mesh
from bulletproofs_r1cs_gadgets_tpu.parallel.sharded_backend import (
    ShardedMsmBackend,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return make_mesh(8, batch_axis=1, axis_names=("batch", "points"))


@pytest.fixture(scope="module")
def backend(mesh):
    # low threshold so the small test circuits actually exercise the
    # sharded device path; small fixed chunk + 2-bit window keep the ONE
    # compiled shard_map shape cheap to build on the CPU mesh
    return ShardedMsmBackend(mesh, min_device_n=64, chunk=256, window=2)


@pytest.mark.mesh_slow
def test_sharded_msm_matches_host(backend):
    import random

    rnd = random.Random(11)
    B = PedersenGens.default().B
    pts = [B.scalar_mul(Scalar(i + 2)) for i in range(100)]
    scalars = [Scalar(rnd.randrange(1 << 252)) for _ in range(100)]
    got = backend.msm(scalars, pts)
    assert got == multiscalar_mul(scalars, pts)


@pytest.mark.mesh_slow
def test_sharded_bound_check_roundtrip(backend):
    """Full prove -> verify of the 64-bit bound-check gadget (128
    multipliers) with every MSM sharded across 8 devices."""
    pc_gens = PedersenGens.default()
    bp_gens = BulletproofGens(256)
    proof, comms = gen_proof_of_bounded_num(
        42, None, 10, 100, 32, b"BoundsTest", pc_gens, bp_gens,
        backend=backend,
    )
    verify_proof_of_bounded_num(
        10, 100, 32, proof, comms, b"BoundsTest", pc_gens, bp_gens,
        backend=backend,
    )


@pytest.mark.mesh_slow
def test_sharded_prover_host_verifier(backend):
    """Proof produced with the sharded backend must verify on the plain
    host path (byte-level Fiat-Shamir equivalence of the backends)."""
    pc_gens = PedersenGens.default()
    bp_gens = BulletproofGens(256)
    proof, comms = gen_proof_of_bounded_num(
        77, None, 0, 1000, 32, b"BoundsTest", pc_gens, bp_gens,
        backend=backend,
    )
    verify_proof_of_bounded_num(
        0, 1000, 32, proof, comms, b"BoundsTest", pc_gens, bp_gens,
        backend=None,
    )


def _bc_build(lower, upper, bits):
    """build_circuit for parallel.batch over the bound-check gadget."""
    from bulletproofs_r1cs_gadgets_tpu.gadgets.bound_check import (
        bound_check_gadget,
    )
    from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import (
        AllocatedQuantity,
    )
    from bulletproofs_r1cs_gadgets_tpu.core.prover import Prover

    def build(cs, w):
        if isinstance(cs, Prover):
            val = w
            a, b = val - lower, upper - val
            comms = []
            com_v, var_v = cs.commit(Scalar(val), Scalar.random())
            com_a, var_a = cs.commit(Scalar(a), Scalar.random())
            com_b, var_b = cs.commit(Scalar(b), Scalar.random())
            comms += [com_v, com_a, com_b]
            qs = [
                AllocatedQuantity(var_v, val),
                AllocatedQuantity(var_a, a),
                AllocatedQuantity(var_b, b),
            ]
        else:
            comms = w
            qs = [AllocatedQuantity(cs.commit(c)) for c in comms]
        bound_check_gadget(cs, *qs, upper, lower, bits)
        return comms

    return build


@pytest.mark.mesh_slow
def test_batch_dp_sharded_proving(mesh):
    """B=4 same-shape proofs in SPMD lockstep over a (batch=4, points=2)
    mesh (BatchShardedBackend): one batched shard_map dispatch series per
    IPP round for all four proofs, per-proof transcripts on host.  Each
    proof must verify on the plain HOST path (byte-level Fiat-Shamir
    equivalence), and a corrupted witness batch must fail."""
    from bulletproofs_r1cs_gadgets_tpu.parallel.batch import (
        prove_batch,
        verify_batch,
    )
    from bulletproofs_r1cs_gadgets_tpu.parallel.sharded_backend import (
        BatchShardedBackend,
    )

    mesh42 = make_mesh(8, batch_axis=4)
    backend = BatchShardedBackend(mesh42, min_device_n=64, chunk=256,
                                  window=2)
    pc_gens = PedersenGens.default()
    bp_gens = BulletproofGens(256)
    build = _bc_build(10, 100, 32)
    res = prove_batch(
        pc_gens, bp_gens, b"BatchDP", [11, 42, 99, 63], build,
        backend=backend,
    )
    assert len(res.proofs) == 4
    # host-path verification of every proof (FS equivalence across paths)
    verify_batch(
        pc_gens, bp_gens, b"BatchDP", res, build, backend=None,
        combined=False,
    )
    # combined single-MSM verification through the sharded backend too
    verify_batch(
        pc_gens, bp_gens, b"BatchDP", res, build, backend=backend,
        combined=True,
    )
    # negative: swap two proofs' commitment lists -> both equations break
    import pytest as _pytest
    from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError

    bad = type(res)(res.proofs, [res.commitments[1], res.commitments[0],
                                 res.commitments[2], res.commitments[3]])
    with _pytest.raises(VerificationError):
        verify_batch(pc_gens, bp_gens, b"BatchDP", bad, build, backend=None,
                     combined=False)
