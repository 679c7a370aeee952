"""Batch proving, batch verification and multi-device paths on the real
XLA device path (small compiled shapes) over the virtual CPU devices."""

import functools

import jax
import pytest

import device_circuits as dc
from bulletproofs_r1cs_gadgets_tpu import batch_verify
from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError
from bulletproofs_r1cs_gadgets_tpu.core.proof import R1CSProof
from bulletproofs_r1cs_gadgets_tpu.parallel.batch import prove_provers
from bulletproofs_r1cs_gadgets_tpu.parallel.device_batch import (
    prove_provers_devices,
)

FAMILY = "bound_check"


def _provers(count, family=FAMILY):
    return [dc.prover_for(family, seed=10 + i) for i in range(count)]


@functools.lru_cache(maxsize=None)
def _host_bytes(count, family=FAMILY):
    return tuple(
        p.prove(dc.BP).to_bytes() for p, _ in _provers(count, family)
    )


@pytest.fixture(scope="module")
def four_devices():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    return devs[:4]


def test_prove_provers_device_backend_matches_host():
    made = _provers(3)
    proofs = prove_provers(
        [p for p, _ in made], dc.BP, backend=dc.small_device_backend()
    )
    assert tuple(p.to_bytes() for p in proofs) == _host_bytes(3)


def test_batch_verify_on_device_backend():
    made = _provers(3)
    proofs = [R1CSProof.from_bytes(b) for b in _host_bytes(3)]
    be = dc.small_device_backend()
    batch_verify(
        [dc.verifier_for(FAMILY, c) for _, c in made], proofs, dc.PC, dc.BP,
        backend=be,
    )
    raw = bytearray(_host_bytes(3)[2])
    raw[-32] ^= 1
    proofs[2] = R1CSProof.from_bytes(bytes(raw))
    with pytest.raises(VerificationError, match=r"indices: \[2\]"):
        batch_verify(
            [dc.verifier_for(FAMILY, c) for _, c in made], proofs, dc.PC,
            dc.BP, backend=be,
        )


def test_prove_provers_devices_on_four_devices(four_devices):
    # one-multiplier proofs: each device compiles its own executables
    made = _provers(4, "factors")
    placed = prove_provers_devices(
        [p for p, _ in made], dc.BP, devices=four_devices,
        backend_factory=dc.small_device_backend,
    )
    assert tuple(p.to_bytes() for p in placed) == _host_bytes(4, "factors")


def test_sharded_msm_backend_on_four_devices(four_devices):
    """The points axis: one MSM sharded over a 1x4 mesh equals the
    single-device result and the host oracle."""
    from bulletproofs_r1cs_gadgets_tpu.core import scvec
    from bulletproofs_r1cs_gadgets_tpu.core.ristretto import multiscalar_mul
    from bulletproofs_r1cs_gadgets_tpu.parallel.mesh import make_mesh
    from bulletproofs_r1cs_gadgets_tpu.parallel.sharded_backend import (
        ShardedMsmBackend,
    )

    mesh = make_mesh(4, batch_axis=1, axis_names=("batch", "points"))
    sharded = ShardedMsmBackend(mesh, min_device_n=1, chunk=32, window=2)
    n = 40
    points = dc.BP.share(0).G(n)
    rows = scvec.from_ints([(7919 * i + 3) ** 5 for i in range(n)])
    want = multiscalar_mul(scvec.to_scalars(rows), points)
    assert sharded.msm(rows, points) == want
    assert dc.small_device_backend().msm(rows, points) == want
