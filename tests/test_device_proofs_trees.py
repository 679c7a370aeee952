"""DeviceBackend proofs of the hash and tree circuits through the real XLA path (small
compiled shapes on the CPU): byte-identical to the host path, verified by
the DeviceBackend, and a tampered proof rejected by it."""

import functools

import pytest

import device_circuits as dc
from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError
from bulletproofs_r1cs_gadgets_tpu.core.proof import R1CSProof

FAMILIES = ["poseidon2_cube", "poseidon2_inverse", "vsmt2", "vsmt4"]


@functools.lru_cache(maxsize=None)
def _backend():
    return dc.small_device_backend()


@functools.lru_cache(maxsize=None)
def _device_proof(family):
    return dc.prove(family, _backend())


@pytest.mark.parametrize("family", FAMILIES)
def test_device_proof_matches_host_and_verifies(family):
    proof, comms = _device_proof(family)
    host, _ = dc.prove(family, None)
    assert proof.to_bytes() == host.to_bytes()
    dc.verify(family, proof, comms, _backend())


@pytest.mark.parametrize("family", FAMILIES)
def test_device_verify_rejects_tampered_proof(family):
    proof, comms = _device_proof(family)
    raw = bytearray(proof.to_bytes())
    raw[-32] ^= 1  # the IPP's final b scalar
    with pytest.raises(VerificationError):
        dc.verify(family, R1CSProof.from_bytes(bytes(raw)), comms, _backend())
