"""bulletproofs_r1cs_gadgets_tpu: an accelerator Bulletproofs R1CS proving
framework with the full gadget zoo of lovesh/bulletproofs-r1cs-gadgets.

Layers (bottom up, mirroring SURVEY.md S1):
  core/     -- proof engine: scalar field, ristretto group, Merlin transcript,
               R1CS prover/verifier, inner-product argument (L0)
  ops/      -- device compute (jax.numpy): limb field arithmetic, curve
               arithmetic, windowed MSM, batched Poseidon; DeviceBackend
  gadgets/  -- R1CS gadget zoo (L1-L3)
  models/   -- authenticated data structures: sparse Merkle trees (L4)
  parallel/ -- mesh sharding + batched proving
  utils/    -- constants, stats, config
"""

from .core.scalar import Scalar
from .core.ristretto import RistrettoPoint
from .core.transcript import Transcript
from .core.pedersen import PedersenGens, BulletproofGens
from .core.prover import Prover
from .core.verifier import Verifier, batch_verify
from .core.proof import R1CSProof
from .core.linear_combination import Variable, LinearCombination
from .core import errors

__all__ = [
    "Scalar", "RistrettoPoint", "Transcript", "PedersenGens",
    "BulletproofGens", "Prover", "Verifier", "batch_verify", "R1CSProof",
    "Variable", "LinearCombination", "errors",
]
__version__ = "0.1.0"
