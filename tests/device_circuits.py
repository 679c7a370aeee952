"""One small seeded circuit per gadget family, for proving the same
statement through several backends and comparing proof bytes.

``prove(family, backend)`` builds a fresh prover whose private randomness
(commitment blindings and the prover's own rng) comes from a fixed seed,
so two backends must yield byte-identical proofs.  ``verify(family, proof,
comms, backend)`` re-synthesizes the verifier side.
"""

from __future__ import annotations

import numpy as np

from bulletproofs_r1cs_gadgets_tpu import (
    BulletproofGens, PedersenGens, Prover, Scalar, Transcript, Verifier,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.bound_check import (
    bound_check_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.factors import factors_gadget
from bulletproofs_r1cs_gadgets_tpu.gadgets.mimc import mimc_gadget
from bulletproofs_r1cs_gadgets_tpu.gadgets.not_equals import (
    not_equals_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.poseidon import (
    Poseidon_hash_2,
    Poseidon_hash_2_gadget,
    PoseidonParams,
    SboxType,
    allocate_statics_for_prover,
    allocate_statics_for_verifier,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import (
    AllocatedQuantity,
    AllocatedScalar,
    constrain_lc_with_scalar,
    positive_no_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.set_membership import (
    bit_gadget,
    vector_product_gadget,
    vector_sum_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.set_membership_1 import (
    set_membership_1_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.set_non_membership import (
    set_non_membership_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.zero_nonzero import (
    is_nonzero_gadget,
    is_zero_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.models.compiled import (
    CompiledVSMT2,
    CompiledVSMT4,
)
from bulletproofs_r1cs_gadgets_tpu.models.vsmt2 import leaf_index_bit_scalars

PC = PedersenGens.default()
BP = BulletproofGens(256)
SET = [2, 3, 5, 7]
MIMC_ROUNDS = 8
MIMC_CONSTANTS = [Scalar(1000 + 7 * i) for i in range(MIMC_ROUNDS)]
HASH_PARAMS = PoseidonParams(6, 1, 1, 1)


def _commit_all(cs, values, arg):
    """Commit ``values`` (prover: ``arg`` is the rng) or re-bind the
    commitments ``arg`` (verifier); returns (variables, comms)."""
    if isinstance(cs, Prover):
        pairs = [cs.commit(Scalar(v), Scalar.random(arg)) for v in values]
        return [var for _, var in pairs], [com for com, _ in pairs]
    return [cs.commit(c) for c in arg], arg


def _factors(cs, arg):
    (vp, vq), comms = _commit_all(cs, [17, 19], arg)
    factors_gadget(cs, AllocatedScalar(vp, Scalar(17)),
                   AllocatedScalar(vq, Scalar(19)), Scalar(323))
    return comms


def _bound_check(cs, arg):
    v, lo, hi = 42, 10, 100
    vs, comms = _commit_all(cs, [v, v - lo, hi - v], arg)
    bound_check_gadget(cs, AllocatedQuantity(vs[0], v),
                       AllocatedQuantity(vs[1], v - lo),
                       AllocatedQuantity(vs[2], hi - v), hi, lo, 8)
    return comms


def _range_proof(cs, arg):
    v, lo, hi = 60, 10, 100
    (va, vb), comms = _commit_all(cs, [v - lo, hi - v], arg)
    positive_no_gadget(cs, AllocatedQuantity(va, v - lo), 7)
    positive_no_gadget(cs, AllocatedQuantity(vb, hi - v), 7)
    constrain_lc_with_scalar(cs, va + vb, Scalar(hi - lo))
    return comms


def _zero_nonzero(cs, arg):
    x = Scalar(9)
    vals = [0, x.v, x.invert().v]
    (vz, vx, vxi), comms = _commit_all(cs, vals, arg)
    is_zero_gadget(cs, AllocatedScalar(vz, Scalar(0)))
    is_nonzero_gadget(cs, AllocatedScalar(vx, x),
                      AllocatedScalar(vxi, x.invert()))
    return comms


def _not_equals(cs, arg):
    value, expected = 10, 5
    diff = Scalar(expected) - Scalar(value)
    (vv, vd, vdi), comms = _commit_all(
        cs, [value, diff.v, diff.invert().v], arg
    )
    not_equals_gadget(cs, AllocatedScalar(vv, Scalar(value)),
                      AllocatedScalar(vd, diff),
                      AllocatedScalar(vdi, diff.invert()), expected)
    return comms


def _set_membership(cs, arg):
    value = 5
    bits = [int(e == value) for e in SET]
    vs, comms = _commit_all(cs, bits + [value], arg)
    qs = [AllocatedQuantity(v, b) for v, b in zip(vs, bits)]
    for q in qs:
        bit_gadget(cs, q)
    vector_sum_gadget(cs, qs, 1)
    vector_product_gadget(cs, SET, qs, AllocatedQuantity(vs[-1], value))
    return comms


def _set_membership_1(cs, arg):
    value = 3
    diffs = [Scalar(e) - Scalar(value) for e in SET]
    vs, comms = _commit_all(cs, [value] + [d.v for d in diffs], arg)
    set_membership_1_gadget(
        cs, AllocatedScalar(vs[0], Scalar(value)),
        [AllocatedScalar(v, d) for v, d in zip(vs[1:], diffs)], SET,
    )
    return comms


def _set_non_membership(cs, arg):
    value = 4
    diffs = [Scalar(e) - Scalar(value) for e in SET]
    vals = [value] + [d.v for d in diffs] + [d.invert().v for d in diffs]
    vs, comms = _commit_all(cs, vals, arg)
    k = len(SET)
    set_non_membership_gadget(
        cs, AllocatedScalar(vs[0], Scalar(value)),
        [AllocatedScalar(v, d) for v, d in zip(vs[1 : k + 1], diffs)],
        [AllocatedScalar(v, d.invert())
         for v, d in zip(vs[k + 1 :], diffs)],
        SET,
    )
    return comms


def _mimc(cs, arg):
    xl, xr = Scalar(11), Scalar(13)
    image, right = xl, xr  # the reduced-round native hash
    for c in MIMC_CONSTANTS:
        image, right = (image + c) * (image + c) * (image + c) + right, image
    (vl, vr), comms = _commit_all(cs, [xl.v, xr.v], arg)
    mimc_gadget(cs, AllocatedScalar(vl, xl), AllocatedScalar(vr, xr),
                MIMC_ROUNDS, MIMC_CONSTANTS, image)
    return comms


def _poseidon(sbox):
    def build(cs, arg):
        xl, xr = Scalar(31), Scalar(59)
        out = Poseidon_hash_2(xl, xr, HASH_PARAMS, sbox)
        (vl, vr), comms = _commit_all(cs, [xl.v, xr.v], arg)
        statics = (
            allocate_statics_for_prover(cs, 4) if isinstance(cs, Prover)
            else allocate_statics_for_verifier(cs, 4, PC)
        )
        Poseidon_hash_2_gadget(cs, AllocatedScalar(vl, xl),
                               AllocatedScalar(vr, xr), statics,
                               HASH_PARAMS, sbox, out)
        return comms

    return build


def _vsmt2(cs, arg):
    depth = 2
    comp = CompiledVSMT2(HASH_PARAMS, depth, constrain_index_bits=False)
    k = Scalar(2)
    bits = [b.v for b in leaf_index_bit_scalars(k, depth)]
    nodes = [Scalar(500 + i) for i in range(depth)]
    aL, aR, aO = comp.witness(k, bits, nodes)
    return _load_compiled(cs, arg, comp, (k, bits, nodes), (aL, aR, aO))


def _vsmt4(cs, arg):
    depth = 4
    comp = CompiledVSMT4(HASH_PARAMS, depth)
    k = Scalar(2)
    nodes = [Scalar(700 + i) for i in range(3 * depth)]
    aL, aR, aO = comp.witness(k, k, nodes)
    return _load_compiled(cs, arg, comp, (k, k, nodes), (aL, aR, aO))


def _load_compiled(cs, arg, comp, inputs, wires):
    tape = comp.tape(comp._root)
    if isinstance(cs, Prover):
        comms = comp.commit_prover(cs, *inputs, rng=arg)
        cs.load_compiled(tape, *wires)
        return comms
    comp.commit_verifier(cs, arg, PC)
    cs.load_compiled(tape, comp.num_multipliers)
    return arg


FAMILIES = {
    "factors": _factors,
    "bound_check": _bound_check,
    "range_proof": _range_proof,
    "zero_nonzero": _zero_nonzero,
    "not_equals": _not_equals,
    "set_membership": _set_membership,
    "set_membership_1": _set_membership_1,
    "set_non_membership": _set_non_membership,
    "mimc": _mimc,
    "poseidon2_cube": _poseidon(SboxType.Cube),
    "poseidon2_inverse": _poseidon(SboxType.Inverse),
    "vsmt2": _vsmt2,
    "vsmt4": _vsmt4,
}


def prover_for(family: str, seed: int = 7):
    """A synthesized prover with seeded private randomness."""
    rng = np.random.RandomState(seed)
    prover = Prover(PC, Transcript(family.encode()), rng=rng)
    comms = FAMILIES[family](prover, rng)
    return prover, comms


def prove(family: str, backend, seed: int = 7):
    prover, comms = prover_for(family, seed)
    return prover.prove(BP, backend=backend), comms


def verifier_for(family: str, comms) -> Verifier:
    verifier = Verifier(Transcript(family.encode()))
    FAMILIES[family](verifier, comms)
    return verifier


def verify(family: str, proof, comms, backend) -> None:
    verifier_for(family, comms).verify(proof, PC, BP, backend=backend)


def small_device_backend():
    """DeviceBackend with small compiled shapes, forced onto the device
    path for every size: the real XLA program at CPU-test cost."""
    from bulletproofs_r1cs_gadgets_tpu.ops.backend import DeviceBackend

    return DeviceBackend(min_device_n=1, chunk=64, window=2, fold_chunk=32)
