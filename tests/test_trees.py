"""Sparse-Merkle-tree tests: host trees (reference tests
``gadget_vsmt_2.rs:222-259``, ``gadget_vsmt_4.rs:325-360``,
``gadget_osmt.rs:293-353``) and circuit round trips at reduced depth;
reference-size circuits under --run-slow (driven by bench.py on the GPU).
"""

import random

import pytest

from bulletproofs_r1cs_gadgets_tpu import (
    Scalar,
    Transcript,
    Prover,
    Verifier,
    PedersenGens,
    BulletproofGens,
)
from bulletproofs_r1cs_gadgets_tpu.core import errors
from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import AllocatedScalar
from bulletproofs_r1cs_gadgets_tpu.gadgets.poseidon import (
    PoseidonParams,
    allocate_statics_for_prover,
    allocate_statics_for_verifier,
)
from bulletproofs_r1cs_gadgets_tpu.models.vsmt2 import (
    VanillaSparseMerkleTree,
    vanilla_merkle_tree_verif_gadget,
    leaf_index_bit_scalars,
)
from bulletproofs_r1cs_gadgets_tpu.models.vsmt4 import (
    VanillaSparseMerkleTree4,
    vanilla_merkle_tree_4_verif_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.models.osmt import (
    OptimizedSparseMerkleTree,
    optimized_sparse_merkle_tree_verif_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.utils.constants import L

PC = PedersenGens.default()

# few partial rounds -> fast host hashing; structure identical
PARAMS = PoseidonParams(6, 4, 4, 6)


def test_vanilla_sparse_merkle_tree():
    # gadget_vsmt_2.rs:222-259 at reduced depth
    tree = VanillaSparseMerkleTree(PARAMS, depth=16)
    for i in range(1, 10):
        s = Scalar(i)
        tree.update(s, s)
    for i in range(1, 10):
        s = Scalar(i)
        assert tree.get(s) == s
        proof = []
        assert tree.get(s, proof) == s
        assert tree.verify_proof(s, s, proof)
        assert tree.verify_proof(s, s, proof, tree.root)
        assert not tree.verify_proof(s, s + Scalar.one(), proof)
    rnd = random.Random(24)
    kvs = [
        (Scalar(rnd.randrange(1 << 16)), Scalar(rnd.randrange(L)))
        for _ in range(10)
    ]
    for k, v in kvs:
        tree.update(k, v)
    expect = {}
    for k, v in kvs:
        expect[k.v] = v
    for k, v in kvs:
        assert tree.get(k) == expect[k.v]


def test_vanilla_sparse_merkle_tree_4():
    # gadget_vsmt_4.rs:325-360 at reduced depth
    tree = VanillaSparseMerkleTree4(PARAMS, depth=8)
    for i in range(1, 6):
        s = Scalar(i)
        tree.update(s, s)
    for i in range(1, 6):
        s = Scalar(i)
        assert tree.get(s) == s
        proof = []
        assert tree.get(s, proof) == s
        assert tree.verify_proof(s, s, proof)
        assert tree.verify_proof(s, s, proof, tree.root)


def test_vsmt4_depth_must_be_multiple_of_4():
    with pytest.raises(ValueError):
        VanillaSparseMerkleTree4(PARAMS, depth=6)


def test_optimized_sparse_merkle_tree():
    # gadget_osmt.rs:293-353 at reduced depth
    tree = OptimizedSparseMerkleTree(PARAMS, 16)
    for i in range(1, 10):
        s = Scalar(i)
        tree.update(s, s)
    for i in range(1, 10):
        s = Scalar(i)
        assert tree.get(s) == s
        proof = []
        assert tree.get(s, proof) == s
        assert tree.verify_proof(s, s, proof, tree.root)
    # unset key reads zero
    assert tree.get(Scalar(5000)) == Scalar.zero()
    # random keys (within depth-bit range)
    rnd = random.Random(24)
    kvs = {}
    while len(kvs) < 20:
        k = rnd.randrange(1 << 16)
        kvs[k] = rnd.randrange(L)
    for k, v in kvs.items():
        tree.update(Scalar(k), Scalar(v))
    for k, v in kvs.items():
        proof = []
        assert tree.get(Scalar(k), proof) == Scalar(v)
        assert tree.verify_proof(Scalar(k), Scalar(v), proof, tree.root)


def test_osmt_gadget_unimplemented():
    with pytest.raises(NotImplementedError):
        optimized_sparse_merkle_tree_verif_gadget()


def _vsmt2_roundtrip(depth, constrain_bits=True, tamper=False):
    tree = VanillaSparseMerkleTree(PARAMS, depth=depth)
    for i in range(1, 6):
        tree.update(Scalar(i), Scalar(i))
    k = Scalar(3)
    merkle_proof = []
    assert tree.get(k, merkle_proof) == k

    bp = BulletproofGens(4096)
    prover = Prover(PC, Transcript(b"VSMT"))
    com_leaf, var_leaf = prover.commit(k, Scalar.random())
    leaf_alloc = AllocatedScalar(var_leaf, k)
    li_comms, li_allocs = [], []
    for b in leaf_index_bit_scalars(k, depth):
        c, v = prover.commit(b, Scalar.random())
        li_comms.append(c)
        li_allocs.append(AllocatedScalar(v, b))
    pf_comms, pf_allocs = [], []
    for p in reversed(merkle_proof):
        c, v = prover.commit(p, Scalar.random())
        pf_comms.append(c)
        pf_allocs.append(AllocatedScalar(v, p))
    statics = allocate_statics_for_prover(prover, 4)
    vanilla_merkle_tree_verif_gadget(
        prover, depth, tree.root, leaf_alloc, li_allocs, pf_allocs, statics,
        PARAMS, constrain_index_bits=constrain_bits,
    )
    proof = prover.prove(bp)

    root = tree.root if not tamper else tree.root + Scalar.one()
    verifier = Verifier(Transcript(b"VSMT"))
    leaf_alloc = AllocatedScalar(verifier.commit(com_leaf))
    li = [AllocatedScalar(verifier.commit(c)) for c in li_comms]
    pf = [AllocatedScalar(verifier.commit(c)) for c in pf_comms]
    vstatics = allocate_statics_for_verifier(verifier, 4, PC)
    vanilla_merkle_tree_verif_gadget(
        verifier, depth, root, leaf_alloc, li, pf, vstatics, PARAMS,
        constrain_index_bits=constrain_bits,
    )
    verifier.verify(proof, PC, bp)


def test_vsmt2_circuit_roundtrip():
    _vsmt2_roundtrip(4)


def test_vsmt2_circuit_reference_parity_mode():
    # constrain_index_bits=False reproduces the reference circuit exactly
    # (gadget_vsmt_2.rs:171-209 leaves index bits unconstrained)
    _vsmt2_roundtrip(4, constrain_bits=False)


def test_vsmt2_circuit_wrong_root_fails():
    with pytest.raises(errors.VerificationError):
        _vsmt2_roundtrip(4, tamper=True)


def test_vsmt4_circuit_roundtrip():
    depth = 4
    tree = VanillaSparseMerkleTree4(PARAMS, depth=depth)
    for i in range(1, 6):
        tree.update(Scalar(i), Scalar(i))
    k = Scalar(3)
    merkle_proof = []
    assert tree.get(k, merkle_proof) == k
    assert tree.verify_proof(k, k, merkle_proof)

    bp = BulletproofGens(8192)
    prover = Prover(PC, Transcript(b"VSMT"))
    com_leaf, var_leaf = prover.commit(k, Scalar.random())
    leaf_alloc = AllocatedScalar(var_leaf, k)
    com_idx, var_idx = prover.commit(k, Scalar.random())
    idx_alloc = AllocatedScalar(var_idx, k)
    pf_comms, pf_allocs = [], []
    for node in merkle_proof:
        for elem in node:
            c, v = prover.commit(elem, Scalar.random())
            pf_comms.append(c)
            pf_allocs.append(AllocatedScalar(v, elem))
    statics = allocate_statics_for_prover(prover, 2)
    vanilla_merkle_tree_4_verif_gadget(
        prover, depth, tree.root, leaf_alloc, idx_alloc, pf_allocs, statics, PARAMS
    )
    proof = prover.prove(bp)

    verifier = Verifier(Transcript(b"VSMT"))
    leaf_alloc = AllocatedScalar(verifier.commit(com_leaf))
    idx_alloc = AllocatedScalar(verifier.commit(com_idx))
    pf = [AllocatedScalar(verifier.commit(c)) for c in pf_comms]
    vstatics = allocate_statics_for_verifier(verifier, 2, PC)
    vanilla_merkle_tree_4_verif_gadget(
        verifier, depth, tree.root, leaf_alloc, idx_alloc, pf, vstatics, PARAMS
    )
    verifier.verify(proof, PC, bp)
