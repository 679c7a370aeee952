"""Batch proving + mesh utilities (CPU)."""

import pytest

from bulletproofs_r1cs_gadgets_tpu import (
    Scalar,
    PedersenGens,
    BulletproofGens,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import constrain_lc_with_scalar
from bulletproofs_r1cs_gadgets_tpu.parallel.batch import prove_batch, verify_batch
from bulletproofs_r1cs_gadgets_tpu.parallel.mesh import make_mesh
from device_circuits import small_device_backend

PC = PedersenGens.default()
BP = BulletproofGens(128)



def test_prove_batch_factors():
    def build(cs, w):
        if isinstance(w, tuple):  # prover side: witness
            p, q = w
            com_p, var_p = cs.commit(p, Scalar.random())
            com_q, var_q = cs.commit(q, Scalar.random())
            _, _, o = cs.multiply(var_p, var_q)
            constrain_lc_with_scalar(cs, o, p * q)
            return [com_p, com_q, (p * q).to_bytes()]
        # verifier side: commitments
        com_p, com_q, r_bytes = w
        var_p = cs.commit(com_p)
        var_q = cs.commit(com_q)
        _, _, o = cs.multiply(var_p, var_q)
        constrain_lc_with_scalar(
            cs, o, Scalar.from_bytes_mod_order(r_bytes)
        )
        return w

    witnesses = [(Scalar(3), Scalar(5)), (Scalar(7), Scalar(11)), (Scalar(13), Scalar(17))]
    result = prove_batch(PC, BP, b"BatchFactors", witnesses, build)
    assert len(result.proofs) == 3
    verify_batch(PC, BP, b"BatchFactors", result, build)


def test_prove_provers_staged_matches_sequential():
    """Staged-fusion batch proving must produce byte-identical proofs to
    the sequential path when each prover draws from a deterministic rng
    (the fusion only reorders device work)."""
    import hashlib

    from bulletproofs_r1cs_gadgets_tpu import Prover, Transcript
    from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError
    from bulletproofs_r1cs_gadgets_tpu.gadgets.bound_check import (
        bound_check_gadget,
    )
    from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import (
        AllocatedQuantity,
    )
    from bulletproofs_r1cs_gadgets_tpu.parallel.batch import prove_provers

    class StreamRng:
        def __init__(self, seed: bytes):
            self.key = seed
            self.ctr = 0

        def bytes(self, n: int) -> bytes:
            out = b""
            while len(out) < n:
                out += hashlib.sha256(
                    self.key + self.ctr.to_bytes(8, "little")
                ).digest()
                self.ctr += 1
            return out[:n]

    def build(seed: int):
        provers = []
        for i in range(3):
            rng = StreamRng(bytes([seed, i]))
            p = Prover(PC, Transcript(b"BoundsBatch"), rng=rng)
            v, lo, hi = 40 + i, 10, 100
            com_v, var_v = p.commit(Scalar(v), Scalar(7 + i))
            com_a, var_a = p.commit(Scalar(v - lo), Scalar(9 + i))
            com_b, var_b = p.commit(Scalar(hi - v), Scalar(11 + i))
            bound_check_gadget(
                p,
                AllocatedQuantity(var_v, v),
                AllocatedQuantity(var_a, v - lo),
                AllocatedQuantity(var_b, hi - v),
                hi, lo, 32,
            )
            provers.append(p)
        return provers

    # scvec.random draws from os entropy, not the prover rng: stub it to a
    # deterministic stream for the byte-equality check
    from bulletproofs_r1cs_gadgets_tpu.core import scvec

    orig_random = scvec.random
    import numpy as np

    def fake_random(n, _state={"i": 0}):
        rows = []
        for _ in range(n):
            _state["i"] += 1
            rows.append(scvec.scalar_to_row(Scalar(10_000 + _state["i"])))
        return np.asarray(rows).reshape(n, 4)

    scvec.random = fake_random
    try:
        seq = [p.prove(BP) for p in build(1)]
        # reset the deterministic stream for the staged run
        fake_random.__defaults__[0]["i"] = 0
        # host_workers=1: the stubbed entropy stream is shared across
        # provers, so cross-prover draw order must match the sequential run
        staged = prove_provers(
            build(1), BP, backend=small_device_backend(),
            host_workers=1,
        )
    finally:
        scvec.random = orig_random
    assert [p.to_bytes() for p in seq] == [p.to_bytes() for p in staged]


def test_prove_stream_matches_individual_proofs():
    """prove_stream (the 4096-proof-configuration queue: lazy prover
    construction, wave groups on workers, bounded in-flight state) must
    produce the same bytes as proving each lazily-built prover alone,
    deliver results in stream order, and honor keep=False + on_result."""
    import hashlib

    from bulletproofs_r1cs_gadgets_tpu import Prover, Transcript
    from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import (
        constrain_lc_with_scalar,
    )
    from bulletproofs_r1cs_gadgets_tpu.parallel.stream import prove_stream

    class StreamRng:
        def __init__(self, seed: bytes):
            self.key = seed
            self.ctr = 0

        def bytes(self, n: int) -> bytes:
            out = b""
            while len(out) < n:
                out += hashlib.sha256(
                    self.key + self.ctr.to_bytes(8, "little")
                ).digest()
                self.ctr += 1
            return out[:n]

    def make_prover(i: int):
        p = Prover(
            PC, Transcript(b"Stream"), rng=StreamRng(b"s%d" % i)
        )
        a, b = Scalar(3 + i), Scalar(5 + i)
        _, va = p.commit(a, Scalar(17))
        _, vb = p.commit(b, Scalar(19))
        _, _, o = p.multiply(va, vb)
        constrain_lc_with_scalar(p, o, a * b)
        return p

    seq = [make_prover(i).prove(BP).to_bytes() for i in range(7)]

    proofs, rep = prove_stream(
        make_prover, 7, BP, backend=None, wave=2, inflight=4
    )
    assert [p.to_bytes() for p in proofs] == seq
    assert rep.count == 7 and rep.proofs_per_s > 0
    assert sum(1 for _ in rep.group_times) == 4  # ceil(7/2) groups

    got = {}
    proofs2, rep2 = prove_stream(
        make_prover, 5, BP, wave=2, inflight=2, keep=False,
        on_result=lambda i, pf: got.__setitem__(i, pf.to_bytes()),
    )
    assert proofs2 is None
    assert [got[i] for i in range(5)] == seq[:5]


def test_make_mesh_shapes():
    mesh = make_mesh()  # whatever devices exist
    assert set(mesh.axis_names) == {"batch", "points"}
    assert mesh.size >= 1


@pytest.mark.mesh_slow
def test_sharded_step_matches_host_oracles():
    """make_sharded_step on the 8-device CPU mesh: the dp witness digests
    must equal the host Poseidon Merkle chain, the tp MSM total must equal
    the host multiscalar_mul, and both must equal the single-device
    proving_step."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs the 8-device CPU mesh")

    from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
        RistrettoPoint,
        multiscalar_mul,
    )
    from bulletproofs_r1cs_gadgets_tpu.gadgets.poseidon import (
        Poseidon_hash_2,
        SboxType,
    )
    from bulletproofs_r1cs_gadgets_tpu.ops.curve import (
        points_from_device,
        points_to_device,
    )
    from bulletproofs_r1cs_gadgets_tpu.ops.field import FQ, STORE
    from bulletproofs_r1cs_gadgets_tpu.parallel import pipeline

    B, W, N, NBITS = 8, 4, 8, 16
    vals = [[3 * i + j + 1 for j in range(W)] for i in range(B)]
    witness = FQ.to_device([v for row in vals for v in row]).reshape(
        B, W, STORE
    )
    base = RistrettoPoint.basepoint()
    pts = [base.scalar_mul(Scalar(i + 1)) for i in range(N)]
    points = points_to_device(pts)
    rng = np.random.RandomState(0)
    ks = [int(rng.randint(1, 1 << 15)) for _ in range(N)]
    bits = jnp.asarray(
        np.array(
            [[(k >> b) & 1 for b in range(NBITS)] for k in ks], np.int32
        )
    )

    mesh = make_mesh(8, batch_axis=1, axis_names=("batch", "points"))
    digest, checksum, total = pipeline.make_sharded_step(mesh)(
        witness, points, bits
    )
    d1, c1 = jax.jit(pipeline.proving_step)(witness, points, bits)

    # dp digests == host Poseidon chain (cube S-box, flagship geometry)
    params = pipeline.flagship_hasher().params
    exp = []
    for row in vals:
        acc = Scalar(row[0])
        for v in row[1:]:
            acc = Poseidon_hash_2(acc, Scalar(v), params, SboxType.Cube)
        exp.append(acc.v)
    assert FQ.to_ints(digest) == exp
    assert FQ.to_ints(d1) == exp
    from bulletproofs_r1cs_gadgets_tpu.utils.constants import L

    assert FQ.to_ints(checksum[None])[0] == sum(exp) % L

    # tp MSM total == host multiscalar_mul (and == single-device partial)
    exp_pt = multiscalar_mul([Scalar(k) for k in ks], pts)
    got = points_from_device(total[None])[0]
    assert got == exp_pt
    assert points_from_device(c1[None])[0] == exp_pt


def test_batch_verify_single_msm():
    """Combined batch verification: one MSM accepts an all-valid batch,
    rejects a tampered proof and names its index, and handles mixed
    circuit sizes (different padded_n) in one combination."""
    import pytest

    from bulletproofs_r1cs_gadgets_tpu import (
        Prover, Transcript, Verifier, batch_verify,
    )
    from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError
    from bulletproofs_r1cs_gadgets_tpu.core.proof import R1CSProof
    from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import (
        AllocatedQuantity, positive_no_gadget,
    )

    def make_factor_proof(p, q):
        pr = Prover(PC, Transcript(b"BVFactors"))
        cp, vp = pr.commit(p, Scalar.random())
        cq, vq = pr.commit(q, Scalar.random())
        _, _, o = pr.multiply(vp, vq)
        pr.constrain(o - p * q)
        return pr.prove(BP), (cp, cq, p * q)

    def factor_verifier(cp, cq, r):
        ve = Verifier(Transcript(b"BVFactors"))
        _, _, o = ve.multiply(ve.commit(cp), ve.commit(cq))
        ve.constrain(o - r)
        return ve

    def make_range_proof(v, bits):
        # different multiplier count -> different padded_n in the batch
        pr = Prover(PC, Transcript(b"BVRange"))
        cv, vv = pr.commit(v, Scalar.random())
        positive_no_gadget(
            pr, AllocatedQuantity(vv, v.v), bits
        )
        return pr.prove(BP), cv

    def range_verifier(cv, bits):
        ve = Verifier(Transcript(b"BVRange"))
        vv = ve.commit(cv)
        positive_no_gadget(ve, AllocatedQuantity(vv, None), bits)
        return ve

    made = [make_factor_proof(Scalar(3), Scalar(5)),
            make_factor_proof(Scalar(7), Scalar(11))]
    rproof, cv = make_range_proof(Scalar(200), 16)

    proofs = [m[0] for m in made] + [rproof]
    verifiers = [factor_verifier(*m[1]) for m in made]
    verifiers.append(range_verifier(cv, 16))
    batch_verify(verifiers, proofs, PC, BP)  # mixed padded_n, all valid

    # tamper with the middle proof: combination fails AND the failure
    # re-check names exactly index 1 (verifier transcripts are consumed
    # by the first call, so rebuild them)
    raw = bytearray(made[1][0].to_bytes())
    raw[-32] ^= 1
    bad = R1CSProof.from_bytes(bytes(raw))
    verifiers = [factor_verifier(*m[1]) for m in made]
    verifiers.append(range_verifier(cv, 16))
    with pytest.raises(VerificationError, match=r"indices: \[1\]"):
        batch_verify(
            verifiers, [made[0][0], bad, rproof], PC, BP,
        )


def test_prove_provers_waves_roundtrip():
    """waves=2 splits the batch into concurrently-driven pipelines; every
    proof must still verify and batch order must be preserved."""
    from bulletproofs_r1cs_gadgets_tpu import Prover, Transcript, Verifier
    from bulletproofs_r1cs_gadgets_tpu.parallel.batch import prove_provers

    vals = [(Scalar(3), Scalar(5)), (Scalar(7), Scalar(11)),
            (Scalar(13), Scalar(17)), (Scalar(19), Scalar(23))]

    provers, pubs = [], []
    for p_w, q_w in vals:
        pr = Prover(PC, Transcript(b"WaveFactors"))
        com_p, var_p = pr.commit(p_w, Scalar.random())
        com_q, var_q = pr.commit(q_w, Scalar.random())
        _, _, o = pr.multiply(var_p, var_q)
        constrain_lc_with_scalar(pr, o, p_w * q_w)
        provers.append(pr)
        pubs.append((com_p, com_q, p_w * q_w))

    proofs = prove_provers(
        provers, BP, backend=small_device_backend(), waves=2
    )
    assert len(proofs) == 4
    for proof, (com_p, com_q, r) in zip(proofs, pubs):
        ve = Verifier(Transcript(b"WaveFactors"))
        var_p = ve.commit(com_p)
        var_q = ve.commit(com_q)
        _, _, o = ve.multiply(var_p, var_q)
        constrain_lc_with_scalar(ve, o, r)
        ve.verify(proof, PC, BP)


def test_prove_provers_inflight_cap_roundtrip():
    """inflight caps concurrent wave groups (device-memory scheduling): with 4
    proofs, waves=2 and inflight=2 the two groups run sequentially; proofs
    must be byte-identical to the uncapped run and all verify."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu import Prover, Transcript, Verifier
    from bulletproofs_r1cs_gadgets_tpu.parallel.batch import prove_provers

    vals = [(Scalar(3), Scalar(5)), (Scalar(7), Scalar(11)),
            (Scalar(13), Scalar(17)), (Scalar(19), Scalar(23))]

    def build():
        provers, pubs = [], []
        for i, (p_w, q_w) in enumerate(vals):
            pr = Prover(PC, Transcript(b"InflightCap"),
                        rng=np.random.RandomState(100 + i))
            com_p, var_p = pr.commit(p_w, Scalar(1234 + i))
            com_q, var_q = pr.commit(q_w, Scalar(5678 + i))
            _, _, o = pr.multiply(var_p, var_q)
            constrain_lc_with_scalar(pr, o, p_w * q_w)
            provers.append(pr)
            pubs.append((com_p, com_q, p_w * q_w))
        return provers, pubs

    be = small_device_backend()
    provers, pubs = build()
    capped = prove_provers(provers, BP, backend=be, waves=2, inflight=2)
    provers2, _ = build()
    uncapped = prove_provers(provers2, BP, backend=be, waves=2)
    assert [p.to_bytes() for p in capped] == [
        p.to_bytes() for p in uncapped
    ]
    for proof, (com_p, com_q, r) in zip(capped, pubs):
        ve = Verifier(Transcript(b"InflightCap"))
        var_p = ve.commit(com_p)
        var_q = ve.commit(com_q)
        _, _, o = ve.multiply(var_p, var_q)
        constrain_lc_with_scalar(ve, o, r)
        ve.verify(proof, PC, BP)

    # inflight with waves<=1 (the default) must derive a wave split, not
    # silently ignore the cap (round-4 advisor finding); and inflight that
    # prevents a 2*waves split must fall back to sequential slices.  Both
    # still produce byte-identical proofs.
    provers3, _ = build()
    derived = prove_provers(provers3, BP, backend=be, inflight=2)
    assert [p.to_bytes() for p in derived] == [
        p.to_bytes() for p in uncapped
    ]
    provers4, _ = build()
    sliced = prove_provers(provers4, BP, backend=be, inflight=1)
    assert [p.to_bytes() for p in sliced] == [
        p.to_bytes() for p in uncapped
    ]
