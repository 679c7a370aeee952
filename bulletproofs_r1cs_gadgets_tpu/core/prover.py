"""R1CS prover (the ``bulletproofs::r1cs::Prover`` equivalent).

Implements the dalek-bulletproofs "yoloproofs" constraint-system prover the
reference builds on (SURVEY.md S2b N5/N6, call stack CS-1), including the
fork-only surface used by the gadgets: ``evaluate_lc`` + ``allocate_single``
(``/root/reference/src/gadget_poseidon.rs:160-166``) and the
``num_constraints`` / ``num_multipliers`` counters
(``/root/reference/src/gadget_mimc.rs:138``).

Protocol (two-phase, Fiat-Shamir over Merlin):

1. per-commitment: ``V_j = v_j B + gamma_j B~``, transcript ``V``.
2. phase-1 vector commitments ``A_I1`` (a_L on G, a_R on H), ``A_O1`` (a_O on
   G), ``S1`` (blinding vectors), transcript ``A_I1, A_O1, S1``.
3. randomized-constraint phase (unused by the reference gadget zoo but
   supported): domain-sep ``r1cs-1phase``/``r1cs-2phase`` then ``A_I2, A_O2,
   S2`` (identity when unused).
4. challenges y, z; constraints flattened by powers of z into per-wire weight
   vectors wL, wR, wO, wV.
5. vector polynomials l(x), r(x) (degree 3) and t(x) = <l, r> (degree 6);
   commitments ``T_1, T_3..T_6``; challenges u, x; blinded evaluations
   ``t_x, t_x_blinding, e_blinding``; challenge w.
6. inner-product argument over 2 * padded_n folded generators.

The heavy vector math of steps 2, 5, 6 routes through an optional *device
backend* (:mod:`bulletproofs_r1cs_gadgets_tpu.ops.backend`); the host
path below is the exact reference implementation.
"""

from __future__ import annotations

import secrets

import numpy as np

from .scalar import Scalar, exp_iter, inner_product
from .linear_combination import Variable, VarKind, LinearCombination, _coerce
from .ristretto import RistrettoPoint, multiscalar_mul
from .transcript import Transcript
from .pedersen import PedersenGens, BulletproofGens
from .ipp import InnerProductProof
from .proof import R1CSProof
from .errors import MissingAssignment, InvalidGeneratorsLength
from .tape import TapeArrays
from . import scvec
from ..utils.stats import CircuitStats

_IDENTITY_BYTES = b"\x00" * 32


class _SystemRng:
    def bytes(self, n: int) -> bytes:
        return secrets.token_bytes(n)


class Prover:
    """Builds a constraint tape with witness assignments, then proves it."""

    def __init__(self, pc_gens: PedersenGens, transcript: Transcript, rng=None):
        self.pc_gens = pc_gens
        self.transcript = transcript
        transcript.r1cs_domain_sep()
        self.rng = rng if rng is not None else _SystemRng()
        # high-level witness
        self.v: list[Scalar] = []
        self.v_blinding: list[Scalar] = []
        # low-level witness (multiplier wires)
        self.a_L: list[Scalar] = []
        self.a_R: list[Scalar] = []
        self.a_O: list[Scalar] = []
        self.constraints: list[LinearCombination] = []
        self.pending_multiplier: int | None = None
        self.deferred_constraints = []  # callbacks for randomized phase
        self.num_phase1_multipliers = 0
        # memoized array lowerings (keyed by list lengths; see prove())
        self._tape_memo = None
        self._wit_memo = None

    # ------------------------------------------------------------ commitments
    def commit(self, v: Scalar, v_blinding: Scalar):
        """Pedersen-commit a high-level witness value; returns
        (compressed commitment, Variable)."""
        i = len(self.v)
        self.v.append(v)
        self.v_blinding.append(v_blinding)
        V = self.pc_gens.commit(v, v_blinding).compress()
        self.transcript.append_point(b"V", V)
        return V, Variable.committed(i)

    # --------------------------------------------------- ConstraintSystem API
    def multiply(self, left, right):
        left = _coerce(left)
        right = _coerce(right)
        l = self.eval_lc(left)
        r = self.eval_lc(right)
        o = l * r
        i = len(self.a_L)
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(o)
        l_var = Variable.mult_left(i)
        r_var = Variable.mult_right(i)
        o_var = Variable.mult_out(i)
        # constrain wires to the LCs
        self.constrain(left - l_var)
        self.constrain(right - r_var)
        return l_var, r_var, o_var

    def allocate(self, assignment: Scalar | None):
        if assignment is None:
            raise MissingAssignment("prover requires assignments")
        if self.pending_multiplier is None:
            i = len(self.a_L)
            self.pending_multiplier = i
            self.a_L.append(assignment)
            self.a_R.append(Scalar.zero())
            self.a_O.append(Scalar.zero())
            return Variable.mult_left(i)
        else:
            i = self.pending_multiplier
            self.pending_multiplier = None
            self.a_R[i] = assignment
            self.a_O[i] = self.a_L[i] * self.a_R[i]
            return Variable.mult_right(i)

    def allocate_single(self, assignment: Scalar | None):
        """Fork extension: like ``allocate`` but also reports the output wire
        when this call completes a multiplier
        (``gadget_poseidon.rs:165-166``)."""
        var = self.allocate(assignment)
        if var.kind == VarKind.MULT_RIGHT:
            return var, Variable.mult_out(var.index)
        return var, None

    def allocate_multiplier(self, assignment: tuple[Scalar, Scalar] | None):
        if assignment is None:
            raise MissingAssignment("prover requires assignments")
        l, r = assignment
        i = len(self.a_L)
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(l * r)
        return (
            Variable.mult_left(i),
            Variable.mult_right(i),
            Variable.mult_out(i),
        )

    def constrain(self, lc) -> None:
        self.constraints.append(_coerce(lc))

    def evaluate_lc(self, lc) -> Scalar | None:
        """Fork extension: evaluate an LC against the current witness."""
        return self.eval_lc(_coerce(lc))

    def eval_lc(self, lc: LinearCombination) -> Scalar:
        acc = 0
        for var, coeff in lc.terms:
            if var.kind == VarKind.MULT_LEFT:
                acc += coeff.v * self.a_L[var.index].v
            elif var.kind == VarKind.MULT_RIGHT:
                acc += coeff.v * self.a_R[var.index].v
            elif var.kind == VarKind.MULT_OUT:
                acc += coeff.v * self.a_O[var.index].v
            elif var.kind == VarKind.COMMITTED:
                acc += coeff.v * self.v[var.index].v
            else:  # ONE
                acc += coeff.v
        return Scalar(acc)

    def specify_randomized_constraints(self, callback) -> None:
        self.deferred_constraints.append(callback)

    def num_constraints(self) -> int:
        if self._tape_memo is not None and not self.constraints:
            return self._tape_memo[0]
        return len(self.constraints)

    def num_multipliers(self) -> int:
        if self._wit_memo is not None and not self.a_L:
            return self._wit_memo[0]
        return len(self.a_L)

    # ----------------------------------------------------- compiled circuits
    def load_compiled(self, tape, a_L, a_R, a_O) -> None:
        """Attach a template-compiled tape + witness arrays
        (:mod:`..models.compiled`) instead of synthesizing gadget-by-gadget.
        The commitment phase (``commit``) still runs normally beforehand."""
        assert not self.a_L and not self.constraints, (
            "load_compiled on a prover with synthesized state"
        )
        n = len(a_L)
        self._tape_memo = (tape.num_constraints, tape)
        self._wit_memo = (n, a_L, a_R, a_O)

    def stats(self) -> CircuitStats:
        return CircuitStats(
            multipliers=len(self.a_L),
            constraints=len(self.constraints),
            commitments=len(self.v),
            phase1_multipliers=self.num_phase1_multipliers or len(self.a_L),
        )

    # ----------------------------------------------------- array lowerings
    def _tape_arrays(self) -> TapeArrays:
        """Constraint tape as flat arrays, memoized per constraint count
        (synthesis only appends, so the length keys the cache)."""
        m = self.num_constraints()
        if self._tape_memo is None or self._tape_memo[0] != m:
            self._tape_memo = (m, TapeArrays(self.constraints))
        return self._tape_memo[1]

    def _witness_arrays(self):
        """(a_L, a_R, a_O) as (n, 4) u64 arrays, memoized per multiplier
        count."""
        n = self.num_multipliers()
        if self._wit_memo is None or self._wit_memo[0] != n:
            self._wit_memo = (
                n,
                scvec.from_scalars(self.a_L),
                scvec.from_scalars(self.a_R),
                scvec.from_scalars(self.a_O),
            )
        return self._wit_memo[1], self._wit_memo[2], self._wit_memo[3]

    # ------------------------------------------------------- snapshot/restore
    def snapshot(self):
        """Capture the synthesized state (tape + transcript) so the same
        circuit can be proven repeatedly without re-synthesis - prove()
        consumes transcript state but never mutates the tape."""
        st = self.transcript.strobe
        # force the lowerings so warm re-proves get them from the snapshot
        self._tape_arrays()
        self._witness_arrays()
        return (
            bytes(st.state),
            st.pos,
            st.pos_begin,
            st.cur_flags,
            list(self.v),
            list(self.v_blinding),
            list(self.a_L),
            list(self.a_R),
            list(self.a_O),
            list(self.constraints),
            self.pending_multiplier,
            self._tape_memo,
            self._wit_memo,
        )

    def restore(self, snap) -> None:
        st = self.transcript.strobe
        (
            state, st.pos, st.pos_begin, st.cur_flags,
            self.v, self.v_blinding, self.a_L, self.a_R, self.a_O,
            self.constraints, self.pending_multiplier,
            self._tape_memo, self._wit_memo,
        ) = snap
        st.state = bytearray(state)
        self.deferred_constraints = []

    # ------------------------------------------------------------- challenges
    def _random_scalar(self) -> Scalar:
        return Scalar.from_bytes_mod_order_wide(self.rng.bytes(64))

    def _random_vec(self, n: int):
        """n uniform scalar rows from the prover's rng (wide reduction)
        — a deterministic private rng therefore yields byte-identical
        proofs across backends (pinned by tests/test_native_backend.py)."""
        return scvec.from_wide_bytes(self.rng.bytes(64 * n))

    def _create_randomized_constraints(self) -> None:
        if not self.deferred_constraints:
            self.transcript.r1cs_1phase_domain_sep()
            return
        self.transcript.r1cs_2phase_domain_sep()
        callbacks = self.deferred_constraints
        self.deferred_constraints = []
        rcs = RandomizingProver(self)
        for cb in callbacks:
            cb(rcs)

    # ------------------------------------------------------------------ prove
    def _phase1_state(self, bp_gens: BulletproofGens) -> dict:
        """Stage 1 of prove(): transcript header, phase-1 blindings and
        witness arrays — everything up to (but excluding) the three phase-1
        vector-commitment MSMs.  Split out so ``parallel.batch.prove_batch``
        can fuse those MSMs across B provers into one device sync."""
        t = self.transcript
        t.append_u64(b"m", len(self.v))
        n1 = self.num_multipliers()
        self.num_phase1_multipliers = n1
        i_blinding1 = self._random_scalar()
        o_blinding1 = self._random_scalar()
        s_blinding1 = self._random_scalar()
        aL_arr, aR_arr, aO_arr = self._witness_arrays()
        return dict(
            n1=n1,
            i_blinding1=i_blinding1,
            o_blinding1=o_blinding1,
            s_blinding1=s_blinding1,
            aL=aL_arr,
            aR=aR_arr,
            aO=aO_arr,
            sL=self._random_vec(n1),
            sR=self._random_vec(n1),
            gens=bp_gens.share(0),
            B_b=self.pc_gens.B_blinding,
        )

    def _phase1_msm_args(self, st: dict) -> tuple:
        """Argument tuple for ``backend.phase_commitments`` /
        ``phase_commitments_batch``."""
        return (
            st["gens"], st["aL"], st["aR"], st["aO"], st["sL"], st["sR"],
            st["i_blinding1"], st["o_blinding1"], st["s_blinding1"],
            st["B_b"], 0,
        )

    def _phase1_host(self, st: dict) -> tuple[bytes, bytes, bytes]:
        """Host-path phase-1 vector commitments."""
        n1, B_b, gens = st["n1"], st["B_b"], st["gens"]
        G1 = gens.G(n1)
        H1 = gens.H(n1)
        if len(G1) < n1:
            raise InvalidGeneratorsLength("gens capacity too small")
        a_Ls = scvec.to_scalars(st["aL"])
        a_Rs = scvec.to_scalars(st["aR"])
        a_Os = scvec.to_scalars(st["aO"])
        s_L1 = scvec.to_scalars(st["sL"])
        s_R1 = scvec.to_scalars(st["sR"])
        A_I1 = multiscalar_mul(
            [st["i_blinding1"]] + a_Ls + a_Rs, [B_b] + G1 + H1
        ).compress()
        A_O1 = multiscalar_mul(
            [st["o_blinding1"]] + a_Os, [B_b] + G1
        ).compress()
        S1 = multiscalar_mul(
            [st["s_blinding1"]] + s_L1 + s_R1, [B_b] + G1 + H1
        ).compress()
        return A_I1, A_O1, S1

    def prove(self, bp_gens: BulletproofGens, backend=None) -> R1CSProof:
        import time as _time

        from ..utils.metrics import METRICS

        _last = [_time.time()]

        def _mark(name):
            now = _time.time()
            METRICS.add_time(f"prove.{name}", now - _last[0])
            _last[0] = now
        t = self.transcript

        # --- phase 1 commitments
        st = self._phase1_state(bp_gens)
        gens = st["gens"]
        if backend is not None:
            A_I1, A_O1, S1 = backend.phase_commitments(
                *self._phase1_msm_args(st)
            )
        else:
            A_I1, A_O1, S1 = self._phase1_host(st)
        _mark("phase1_commitments")

        mid = self._prove_middle(st, A_I1, A_O1, S1, bp_gens, _mark)

        t.innerproduct_domain_sep(mid["padded_n"])
        if backend is not None:
            ipp = backend.ipp_create(
                t, mid["Q"], mid["G_factors"], mid["H_factors"],
                gens, mid["padded_n"], mid["l_vec"], mid["r_vec"],
            )
        else:
            from .ipp import _skip_domain_sep

            ipp = InnerProductProof.create(
                _skip_domain_sep(t),
                mid["Q"],
                scvec.to_scalars(mid["G_factors"]),
                scvec.to_scalars(mid["H_factors"]),
                gens.G(mid["padded_n"]),
                gens.H(mid["padded_n"]),
                scvec.to_scalars(mid["l_vec"]),
                scvec.to_scalars(mid["r_vec"]),
            )

        _mark("ipp")
        METRICS.add_count("prove.proofs")
        METRICS.dump_group("prove")
        return R1CSProof(*mid["fields"], ipp)

    def _prove_middle(
        self, st: dict, A_I1, A_O1, S1, bp_gens: BulletproofGens, _mark=None
    ) -> dict:
        """Stages 2-5 of prove(): transcript appends for the phase-1
        commitments, the randomized-constraint phase, challenges y/z,
        constraint flattening, the l(x)/r(x)/t(x) polynomials and
        T-commitments, and the IPP input vectors.  All host scalar work +
        transcript; no device MSMs (those are phase 1 and the IPP)."""
        if _mark is None:
            _mark = lambda name: None  # noqa: E731
        t = self.transcript
        n1 = st["n1"]
        i_blinding1 = st["i_blinding1"]
        o_blinding1 = st["o_blinding1"]
        s_blinding1 = st["s_blinding1"]
        aL_arr, aR_arr, aO_arr = st["aL"], st["aR"], st["aO"]
        sL_arr, sR_arr = st["sL"], st["sR"]
        gens = st["gens"]
        B_b = st["B_b"]
        t.append_point(b"A_I1", A_I1)
        t.append_point(b"A_O1", A_O1)
        t.append_point(b"S1", S1)

        # --- phase 2 (randomized constraints)
        self._create_randomized_constraints()
        n = self.num_multipliers()
        n2 = n - n1
        padded_n = max(1, n)
        if padded_n & (padded_n - 1):
            padded_n = 1 << padded_n.bit_length()
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise InvalidGeneratorsLength(
                f"need {padded_n} generators, have {bp_gens.gens_capacity}"
            )

        has_2nd_phase = n2 > 0
        if has_2nd_phase:
            i_blinding2 = self._random_scalar()
            o_blinding2 = self._random_scalar()
            s_blinding2 = self._random_scalar()
            sL2_arr = self._random_vec(n2)
            sR2_arr = self._random_vec(n2)
            s_L2 = scvec.to_scalars(sL2_arr)
            s_R2 = scvec.to_scalars(sR2_arr)
            G2 = gens.G(n)[n1:]
            H2 = gens.H(n)[n1:]
            A_I2 = multiscalar_mul(
                [i_blinding2] + self.a_L[n1:] + self.a_R[n1:], [B_b] + G2 + H2
            ).compress()
            A_O2 = multiscalar_mul(
                [o_blinding2] + self.a_O[n1:], [B_b] + G2
            ).compress()
            S2 = multiscalar_mul(
                [s_blinding2] + s_L2 + s_R2, [B_b] + G2 + H2
            ).compress()
            aL_arr, aR_arr, aO_arr = self._witness_arrays()
            sL_arr = np.concatenate([sL_arr, sL2_arr])
            sR_arr = np.concatenate([sR_arr, sR2_arr])
        else:
            i_blinding2 = o_blinding2 = s_blinding2 = Scalar.zero()
            A_I2 = A_O2 = S2 = _IDENTITY_BYTES
        t.append_point(b"A_I2", A_I2)
        t.append_point(b"A_O2", A_O2)
        t.append_point(b"S2", S2)

        y = t.challenge_scalar(b"y")
        z = t.challenge_scalar(b"z")

        _mark("phase2")
        wL, wR, wO, wV_arr = self._tape_arrays().flatten(z, n, len(self.v))
        _mark("flatten")

        # --- l(x), r(x) vector polynomials ((n, 4) arrays; the pad region
        # is all-zero for l and handled analytically for r)
        y_inv = y.invert()
        ypow = scvec.powers(y, padded_n)
        yinv_pow = scvec.powers(y_inv, padded_n)

        l1 = scvec.add(aL_arr, scvec.mul(yinv_pow[:n], wR))
        l2 = aO_arr
        l3 = sL_arr
        r0 = scvec.sub(wO, ypow[:n])
        r1 = scvec.add(scvec.mul(ypow[:n], aR_arr), wL)
        r3 = scvec.mul(ypow[:n], sR_arr)
        # pad region: r0 = -y^i for n <= i < padded_n; l's are zero there
        r0_pad = scvec.sub(scvec.zeros(pad), ypow[n:]) if pad else None

        # t(x) = <l(x), r(x)>, degree 6, t0 == 0 (l0 == 0); l is zero on the
        # pad so inner products over the first n entries are exact
        t1 = scvec.inner(l1, r0)
        t2 = scvec.inner(l1, r1) + scvec.inner(l2, r0)
        t3 = scvec.inner(l2, r1) + scvec.inner(l3, r0)
        t4 = scvec.inner(l1, r3) + scvec.inner(l3, r1)
        t5 = scvec.inner(l2, r3)
        t6 = scvec.inner(l3, r3)

        t_1_blinding = self._random_scalar()
        t_3_blinding = self._random_scalar()
        t_4_blinding = self._random_scalar()
        t_5_blinding = self._random_scalar()
        t_6_blinding = self._random_scalar()

        pc = self.pc_gens
        T_1 = pc.commit(t1, t_1_blinding).compress()
        T_3 = pc.commit(t3, t_3_blinding).compress()
        T_4 = pc.commit(t4, t_4_blinding).compress()
        T_5 = pc.commit(t5, t_5_blinding).compress()
        T_6 = pc.commit(t6, t_6_blinding).compress()
        t.append_point(b"T_1", T_1)
        t.append_point(b"T_3", T_3)
        t.append_point(b"T_4", T_4)
        t.append_point(b"T_5", T_5)
        t.append_point(b"T_6", T_6)

        u = t.challenge_scalar(b"u")
        x = t.challenge_scalar(b"x")

        t_2_blinding = scvec.inner(
            wV_arr, scvec.from_scalars(self.v_blinding)
        )

        # evaluate t, blinding poly, l, r at x
        xx = x * x
        xxx = xx * x
        t_x = (
            t1 * x + t2 * xx + t3 * xxx + t4 * xx * xx
            + t5 * xx * xxx + t6 * xxx * xxx
        )
        t_x_blinding = (
            t_1_blinding * x
            + t_2_blinding * xx
            + t_3_blinding * xxx
            + t_4_blinding * xx * xx
            + t_5_blinding * xx * xxx
            + t_6_blinding * xxx * xxx
        )
        l_vec = scvec.add(
            scvec.axpby(l1, x, l2, xx), scvec.scale(l3, xxx)
        )
        r_vec = scvec.add(r0, scvec.axpby(r1, x, r3, xxx))
        if pad:
            l_vec = np.concatenate([l_vec, scvec.zeros(pad)])
            r_vec = np.concatenate([r_vec, r0_pad])

        i_blinding = i_blinding1 + u * i_blinding2
        o_blinding = o_blinding1 + u * o_blinding2
        s_blinding = s_blinding1 + u * s_blinding2
        e_blinding = x * (i_blinding + x * (o_blinding + x * s_blinding))

        _mark("polys")
        t.append_scalar(b"t_x", t_x)
        t.append_scalar(b"t_x_blinding", t_x_blinding)
        t.append_scalar(b"e_blinding", e_blinding)

        w = t.challenge_scalar(b"w")
        Q = self.pc_gens.B.scalar_mul(w)

        # G_factors = [1]*n1 + [u]*(n2+pad); H_factors = y^-i * G_factors
        G_factors = np.concatenate(
            [
                np.tile(scvec.scalar_to_row(Scalar.one()), (n1, 1)),
                np.tile(scvec.scalar_to_row(u), (n2 + pad, 1)),
            ]
        )
        H_factors = scvec.mul(yinv_pow, G_factors)

        return dict(
            padded_n=padded_n,
            Q=Q,
            G_factors=G_factors,
            H_factors=H_factors,
            l_vec=l_vec,
            r_vec=r_vec,
            fields=(
                A_I1, A_O1, S1, A_I2, A_O2, S2,
                T_1, T_3, T_4, T_5, T_6,
                t_x, t_x_blinding, e_blinding,
            ),
        )


class RandomizingProver:
    """Phase-2 constraint system handed to randomized-constraint callbacks."""

    def __init__(self, prover: Prover):
        self.prover = prover

    def challenge_scalar(self, label: bytes) -> Scalar:
        return self.prover.transcript.challenge_scalar(label)

    def __getattr__(self, name):
        return getattr(self.prover, name)
