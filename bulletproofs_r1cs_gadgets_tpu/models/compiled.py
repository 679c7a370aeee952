"""Template-compiled circuits: record one structural segment, stamp N copies.

The reference synthesizes the VSMT circuit level by level through the full
LinearCombination algebra (``gadget_vsmt_2.rs:171-209`` +
``gadget_poseidon.rs:282-399``) — a per-proof cost that round 1 measured at
~350 s of Python for depth 253.  But the tape is *witness-independent* and
every tree level is structurally identical (same MDS/round-key coefficients,
indices shifted by a constant): the design is therefore
compile-once/stamp-many:

1. **Record**: run the unmodified gadget code for two consecutive levels on
   a recording constraint system whose committed variables are symbolic
   markers.  Level A captures the leaf-input variant, level B the chained
   variant (its select gates reference level A's hash-output wires).
2. **Stamp**: instantiate ``depth`` copies of the level-B segment with
   vectorized index offsets directly into :class:`~..core.tape.TapeArrays`
   form — no LC objects, no Python loops over terms.
3. **Witness**: the multiplier wire values come from a C++ recording
   Poseidon chain (``native/bptpu_native.cpp:vsmt2_chain_witness``) that
   emits every S-box (input, output) pair; numpy assembles the (n, 4)
   a_L/a_R/a_O arrays.

Because both prover and verifier load the same stamped tape, Fiat-Shamir
symmetry holds by construction; ``tests/test_compiled.py`` additionally
cross-verifies compiled-prover proofs with the generic verifier (and vice
versa), pinning tape equality with the reference circuit.
"""

from __future__ import annotations

import numpy as np

from ..core.scalar import Scalar
from ..core.linear_combination import (
    Variable,
    VarKind,
    LinearCombination,
    _coerce,
)
from ..core.tape import TapeArrays
from ..core import scvec
from ..utils.constants import L
from ..gadgets.poseidon import (
    PADDING_CONST,
    PoseidonParams,
    Poseidon_hash_2_constraints,
    SboxType,
)
from .vsmt2 import vsmt_level_gadget

try:
    from ..native import _native as _NATIVE
except Exception:  # pragma: no cover
    _NATIVE = None

# committed-variable markers used during recording
_MARK = 1 << 40
M_LEAF = _MARK
M_BIT_A = _MARK + 1
M_NODE_A = _MARK + 2
M_BIT_B = _MARK + 3
M_NODE_B = _MARK + 4
M_XL = _MARK + 5
M_XR = _MARK + 6
M_STATIC = _MARK + 16  # + j
# VSMT-4 sibling markers (segment A / segment B instances)
M_N1_A = _MARK + 32
M_N2_A = _MARK + 33
M_N3_A = _MARK + 34
M_N1_B = _MARK + 35
M_N2_B = _MARK + 36
M_N3_B = _MARK + 37


class _RecordingCS:
    """Witness-free constraint recorder (the Verifier's tape semantics)."""

    def __init__(self):
        self.num_vars = 0
        self.constraints: list[LinearCombination] = []
        self.pending_multiplier: int | None = None

    def multiply(self, left, right):
        left = _coerce(left)
        right = _coerce(right)
        i = self.num_vars
        self.num_vars += 1
        l_var = Variable.mult_left(i)
        r_var = Variable.mult_right(i)
        o_var = Variable.mult_out(i)
        self.constrain(left - l_var)
        self.constrain(right - r_var)
        return l_var, r_var, o_var

    def allocate(self, assignment=None):
        if self.pending_multiplier is None:
            i = self.num_vars
            self.num_vars += 1
            self.pending_multiplier = i
            return Variable.mult_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        return Variable.mult_right(i)

    def allocate_single(self, assignment=None):
        var = self.allocate(assignment)
        if var.kind == VarKind.MULT_RIGHT:
            return var, Variable.mult_out(var.index)
        return var, None

    def allocate_multiplier(self, assignment=None):
        i = self.num_vars
        self.num_vars += 1
        return (
            Variable.mult_left(i),
            Variable.mult_right(i),
            Variable.mult_out(i),
        )

    def constrain(self, lc) -> None:
        self.constraints.append(_coerce(lc))

    def evaluate_lc(self, lc):
        return None


def _collect_terms(constraints, c_lo: int, c_hi: int):
    """Recorded constraints [c_lo, c_hi) -> per-category flat term lists.

    Categories: 'L'/'R'/'O' (multiplier wires, local index), '1' (constant),
    and marker classes for committed variables.  Coefficients are ints.
    """
    out: dict = {}

    def add(cat, c_loc, w, coeff):
        lst = out.setdefault(cat, ([], [], []))
        lst[0].append(c_loc)
        lst[1].append(w)
        lst[2].append(coeff)

    kind_ch = {
        VarKind.MULT_LEFT: "L",
        VarKind.MULT_RIGHT: "R",
        VarKind.MULT_OUT: "O",
    }
    for c in range(c_lo, c_hi):
        for var, coeff in constraints[c].terms:
            k = var.kind
            if k in kind_ch:
                add(kind_ch[k], c - c_lo, var.index, coeff.v)
            elif k == VarKind.ONE:
                add("1", c - c_lo, 0, coeff.v)
            else:  # committed marker
                idx = var.index
                if idx in (M_N1_A, M_N1_B):
                    add("N1", c - c_lo, 0, coeff.v)
                elif idx in (M_N2_A, M_N2_B):
                    add("N2", c - c_lo, 0, coeff.v)
                elif idx in (M_N3_A, M_N3_B):
                    add("N3", c - c_lo, 0, coeff.v)
                elif idx >= M_STATIC:
                    add("S", c - c_lo, idx - M_STATIC, coeff.v)
                elif idx in (M_BIT_A, M_BIT_B):
                    add("BIT", c - c_lo, 0, coeff.v)
                elif idx in (M_NODE_A, M_NODE_B):
                    add("NODE", c - c_lo, 0, coeff.v)
                elif idx == M_LEAF:
                    add("LEAF", c - c_lo, 0, coeff.v)
                elif idx == M_XL:
                    add("XL", c - c_lo, 0, coeff.v)
                elif idx == M_XR:
                    add("XR", c - c_lo, 0, coeff.v)
                else:  # pragma: no cover
                    raise AssertionError(f"unknown marker {idx}")
    return {
        cat: (
            np.asarray(c_, dtype=np.int64),
            np.asarray(w_, dtype=np.int64),
            scvec.from_ints(co),
        )
        for cat, (c_, w_, co) in out.items()
    }


def _lc_terms(lc: LinearCombination):
    """LC -> same category encoding as :func:`_collect_terms` (single
    pseudo-constraint at index 0)."""
    fake = _RecordingCS()
    fake.constraints = [lc]
    return _collect_terms(fake.constraints, 0, 1)


_VSMT_TEMPLATE_CACHE: dict = {}


def _vsmt_templates(params: PoseidonParams, constrain_index_bits: bool):
    key = (
        params.width,
        params.full_rounds_beginning,
        params.partial_rounds,
        params.full_rounds_end,
        constrain_index_bits,
    )
    hit = _VSMT_TEMPLATE_CACHE.get(key)
    if hit is not None:
        return hit
    rec = _RecordingCS()
    statics_lcs = [
        Variable.committed(M_STATIC + j).lc() for j in range(4)
    ]
    out_a = vsmt_level_gadget(
        rec,
        Variable.committed(M_LEAF).lc(),
        Variable.committed(M_BIT_A),
        Variable.committed(M_NODE_A),
        statics_lcs,
        params,
        constrain_index_bits,
    )
    n_a, c_a = rec.num_vars, len(rec.constraints)
    out_b = vsmt_level_gadget(
        rec,
        out_a,
        Variable.committed(M_BIT_B),
        Variable.committed(M_NODE_B),
        statics_lcs,
        params,
        constrain_index_bits,
    )
    n_b, c_b = rec.num_vars - n_a, len(rec.constraints) - c_a
    assert n_a == n_b and c_a == c_b, "levels are not isomorphic"
    tpl = {
        "npl": n_a,
        "cpl": c_a,
        "seg_a": _collect_terms(rec.constraints, 0, c_a),
        "seg_b": _collect_terms(rec.constraints, c_a, 2 * c_a),
        "out_a": _lc_terms(out_a),
        "out_b": _lc_terms(out_b),
    }
    _VSMT_TEMPLATE_CACHE[key] = tpl
    return tpl


def _new_tape(num_constraints: int, parts: dict) -> TapeArrays:
    """Assemble a TapeArrays from accumulated per-kind stamped term arrays.

    ``parts`` maps 'L'/'R'/'O'/'V'/'1' to lists of (cidx, widx, coeff-array)
    triples; committed ('V') and constant ('1') coefficients are negated
    here (TapeArrays storage convention)."""
    tape = TapeArrays.__new__(TapeArrays)
    tape.num_constraints = num_constraints
    zero = (
        np.zeros(0, dtype=np.int64),
        np.zeros(0, dtype=np.int64),
        scvec.zeros(0),
    )

    def pack(kind, negate):
        triples = parts.get(kind, [])
        if not triples:
            return zero
        cidx = np.concatenate([t[0] for t in triples])
        widx = np.concatenate([t[1] for t in triples])
        coeff = np.concatenate([t[2] for t in triples])
        if negate and len(coeff):
            coeff = scvec.sub(scvec.zeros(len(coeff)), coeff)
        return (
            np.ascontiguousarray(cidx),
            np.ascontiguousarray(widx),
            np.ascontiguousarray(coeff),
        )

    tape.lc = pack("L", False)
    tape.rc = pack("R", False)
    tape.oc = pack("O", False)
    tape.vc = pack("V", True)
    tape.onec = pack("1", True)
    return tape


def _sbox_witness_arrays(sbox_uv: np.ndarray, sbox: SboxType):
    """(..., nsbox, 2, 4) u, out pairs -> per-sbox multiplier rows.

    Inverse: (u, u^-1, 1), (u, 0, 0), (u, u^-1, 1)   [3 multipliers]
    Cube:    (u, u, u^2), (u^2, u, u^3)              [2 multipliers]
    """
    u = sbox_uv[..., 0, :]
    out = sbox_uv[..., 1, :]
    lead = u.shape[:-1]
    zeros = np.zeros_like(u)
    if sbox is SboxType.Inverse:
        ones = np.zeros_like(u)
        ones[..., 0] = 1
        aL = np.stack([u, u, u], axis=-2)
        aR = np.stack([out, zeros, out], axis=-2)
        aO = np.stack([ones, zeros, ones], axis=-2)
        per = 3
    else:
        flat_u = u.reshape(-1, 4)
        usq = scvec.mul(flat_u, flat_u).reshape(u.shape)
        aL = np.stack([u, usq], axis=-2)
        aR = np.stack([u, u], axis=-2)
        aO = np.stack([usq, out], axis=-2)
        per = 2
    n = int(np.prod(lead)) * per
    return aL.reshape(n, 4), aR.reshape(n, 4), aO.reshape(n, 4)


def _params_blobs(params: PoseidonParams):
    rk = b"".join(s.to_bytes() for s in params.round_keys)
    mds = b"".join(s.to_bytes() for row in params.MDS_matrix for s in row)
    return rk, mds


class CompiledVSMT2:
    """Compile-once VSMT-2 membership circuit (SURVEY CS-2 workload).

    Produces the exact tape of
    :func:`..models.vsmt2.vanilla_merkle_tree_verif_gadget` with the bench's
    commitment layout: leaf (index 0), ``depth`` index bits, ``depth`` proof
    nodes, 4 statics — the order of ``gadget_vsmt_2.rs:296-330``.
    """

    def __init__(
        self,
        params: PoseidonParams,
        depth: int,
        constrain_index_bits: bool = False,
    ):
        assert depth >= 1
        self.params = params
        self.depth = depth
        self.constrain_index_bits = constrain_index_bits
        tpl = _vsmt_templates(params, constrain_index_bits)
        self.npl = tpl["npl"]
        self.cpl = tpl["cpl"]
        self._tpl = tpl
        self.num_multipliers = depth * self.npl
        self.num_constraints = depth * self.cpl + 1
        w = params.width
        self.nsbox = (
            params.full_rounds_beginning + params.full_rounds_end
        ) * w + params.partial_rounds
        # commitment layout (bench order)
        self.leaf_vidx = 0
        self.bits_vbase = 1
        self.nodes_vbase = 1 + depth
        self.statics_vbase = 1 + 2 * depth
        self.num_commitments = 2 * depth + 5

    # ------------------------------------------------------------------ tape
    def tape(self, root: Scalar) -> TapeArrays:
        depth, npl, cpl = self.depth, self.npl, self.cpl
        tpl = self._tpl
        parts: dict = {k: [] for k in ("L", "R", "O", "V", "1")}

        def emit(cat_terms, c_off, w_off, vmap):
            """Stamp one segment instance: multiplier wires shift by w_off,
            constraints by c_off, committed markers map via vmap."""
            for cat, (cidx, widx, coeff) in cat_terms.items():
                if cat in ("L", "R", "O"):
                    parts[cat].append((cidx + c_off, widx + w_off, coeff))
                elif cat == "1":
                    parts["1"].append((cidx + c_off, widx, coeff))
                elif cat == "S":
                    parts["V"].append(
                        (cidx + c_off, widx + self.statics_vbase, coeff)
                    )
                else:
                    parts["V"].append(
                        (
                            cidx + c_off,
                            np.full(len(cidx), vmap[cat], dtype=np.int64),
                            coeff,
                        )
                    )

        # level 0 (segment A; wires 0.., leaf input)
        emit(
            tpl["seg_a"], 0, 0,
            {
                "LEAF": self.leaf_vidx,
                "BIT": self.bits_vbase,
                "NODE": self.nodes_vbase,
            },
        )
        # levels 1..depth-1: segment B stamped with vectorized offsets
        if depth > 1:
            levels = np.arange(1, depth, dtype=np.int64)
            for cat, (cidx, widx, coeff) in tpl["seg_b"].items():
                m = len(cidx)
                if m == 0:
                    continue
                c_full = (
                    (levels - 1)[:, None] * cpl + cpl + cidx[None, :]
                ).reshape(-1)
                coeff_full = np.tile(coeff, (depth - 1, 1))
                if cat in ("L", "R", "O"):
                    w_full = (
                        (levels - 1)[:, None] * npl + widx[None, :]
                    ).reshape(-1)
                    parts[cat].append((c_full, w_full, coeff_full))
                elif cat == "1":
                    parts["1"].append(
                        (c_full, np.zeros(m * (depth - 1), np.int64), coeff_full)
                    )
                elif cat == "S":
                    w_full = np.tile(
                        widx + self.statics_vbase, depth - 1
                    )
                    parts["V"].append((c_full, w_full, coeff_full))
                elif cat == "BIT":
                    w_full = (
                        levels[:, None] + self.bits_vbase + 0 * widx[None, :]
                    ).reshape(-1)
                    parts["V"].append((c_full, w_full, coeff_full))
                elif cat == "NODE":
                    w_full = (
                        levels[:, None] + self.nodes_vbase + 0 * widx[None, :]
                    ).reshape(-1)
                    parts["V"].append((c_full, w_full, coeff_full))
                else:  # pragma: no cover
                    raise AssertionError(f"unexpected category {cat}")

        # root constraint: out(last level) - root == 0
        c_root = depth * cpl
        out = tpl["out_b"] if depth > 1 else tpl["out_a"]
        emit(
            out,
            c_root,
            (depth - 2) * npl if depth > 1 else 0,
            {
                "LEAF": self.leaf_vidx,
                "BIT": self.bits_vbase + depth - 1,
                "NODE": self.nodes_vbase + depth - 1,
            },
        )
        parts["1"].append(
            (
                np.asarray([c_root], dtype=np.int64),
                np.zeros(1, dtype=np.int64),
                scvec.from_ints([(-root.v) % L]),
            )
        )
        return _new_tape(self.num_constraints, parts)

    # --------------------------------------------------------------- witness
    def witness(self, leaf: Scalar, bits: list[int], nodes: list[Scalar]):
        """Multiplier wire arrays (a_L, a_R, a_O) for an honest witness.

        ``bits``: depth index bits (0/1, LSB first); ``nodes``: depth proof
        nodes ordered leaf level first (the reversed merkle proof)."""
        assert _NATIVE is not None, "compiled witness needs the native lib"
        depth = self.depth
        assert len(bits) == depth and len(nodes) == depth
        assert all(b in (0, 1) for b in bits)
        p = self.params
        rk, mds = _params_blobs(p)
        leaf_arr = scvec.from_scalars([leaf])
        bits_arr = scvec.from_ints(bits)
        nodes_arr = scvec.from_scalars(nodes)
        cur_chain = scvec.zeros(depth + 1)
        sbox_uv = np.zeros((depth, self.nsbox, 2, 4), dtype=np.uint64)
        _NATIVE._lib.vsmt2_chain_witness(
            scvec._ptr(leaf_arr),
            scvec._ptr(bits_arr),
            scvec._ptr(nodes_arr),
            depth,
            p.width,
            rk,
            mds,
            p.full_rounds_beginning,
            p.partial_rounds,
            p.full_rounds_end,
            1,  # inverse sbox
            scvec._ptr(scvec.from_ints([PADDING_CONST])),
            scvec._ptr(cur_chain),
            sbox_uv.ctypes.data_as(scvec._U64P),
        )
        # select gates
        cur = cur_chain[:depth]
        b_rows = bits_arr
        omb_rows = scvec.from_ints([1 - b for b in bits])
        zero_rows = scvec.zeros(depth)
        l1 = (omb_rows, cur, scvec.mul(omb_rows, cur))
        l2 = (b_rows, nodes_arr, scvec.mul(b_rows, nodes_arr))
        r1 = (b_rows, cur, scvec.mul(b_rows, cur))
        r2 = (omb_rows, nodes_arr, scvec.mul(omb_rows, nodes_arr))
        sel = [l1, l2, r1, r2]
        if self.constrain_index_bits:
            sel.insert(0, (b_rows, omb_rows, zero_rows))
        nsel = len(sel)
        sel_aL = np.stack([s[0] for s in sel], axis=1)  # (depth, nsel, 4)
        sel_aR = np.stack([s[1] for s in sel], axis=1)
        sel_aO = np.stack([s[2] for s in sel], axis=1)
        sb_aL, sb_aR, sb_aO = _sbox_witness_arrays(sbox_uv, SboxType.Inverse)
        per_sbox = 3
        sb_shape = (depth, self.nsbox * per_sbox, 4)

        def assemble(sel_part, sb_part):
            return np.concatenate(
                [sel_part, sb_part.reshape(sb_shape)], axis=1
            ).reshape(depth * (nsel + self.nsbox * per_sbox), 4)

        aL = assemble(sel_aL, sb_aL)
        aR = assemble(sel_aR, sb_aR)
        aO = assemble(sel_aO, sb_aO)
        assert len(aL) == self.num_multipliers
        self._root = scvec.row_to_scalar(cur_chain[depth])
        return aL, aR, aO

    # ---------------------------------------------------------- commitments
    def commit_prover(self, prover, leaf: Scalar, bits, nodes, rng=None):
        """Issue the bench-order commitments (leaf, bits, nodes, statics)
        and return their compressed forms for the verifier."""
        from ..gadgets.poseidon import allocate_statics_for_prover

        rand = (lambda: Scalar.random(rng)) if rng else Scalar.random
        comms = [prover.commit(leaf, rand())[0]]
        for b in bits:
            comms.append(prover.commit(Scalar(b), rand())[0])
        for nd in nodes:
            comms.append(prover.commit(nd, rand())[0])
        allocate_statics_for_prover(prover, 4)
        return comms

    def commit_verifier(self, verifier, comms, pc_gens):
        from ..gadgets.poseidon import allocate_statics_for_verifier

        for c in comms:
            verifier.commit(c)
        allocate_statics_for_verifier(verifier, 4, pc_gens)


_POSEIDON2_TEMPLATE_CACHE: dict = {}


class CompiledPoseidon2:
    """Compile-once Poseidon 2:1 preimage circuit (SURVEY CS-3): committed
    xl, xr and statics; constraint ``hash(xl, xr) == expected``."""

    def __init__(self, params: PoseidonParams, sbox: SboxType = SboxType.Inverse):
        self.params = params
        self.sbox = sbox
        key = (
            params.width,
            params.full_rounds_beginning,
            params.partial_rounds,
            params.full_rounds_end,
            sbox,
        )
        tpl = _POSEIDON2_TEMPLATE_CACHE.get(key)
        if tpl is None:
            rec = _RecordingCS()
            statics_lcs = [
                Variable.committed(M_STATIC + j).lc() for j in range(4)
            ]
            h = Poseidon_hash_2_constraints(
                rec,
                Variable.committed(M_XL).lc(),
                Variable.committed(M_XR).lc(),
                statics_lcs,
                params,
                sbox,
            )
            tpl = {
                "n": rec.num_vars,
                "c": len(rec.constraints),
                "seg": _collect_terms(rec.constraints, 0, len(rec.constraints)),
                "out": _lc_terms(h),
            }
            _POSEIDON2_TEMPLATE_CACHE[key] = tpl
        self._tpl = tpl
        self.num_multipliers = tpl["n"]
        self.num_constraints = tpl["c"] + 1
        w = params.width
        self.nsbox = (
            params.full_rounds_beginning + params.full_rounds_end
        ) * w + params.partial_rounds
        self.xl_vidx = 0
        self.xr_vidx = 1
        self.statics_vbase = 2

    def tape(self, expected: Scalar) -> TapeArrays:
        parts: dict = {k: [] for k in ("L", "R", "O", "V", "1")}
        vmap = {"XL": self.xl_vidx, "XR": self.xr_vidx}
        for src in (self._tpl["seg"], self._tpl["out"]):
            c_off = 0 if src is self._tpl["seg"] else self._tpl["c"]
            for cat, (cidx, widx, coeff) in src.items():
                if cat in ("L", "R", "O"):
                    parts[cat].append((cidx + c_off, widx, coeff))
                elif cat == "1":
                    parts["1"].append((cidx + c_off, widx, coeff))
                elif cat == "S":
                    parts["V"].append(
                        (cidx + c_off, widx + self.statics_vbase, coeff)
                    )
                else:
                    parts["V"].append(
                        (
                            cidx + c_off,
                            np.full(len(cidx), vmap[cat], dtype=np.int64),
                            coeff,
                        )
                    )
        parts["1"].append(
            (
                np.asarray([self._tpl["c"]], dtype=np.int64),
                np.zeros(1, dtype=np.int64),
                scvec.from_ints([(-expected.v) % L]),
            )
        )
        return _new_tape(self.num_constraints, parts)

    def witness(self, xl: Scalar, xr: Scalar):
        assert _NATIVE is not None, "compiled witness needs the native lib"
        p = self.params
        rk, mds = _params_blobs(p)
        state = scvec.from_ints(
            [0, xl.v, xr.v, PADDING_CONST, 0, 0]
        )
        out_state = scvec.zeros(p.width)
        sbox_uv = np.zeros((self.nsbox, 2, 4), dtype=np.uint64)
        _NATIVE._lib.poseidon_permutation_witness(
            scvec._ptr(state),
            scvec._ptr(out_state),
            p.width,
            rk,
            mds,
            p.full_rounds_beginning,
            p.partial_rounds,
            p.full_rounds_end,
            1 if self.sbox is SboxType.Inverse else 0,
            sbox_uv.ctypes.data_as(scvec._U64P),
        )
        aL, aR, aO = _sbox_witness_arrays(sbox_uv, self.sbox)
        assert len(aL) == self.num_multipliers
        self._hash = scvec.row_to_scalar(out_state[1])
        return aL, aR, aO


_VSMT4_TEMPLATE_CACHE: dict = {}


def _vsmt4_templates(params: PoseidonParams):
    from .vsmt4 import vsmt4_digit_gadget

    key = (
        params.width,
        params.full_rounds_beginning,
        params.partial_rounds,
        params.full_rounds_end,
    )
    hit = _VSMT4_TEMPLATE_CACHE.get(key)
    if hit is not None:
        return hit
    rec = _RecordingCS()
    statics_lcs = [
        Variable.committed(M_STATIC + j).lc() for j in range(2)
    ]
    out_a, b0a, b1a = vsmt4_digit_gadget(
        rec,
        Variable.committed(M_LEAF).lc(),
        None,
        Variable.committed(M_N1_A).lc(),
        Variable.committed(M_N2_A).lc(),
        Variable.committed(M_N3_A).lc(),
        statics_lcs,
        params,
    )
    n_a, c_a = rec.num_vars, len(rec.constraints)
    # the leaf-index recomposition reads each level's bit wires at fixed
    # local offsets — pin them
    assert (b0a.kind, b0a.index) == (VarKind.MULT_LEFT, 0)
    assert (b1a.kind, b1a.index) == (VarKind.MULT_LEFT, 1)
    out_b, _, _ = vsmt4_digit_gadget(
        rec,
        out_a,
        None,
        Variable.committed(M_N1_B).lc(),
        Variable.committed(M_N2_B).lc(),
        Variable.committed(M_N3_B).lc(),
        statics_lcs,
        params,
    )
    n_b, c_b = rec.num_vars - n_a, len(rec.constraints) - c_a
    assert n_a == n_b and c_a == c_b, "digit levels are not isomorphic"
    tpl = {
        "npl": n_a,
        "cpl": c_a,
        "seg_a": _collect_terms(rec.constraints, 0, c_a),
        "seg_b": _collect_terms(rec.constraints, c_a, 2 * c_a),
        "out_a": _lc_terms(out_a),
        "out_b": _lc_terms(out_b),
    }
    _VSMT4_TEMPLATE_CACHE[key] = tpl
    return tpl


class CompiledVSMT4:
    """Compile-once VSMT-4 membership circuit (BASELINE config 4;
    ``gadget_vsmt_4.rs:199-312``): ``depth`` base-4 digit levels of
    2 booleanity-constrained bit multipliers + 4 bit-products + 9 child
    placements + a Poseidon-4:1 hash (inverse S-box), then the leaf-index
    recomposition constraint and the root constraint.

    Commitment layout (the reference test's order,
    ``gadget_vsmt_4.rs:339-395`` / ``tests/test_trees.py``): leaf (0),
    leaf_index (1), then the merkle proof flattened root-level-first with
    each level's 3 siblings in child order, then 2 statics.
    """

    def __init__(self, params: PoseidonParams, depth: int):
        assert depth >= 1 and depth % 4 == 0
        self.params = params
        self.depth = depth
        tpl = _vsmt4_templates(params)
        self.npl = tpl["npl"]
        self.cpl = tpl["cpl"]
        self._tpl = tpl
        self.num_multipliers = depth * self.npl
        # + leaf-index recomposition + root constraint
        self.num_constraints = depth * self.cpl + 2
        w = params.width
        self.nsbox = (
            params.full_rounds_beginning + params.full_rounds_end
        ) * w + params.partial_rounds
        self.leaf_vidx = 0
        self.idx_vidx = 1
        self.nodes_vbase = 2
        self.statics_vbase = 2 + 3 * depth
        self.num_commitments = 3 * depth + 4

    @staticmethod
    def digit_bits(idx: Scalar, depth: int) -> list[tuple[int, int]]:
        """Per-level (bit0, bit1) pairs, leaf level first — exactly the
        gadget's byte/bit extraction (``gadget_vsmt_4.rs:226-233``)."""
        out = []
        for i in range(depth // 4):
            byte = idx.byte(i)
            for j in range(4):
                out.append(((byte >> (2 * j)) & 1, (byte >> (2 * j + 1)) & 1))
        return out

    def _node_vidx(self, level: int) -> int:
        """Committed index of sibling N1 at digit `level` (leaf level 0):
        the gadget pops from the tail of the root-first flattened list."""
        return self.nodes_vbase + 3 * (self.depth - 1 - level)

    # ------------------------------------------------------------------ tape
    def tape(self, root: Scalar) -> TapeArrays:
        depth, npl, cpl = self.depth, self.npl, self.cpl
        tpl = self._tpl
        parts: dict = {k: [] for k in ("L", "R", "O", "V", "1")}

        def emit(cat_terms, c_off, w_off, vmap):
            for cat, (cidx, widx, coeff) in cat_terms.items():
                if cat in ("L", "R", "O"):
                    parts[cat].append((cidx + c_off, widx + w_off, coeff))
                elif cat == "1":
                    parts["1"].append((cidx + c_off, widx, coeff))
                elif cat == "S":
                    parts["V"].append(
                        (cidx + c_off, widx + self.statics_vbase, coeff)
                    )
                else:
                    parts["V"].append(
                        (
                            cidx + c_off,
                            np.full(len(cidx), vmap[cat], dtype=np.int64),
                            coeff,
                        )
                    )

        # level 0 (segment A; leaf input)
        emit(
            tpl["seg_a"], 0, 0,
            {
                "LEAF": self.leaf_vidx,
                "N1": self._node_vidx(0),
                "N2": self._node_vidx(0) + 1,
                "N3": self._node_vidx(0) + 2,
            },
        )
        # levels 1..depth-1: segment B stamped with vectorized offsets
        if depth > 1:
            levels = np.arange(1, depth, dtype=np.int64)
            nvidx = self.nodes_vbase + 3 * (depth - 1 - levels)
            for cat, (cidx, widx, coeff) in tpl["seg_b"].items():
                m = len(cidx)
                if m == 0:
                    continue
                c_full = (
                    (levels - 1)[:, None] * cpl + cpl + cidx[None, :]
                ).reshape(-1)
                coeff_full = np.tile(coeff, (depth - 1, 1))
                if cat in ("L", "R", "O"):
                    w_full = (
                        (levels - 1)[:, None] * npl + widx[None, :]
                    ).reshape(-1)
                    parts[cat].append((c_full, w_full, coeff_full))
                elif cat == "1":
                    parts["1"].append(
                        (c_full, np.zeros(m * (depth - 1), np.int64),
                         coeff_full)
                    )
                elif cat == "S":
                    w_full = np.tile(widx + self.statics_vbase, depth - 1)
                    parts["V"].append((c_full, w_full, coeff_full))
                elif cat in ("N1", "N2", "N3"):
                    slot = {"N1": 0, "N2": 1, "N3": 2}[cat]
                    w_full = (
                        nvidx[:, None] + slot + 0 * widx[None, :]
                    ).reshape(-1)
                    parts["V"].append((c_full, w_full, coeff_full))
                else:  # pragma: no cover
                    raise AssertionError(f"unexpected category {cat}")

        # leaf-index recomposition: sum((2*b1 + b0) * 4^l) - idx == 0
        c_idx = depth * cpl
        pow4 = [pow(4, lv, L) for lv in range(depth)]
        b0_w = np.arange(depth, dtype=np.int64) * npl
        parts["L"].append((
            np.full(2 * depth, c_idx, dtype=np.int64),
            np.concatenate([b0_w, b0_w + 1]),
            scvec.from_ints(pow4 + [(2 * p) % L for p in pow4]),
        ))
        parts["V"].append((
            np.asarray([c_idx], dtype=np.int64),
            np.asarray([self.idx_vidx], dtype=np.int64),
            scvec.from_ints([L - 1]),
        ))

        # root constraint: out(last level) - root == 0
        c_root = depth * cpl + 1
        out = tpl["out_b"] if depth > 1 else tpl["out_a"]
        emit(
            out,
            c_root,
            (depth - 2) * npl if depth > 1 else 0,
            {
                "LEAF": self.leaf_vidx,
                "N1": self._node_vidx(depth - 1),
                "N2": self._node_vidx(depth - 1) + 1,
                "N3": self._node_vidx(depth - 1) + 2,
            },
        )
        parts["1"].append(
            (
                np.asarray([c_root], dtype=np.int64),
                np.zeros(1, dtype=np.int64),
                scvec.from_ints([(-root.v) % L]),
            )
        )
        return _new_tape(self.num_constraints, parts)

    # --------------------------------------------------------------- witness
    def witness(self, leaf: Scalar, idx: Scalar, nodes_flat: list[Scalar]):
        """Multiplier wire arrays (a_L, a_R, a_O) for an honest witness.

        ``nodes_flat``: the committed merkle proof, flattened root-level
        first (3 siblings per level in child order) — the order of
        :meth:`commit_prover`."""
        assert _NATIVE is not None, "compiled witness needs the native lib"
        depth = self.depth
        assert len(nodes_flat) == 3 * depth
        p = self.params
        rk, mds = _params_blobs(p)
        bits = self.digit_bits(idx, depth)
        one, zero = Scalar.one(), Scalar.zero()
        sbox_uv = np.zeros((depth, self.nsbox, 2, 4), dtype=np.uint64)
        sel_rows: list[list[tuple]] = []
        h = leaf
        for lv in range(depth):
            b0i, b1i = bits[lv]
            base = 3 * (depth - 1 - lv)
            N1, N2, N3 = nodes_flat[base : base + 3]
            b0 = Scalar(b0i)
            b1 = Scalar(b1i)
            nb0 = one - b0
            nb1 = one - b1
            p00, p01 = nb0 * nb1, nb0 * b1
            p10, p11 = b0 * nb1, b0 * b1
            tri = [
                (b0, nb0, zero),
                (b1, nb1, zero),
                (nb0, nb1, p00),
                (nb0, b1, p01),
                (b0, nb1, p10),
                (b0, b1, p11),
                (p00, h, p00 * h),
                (b0, N1, b0 * N1),
                (p01, N1, p01 * N1),
                (p00, N1, p00 * N1),
                (p10, h, p10 * h),
                (p01, N2, p01 * N2),
                (p11, N2, p11 * N2),
                (nb1, N2, nb1 * N2),
                (p01, h, p01 * h),
                (p11, N3, p11 * N3),
                (nb1, N3, nb1 * N3),
                (p01, N3, p01 * N3),
                (p11, h, p11 * h),
            ]
            sel_rows.append(tri)
            c0 = tri[6][2] + tri[7][2] + tri[8][2]
            c1 = tri[9][2] + tri[10][2] + tri[11][2] + tri[12][2]
            c2 = tri[13][2] + tri[14][2] + tri[15][2]
            c3 = tri[16][2] + tri[17][2] + tri[18][2]
            state = scvec.from_scalars(
                [zero, c0, c1, c2, c3, Scalar(PADDING_CONST)]
            )
            out_state = scvec.zeros(p.width)
            _NATIVE._lib.poseidon_permutation_witness(
                scvec._ptr(state),
                scvec._ptr(out_state),
                p.width,
                rk,
                mds,
                p.full_rounds_beginning,
                p.partial_rounds,
                p.full_rounds_end,
                1,  # inverse sbox
                sbox_uv[lv].ctypes.data_as(scvec._U64P),
            )
            h = scvec.row_to_scalar(out_state[1])
        nsel = len(sel_rows[0])
        sel_aL = scvec.from_scalars(
            [t[0] for tri in sel_rows for t in tri]
        ).reshape(depth, nsel, 4)
        sel_aR = scvec.from_scalars(
            [t[1] for tri in sel_rows for t in tri]
        ).reshape(depth, nsel, 4)
        sel_aO = scvec.from_scalars(
            [t[2] for tri in sel_rows for t in tri]
        ).reshape(depth, nsel, 4)
        sb_aL, sb_aR, sb_aO = _sbox_witness_arrays(sbox_uv, SboxType.Inverse)
        per_sbox = 3
        sb_shape = (depth, self.nsbox * per_sbox, 4)

        def assemble(sel_part, sb_part):
            return np.ascontiguousarray(np.concatenate(
                [sel_part, sb_part.reshape(sb_shape)], axis=1
            ).reshape(depth * (nsel + self.nsbox * per_sbox), 4))

        aL = assemble(sel_aL, sb_aL)
        aR = assemble(sel_aR, sb_aR)
        aO = assemble(sel_aO, sb_aO)
        assert len(aL) == self.num_multipliers
        self._root = h
        return aL, aR, aO

    # ---------------------------------------------------------- commitments
    def commit_prover(self, prover, leaf: Scalar, idx: Scalar, nodes_flat,
                      rng=None):
        from ..gadgets.poseidon import allocate_statics_for_prover

        rand = (lambda: Scalar.random(rng)) if rng else Scalar.random
        comms = [prover.commit(leaf, rand())[0]]
        comms.append(prover.commit(idx, rand())[0])
        for nd in nodes_flat:
            comms.append(prover.commit(nd, rand())[0])
        allocate_statics_for_prover(prover, 2)
        return comms

    def commit_verifier(self, verifier, comms, pc_gens):
        from ..gadgets.poseidon import allocate_statics_for_verifier

        for c in comms:
            verifier.commit(c)
        allocate_statics_for_verifier(verifier, 2, pc_gens)
