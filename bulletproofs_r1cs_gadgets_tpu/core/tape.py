"""Constraint-tape lowering: LinearCombination lists -> flat index/coeff
arrays, and C-speed flattening by powers of the challenge z.

The dalek engine flattens constraints per proof (``flattened_constraints``
in its r1cs prover/verifier); the tape itself is witness-independent, so
this lowering happens once per synthesized circuit and is reused across
proofs of the same shape (tape caching).  Layout per
wire class: ``cidx[t]`` (constraint index -> z power), ``widx[t]`` (wire
index), ``coeff[t]`` ((m, 4) u64 rows); committed-wire and constant terms
store negated coefficients because both the prover's wV and the verifier's
wV/wc accumulate with a minus sign.
"""

from __future__ import annotations

import numpy as np

from ..utils.constants import L
from .linear_combination import VarKind
from .scalar import Scalar
from . import scvec


class TapeArrays:
    """A constraint tape in flat-array form (built once, flattened often)."""

    __slots__ = (
        "num_constraints", "lc", "rc", "oc", "vc", "onec",
    )

    def __init__(self, constraints):
        self.num_constraints = len(constraints)
        acc = {
            k: ([], [], [])  # cidx, widx, coeff ints
            for k in ("L", "R", "O", "V", "1")
        }
        kind_map = {
            VarKind.MULT_LEFT: "L",
            VarKind.MULT_RIGHT: "R",
            VarKind.MULT_OUT: "O",
            VarKind.COMMITTED: "V",
            VarKind.ONE: "1",
        }
        for c, lc in enumerate(constraints):
            for var, coeff in lc.terms:
                k = kind_map[var.kind]
                cidx, widx, co = acc[k]
                cidx.append(c)
                widx.append(var.index if k not in ("1",) else 0)
                # committed & constant terms enter negated (see module doc)
                co.append((-coeff.v) % L if k in ("V", "1") else coeff.v)

        def pack(key):
            cidx, widx, co = acc[key]
            return (
                np.asarray(cidx, dtype=np.int64),
                np.asarray(widx, dtype=np.int64),
                scvec.from_ints(co),
            )

        self.lc = pack("L")
        self.rc = pack("R")
        self.oc = pack("O")
        self.vc = pack("V")
        self.onec = pack("1")

    def flatten(self, z: Scalar, n: int, num_v: int, want_wc: bool = False):
        """Returns (wL, wR, wO, wV) as (k,4) u64 arrays — and the constant
        accumulator wc as a Scalar when ``want_wc`` (verifier side)."""
        # z, z^2, ..., z^m  (dalek starts at z^1 for the first constraint)
        zp = scvec.scale(scvec.powers(z, self.num_constraints), z)
        wL = scvec.flatten_terms(zp, self.lc[2], self.lc[0], self.lc[1], n)
        wR = scvec.flatten_terms(zp, self.rc[2], self.rc[0], self.rc[1], n)
        wO = scvec.flatten_terms(zp, self.oc[2], self.oc[0], self.oc[1], n)
        wV = scvec.flatten_terms(
            zp, self.vc[2], self.vc[0], self.vc[1], max(num_v, 1)
        )[:num_v]
        if not want_wc:
            return wL, wR, wO, wV
        wc_arr = scvec.flatten_terms(
            zp, self.onec[2], self.onec[0], self.onec[1], 1
        )
        return wL, wR, wO, wV, scvec.row_to_scalar(wc_arr[0])
