"""Poseidon permutation and 2:1 / 4:1 hashes - native and circuit duals.

Reference: ``/root/reference/src/gadget_poseidon.rs``:
* native permutation :189-280 (full/partial/full rounds; the partial rounds
  apply the S-box to the LAST lane only, :237-239)
* circuit dual :282-399 with per-partial-round LC simplification :365
* S-boxes: cube :141-150 (2 multipliers) and inverse :153-185 (x -> (x+k)^-1,
  3 multipliers via allocate_single + is_nonzero + product==1)
* 2:1 hash :428-486 (input layout [0, xl, xr, PAD, 0, 0], output lane 1),
  4:1 hash :488-551 ([0, i0..i3, PAD]); PADDING_CONST = 101 :425
* static commitments (to 0 / PAD with blinding 0) :554-608

The native permutation is duplicated as a batched device program in
:mod:`bulletproofs_r1cs_gadgets_tpu.ops.poseidon` (used for bulk tree
updates); this host version is its correctness oracle.
"""

from __future__ import annotations

from enum import Enum

from ..core.scalar import Scalar, batch_invert
from ..core.linear_combination import LinearCombination, _coerce
from ..core.errors import GadgetError
from .r1cs_utils import AllocatedScalar, constrain_lc_with_scalar
from .zero_nonzero import is_nonzero_gadget
from .poseidon_params import PoseidonParams

from ..utils.config import DEFAULT_CONFIG

PADDING_CONST = DEFAULT_CONFIG.poseidon.padding_const  # gadget_poseidon.rs:425
ZERO_CONST = DEFAULT_CONFIG.poseidon.zero_const  # gadget_poseidon.rs:426

try:
    from ..native import _native as _NATIVE
except Exception:  # pragma: no cover
    _NATIVE = None

_NATIVE_PARAM_CACHE: dict = {}


def _poseidon_native(inputs, params, sbox):
    key = id(params)
    cached = _NATIVE_PARAM_CACHE.get(key)
    if cached is None:
        rk = b"".join(s.to_bytes() for s in params.round_keys)
        mds = b"".join(s.to_bytes() for row in params.MDS_matrix for s in row)
        cached = (rk, mds)
        _NATIVE_PARAM_CACHE[key] = cached
    rk, mds = cached
    states = b"".join(s.to_bytes() for s in inputs)
    out = _NATIVE.poseidon_permutation_batch(
        states, 1, params.width, rk, mds,
        params.full_rounds_beginning, params.partial_rounds,
        params.full_rounds_end, 0 if sbox is SboxType.Cube else 1,
    )
    return [
        Scalar(int.from_bytes(out[32 * i : 32 * i + 32], "little"))
        for i in range(params.width)
    ]


class SboxType(Enum):
    Cube = "cube"
    Inverse = "inverse"

    def apply_sbox(self, elem: Scalar) -> Scalar:
        if self is SboxType.Cube:
            return elem * elem * elem
        return elem.invert()

    def synthesize_sbox(self, cs, input_lc, round_key: Scalar):
        if self is SboxType.Cube:
            return _synthesize_cube_sbox(cs, input_lc, round_key)
        if self is SboxType.Inverse:
            return _synthesize_inverse_sbox(cs, input_lc, round_key)
        raise GadgetError("Unknown Sbox type")


def _synthesize_cube_sbox(cs, input_lc, round_key: Scalar):
    inp_plus_const = _coerce(input_lc) + round_key
    i, _, sqr = cs.multiply(inp_plus_const, inp_plus_const)
    _, _, cube = cs.multiply(sqr.lc(), i.lc())
    return cube


def _synthesize_inverse_sbox(cs, input_lc, round_key: Scalar):
    inp_plus_const = _coerce(input_lc) + round_key
    val_l = cs.evaluate_lc(inp_plus_const)
    val_r = val_l.invert() if val_l is not None else None

    var_l, _ = cs.allocate_single(val_l)
    var_r, var_o = cs.allocate_single(val_r)

    # (x + k) != 0, and l * r wires belong to one multiplier
    is_nonzero_gadget(
        cs,
        AllocatedScalar(var_l, val_l),
        AllocatedScalar(var_r, val_r),
    )
    # product of (x + k) and its inverse is 1
    constrain_lc_with_scalar(cs, var_o.lc(), Scalar.one())
    return var_r


def simplify_lc(lc: LinearCombination) -> LinearCombination:
    """Deduplicate LC terms (``gadget_poseidon.rs:99-112``); keeps partial
    rounds from growing LCs quadratically."""
    return lc.simplify()


def Poseidon_permutation(
    inputs: list[Scalar], params: PoseidonParams, sbox: SboxType
) -> list[Scalar]:
    """Native permutation (``gadget_poseidon.rs:189-280``).

    Dispatches to the C++ implementation (native/bptpu_native.cpp) when
    built; the pure-Python path below is the reference oracle.
    """
    width = params.width
    assert len(inputs) == width
    if _NATIVE is not None:
        return _poseidon_native(inputs, params, sbox)
    state = list(inputs)
    keys = params.round_keys
    mds = params.MDS_matrix
    off = 0

    def linear_layer(s):
        return [
            Scalar(sum(mds[i][j].v * s[j].v for j in range(width)))
            for i in range(width)
        ]

    for _ in range(params.full_rounds_beginning):
        state = [sbox.apply_sbox(state[i] + keys[off + i]) for i in range(width)]
        off += width
        state = linear_layer(state)

    for _ in range(params.partial_rounds):
        state = [state[i] + keys[off + i] for i in range(width)]
        off += width
        state[width - 1] = sbox.apply_sbox(state[width - 1])
        state = linear_layer(state)

    for _ in range(params.full_rounds_end):
        state = [sbox.apply_sbox(state[i] + keys[off + i]) for i in range(width)]
        off += width
        state = linear_layer(state)

    return state


def Poseidon_permutation_constraints(
    cs, inputs: list, params: PoseidonParams, sbox_type: SboxType
) -> list[LinearCombination]:
    """Circuit dual (``gadget_poseidon.rs:282-399``)."""
    width = params.width
    assert len(inputs) == width
    input_vars = [_coerce(x) for x in inputs]
    keys = params.round_keys
    mds = params.MDS_matrix
    off = 0

    def apply_linear_layer(sbox_outs):
        next_inputs = [LinearCombination() for _ in range(width)]
        for j in range(width):
            for i in range(width):
                next_inputs[i] = next_inputs[i] + sbox_outs[j] * mds[i][j]
        return next_inputs

    for _ in range(params.full_rounds_beginning):
        sbox_outputs = [
            _coerce(sbox_type.synthesize_sbox(cs, input_vars[i], keys[off + i]))
            for i in range(width)
        ]
        off += width
        input_vars = apply_linear_layer(sbox_outputs)

    for _ in range(params.partial_rounds):
        sbox_outputs = []
        for i in range(width):
            if i == width - 1:
                sbox_outputs.append(
                    _coerce(
                        sbox_type.synthesize_sbox(cs, input_vars[i], keys[off + i])
                    )
                )
            else:
                sbox_outputs.append(input_vars[i] + keys[off + i])
        off += width
        # simplify to keep LC term counts bounded across partial rounds
        input_vars = [simplify_lc(lc) for lc in apply_linear_layer(sbox_outputs)]

    for _ in range(params.full_rounds_end):
        sbox_outputs = [
            _coerce(sbox_type.synthesize_sbox(cs, input_vars[i], keys[off + i]))
            for i in range(width)
        ]
        off += width
        input_vars = apply_linear_layer(sbox_outputs)

    return input_vars


def Poseidon_permutation_gadget(
    cs,
    inputs: list[AllocatedScalar],
    params: PoseidonParams,
    sbox_type: SboxType,
    output: list[Scalar],
) -> None:
    width = params.width
    assert len(output) == width
    input_lcs = [e.variable.lc() for e in inputs]
    perm_output = Poseidon_permutation_constraints(cs, input_lcs, params, sbox_type)
    for i in range(width):
        constrain_lc_with_scalar(cs, perm_output[i], output[i])


# --- 2:1 hash: input layout [0, xl, xr, PAD, 0, 0], output lane 1 ----------

def Poseidon_hash_2(
    xl: Scalar, xr: Scalar, params: PoseidonParams, sbox: SboxType
) -> Scalar:
    inputs = [
        Scalar(ZERO_CONST),
        xl,
        xr,
        Scalar(PADDING_CONST),
        Scalar(ZERO_CONST),
        Scalar(ZERO_CONST),
    ]
    return Poseidon_permutation(inputs, params, sbox)[1]


def Poseidon_hash_2_constraints(
    cs, xl, xr, statics: list, params: PoseidonParams, sbox_type: SboxType
) -> LinearCombination:
    width = params.width
    assert len(statics) == width - 2
    inputs = [statics[0], _coerce(xl), _coerce(xr)] + list(statics[1:])
    return Poseidon_permutation_constraints(cs, inputs, params, sbox_type)[1]


def Poseidon_hash_2_gadget(
    cs,
    xl: AllocatedScalar,
    xr: AllocatedScalar,
    statics: list[AllocatedScalar],
    params: PoseidonParams,
    sbox_type: SboxType,
    output: Scalar,
) -> None:
    statics_lcs = [s.variable.lc() for s in statics]
    h = Poseidon_hash_2_constraints(
        cs, xl.variable.lc(), xr.variable.lc(), statics_lcs, params, sbox_type
    )
    constrain_lc_with_scalar(cs, h, output)


# --- 4:1 hash: input layout [0, i0, i1, i2, i3, PAD], output lane 1 --------

def Poseidon_hash_4(
    inputs: list[Scalar], params: PoseidonParams, sbox: SboxType
) -> Scalar:
    assert len(inputs) == 4
    full = [
        Scalar(ZERO_CONST),
        inputs[0],
        inputs[1],
        inputs[2],
        inputs[3],
        Scalar(PADDING_CONST),
    ]
    return Poseidon_permutation(full, params, sbox)[1]


def Poseidon_hash_4_constraints(
    cs, inputs: list, statics: list, params: PoseidonParams, sbox_type: SboxType
) -> LinearCombination:
    width = params.width
    assert len(statics) == width - 4
    full = [statics[0]] + [_coerce(x) for x in inputs] + list(statics[1:])
    return Poseidon_permutation_constraints(cs, full, params, sbox_type)[1]


def Poseidon_hash_4_gadget(
    cs,
    inputs: list[AllocatedScalar],
    statics: list[AllocatedScalar],
    params: PoseidonParams,
    sbox_type: SboxType,
    output: Scalar,
) -> None:
    statics_lcs = [s.variable.lc() for s in statics]
    input_lcs = [x.variable.lc() for x in inputs]
    h = Poseidon_hash_4_constraints(cs, input_lcs, statics_lcs, params, sbox_type)
    constrain_lc_with_scalar(cs, h, output)


# --- static commitments -----------------------------------------------------

def allocate_statics_for_prover(prover, num_statics: int) -> list[AllocatedScalar]:
    """Commitments to [0, PAD, 0, ...] with blinding 0
    (``gadget_poseidon.rs:554-578``)."""
    statics = []
    _, var = prover.commit(Scalar(ZERO_CONST), Scalar.zero())
    statics.append(AllocatedScalar(var, Scalar(ZERO_CONST)))
    _, var = prover.commit(Scalar(PADDING_CONST), Scalar.zero())
    statics.append(AllocatedScalar(var, Scalar(PADDING_CONST)))
    for _ in range(2, num_statics):
        _, var = prover.commit(Scalar(ZERO_CONST), Scalar.zero())
        statics.append(AllocatedScalar(var, Scalar(ZERO_CONST)))
    return statics


def allocate_statics_for_verifier(
    verifier, num_statics: int, pc_gens
) -> list[AllocatedScalar]:
    """Verifier re-derives the static commitments as pc_gens.commit(c, 0)
    (``gadget_poseidon.rs:581-608``)."""
    pad_comm = pc_gens.commit(Scalar(PADDING_CONST), Scalar.zero()).compress()
    zero_comm = pc_gens.commit(Scalar(ZERO_CONST), Scalar.zero()).compress()
    statics = [AllocatedScalar(verifier.commit(zero_comm))]
    statics.append(AllocatedScalar(verifier.commit(pad_comm)))
    for _ in range(2, num_statics):
        statics.append(AllocatedScalar(verifier.commit(zero_comm)))
    return statics
