#!/usr/bin/env python3
"""Measure the single-core native (C++) baseline proxy and write
BASELINE_LOCAL.json (consumed by bench.py to emit vs_baseline).

Workloads match the bench stages exactly:
  * msm_65536_s        — one 65536-point MSM (stage 1's shape)
  * poseidon2_prove_s  — Poseidon 2:1 preimage proof (stage 2 circuit)
  * vsmt2_prove_s      — depth-253 VSMT-2 proof, CS-2 (stage 3/4 circuit)

Run standalone (CPU only; no accelerator needed):
  python scratch/measure_native_baseline.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "BASELINE_LOCAL.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cpu_model() -> str:
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def measure(out: dict) -> dict:
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu import (
        BulletproofGens, PedersenGens, Prover, Scalar, Transcript,
    )
    from bulletproofs_r1cs_gadgets_tpu.core import scvec
    from bulletproofs_r1cs_gadgets_tpu.gadgets.poseidon import (
        PoseidonParams, SboxType, Poseidon_hash_2,
        allocate_statics_for_prover,
    )
    from bulletproofs_r1cs_gadgets_tpu.models.compiled import (
        CompiledPoseidon2, CompiledVSMT2,
    )
    from bulletproofs_r1cs_gadgets_tpu.ops.native_backend import (
        NativeBackend, _gens_raw_u8,
    )

    be = NativeBackend()
    params = PoseidonParams(6, 4, 4, 140)
    pc = PedersenGens.default()

    # ---- MSM 65536 (stage-1 shape)
    if "msm_65536_s" not in out:
        n = 65536
        bp = BulletproofGens(n)
        rows = scvec.from_wide_bytes(np.random.RandomState(0).bytes(64 * n))
        coords = _gens_raw_u8(bp.G_raw(n))
        t0 = time.time()
        be._msm_raw(rows, coords)
        out["msm_65536_s"] = round(time.time() - t0, 4)
        log(f"msm_65536_s = {out['msm_65536_s']}")

    # ---- Poseidon 2:1 preimage proof (stage-2 circuit)
    if "poseidon2_prove_s" not in out:
        comp = CompiledPoseidon2(params, SboxType.Inverse)
        xl, xr = Scalar(31), Scalar(59)
        expected = Poseidon_hash_2(xl, xr, params, SboxType.Inverse)
        bp = BulletproofGens(2048)
        pr = Prover(pc, Transcript(b"PoseidonBench"))
        pr.commit(xl, Scalar.random())
        pr.commit(xr, Scalar.random())
        allocate_statics_for_prover(pr, 4)
        aL, aR, aO = comp.witness(xl, xr)
        pr.load_compiled(comp.tape(expected), aL, aR, aO)
        snap = pr.snapshot()
        pr.prove(bp, backend=be)  # warm caches
        pr.restore(snap)
        t0 = time.time()
        pr.prove(bp, backend=be)
        out["poseidon2_prove_s"] = round(time.time() - t0, 4)
        log(f"poseidon2_prove_s = {out['poseidon2_prove_s']}")

    # ---- VSMT-2 depth-253 (CS-2, the primary metric's circuit)
    if "vsmt2_prove_s" not in out:
        sys.path.insert(0, REPO)
        import bench

        depth = 253
        tree = bench._build_tree(params, depth)
        from bulletproofs_r1cs_gadgets_tpu.models.vsmt2 import (
            leaf_index_bit_scalars,
        )

        k = Scalar(7)
        mp = []
        assert tree.get(k, mp) == k
        bits = [b.v for b in leaf_index_bit_scalars(k, depth)]
        nodes = list(reversed(mp))
        padded = 1 << (depth * 568 - 1).bit_length()
        bp = BulletproofGens(padded)
        comp = CompiledVSMT2(params, depth, constrain_index_bits=False)
        tape = comp.tape(tree.root)
        pr = Prover(pc, Transcript(b"VSMT"))
        comp.commit_prover(pr, k, bits, nodes)
        aL, aR, aO = comp.witness(k, bits, nodes)
        pr.load_compiled(tape, aL, aR, aO)
        log(f"vsmt2: {pr.num_multipliers()} multipliers, proving "
            f"(single core)...")
        t0 = time.time()
        pr.prove(bp, backend=be)
        out["vsmt2_prove_s"] = round(time.time() - t0, 2)
        log(f"vsmt2_prove_s = {out['vsmt2_prove_s']}")

    # ---- VSMT-4 depth-128 (BASELINE config 4, stage-3b circuit)
    if "vsmt4_prove_s" not in out:
        from bulletproofs_r1cs_gadgets_tpu.models.compiled import (
            CompiledVSMT4,
        )

        depth = 128
        comp = CompiledVSMT4(params, depth)
        padded = 1 << (comp.num_multipliers - 1).bit_length()
        bp = BulletproofGens(padded)
        k = Scalar(7)
        nodes = [Scalar(1000 + i) for i in range(3 * depth)]
        aL, aR, aO = comp.witness(k, k, nodes)
        tape = comp.tape(comp._root)
        pr = Prover(pc, Transcript(b"VSMT"))
        comp.commit_prover(pr, k, k, nodes)
        pr.load_compiled(tape, aL, aR, aO)
        log(f"vsmt4: {pr.num_multipliers()} multipliers, proving "
            f"(single core)...")
        t0 = time.time()
        pr.prove(bp, backend=be)
        out["vsmt4_prove_s"] = round(time.time() - t0, 2)
        log(f"vsmt4_prove_s = {out['vsmt4_prove_s']}")

    out["machine"] = cpu_model()
    out["note"] = (
        "single-core C++ NativeBackend (ops/native_backend.py): "
        "dalek-serial-equivalent algorithms; stand-in for the reference's "
        "single-core Rust engine, measured on this host"
    )
    return out


def main():
    out = {}
    if os.path.exists(OUT) and "--force" not in sys.argv:
        out = json.load(open(OUT))
    out = measure(out)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
