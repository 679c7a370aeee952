#!/usr/bin/env python3
"""Smoke test of the prover on the GPU: drives the main path once, through
the entry points a user calls, and checks every result exactly.

    python chip_smoke.py                # one card: phases 0-4
    python chip_smoke.py --four-cards   # four cards: the multi-card paths

Phases (one card):
  0. preflight: a GPU, the C++ helper library, the card's name and power
     limit, versions, the compile-cache directory, the host crossover;
  1. MSM at n = 2^16 + 3 against the C++ NativeBackend, and the plain
     MSM's warm time at 2^16 and 2^18;
  2. depth-8 VSMT-2: host path, NativeBackend and DeviceBackend proofs are
     byte-identical, verify on the card, and a flipped byte is rejected;
  3. depth-253 VSMT-2 (2^18 padded): DeviceBackend proof == NativeBackend
     proof, verifies on the card, a wrong root is rejected;
  4. three VSMT-4 depth-128 proofs through ``prove_provers`` equal the
     same provers proved one by one, and verify in one ``batch_verify``.

``--four-cards`` runs only ``prove_provers_devices`` over four cards and a
``ShardedMsmBackend`` on a 1x4 ``points`` mesh, each against its
single-card reference.  Every phase prints its wall time and the compile
time spent in it.  Any failure raises; only a run in which every check
passed prints the final JSON line.

``SIZES`` and ``BACKEND_KW`` hold the real widths and the production
backend; the CPU tests shrink both to rehearse the phases' logic.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Sizes:
    msm_n: int = (1 << 16) + 3  # +3 exercises the tail chunk
    timing_log2: tuple = (16, 18)  # plain-MSM timings
    eq_depth: int = 8  # 4,544 multipliers, 8,192 padded
    full_depth: int = 253  # 143,704 multipliers, 2^18 padded
    batch_depth: int = 128  # VSMT-4: 74,624 multipliers, 2^17 padded
    hash_params: tuple = (6, 4, 4, 140)  # Poseidon width and rounds


SIZES = Sizes()
BACKEND_KW: dict = {}  # DeviceBackend/ShardedMsmBackend shape arguments

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class Phase:
    """Context manager that prints a phase's wall time and the seconds
    JAX spent tracing, lowering and compiling inside it."""

    _compile = {"s": 0.0, "n": 0}
    _installed = False

    @classmethod
    def install(cls):
        import jax

        if cls._installed:
            return
        cls._installed = True

        def listener(event, duration, **_):
            if event in _COMPILE_EVENTS:
                cls._compile["s"] += duration
                if event == _COMPILE_EVENTS[-1]:
                    cls._compile["n"] += 1

        jax.monitoring.register_event_duration_secs_listener(listener)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        self.c0 = dict(self._compile)
        print(f"[{self.name}] start", flush=True)
        return self

    def lap(self, what: str, t0: float, c0: dict | None = None) -> float:
        """Print one timed step; returns its wall seconds."""
        dt = time.time() - t0
        extra = ""
        if c0 is not None:
            extra = (f" (compile {self._compile['s'] - c0['s']:.1f} s, "
                     f"{self._compile['n'] - c0['n']} compiles)")
        print(f"[{self.name}] {what}: {dt:.3f} s{extra}", flush=True)
        return dt

    def timed(self, what: str, fn, *args, **kw):
        t0, c0 = time.time(), dict(self._compile)
        out = fn(*args, **kw)
        self.lap(what, t0, c0)
        return out

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            self.lap("phase wall", self.t0, self.c0)


def _seeded_rows(n: int, seed: int):
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu.core import scvec

    return scvec.from_wide_bytes(np.random.RandomState(seed).bytes(64 * n))


def _device_backend():
    from bulletproofs_r1cs_gadgets_tpu.ops.backend import DeviceBackend

    return DeviceBackend(**BACKEND_KW)


def _native_backend():
    from bulletproofs_r1cs_gadgets_tpu.ops.native_backend import (
        NativeBackend,
    )

    return NativeBackend(threads=0)


def _params():
    from bulletproofs_r1cs_gadgets_tpu.gadgets.poseidon import PoseidonParams

    return PoseidonParams(*SIZES.hash_params)


# ------------------------------------------------------------------ phase 0
def preflight(four_cards: bool) -> None:
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})"
        )
    if four_cards and len(devices) < 4:
        raise SystemExit(f"chip_smoke: --four-cards found {len(devices)} GPU(s)")
    from bulletproofs_r1cs_gadgets_tpu.ops.native_backend import (
        native_available,
    )

    if not native_available():
        raise SystemExit("chip_smoke: the C++ helper library did not build")
    import jaxlib

    from bulletproofs_r1cs_gadgets_tpu.utils import jaxcfg
    from bulletproofs_r1cs_gadgets_tpu.utils.config import DEFAULT_CONFIG

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"[preflight] devices {len(devices)} x {devices[0].device_kind}; "
          f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
          f"compile cache {jaxcfg.cache_dir()}; "
          f"min_device_n {DEFAULT_CONFIG.engine.min_device_n}", flush=True)


# ------------------------------------------------------------------ phase 1
def msm_program_text(n: int = 16) -> str:
    """StableHLO of one MSM chunk, as handed to XLA."""
    import jax
    import jax.numpy as jnp

    from bulletproofs_r1cs_gadgets_tpu.ops.field import STORE
    from bulletproofs_r1cs_gadgets_tpu.ops.msm import msm_chunk_impl

    return jax.jit(msm_chunk_impl).lower(
        jnp.zeros((n, 4, STORE), jnp.int32), jnp.zeros((n, 64), jnp.uint8)
    ).as_text()


def phase_msm() -> None:
    import jax

    from bulletproofs_r1cs_gadgets_tpu import BulletproofGens
    from bulletproofs_r1cs_gadgets_tpu.ops.curve import points_from_device

    with Phase("phase 1 msm") as ph:
        hlo = msm_program_text()
        for bad in ("f16", "f32", "f64", "dot_general"):
            assert bad not in hlo, f"the MSM program contains {bad}"
        print(f"[{ph.name}] MSM program: integer ops only, no dot",
              flush=True)

        native, dev = _native_backend(), _device_backend()
        cap = max(SIZES.msm_n, *(1 << k for k in SIZES.timing_log2))
        gens = BulletproofGens(1 << (cap - 1).bit_length()).share(0)
        n = SIZES.msm_n
        points = gens.G(n)
        for label, seed in (("cold", 1), ("warm", 2)):
            rows = _seeded_rows(n, seed)
            got = ph.timed(f"DeviceBackend.msm n={n} {label}", dev.msm,
                           rows, points)
            assert got.compress() == native.msm(rows, points).compress(), \
                "device MSM != native MSM"

        for k in SIZES.timing_log2:
            m = 1 << k
            rows = _seeded_rows(m, seed=3 + k)
            G = dev._gens_device(gens, m, "G")
            out = ph.timed(f"plain MSM 2^{k} on the card (warm)",
                           lambda: jax.block_until_ready(dev._msm_dev(rows, G)))
            want = native.msm(rows, gens.G(m)).compress()
            assert points_from_device(out[None])[0].compress() == want


# --------------------------------------------------------- shared circuits
def vsmt2_equivalence_circuit():
    """A real VSMT-2 tree of depth ``SIZES.eq_depth`` with seeded prover and
    commitment rngs; returns prove(backend) and verify(proof, comms,
    backend)."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu import (
        BulletproofGens, PedersenGens, Prover, Scalar, Transcript, Verifier,
    )
    from bulletproofs_r1cs_gadgets_tpu.models.compiled import CompiledVSMT2
    from bulletproofs_r1cs_gadgets_tpu.models.vsmt2 import (
        VanillaSparseMerkleTree, leaf_index_bit_scalars,
    )

    depth, params = SIZES.eq_depth, _params()
    tree = VanillaSparseMerkleTree(params, depth=depth)
    for i in range(1, 4):
        tree.update(Scalar(i), Scalar(i))
    k = Scalar(2)
    mp = []
    assert tree.get(k, mp) == k
    bits = [b.v for b in leaf_index_bit_scalars(k, depth)]
    nodes = list(reversed(mp))
    comp = CompiledVSMT2(params, depth, constrain_index_bits=False)
    tape = comp.tape(tree.root)
    wires = comp.witness(k, bits, nodes)
    pc = PedersenGens.default()
    bp = BulletproofGens(1 << (comp.num_multipliers - 1).bit_length())

    def prove(backend):
        prover = Prover(pc, Transcript(b"VSMT"), rng=np.random.RandomState(42))
        comms = comp.commit_prover(prover, k, bits, nodes,
                                   rng=np.random.RandomState(7))
        prover.load_compiled(tape, *wires)
        return prover.prove(bp, backend=backend), comms

    def verify(proof, comms, backend):
        verifier = Verifier(Transcript(b"VSMT"))
        comp.commit_verifier(verifier, comms, pc)
        verifier.load_compiled(tape, comp.num_multipliers)
        verifier.verify(proof, pc, bp, backend=backend)

    return prove, verify


def vsmt4_provers(count: int):
    """``count`` seeded VSMT-4 provers of depth ``SIZES.batch_depth`` with
    synthetic path nodes; returns (provers, verifier factories, pc, bp,
    circuit).  Each call rebuilds them with the same seeds."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu import (
        BulletproofGens, PedersenGens, Prover, Scalar, Transcript, Verifier,
    )
    from bulletproofs_r1cs_gadgets_tpu.models.compiled import CompiledVSMT4

    depth = SIZES.batch_depth
    comp = CompiledVSMT4(_params(), depth)
    pc = PedersenGens.default()
    bp = BulletproofGens(1 << (comp.num_multipliers - 1).bit_length())

    def build(i):
        rng = np.random.RandomState(100 + i)
        k = Scalar(7 + i)
        nodes = [Scalar.random(rng) for _ in range(3 * depth)]
        wires = comp.witness(k, k, nodes)
        tape = comp.tape(comp._root)
        prover = Prover(pc, Transcript(b"VSMT4"), rng=rng)
        comms = comp.commit_prover(prover, k, k, nodes, rng=rng)
        prover.load_compiled(tape, *wires)

        def verifier():
            v = Verifier(Transcript(b"VSMT4"))
            comp.commit_verifier(v, comms, pc)
            v.load_compiled(tape, comp.num_multipliers)
            return v

        return prover, verifier

    made = [build(i) for i in range(count)]
    return [p for p, _ in made], [v for _, v in made], pc, bp, comp


# ------------------------------------------------------------------ phase 2
def phase_equivalence() -> None:
    from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError
    from bulletproofs_r1cs_gadgets_tpu.core.proof import R1CSProof

    with Phase("phase 2 equivalence") as ph:
        prove, verify = vsmt2_equivalence_circuit()
        dev = _device_backend()
        host, comms = ph.timed("host-path proof", prove, None)
        native, _ = ph.timed("NativeBackend proof", prove, _native_backend())
        device, _ = ph.timed("DeviceBackend proof (cold)", prove, dev)
        blobs = {host.to_bytes(), native.to_bytes(), device.to_bytes()}
        assert len(blobs) == 1, "host, native and device proofs differ"
        ph.timed("DeviceBackend verify", verify, device, comms, dev)
        raw = bytearray(device.to_bytes())
        raw[-32] ^= 1
        try:
            verify(R1CSProof.from_bytes(bytes(raw)), comms, dev)
        except VerificationError:
            pass
        else:
            raise AssertionError("a flipped proof byte verified")
        print(f"[{ph.name}] 3 paths byte-identical "
              f"({len(device.to_bytes())} B), verified; tamper rejected",
              flush=True)


# ------------------------------------------------------------------ phase 3
def phase_full_width() -> None:
    import jax
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu import (
        BulletproofGens, PedersenGens, Prover, Scalar, Transcript, Verifier,
    )
    from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError
    from bulletproofs_r1cs_gadgets_tpu.models.compiled import CompiledVSMT2
    from bulletproofs_r1cs_gadgets_tpu.models.vsmt2 import (
        leaf_index_bit_scalars,
    )

    depth = SIZES.full_depth
    with Phase(f"phase 3 vsmt2 depth {depth}") as ph:
        rng = np.random.RandomState(2530)
        t0 = time.time()
        comp = CompiledVSMT2(_params(), depth, constrain_index_bits=False)
        k = Scalar(7)
        bits = [b.v for b in leaf_index_bit_scalars(k, depth)]
        nodes = [Scalar.random(rng) for _ in range(depth)]
        wires = comp.witness(k, bits, nodes)
        tape = comp.tape(comp._root)
        pc = PedersenGens.default()
        bp = BulletproofGens(1 << (comp.num_multipliers - 1).bit_length())
        ph.lap(f"synthesis + gens ({comp.num_multipliers} multipliers, "
               f"{bp.gens_capacity} padded)", t0)

        def prove(backend):
            prover = Prover(pc, Transcript(b"VSMT"),
                            rng=np.random.RandomState(11))
            comms = comp.commit_prover(prover, k, bits, nodes,
                                       rng=np.random.RandomState(12))
            prover.load_compiled(tape, *wires)
            return prover.prove(bp, backend=backend), comms

        def verify(proof, comms, backend, root):
            verifier = Verifier(Transcript(b"VSMT"))
            comp.commit_verifier(verifier, comms, pc)
            verifier.load_compiled(comp.tape(root), comp.num_multipliers)
            verifier.verify(proof, pc, bp, backend=backend)

        dev = _device_backend()
        native, comms = ph.timed("NativeBackend proof", prove,
                                 _native_backend())
        device, _ = ph.timed("DeviceBackend prove (cold)", prove, dev)
        assert device.to_bytes() == native.to_bytes(), \
            f"depth-{depth} device proof != native proof"
        ph.timed("DeviceBackend prove (warm)", prove, dev)
        ph.timed("DeviceBackend verify", verify, device, comms, dev,
                 comp._root)
        try:
            verify(device, comms, dev, comp._root + Scalar(1))
        except VerificationError:
            pass
        else:
            raise AssertionError("a wrong root verified")
        stats = jax.devices()[0].memory_stats() or {}
        print(f"[{ph.name}] proof == native ({len(device.to_bytes())} B), "
              f"verified; wrong root rejected; peak_bytes_in_use "
              f"{stats.get('peak_bytes_in_use')}", flush=True)


# ------------------------------------------------------------------ phase 4
def phase_batch() -> None:
    from bulletproofs_r1cs_gadgets_tpu import batch_verify
    from bulletproofs_r1cs_gadgets_tpu.parallel.batch import prove_provers

    with Phase(f"phase 4 vsmt4 depth {SIZES.batch_depth} batch") as ph:
        provers, verifiers, pc, bp, comp = ph.timed(
            "build 3 seeded VSMT-4 provers", vsmt4_provers, 3
        )
        dev = _device_backend()
        proofs = ph.timed("prove_provers x3 on DeviceBackend",
                          prove_provers, provers, bp, backend=dev)
        native = _native_backend()
        singles = [p.prove(bp, backend=native).to_bytes()
                   for p in vsmt4_provers(3)[0]]
        assert [p.to_bytes() for p in proofs] == singles, \
            "batched proofs != the same provers proved one by one"
        ph.timed("batch_verify x3 (one combined MSM) on DeviceBackend",
                 batch_verify, [v() for v in verifiers], proofs, pc, bp,
                 backend=dev)
        print(f"[{ph.name}] {len(proofs)} proofs ({comp.num_multipliers} "
              f"multipliers) == one-by-one NativeBackend proofs; "
              f"batch-verified", flush=True)


# ------------------------------------------------------------- four cards
def phase_four_cards(devices) -> None:
    """Batch axis (``prove_provers_devices``) and points axis
    (``ShardedMsmBackend`` on a 1x4 mesh) against single-card runs."""
    from bulletproofs_r1cs_gadgets_tpu import BulletproofGens
    from bulletproofs_r1cs_gadgets_tpu.parallel.batch import prove_provers
    from bulletproofs_r1cs_gadgets_tpu.parallel.device_batch import (
        prove_provers_devices,
    )
    from bulletproofs_r1cs_gadgets_tpu.parallel.mesh import make_mesh
    from bulletproofs_r1cs_gadgets_tpu.parallel.sharded_backend import (
        ShardedMsmBackend,
    )

    with Phase("four cards: batch axis") as ph:
        provers, _, _, bp, _ = vsmt4_provers(4)
        placed = ph.timed(
            "prove_provers_devices: 4 VSMT-4 proofs on 4 cards",
            prove_provers_devices, provers, bp, devices=devices[:4],
            backend_factory=_device_backend,
        )
        alone = ph.timed("prove_provers: the same 4 proofs on card 0",
                         prove_provers, vsmt4_provers(4)[0], bp,
                         backend=_device_backend())
        assert [p.to_bytes() for p in placed] == \
            [p.to_bytes() for p in alone], "4-card proofs != card-0 proofs"
        print(f"[{ph.name}] 4 proofs byte-identical to card 0's", flush=True)

    with Phase("four cards: points axis") as ph:
        mesh = make_mesh(4, batch_axis=1, axis_names=("batch", "points"))
        sharded = ShardedMsmBackend(mesh, **BACKEND_KW)
        n = 1 << max(SIZES.timing_log2)
        gens = BulletproofGens(n).share(0)
        rows = _seeded_rows(n, seed=5)
        points = gens.G(n)
        got = ph.timed(f"ShardedMsmBackend.msm n={n}", sharded.msm, rows,
                       points)
        want = ph.timed(f"DeviceBackend.msm n={n} (card 0)",
                        _device_backend().msm, rows, points)
        assert got.compress() == want.compress(), "sharded MSM != card 0"
        prove, verify = vsmt2_equivalence_circuit()
        proof, comms = ph.timed("depth-8 VSMT-2 proof, sharded", prove,
                                sharded)
        reference, _ = prove(_native_backend())
        assert proof.to_bytes() == reference.to_bytes(), \
            "sharded proof != the phase-2 proof"
        ph.timed("depth-8 VSMT-2 verify, sharded", verify, proof, comms,
                 sharded)
        print(f"[{ph.name}] mesh {dict(mesh.shape)}: MSM == card 0, "
              f"proof == phase-2 bytes and verified", flush=True)


def run_phases(four_cards: bool, devices) -> None:
    Phase.install()
    if four_cards:
        phase_four_cards(devices)
        return
    phase_msm()
    phase_equivalence()
    phase_full_width()
    phase_batch()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    preflight(args.four_cards)
    t0 = time.time()
    run_phases(args.four_cards, jax.devices())
    print(f"[chip_smoke] all phases passed in {time.time() - t0:.1f} s",
          flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
