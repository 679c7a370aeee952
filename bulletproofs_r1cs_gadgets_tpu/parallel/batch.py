"""Batch-parallel proving (the data-parallel axis, SURVEY.md S2b N10).

Each proof has an independent Fiat-Shamir transcript, so proofs cannot
share challenges — but all device work (vector commitments, IPP L/R MSMs,
generator folds) is independent across proofs and batches cleanly.

**Staged fusion** (``prove_provers``): B provers advance stage-
synchronously.  The B×3 phase-1 vector-commitment MSM chunk chains queue
asynchronously and resolve with ONE device sync
(``backend.phase_commitments_batch``); per-proof transcript challenges and
host polynomial work run between device stages; then all B inner-product
arguments run in lockstep log-rounds with one sync per round for the whole
batch (``backend.ipp_create_batch``).  Device dispatch queues stay full
while the host computes the next proof's scalars, so throughput approaches
max(host, device) instead of host+device, and the per-sync latency
amortises B-fold.

Backends without fused batch methods (or ``backend=None``) fall back to a
sequential loop with identical proof bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core.prover import Prover
from ..core.verifier import Verifier, batch_verify
from ..core.transcript import Transcript
from ..core.pedersen import PedersenGens, BulletproofGens
from ..core.proof import R1CSProof


@dataclass
class BatchResult:
    proofs: list[R1CSProof]
    commitments: list[list[bytes]]


def prove_provers(
    provers: list[Prover], bp_gens: BulletproofGens, backend=None,
    host_workers: int | None = None, waves: int = 1,
    inflight: int | None = None,
) -> list[R1CSProof]:
    """Prove B fully-synthesized provers with staged device fusion.

    Provers may have different circuits/sizes; each keeps its own
    transcript and challenge schedule.  The fusion only reorders *device*
    work across proofs — per proof, transcript operations and rng draws
    happen in the sequential path's order, so a prover with a
    deterministic private rng produces byte-identical proofs either
    way.  ``host_workers=1`` additionally preserves the *cross-prover*
    order of any shared (global) entropy source.

    ``waves > 1`` splits the batch into that many contiguous groups whose
    staged pipelines run on separate threads: while one wave blocks on a
    device sync the other waves' host stages (and queued device work)
    proceed, hiding sync latency and host/device idle gaps.  Proof bytes
    are unchanged (grouping only interleaves independent pipelines).

    ``inflight`` caps the number of proofs whose device state is live at
    once (device-memory scheduling: each in-flight IPP job owns its folded
    generator arrays).  Waves beyond the cap queue and start as earlier
    waves retire, so B can exceed the device's in-flight ceiling without
    OOM.  Default: no cap
    (every wave concurrent, the round-3 behavior)."""
    if backend is None or not hasattr(backend, "phase_commitments_batch"):
        return [p.prove(bp_gens, backend=backend) for p in provers]
    if inflight is not None and inflight < len(provers):
        # the cap must hold regardless of the wave split: derive enough
        # waves that one wave's size k = ceil(B/waves) fits the cap (the
        # thread-pool sizing below then keeps concurrent waves * k <=
        # inflight).  Without this, inflight was silently ignored when
        # waves <= 1 (advisor finding, round 4).
        waves = max(waves, -(-len(provers) // inflight))
        if len(provers) < 2 * waves:
            # too few provers for interleaved waves: honor the cap with
            # sequential slices of at most `inflight` proofs
            out = []
            for i in range(0, len(provers), inflight):
                out.extend(prove_provers(
                    provers[i : i + inflight], bp_gens, backend=backend,
                    host_workers=host_workers,
                ))
            return out
    if waves > 1 and len(provers) >= 2 * waves:
        from concurrent.futures import ThreadPoolExecutor

        k = -(-len(provers) // waves)
        groups = [provers[i : i + k] for i in range(0, len(provers), k)]
        workers = len(groups)
        if inflight is not None:
            workers = max(1, min(workers, inflight // k))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            outs = list(pool.map(
                lambda g: prove_provers(
                    g, bp_gens, backend=backend, host_workers=host_workers
                ),
                groups,
            ))
        return [p for out in outs for p in out]

    # Host stages run on a thread pool: each prover's work is independent
    # and the heavy parts (C++ scvec ops, numpy encodes, flatten) release
    # the GIL, so B middles overlap on the host cores.  Per prover the
    # transcript/rng order is unchanged (a prover's own stages still run
    # sequentially inside one task), so a prover with a deterministic
    # PRIVATE rng still produces byte-identical proofs.
    import os
    from concurrent.futures import ThreadPoolExecutor

    # leave a core for the thread that dispatches device work:
    # oversubscribing the host slows the batch down
    workers = host_workers or max(
        1, min((os.cpu_count() or 4) - 1, len(provers))
    )

    with ThreadPoolExecutor(max_workers=workers) as pool:
        # stage 1: phase-1 blindings + witness arrays (threaded), then ALL
        # phase-1 MSMs with one fused sync
        sts = list(pool.map(lambda p: p._phase1_state(bp_gens), provers))
        triples = backend.phase_commitments_batch(
            [p._phase1_msm_args(st) for p, st in zip(provers, sts)]
        )

        # stages 2-5 (host): challenges, flattening, l/r/t polynomials,
        # T-commitments — per proof, threaded between device stages
        mids = list(
            pool.map(
                lambda a: a[0]._prove_middle(a[1], *a[2], bp_gens),
                zip(provers, sts, triples),
            )
        )

    # stage 6: all B inner-product arguments in lockstep rounds
    jobs = []
    for p, st, mid in zip(provers, sts, mids):
        p.transcript.innerproduct_domain_sep(mid["padded_n"])
        jobs.append((
            p.transcript, mid["Q"], mid["G_factors"], mid["H_factors"],
            st["gens"], mid["padded_n"], mid["l_vec"], mid["r_vec"],
        ))
    ipps = backend.ipp_create_batch(jobs)
    return [
        R1CSProof(*mid["fields"], ipp) for mid, ipp in zip(mids, ipps)
    ]


def prove_batch(
    pc_gens: PedersenGens,
    bp_gens: BulletproofGens,
    transcript_label: bytes,
    witnesses: list,
    build_circuit: Callable,
    backend=None,
    rng=None,
) -> BatchResult:
    """Prove the same circuit over a batch of witnesses.

    ``build_circuit(prover_or_verifier, witness_or_None) -> list[bytes]``
    must commit its inputs and synthesize constraints, returning the
    commitment list (prover side) or re-binding them (verifier side).
    """
    provers = []
    commitments = []
    for w in witnesses:
        prover = Prover(pc_gens, Transcript(transcript_label), rng=rng)
        commitments.append(build_circuit(prover, w))
        provers.append(prover)
    proofs = prove_provers(provers, bp_gens, backend=backend)
    return BatchResult(proofs, commitments)


def verify_batch(
    pc_gens: PedersenGens,
    bp_gens: BulletproofGens,
    transcript_label: bytes,
    result: BatchResult,
    build_circuit: Callable,
    backend=None,
    combined: bool = True,
) -> None:
    """Verify a batch of proofs.

    With ``combined`` (default) all B verification equations are merged
    into ONE multiscalar multiplication via a random linear combination
    (``core.verifier.batch_verify``): the shared G/H generator segments —
    the dominant cost — are paid once for the whole batch.  On failure the
    equations are re-checked individually and the error names the invalid
    proof indices.  ``combined=False`` verifies one proof at a time."""
    verifiers = []
    for comms in result.commitments:
        verifier = Verifier(Transcript(transcript_label))
        build_circuit(verifier, comms)
        verifiers.append(verifier)
    if combined:
        batch_verify(
            verifiers, result.proofs, pc_gens, bp_gens, backend=backend
        )
        return
    for verifier, proof in zip(verifiers, result.proofs):
        verifier.verify(proof, pc_gens, bp_gens, backend=backend)
