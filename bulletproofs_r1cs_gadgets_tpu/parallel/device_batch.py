"""Batch-axis data parallelism: whole proofs placed on distinct devices.

Proofs are embarrassingly parallel — each has its own Fiat-Shamir
transcript and shares nothing with its batch peers — so the multi-device
layout needs NO collectives: pin one backend instance per device and place
whole proofs' dispatch streams on distinct devices
(``jax.default_device`` commits every array a backend uploads, so all its
kernel dispatches follow).  Within a device, ``parallel.batch.prove_provers``
still fuses that device's share of the batch (staged syncs + waves).

This composes with the two other axes of SURVEY.md §2b N10:

* points axis (``ShardedMsmBackend``): ONE proof's MSMs sharded over the
  devices — for latency on a single huge proof;
* batch axis (this module): throughput scaling, linear in devices
  (nothing crosses devices but the final proof bytes);
* multi-host: call :func:`bootstrap_distributed` first so every host sees
  the global device set, then hand each host its local slice of the batch.

Proof bytes are unchanged by placement (per-proof transcript/rng order is
untouched).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax

from .batch import prove_provers


def bootstrap_distributed(**kw) -> bool:
    """Multi-host bootstrap: initialize the JAX distributed runtime when a
    coordinator is given (``coordinator_address=...`` plus
    ``num_processes`` and ``process_id``, or the ``JAX_COORDINATOR_ADDRESS``
    environment variable); single-process runs return False and proceed
    single-host.  Call once, before device queries."""
    try:
        if jax.process_count() > 1:  # already initialized
            return True
    except Exception:
        pass
    import os

    if not (kw.get("coordinator_address")
            or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return False
    jax.distributed.initialize(**kw)
    return True


class DevicePinnedBackend:
    """Wrap a backend so every call runs under ``jax.default_device(dev)``:
    arrays it uploads are committed to ``dev`` and its kernel dispatches
    execute there.  Method set mirrors the backend protocol used by
    ``Prover``/``Verifier``/``prove_provers``."""

    _METHODS = (
        "msm", "msm_gens", "phase_commitments", "phase_commitments_batch",
        "ipp_create", "ipp_create_batch",
    )

    def __init__(self, inner, device):
        self.inner = inner
        self.device = device
        for name in self._METHODS:
            fn = getattr(inner, name, None)
            if fn is not None:
                setattr(self, name, self._pin(fn))

    def _pin(self, fn):
        dev = self.device

        def wrapped(*args, **kw):
            with jax.default_device(dev):
                return fn(*args, **kw)

        return wrapped

    def __getattr__(self, name):  # non-method attrs (min_device_n, ...)
        return getattr(self.inner, name)


def prove_provers_devices(
    provers: list,
    bp_gens,
    devices: list | None = None,
    backend_factory=None,
    waves: int = 1,
    sequential: bool = False,
) -> list:
    """Prove B synthesized provers with whole proofs placed round-robin on
    distinct devices (batch-axis data parallelism for the fast path).

    ``backend_factory(device=...)`` (or ``backend_factory()``) builds one
    backend per device (each keeps its own generator/device caches, so
    uploads land on its device); the default is
    :class:`..ops.backend.DeviceBackend`.  Per device, its group
    proves with the staged-fusion pipeline; groups run on threads
    (``sequential=True`` runs them one after another — e.g. on a CPU mesh
    where concurrent per-device XLA compiles are slow).  Returns proofs in
    input order (bytes identical to any other schedule for provers with
    deterministic private rngs)."""
    import inspect

    if devices is None:
        devices = jax.local_devices()
    if backend_factory is None:
        from ..ops.backend import DeviceBackend

        backend_factory = DeviceBackend
    ndev = max(1, min(len(devices), len(provers)))
    devices = devices[:ndev]

    def make(dev):
        try:
            if "device" in inspect.signature(backend_factory).parameters:
                return DevicePinnedBackend(backend_factory(device=dev), dev)
        except (TypeError, ValueError):
            pass
        with jax.default_device(dev):
            return DevicePinnedBackend(backend_factory(), dev)

    backends = [make(dev) for dev in devices]
    groups: list[list[tuple[int, object]]] = [[] for _ in range(ndev)]
    for i, p in enumerate(provers):
        groups[i % ndev].append((i, p))

    out: list = [None] * len(provers)

    def run(d: int):
        idxs = [i for i, _ in groups[d]]
        ps = [p for _, p in groups[d]]
        proofs = prove_provers(ps, bp_gens, backend=backends[d], waves=waves)
        for i, proof in zip(idxs, proofs):
            out[i] = proof

    if ndev == 1 or sequential:
        for d in range(ndev):
            run(d)
    else:
        with ThreadPoolExecutor(max_workers=ndev) as pool:
            list(pool.map(run, range(ndev)))
    return out
