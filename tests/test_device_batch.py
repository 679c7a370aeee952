"""Device-pinned batch placement (parallel/device_batch.py) on the CPU mesh.

These tests pin the placement MECHANISM (arrays created inside a pinned
backend land on its device) and the scheduling invariants (round-robin
grouping, input-order results, byte-identical proofs vs the host path);
tests/test_device_parallel.py runs the same path with real device math,
and ``chip_smoke.py --four-cards`` on four GPUs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bulletproofs_r1cs_gadgets_tpu import (
    BulletproofGens,
    PedersenGens,
    Prover,
    Scalar,
    Transcript,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.bound_check import (
    bound_check_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import AllocatedQuantity
from bulletproofs_r1cs_gadgets_tpu.ops.backend import DeviceBackend
from bulletproofs_r1cs_gadgets_tpu.parallel.device_batch import (
    DevicePinnedBackend,
    bootstrap_distributed,
    prove_provers_devices,
)


def test_pinned_backend_places_arrays():
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs >= 2 devices")

    class Fake:
        min_device_n = 7

        def msm(self):
            return jnp.zeros(3)

    for d in devs[:2]:
        pb = DevicePinnedBackend(Fake(), d)
        arr = pb.msm()
        got = set(arr.devices()) if hasattr(arr, "devices") else {arr.device}
        assert got == {d}
        assert pb.min_device_n == 7  # non-method attrs pass through


def _mk_provers(n, rng_seed=None):
    pc = PedersenGens.default()
    provers, comms = [], []
    for i in range(n):
        rng = np.random.RandomState(1000 + i) if rng_seed else None
        p = Prover(pc, Transcript(b"DevBatch"), rng=rng)
        rand = (lambda: Scalar.random(rng)) if rng else Scalar.random
        val = 20 + i
        a, b = val - 10, 100 - val
        _, var_v = p.commit(Scalar(val), rand())
        _, var_a = p.commit(Scalar(a), rand())
        _, var_b = p.commit(Scalar(b), rand())
        bound_check_gadget(
            p,
            AllocatedQuantity(var_v, val),
            AllocatedQuantity(var_a, a),
            AllocatedQuantity(var_b, b),
            100, 10, 16,
        )
        provers.append(p)
    return provers


def test_placed_proofs_match_host_bytes():
    """Placement must not change proof bytes: same seeded provers through
    prove_provers_devices (host-threshold backend: all math on host, the
    scheduling machinery fully exercised) vs plain host proves."""
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs >= 2 devices")
    bp = BulletproofGens(64)
    placed = prove_provers_devices(
        _mk_provers(5, rng_seed=True), bp,
        devices=devs[:2],
        # min_device_n above every MSM size: the backend protocol runs but
        # all compute takes the host fallback (no CPU-mesh XLA compiles)
        backend_factory=lambda: DeviceBackend(min_device_n=1 << 30),
    )
    host = [p.prove(bp, backend=None) for p in _mk_provers(5, rng_seed=True)]
    assert [p.to_bytes() for p in placed] == [p.to_bytes() for p in host]


def test_sequential_matches_threaded():
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs >= 2 devices")
    bp = BulletproofGens(64)
    fac = lambda: DeviceBackend(min_device_n=1 << 30)
    seq = prove_provers_devices(
        _mk_provers(4, rng_seed=True), bp, devices=devs[:2],
        backend_factory=fac, sequential=True,
    )
    par = prove_provers_devices(
        _mk_provers(4, rng_seed=True), bp, devices=devs[:2],
        backend_factory=fac,
    )
    assert [p.to_bytes() for p in seq] == [p.to_bytes() for p in par]


def test_bootstrap_distributed_noop_single_process():
    assert bootstrap_distributed() is False
