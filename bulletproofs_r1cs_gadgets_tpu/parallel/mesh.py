"""Device-mesh utilities for multi-device proving.

The reference is a single-threaded library (SURVEY.md S2b N10); scaling is
where an accelerator build adds value.  Two parallel axes map naturally onto a
``jax.sharding.Mesh``:

* ``batch`` - independent proofs (data parallel; SURVEY.md S5 "batch-parallel
  proving").  Transcripts stay per-proof on host; all vector math batches.
* ``points`` - the n-axis of MSMs (tensor-parallel analog): generator
  vectors are partitioned across devices, each computes a partial MSM over
  its shard, and the partial group elements are combined with a short
  all-gather + local point additions (a point sum is NOT a ``psum`` - the
  group law is not lane-wise integer addition - so we gather the 4x23-limb
  partials, which are tiny, and fold them locally).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as PSpec, NamedSharding


def make_mesh(
    n_devices: int | None = None,
    batch_axis: int | None = None,
    axis_names: tuple[str, str] = ("batch", "points"),
) -> Mesh:
    """Build a (batch, points) mesh over the available devices.

    With ``batch_axis=None`` the devices are split as evenly as possible
    (batch-major).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if batch_axis is None:
        batch_axis = 1
        while batch_axis * batch_axis <= n and n % (batch_axis * 2) == 0:
            batch_axis *= 2
    assert n % batch_axis == 0
    arr = np.asarray(devs).reshape(batch_axis, n // batch_axis)
    return Mesh(arr, axis_names)


def batch_spec(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PSpec("batch"))


def points_spec(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PSpec(None, "points"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PSpec())
