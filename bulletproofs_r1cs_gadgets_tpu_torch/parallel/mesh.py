"""Device meshes for multi-card proving.

Two parallel axes, as in the JAX package's ``parallel/mesh.py``:

* ``batch``: independent proofs (data parallel); transcripts stay per
  proof on the host (``parallel/device_batch.py``);
* ``points``: the n-axis of one MSM; each device walks its shard of the
  generators and the partial points are gathered and folded on one device
  (``parallel/sharded_fast.py``, ``parallel/sharded_backend.py``; a point
  sum is the group law, not a lane-wise sum).

A mesh here is a ``(batch, points)`` grid of ``torch.device`` objects.
The reference's ``NamedSharding`` helpers (``batch_spec``,
``points_spec``, ``replicated``) have no counterpart: the port places
each shard on its device itself, by the mesh's device lists
(``axis_devices``, the rows of ``devices``), where the reference hands
``shard_map`` a partition spec.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.curve import point_add


class Mesh:
    """A ``(batch, points)`` array of devices with named axes."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis` in the mesh's first row or column."""
        k = self.axis_names.index(axis)
        line = self.devices[0, :] if k == 1 else self.devices[:, 0]
        return list(line)

    def rows(self, axis: str) -> list[list[torch.device]]:
        """For each index along `axis`, its devices along the other axis
        (``rows("batch")``: each batch row's points devices)."""
        k = self.axis_names.index(axis)
        grid = self.devices if k == 0 else self.devices.T
        return [list(line) for line in grid]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def even_spans(n: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of `parts` contiguous slices of n items, ceil(n / parts)
    each: the last one short, any past n empty (a shard's share)."""
    per = -(-n // parts)
    return [(k * per, min(n, (k + 1) * per)) for k in range(parts)]


def sum_partials(parts: list, lead) -> torch.Tensor:
    """The group sum of the shards' partial points (each ``(..., 4, 8)``):
    gathered onto `lead` (the reference's ``all_gather``) and added there
    one at a time with ``point_add`` (the ``padd`` kernel)."""
    total = parts[0].to(lead)
    for p in parts[1:]:
        total = point_add(total, p.to(lead))
    return total


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises without one (the parallel entry
    points never fall back to the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device: pass the devices (e.g. ['cpu', 'cpu']) to run "
            "the kernels' plain versions on the host"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_devices: int | None = None,
    batch_axis: int | None = None,
    axis_names: tuple[str, str] = ("batch", "points"),
    devices: list | None = None,
) -> Mesh:
    """Build a (batch, points) mesh over `devices` (default: every
    visible CUDA device, raising without one).

    With ``batch_axis=None`` the devices are split as evenly as possible
    (batch-major), by the reference's rule."""
    devs = cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if batch_axis is None:
        batch_axis = 1
        while batch_axis * batch_axis <= n and n % (batch_axis * 2) == 0:
            batch_axis *= 2
    if n == 0 or n % batch_axis:
        raise ValueError(f"{n} devices do not split into {batch_axis} rows")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(batch_axis, n // batch_axis), axis_names)
