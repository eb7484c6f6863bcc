"""Batch-axis data parallelism over several devices.

Proofs are embarrassingly parallel (each has its own Fiat-Shamir
transcript and shares nothing with its batch peers), so the multi-card
layout needs no collectives: one backend per device, and whole proofs
placed round-robin on the devices.  Within a device,
``parallel.batch.prove_provers`` still fuses that device's share of the
batch (staged syncs and waves).  The counterpart of the JAX package's
``parallel/device_batch.py``:

* ``jax.default_device`` becomes ``torch.cuda.device``
  (:class:`DevicePinnedBackend`); every kernel wrapper also makes its
  tensors' device current for its own launch, so the backend's pool
  threads launch on the right card too;
* multi-host: :func:`bootstrap_distributed` joins the process group when
  the cluster's environment is there; then hand each host its slice of
  the batch.

Placement does not change proof bytes: each proof's transcript and rng
order is untouched.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from ..ops.torch_backend import TorchBackend
from .batch import prove_provers
from .mesh import cuda_devices


def bootstrap_distributed(**kw) -> bool:
    """Multi-host bootstrap: ``torch.distributed.init_process_group(**kw)``
    when a cluster environment is present (``MASTER_ADDR`` with
    ``WORLD_SIZE``, or an explicit ``init_method``); a single process
    returns False and proceeds alone.  The backend defaults to NCCL with
    a card, gloo without.  Call once, before the device queries."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if not (kw.get("init_method")
            or (env.get("MASTER_ADDR") and env.get("WORLD_SIZE"))):
        return False
    kw.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kw)
    return True


def _pinned(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class DevicePinnedBackend:
    """Wrap a backend so every call of the engine's backend methods runs
    with `device` current (``torch.cuda.device``; nothing for the CPU).
    Other attributes (``device``, ``min_device_n``, ...) pass through."""

    _METHODS = (
        "msm", "msm_gens", "phase_commitments", "phase_commitments_batch",
        "ipp_create", "ipp_create_batch",
    )

    def __init__(self, inner, device):
        self.inner = inner
        self.device = torch.device(device)
        for name in self._METHODS:
            fn = getattr(inner, name, None)
            if fn is not None:
                setattr(self, name, self._pin(fn))

    def _pin(self, fn):
        dev = self.device

        def wrapped(*args, **kw):
            with _pinned(dev):
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
    """Prove B synthesized provers with whole proofs placed round-robin
    on `devices` (default: every visible CUDA device; raises without
    one, never falling back to the CPU).  A list may repeat a device.

    ``backend_factory(device=...)`` builds one backend per device; the
    default is :class:`..ops.torch_backend.TorchBackend`.  Each device's group
    proves through ``prove_provers``; groups run on threads
    (``sequential=True`` runs them one after another).  Returns proofs in
    input order (bytes identical to any other schedule for provers with
    deterministic private rngs)."""
    devices = cuda_devices() if devices is None else devices
    devices = [torch.device(d) for d in devices]
    if backend_factory is None:
        backend_factory = TorchBackend
    ndev = max(1, min(len(devices), len(provers)))
    devices = devices[:ndev]

    backends = [DevicePinnedBackend(backend_factory(device=dev), dev)
                for dev in devices]
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
