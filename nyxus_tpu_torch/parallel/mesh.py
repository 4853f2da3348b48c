"""ROI-axis device lists and batch sharding (the counterparts of
nyxus_tpu/parallel/mesh.py's ``roi_mesh``, ``shard_batch`` and
``replicate``).

Every feature family runs as one batched launch sequence over a padded
``[B, H, W]`` ROI bucket, and each ROI's features depend on its own crop
alone.  Scaling out is therefore data parallelism over B: the bucket's
rows are split into contiguous shards, each placed on its card, and every
family runs on each shard there.  No reference counterpart: the
reference's unit of parallelism is a std::async thread over a contiguous
label range (parallel.h:36-40).
"""

from __future__ import annotations

import contextlib

import torch


def roi_devices(n_devices: int | None = None, devices=None,
                device="cuda") -> list:
    """The devices the ROI axis is sharded over, as ``torch.device`` s.

    ``devices``: used as given (a repeated device, e.g. ``cuda:0`` twice,
    makes two shards on one card).  Otherwise, for CUDA, every visible
    card for ``n_devices`` -1, the first k for k, one card (the current
    one) for None, 0 or 1; more than ``torch.cuda.device_count()`` raises
    ValueError.  For the CPU, ``n_devices`` k makes k shards of the one
    CPU device (as the JAX package's tests force 8 host devices); -1 is
    one shard."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    dev = torch.device(device)
    if n_devices in (None, 0, 1):
        return [dev]
    if dev.type != "cuda":
        return [dev] * (1 if n_devices == -1 else int(n_devices))
    avail = torch.cuda.device_count()
    n = avail if n_devices == -1 else int(n_devices)
    if n > avail:
        raise ValueError("requested %d devices, %d available" % (n, avail))
    return [torch.device("cuda", k) for k in range(n)]


def partition(b: int, n: int) -> list:
    """The contiguous partition of ``b`` rows over ``n`` shards that
    nyxus_tpu/parallel/mesh.py shard_batch makes: ceil(b / n) rows a
    shard, the last ones shorter.  JAX pads b up to a multiple of n with
    copies of row 0 because XLA needs even shards; the port needs neither
    the pad rows nor the empty shards they would fill, so it returns only
    the non-empty ones, as (shard index, slice)."""
    c = -(-b // n) if n else b
    return [(k, slice(k * c, min(b, (k + 1) * c)))
            for k in range(n) if k * c < b]


def shard_batch(devices, arrays):
    """Split a tuple of per-ROI batch arrays (numpy or torch, None kept)
    along axis 0 by ``partition``, each shard moved to its device.
    Returns [(device, (shard arrays...)), ...], one entry a non-empty
    shard."""
    b = next(a for a in arrays if a is not None).shape[0]
    out = []
    for k, sl in partition(b, len(devices)):
        dev = devices[k]
        out.append((dev, tuple(None if a is None else
                               torch.as_tensor(a[sl]).to(dev)
                               for a in arrays)))
    return out


def replicate(devices, a) -> list:
    """A copy of ``a`` on every device (e.g. a table each shard reads)."""
    a = torch.as_tensor(a)
    return [a.to(d) for d in devices]


def device_guard(dev):
    """``torch.cuda.device(dev)`` for a CUDA device, so that the kernels
    launch on the card their tensors lie on; nothing for the CPU."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
