"""Dataset sharding over processes (the counterpart of
nyxus_tpu/parallel/dataset.py).

The reference fans whole slides out over threads of one process
(workflow_2d_whole.cpp:292-330).  Several processes, on one host or many,
instead split the (intensity, mask) pair list by process index, so that
each featurizes a disjoint subset of the slides on its own card(s).  The
outputs compose trivially: each process writes its own per-slide rows.
"""

from __future__ import annotations

import os

import torch


def initialize_distributed(**kwargs) -> None:
    """Join the process group that names this process's rank: a thin gate
    around ``torch.distributed.init_process_group`` (gloo), which does
    nothing when the group is already initialised.  The JAX package's
    keyword names are accepted, so that a script written for it runs
    unchanged: ``coordinator_address`` ("host:port", or a URL) becomes
    ``init_method`` ("tcp://host:port"), ``num_processes`` ``world_size``
    and ``process_id`` ``rank``.  The group carries no collective: only
    ``process_shard`` reads it."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    addr = kwargs.pop("coordinator_address", None)
    if addr is not None:
        kwargs.setdefault("init_method",
                          addr if "://" in addr else "tcp://" + addr)
    if "num_processes" in kwargs:
        kwargs.setdefault("world_size", kwargs.pop("num_processes"))
    if "process_id" in kwargs:
        kwargs.setdefault("rank", kwargs.pop("process_id"))
    kwargs.setdefault("backend", "gloo")
    dist.init_process_group(**kwargs)


def _group():
    """(rank, world size) of an initialised process group, else None."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def process_shard(items, index=None, count=None):
    """This process's slice of a work list, ``items[index::count]``:
    round-robin, so that slides of mixed sizes balance in expectation.

    The index and count resolve in this order: the arguments;
    ``NYXUS_PROCESS_INDEX`` / ``NYXUS_PROCESS_COUNT`` (for mpirun- or
    srun-style launchers); the rank and world size of an initialised
    ``torch.distributed`` group (``initialize_distributed``, torchrun);
    otherwise 0 and 1."""
    group = _group()
    if index is None:
        env = os.environ.get("NYXUS_PROCESS_INDEX")
        index = int(env) if env is not None else (group[0] if group else 0)
    if count is None:
        env = os.environ.get("NYXUS_PROCESS_COUNT")
        count = int(env) if env is not None else (group[1] if group else 1)
    return list(items)[index::count]
