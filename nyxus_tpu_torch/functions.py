"""Module-level device-introspection functions
(reference: src/nyx/python/nyxus/functions.py:3-6 -- gpu_is_available /
get_gpu_properties over the CUDA devices, here as torch.cuda sees them).
"""

from __future__ import annotations

import torch


def gpu_is_available(nyxus_instance_id=None):
    """True when torch sees at least one CUDA device."""
    return torch.cuda.is_available() and torch.cuda.device_count() > 0


def get_gpu_properties(nyxus_instance_id=None):
    """Per-device property dicts for every visible CUDA device."""
    out = []
    if not gpu_is_available():
        return out
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        out.append({
            "id": i,
            "platform": "gpu",
            "device_kind": p.name,
            "compute_capability": "%d.%d" % (p.major, p.minor),
            "multi_processor_count": p.multi_processor_count,
            "memory_total": p.total_memory,
            "memory_in_use": torch.cuda.memory_allocated(i),
        })
    return out
