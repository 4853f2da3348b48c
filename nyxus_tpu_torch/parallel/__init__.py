"""Scale-out over cards and processes (PyTorch port of
nyxus_tpu/parallel: the same two levels, in the port's own code).

* over cards: each padded ROI bucket is split along its ROI axis into
  contiguous shards, one a device of ``roi_devices``; every family runs on
  each shard on its own card (``PairRunner`` / ``VolumeRunner`` with
  ``devices=``), the cards' launches overlapping from one host thread, and
  the packed rows come back in one device-to-host copy a card.  The
  families compute per ROI, so no collective is needed.
* over processes: the slide list is split round-robin by process index
  (``process_shard``); each process featurizes its own pairs.
"""

from .mesh import device_guard, partition, replicate, roi_devices, shard_batch
from .dataset import initialize_distributed, process_shard

__all__ = ["roi_devices", "partition", "shard_batch", "replicate",
           "device_guard", "process_shard", "initialize_distributed"]
