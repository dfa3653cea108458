"""Data parallelism over a mesh of devices, async result streams and
cross-video clip packing (port of ``video_features_tpu/parallel``)."""
from .mesh import DataParallelApply, get_mesh, local_shard_of_list

__all__ = ["DataParallelApply", "get_mesh", "local_shard_of_list"]
