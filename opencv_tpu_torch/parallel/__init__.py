"""Batch data parallelism and spatial sharding over ``torch.distributed``
(twin of ``opencv_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    pipeline,
    sharded_pipeline,
    spatial_gaussian_blur,
    spatial_sep_filter,
    sharded_min_max,
    sharded_hist,
    sharded_otsu,
)


def setParallelForBackend(backendName, propagateNumThreads=True):
    """cv2.parallel.setParallelForBackend — accepted for compatibility;
    parallelism here is torch.distributed over ranks, not a host thread
    pool."""
    return False
