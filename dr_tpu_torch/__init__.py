"""dr_tpu_torch — the distributed-ranges framework ported to PyTorch and
CUDA (NVIDIA Hopper).

The JAX package ``dr_tpu`` is the reference; module paths and names
mirror it (``dr_tpu_torch/parallel/halo.py`` is the counterpart of
``dr_tpu/parallel/halo.py``, and so on).  One process drives every rank:
a ``distributed_vector`` keeps one padded row tensor per rank on that
rank's device, and collectives are tensor copies between rank rows.

The kernels of the 1-D stencil -> dot -> scan path are hand-written CUDA
for ``sm_90a`` (``dr_tpu_torch/csrc``), built at first use.  A CUDA
tensor takes the kernel or raises; a CPU tensor takes the kernel's plain
PyTorch version.  ``init()`` takes the visible CUDA devices and raises
without one; the CPU runs only when named (``init(["cpu"] * 8)``).

Public surface of this slice:

- runtime:    ``init / final / nprocs / devices / barrier / fence /
  get_duplicated_devices``
- vocabulary: ``rank / segments / local`` + concept predicates
- containers: ``distributed_vector``, ``block_distribution``,
  ``from_reference_state``
- views:      ``views.take / drop / subrange / zip / transform /
  iota_view``, ``aligned``, ``local_segments``
- algorithms: ``fill / iota / copy / for_each / transform / to_numpy /
  reduce / transform_reduce / dot / dot_n / inclusive_scan /
  exclusive_scan / inclusive_scan_n``
- halo:       ``halo_bounds / span_halo / halo_ops / halo``
- stencils:   ``stencil_transform / stencil_iterate /
  stencil_iterate_matmul / stencil_iterate_blocked``
"""

from .parallel.runtime import (init, final, finalize, runtime, nprocs,
                               devices, barrier, fence,
                               get_duplicated_devices)
from .parallel.halo import halo_bounds, span_halo, halo_ops
from .core.vocabulary import (rank, segments, local, is_remote_range,
                              is_distributed_range,
                              is_remote_contiguous_range,
                              is_distributed_contiguous_range)
from .core.segment import Segment, ZipSegment
from .containers.distribution import block_distribution, even_sizes
from .containers.distributed_vector import (distributed_vector, halo,
                                            from_reference_state)
from .views import views
from .views.views import aligned, local_segments
from .algorithms.elementwise import (fill, iota, copy, for_each, transform,
                                     to_numpy)
from .algorithms.reduce import (reduce, transform_reduce, dot, dot_n,
                                reduce_async, dot_async)
from .algorithms.scan import inclusive_scan, exclusive_scan, inclusive_scan_n
from .algorithms.stencil import (stencil_transform, stencil_iterate,
                                 stencil_iterate_blocked,
                                 stencil_iterate_matmul)

__version__ = "0.1.0"

__all__ = [
    "init", "final", "finalize", "runtime", "nprocs", "devices",
    "barrier", "fence", "get_duplicated_devices",
    "halo_bounds", "span_halo", "halo_ops", "halo",
    "rank", "segments", "local", "is_remote_range", "is_distributed_range",
    "is_remote_contiguous_range", "is_distributed_contiguous_range",
    "Segment", "ZipSegment", "block_distribution", "even_sizes",
    "distributed_vector", "from_reference_state",
    "views", "aligned", "local_segments",
    "fill", "iota", "copy", "for_each", "transform", "to_numpy",
    "reduce", "transform_reduce", "dot", "dot_n", "reduce_async",
    "dot_async",
    "inclusive_scan", "exclusive_scan", "inclusive_scan_n",
    "stencil_transform", "stencil_iterate", "stencil_iterate_blocked",
    "stencil_iterate_matmul",
]
