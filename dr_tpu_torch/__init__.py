"""dr_tpu_torch — the distributed-ranges framework ported to PyTorch and
CUDA (NVIDIA Hopper).

The JAX package ``dr_tpu`` is the reference; module paths and names
mirror it (``dr_tpu_torch/parallel/halo.py`` is the counterpart of
``dr_tpu/parallel/halo.py``, and so on).  With one controller
(``init()``) one process drives every rank: a ``distributed_vector``
keeps one padded row tensor per rank on that rank's device, and
collectives are tensor copies between rank rows.

The kernels of the 1-D stencil -> dot -> scan path, of the 2-D heat
stencil, of the sort's local phase, of ``reduce``'s min/max/integer
route and the groupby's segmented reduce, of the histogram's bincount and
of ring attention's flash update are hand-written CUDA for
``sm_90a`` (``dr_tpu_torch/csrc``), built at first use.  A CUDA tensor takes the kernel or raises; a CPU
tensor takes the kernel's plain PyTorch version.  ``init()`` takes the visible CUDA devices and raises
without one; the CPU runs only when named (``init(["cpu"] * 8)``).

``init_distributed(address, nprocs, pid, device=...)`` starts the
multi-process mode instead (the reference's MPI ranks in separate
processes): one rank a process, collectives across processes through
``torch.distributed`` (gloo, or nccl between distinct cards), and every
host read valid on every process.  Every kernel path, the relational
ops, re-layout, deferred plans, the tuning layer and the elastic shrink
run there (a survivor of a dead peer shrinks onto its own ranks); the
serving daemon, the router and an elastic grow run in one process by
design and raise a classified ``ProgramError`` at their entry.

Public surface of this slice:

- runtime:    ``init / init_distributed / final / nprocs / devices /
  barrier / fence / get_duplicated_devices``
- vocabulary: ``rank / segments / local`` + concept predicates
- containers: ``distributed_vector``, ``block_distribution``,
  ``from_reference_state``, ``distributed_span``
- views:      ``views.take / drop / subrange / slice_view / counted /
  zip / transform / enumerate / ranked_view / iota_view /
  segment_ranges`` (and their pipe forms), ``aligned``,
  ``local_segments``
- algorithms: ``fill / iota / copy / copy_async / for_each / transform /
  to_numpy / reduce / transform_reduce / transform_reduce_async / dot /
  dot_n / inclusive_scan / exclusive_scan / inclusive_scan_n``
- communicator: ``communicator``, ``default_comm``, ``rma_window``
  (collectives over per-rank tensor lists)
- re-layout and state: ``redistribute`` (collective or host-staged),
  ``checkpoint`` (``save / load``, the JAX package's file format),
  ``unstructured_halo`` (index-list ghosts)
- resilience and guards: ``resilience`` (the classified taxonomy,
  ``retry``, ``with_deadline``, ``session_story``), ``faults`` (the
  injection sites,
  ``DR_GPU_FAULT_SPEC``), ``spmd_guard`` (the dispatch tap and its
  digest), ``utils.sanitize`` (``DR_GPU_SANITIZE=1``)
- debugging:  ``drlog`` (``DR_GPU_LOG``), ``print_range``,
  ``print_matrix``, ``range_details``
- observability: ``obs`` (spans, metrics and the Chrome export, armed by
  ``DR_GPU_TRACE=1``), ``profiling`` (``torch.profiler`` traces, the
  marginal timer, phase breakdowns)
- sort:       ``sort / sort_by_key / argsort / is_sorted / sort_n /
  sort_by_key_n``
- relational: ``join`` (inner/left/right/outer, broadcast and partition
  merges), ``groupby_aggregate``, ``unique``, ``histogram``, ``top_k``,
  ``join_auto / groupby_auto / unique_auto`` (``AutoResult``)
- attention:  ``ring_attention / ring_attention_n`` (sequence-parallel
  ring attention; ``ops.ring_attention.ring_self_attention``), on the
  ring schedules of ``parallel/pipeline.py``
- halo:       ``halo_bounds / span_halo / halo_ops / halo``
- stencils:   ``stencil_transform / stencil_iterate /
  stencil_iterate_matmul / stencil_iterate_blocked``
- 2-D:        ``dense_matrix``, ``matrix_entry``, ``Index2D``,
  ``block_cyclic``, ``row_tiles``, ``factor``, ``tile``,
  ``distributed_mdarray``, ``distributed_mdspan``, ``transpose``,
  ``stencil2d_transform / stencil2d_iterate /
  stencil2d_iterate_blocked / stencil2d_n``, ``heat_step_weights``,
  ``gemm``
- sparse:     ``sparse_matrix`` (padded COO, csr / ell / bcsr / ring
  layouts), ``random_sparse_matrix``, ``gemv / gemv_n / flat_gemv /
  spmm / spmm_n``
- entry:      ``dr_tpu_torch.entry.entry`` and ``dryrun``, the
  counterparts of ``__graft_entry__``'s
- plans:      ``deferred`` (record a region, run it at a flush),
  ``Plan``, ``PlanScalar``, ``plan`` (``plan.opt``, ``plan.plansan``,
  ``plan.interference``); on a card a flushed run replays as one CUDA
  graph
- tuning:     ``tuning`` (measured config winners: ``lookup``,
  ``record``, ``note``; ``DR_GPU_TUNING_DB`` / ``DR_GPU_TUNING_DIR``)
- elastic:    ``elastic`` (``rescue_session`` shrinks onto the surviving
  ranks, ``grow_session`` / ``maybe_grow`` re-admit dropped ones;
  ``DR_GPU_ELASTIC=1`` arms the shrink in ``retry`` and at a flush)
"""

from . import obs
obs.install()  # no-op unless DR_GPU_TRACE=1
from .utils import sanitize as _sanitize
_sanitize.install()  # no-op unless DR_GPU_SANITIZE=1
from .parallel.runtime import (init, final, finalize, runtime, nprocs,
                               devices, barrier, fence,
                               get_duplicated_devices)
from .parallel.halo import halo_bounds, span_halo, halo_ops
from .parallel.unstructured_halo import unstructured_halo
from .parallel.collectives import (communicator, rma_window, default_comm,
                                   init_distributed)
from .core.vocabulary import (rank, segments, local, is_remote_range,
                              is_distributed_range,
                              is_remote_contiguous_range,
                              is_distributed_contiguous_range)
from .core.segment import Segment, ZipSegment
from .containers.distribution import block_distribution, even_sizes
from .containers.distributed_vector import (distributed_vector, halo,
                                            from_reference_state)
from .containers.distributed_span import distributed_span
from .views import views
from .views.views import aligned, local_segments
from .algorithms.elementwise import (fill, iota, copy, copy_async, for_each,
                                     transform, to_numpy)
from .algorithms.reduce import (reduce, transform_reduce, dot, dot_n,
                                reduce_async, transform_reduce_async,
                                dot_async)
from .algorithms.scan import inclusive_scan, exclusive_scan, inclusive_scan_n
from .algorithms.stencil import (stencil_transform, stencil_iterate,
                                 stencil_iterate_blocked,
                                 stencil_iterate_matmul)
from .containers.partition import (tile, matrix_partition, block_cyclic,
                                   row_tiles, factor)
from .containers.dense_matrix import dense_matrix, matrix_entry, Index2D
from .containers.mdarray import (distributed_mdarray, distributed_mdspan,
                                 transpose)
from .algorithms.stencil2d import (stencil2d_transform, stencil2d_iterate,
                                   stencil2d_iterate_blocked, stencil2d_n,
                                   heat_step_weights)
from .containers.sparse_matrix import sparse_matrix, random_sparse_matrix
from .algorithms.gemv import gemm, gemv, gemv_n, flat_gemv, spmm, spmm_n
from .algorithms.sort import (sort, sort_by_key, argsort, is_sorted, sort_n,
                              sort_by_key_n)
from .ops.ring_attention import ring_attention, ring_attention_n
from .algorithms.relational import (join, groupby_aggregate, unique,
                                    histogram, top_k, join_auto,
                                    groupby_auto, unique_auto, AutoResult,
                                    DeferredCount)
from .utils.logging import drlog
from .utils.debug import print_range, print_matrix, range_details
from .utils import checkpoint
from .utils import profiling
from .utils import faults
from .utils import resilience
from .utils import spmd_guard
from .utils.elastic import redistribute
from .utils import elastic
from . import tuning
from . import plan
from .plan import Plan, PlanScalar, deferred

__version__ = "0.1.0"

__all__ = [
    "init", "init_distributed", "final", "finalize", "runtime", "nprocs",
    "devices", "barrier", "fence", "get_duplicated_devices",
    "halo_bounds", "span_halo", "halo_ops", "halo",
    "rank", "segments", "local", "is_remote_range", "is_distributed_range",
    "is_remote_contiguous_range", "is_distributed_contiguous_range",
    "Segment", "ZipSegment", "block_distribution", "even_sizes",
    "distributed_vector", "from_reference_state",
    "views", "aligned", "local_segments",
    "fill", "iota", "copy", "copy_async", "for_each", "transform",
    "to_numpy", "reduce", "transform_reduce", "dot", "dot_n",
    "reduce_async", "transform_reduce_async", "dot_async",
    "inclusive_scan", "exclusive_scan", "inclusive_scan_n",
    "stencil_transform", "stencil_iterate", "stencil_iterate_blocked",
    "stencil_iterate_matmul",
    "tile", "matrix_partition", "block_cyclic", "row_tiles", "factor",
    "dense_matrix", "matrix_entry", "Index2D",
    "distributed_mdarray", "distributed_mdspan", "transpose",
    "stencil2d_transform", "stencil2d_iterate", "stencil2d_iterate_blocked",
    "stencil2d_n", "heat_step_weights", "gemm",
    "sparse_matrix", "random_sparse_matrix", "gemv", "gemv_n", "flat_gemv",
    "spmm", "spmm_n",
    "sort", "sort_by_key", "argsort", "is_sorted", "sort_n", "sort_by_key_n",
    "ring_attention", "ring_attention_n",
    "join", "groupby_aggregate", "unique", "histogram", "top_k",
    "join_auto", "groupby_auto", "unique_auto", "AutoResult",
    "DeferredCount", "unstructured_halo", "communicator", "rma_window",
    "default_comm",
    "distributed_span", "drlog", "print_range", "print_matrix",
    "range_details", "checkpoint", "resilience", "redistribute",
    "obs", "profiling", "faults", "spmd_guard",
    "plan", "Plan", "PlanScalar", "deferred", "tuning", "elastic",
]
