#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dr_tpu_torch``) on one NVIDIA card.

Run from the repository root:  ``python3 chip_smoke.py``  (``--quick``
checks the kernels at small shapes only).  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the eight CUDA sources from ``dr_tpu_torch/csrc`` (``nvcc``;
   K8 runs on K7's library);
3. hold each kernel against its plain PyTorch version at the main-path
   shapes, on the card (K1 the same bits on a second launch; K2 bit for
   bit, also on one partial tile with
   17 taps and on its shared-memory route; K4 the same bits on a second
   call, and on inputs 4 (f32) and 6 (bf16) bytes past a 16-byte
   boundary; K5 also on
   partial last tiles with T = 17 and pad > T; K6 and K7 bit for bit:
   K6 at M in {256, 4096, 2^15}, keys-only and KV, one block a call,
   and batches of 8 and 133 blocks at M in {256, 4096, 16384, 2^15}; K7
   at nseg in {1, 127, 128,
   129, 2^15} over int32, f32, bf16, 8- and 16-bit integer and bool
   columns, at n = 2^30 in one segment, and on columns that start 0 to
   15 elements past a 16-byte boundary with ragged tails; K8 at
   n = 2^30 over 1024 and 2^15 bins);
4. the 1-D main path at full size on one rank: a 2^30-element f32
   ``distributed_vector``, 512 steps of ``stencil_iterate_matmul``
   (k_block=256, halo 512) and of ``stencil_iterate_blocked``
   (time_block=64, halo 1024), ``dot_n``, ``inclusive_scan`` and
   ``inclusive_scan_n``; launch counts are read around this phase, and
   every result is compared with the same path run on the plain
   versions;
5. the same path on 4 logical ranks of the one card at n = 2^26 (ring
   exchanges and the scan's cross-rank carry), against a numpy oracle;
6. the 2-D heat path on one rank: a 16384 x 16384 f32 ``dense_matrix``,
   ``stencil2d_iterate_blocked`` (520 steps, time_block=16: 33 K5
   passes) and ``stencil2d_n`` (32 passes); launch counts around this
   phase, results against the plain versions;
7. the 2-D path on 4 logical ranks (a 2x2 grid) at 8192 x 8192: the
   tiled ``stencil2d_iterate`` in block and block-cyclic layouts and the
   single-tile blocked path against a float64 recurrence, ``gemm``
   against a float64 product, and a ``distributed_mdarray`` transpose and
   ``submdspan``, bit-exact;
8. per-kernel times from CUDA events beside their bounds, the plain
   versions' and one library call's times, K1's TFLOP/s and share of
   its bound (three bf16 passes at the tensor-core rate) and the
   ``HGMMA`` instructions in its SASS, K2's floor without FMAs, and
   K1's, K2's and K5's ptxas registers and spills;
9. the sort path on one rank at 2^28 f32 keys: ``sort`` (ascending and
   descending), ``is_sorted``, ``sort_by_key`` with an int32 iota
   payload, ``argsort``, ``reduce`` min / max / int32 sum; launch counts
   around this phase (K7 once per reduce, K6 none: the blocks are above
   its cap), results against numpy sorting the same encoding;
10. the sort path on 4 logical ranks at 2^26 over a distribution with
    an empty rank: keys-only, a window, key-value, and the seconds of
    each phase of the sample sort;
11. the K6 path: 8 ranks x 16384 keys and 4 ranks x 2^15, ``sort``,
    ``sort_by_key`` and ``sort_n(8)``; K6 launches once per sort (the
    ranks share the card, so their blocks are one batch); and the peak
    device memory of the paths;
12. ring attention on one rank at Llama-3-8B's attention geometry and a
    32k-token context (B = 1, S = 32768, 32 q heads, 8 K/V heads, d =
    128, bf16), causal and not: one K9 launch per call, the output
    against the plain version on the card and against a float64 dense
    oracle on 64 query rows per head, ms per call, effective TFLOP/s and
    the peak device memory;
13. the same causal call on 4 ranks of the card (16 K9 launches, serial
    equal to pipelined bit for bit, the output against phase 12's), the
    f32 blockwise route at S = 4096 (h = 8, hkv = 2) with and without
    ``q_chunk`` against float64, and ``ring_attention_n`` at bench.py's
    shape (S = 8192, h = 8, causal): TFLOP/s from 2 and 18 iterations;
14. the relational path on one rank: bench.py's pipeline (f32 fact keys,
    fan-in 16, a permuted dimension table; join -> groupby sum -> top_k
    8, and a 16-bin histogram of the joined values) at n_fact = 2^26 over
    2^22 keys, a 1024-bin histogram of 2^30 f32 normals, and bench.py's
    kernel geometry (8192 int32 keys a rank: K7 and K8 once a rank, K6
    once);
    K7 launches 0 times on the 2^26 groupby (above its cap); every result
    against torch or numpy oracles that do not use the port's code;
15. the same on 4 ranks of the card at n_fact = 2^24: the partition
    join (the default above 2^18 rows) equal bit for bit to the forced
    broadcast join, an outer join with keys missing on both sides, and
    the kernel geometry;
16. the main-path entry: ``dr_tpu_torch.entry.entry()``'s step and
    masked sum on the card against the same step on the CPU, and
    ``dryrun(4)`` on 4 ranks of the card (every section of
    ``__graft_entry__.dryrun_multichip`` the port has), with K1, K3, K4,
    K6/K7 and K9 launched by it;
17. bench.py's halo-exchange p50 (a periodic ``halo_bounds(1024,
    1024)`` vector of 2^22 cells a rank, ``exchange_n(64)``, 4 calls x 5
    batches, CUDA events) on 1 and 4 ranks, the ghosts checked against
    their owners; and GB/s/chip of phase 4's steps and phase 8's kernels
    with bytes counted as bench.py counts them;
18. the sparse path on one rank: bench.py's config 5 pattern (32 random
    columns a row) at 2^22 rows and 2^27 nonzeros: the autoselected
    format (ELL), ``gemv`` against a float64 scipy product row by row
    and the same bits on a second call, ``gemv_n`` GFLOP/s beside the
    bytes bound (``nnz*8 + m*12`` bytes) and one cuSPARSE call, ``spmm``
    with 8 vectors, the banded case (2^18 rows, half-band 128) on BCSR,
    and the peak device memory;
19. the sparse path on 4 ranks at 2^20 rows against float64 scipy: row
    tiles (ELL), the ring layout (serial equal to pipelined bit for
    bit), a 2x2 block-cyclic grid with ``gemv`` and ``spmm``, the banded
    matrix on the grid (BCSR) and a matrix with one dense row (csr);
20. re-layout and state on 4 ranks of the card: bench.py's redistribute
    ping-pong (even <-> a rotated cut, ``bench.py:1064-1102``) at 2^28
    f32, each hop's rows equal bit for bit between the collective and the
    host-staged routes, a team hop, a seeded uneven cut, a hop onto 2
    ranks (host-staged), GB/s of both routes by bench.py's count
    (``2*n*4`` bytes an iteration) and the collective route's peak
    memory, a periodic halo-1024 vector at 2^26 moved and exchanged; an
    unstructured halo over 2^26 cells (2^20 indices a rank, duplicates
    included): ``exchange()`` and the five ``reduce`` ops bit for bit
    with numpy, twice, ms per call; checkpoint round trips (a 2^28 f32
    vector with an uneven distribution, a 2^26 bf16 vector, an 8192^2
    cyclic matrix, config 5's pattern at 2^20 rows, a 3-D mdarray), bit
    for bit, with seconds and bytes, and a truncated file refused; the
    communicator at 2^24, ``rma_window``, an ``op_from_expr`` transform
    at 2^28 and the views, against numpy or torch;
21. observability: phase 14's relational pipeline (one rank, n_fact =
    2^26) and phase 15's (4 ranks, 2^24, the partition and the forced
    broadcast join) untraced and with ``dr_tpu_torch.obs`` armed, the
    outputs equal bit for bit, the four spans and their
    ``relational.phase`` children in the trace, the join's median of 5
    both ways; phase 20's 2^28 f32 re-layout traced on both routes (the
    ``redistribute`` span's ``impl``, the phases plan -> exchange ->
    rebind, ``redistribute.bytes_moved`` == ``plan_moves``' moved
    elements x 4, rows equal to the untraced hop's); ``obs.write()``
    into ``chiprun_out/phase21/``, read back and by
    ``tools/trace_view.py``; one step of the 1-D main path (one rank at
    2^30, 4 ranks at 2^26) under ``profiling.trace``: the device's idle
    share, the top device operations and the longest idle gaps with the
    host operations over them, the trace's kernels mapped to K1-K4 by
    their ``__global__`` names and counted against the launch counters;
    ``profiling.device_timer`` of ``dot_n`` within 10% of phase 8's K3
    time, and ``profiling.profile_phases`` of the 4-rank sort at 2^24;
22. resilience and guards: the chaos battery (init, halo exchange and
    reduce, the communicator's shift and all-to-all, a sort on K6, a
    scan on K4, ``dot_n`` on K3, a K1 stencil block, a ring gemv, bf16
    ring attention on K9, three collective re-layouts, a checkpoint
    write and read) on 4 ranks of the card, clean and with visit
    counting (every site the port fires reached), then one fault at each
    (site, kind) under ``with_deadline`` (a classified error at that
    site, never a hang), and a transient once at each site, retried: the
    clean run's bits; ``kernel.build`` of both kinds at K1-K9's wrappers
    on CUDA tensors (classified, launch counters unmoved, no plain
    version run, the clean bits after); an allocation above the card's
    memory classified as ``DeviceOOM`` with a main-path step's bits the
    same before and after; ``entry.dryrun(4)`` under one ``spmd_guard``
    with the same digest on card ranks and CPU ranks, and
    ``sanitize.zero_recompile`` around the second main-path step at
    2^30; the step, the halo p50 (1 and 4 ranks) and a ``TappedCache``
    lookup with nothing armed, a guard active and tracing armed.
    ``--phase22`` runs phases 1-3 and this one;
23. deferred plans: the main path (iota, for_each, transform, a halo
    exchange, K1 or K2, dot, K4's scan, dot_n on K3) as one recorded
    region at 2^30 on one rank (K1) and 2^26 on 4 ranks (K2), twice (the
    second flush replays the runs' CUDA graphs), against the same calls
    made eagerly: every row, both scalars and the launch counts equal;
    the small-op region (4 ranks, 2^20 f32 vectors, 64 x (for_each, halo
    exchange, transform, reduce)) eager and deferred in turns, 9 each:
    the host ms of each, the card's kernels and launch calls of each
    from a profiler trace (``chiprun_out/phase23/``), ``Plan.stats()``;
    graph-replayed fills and for_each with new scalars in f32, bf16 and
    f16 against the eager calls' bits; ``plan.flush`` armed transient
    (rows kept, the dropped scalar raises, a retry gives the clean bits);
    the sanitizer armed over the recorded main path (``verify_run``,
    ``check_serializable``) and a NaN made in a run raising at
    ``check_finite``; a traced region's ``plan.flush`` > ``plan.run`` /
    ``plan.opaque`` spans and counters; the phase's peak device memory.
    ``--phase23`` runs phases 1-3 and this one;
24. the tuning DB and elastic sessions: ``tuning.context()`` on the
    card; phase 18's matrix timed in the ELL and CSR formats in turns,
    the faster recorded in a DB and picked by a fresh session, a
    ``DR_GPU_SPMV_FORMAT`` pin beating it; ``join.broadcast_max = 0``
    from the DB sending a 4-rank join to the partition route with the
    broadcast route's bits; ``join_auto`` twice under
    ``DR_GPU_PLAN_OPT=all``, the second without its count probe.  Then
    on 4 ranks of the card with f32 vectors of 2^26 (a team vector on
    rank 0, a checkpointed one written after its checkpoint, one with
    no checkpoint): ``device.lost`` once under ``retry`` around a K2
    pass, ``dot_n`` and a scan with ``DR_GPU_ELASTIC=1``, the path
    finishing on 3 ranks with a fresh 3-rank runtime's bits, fates
    1 / 1 / 1 bit for bit, the lost vector raising, the shrink's wall
    time and each fate's GB/s, and the graph a deferred run captured on
    4 ranks released with its pool; ``mesh.grow`` injected (the session
    stays on 3 ranks), ``grow_session()`` back to 4 (the probe finds the
    dropped slot on cuda:0); ``device.lost`` at the flush of a deferred
    fill / for_each / reduce region, replayed on 3 ranks with the eager
    chain's bits; the region exit's grow poll
    (``DR_GPU_ELASTIC_GROW=1``); ``session_story()`` with both chapters.
    ``--phase24`` runs phases 1-3 and this one;
25. the serving daemon (``dr_tpu_torch.serve``) in process on the card,
    client threads over its Unix socket: on one rank, 8 tenants each put
    two residents of 2^25 f32 over the wire (2 GiB), then send 64
    requests (dot, reduce, histogram of 1024 bins, top_k 1024, scan and
    sort over the residents; K6's sort of 2^14 keys, scale, fill,
    groupby sum and min, unique and join at 2^20 rows inline), every
    reply bit for bit against the direct call on the same containers,
    K3, K4, K6, K7 and K8 launched as often as the direct calls imply,
    per-op client p50 / p99, requests/s, the daemon's queue-wait /
    service / flush percentiles, batch high-water mark, arena and
    resident counters, plan captures / replays / in-order runs and peak
    memory (25.1); each ``serve.*`` / ``arena.*`` (site, kind) once
    against the live daemon, classified or right, the daemon serving on;
    ``drain`` and a restart on the same state directory bringing the 2
    GiB back bit-equal (the replay's GB/s); ``python -m
    dr_tpu_torch.serve`` on the device route answering a scale and
    exiting 0 on ``shutdown`` (25.3); then on 4 ranks of the card, a
    device loss injected into a held batch of six clients' requests
    with ``DR_GPU_ELASTIC=1``: every answer with a fresh 3-rank
    runtime's bits, one shrink in ``stats()`` and the story's serve
    chapter, the grow back between batches and a fresh 4-rank runtime's
    bits after it (25.2).  ``--phase25`` runs phases 1-3 and this one;
26. the replica router (``serve.Router``, ``serve.RouterClient``) on
    the card: 3 in-process replicas on one rank, 12 tenants each put
    two residents of 2^24 f32 (1.5 GiB; cut from 2^25 for the phase's
    time) through their ``RouterClient``
    and send phase 25's 64-request mix from one thread a tenant, every
    reply bit for bit against the direct call on the same containers,
    each tenant's residents on the replica its ring names alone, K3,
    K4, K6, K7 and K8 launched as often as the direct calls imply,
    requests/s (26.1); ``router.route`` and ``router.probe`` with each
    kind against that fleet, classified at their sites, a retried
    transient with the same bits (26.3); then 3 spawned daemons on one
    state directory, every replica on the device route: the residents
    put and one round of the mix, the mix of one replica's tenants
    through that replica alone (requests/s against the three), a
    SIGKILL of the replica homing the most tenants (re-hash, the
    breaker open, the story's serve chapter, a ``Ref`` to a lost
    resident classified, re-put residents right), ``poll()``'s respawn
    replaying the journal and a probe re-admitting it (its tenants read
    their journalled residents bit for bit), and ``rolling_restart()``
    under 12 client threads with zero classified errors and every reply
    right (26.2).  ``--phase26`` runs phases 1-3 and this one;
27. the C++ bridge (``dr_tpu_torch/native``): ``bridge_demo`` and
    ``bridge_parity`` built with the card's ``g++`` and run through
    ``native.env()``; ``bridge_demo 0`` (``thp::session(0)``, the card)
    passes and its process launches K3, K4, K6 and K7 as often as the
    same calls made directly (27.1); ``bridge_parity`` from a checkpoint
    of 2^28 f32 (windowed sorts of 2^14 keys, which take K6), three
    runs: every result's digest equal to the same sequence made directly
    here from the same checkpoint, the launch counts equal, each call's
    least host time both ways and the child's start (27.2).
    ``--phase27`` runs phases 1-3 and this one.
28. multi-process execution: phase 4's 1-D main path (K1 with halo 512
    and k_block 256, K2 with halo 1024 and T = 64, ``dot_n``,
    ``inclusive_scan`` / ``exclusive_scan`` / ``inclusive_scan_n``) at
    n = 2^30 f32, first with one controller on two ranks of cuda:0
    (28.1), then in two processes (``init_distributed``, gloo), each
    owning one rank on cuda:0 (28.2): each child's int64 digests of its
    rank's cells equal the single controller's bit for bit, its K1-K4
    launch counts equal its rank's, ``to_host`` of 2^24 f32 returns the
    source exactly on each process; each process's step times, its
    start, the cross-process halo p50 (2^22 cells a rank,
    ``exchange_n(64)``, host clock) and ``to_host``'s GB/s.  A child
    that fails, hangs past its deadline or disagrees fails the phase.
    ``--phase28`` runs phases 1-3 and this one.
29. multi-process execution of the other kernel paths, first with one
    controller on two ranks of cuda:0 (29.1), then in two processes
    over gloo, each owning one rank on cuda:0 (29.2): ``sort``,
    ``is_sorted``, ``sort_by_key`` and ``argsort`` at 2^26 f32 (phase
    10's size) and the exchange's seconds (the ``exchange`` cut minus
    the ``splitter`` cut), K6's geometry (2 x 16384 int32 keys: a sort,
    a key-value sort and a window of 2^14 keys), ``reduce`` min and max
    at 2^28 f32 (K7), ``stencil2d_n`` on a one-tile 16384^2 matrix (4
    K5 passes of T = 16, run by process 0, which owns the tile), the
    tiled ``stencil2d_iterate`` on a 2 x 1 grid at 8192^2 (8 steps), a
    ``transpose`` of an 8192^2 mdarray, config 5's pattern at 2^20 rows
    (cut from 2^22: every process draws and builds the whole COO) on
    the csr route (``gemv_n`` 8 rounds, ``spmm_n`` with 8 vectors), and
    ring attention at Llama-3-8B's shape and S = 32768 (one causal
    call; ``ring_attention_n`` with 2 iterations at 8 q heads, since it
    chains v through the output).  Each child's int64 digests of its
    rank's cells equal 29.1's bit for bit; it launches K5, K6, K7 and
    K9 as often as its rank's share of 29.1 (K5 all or none by the
    tile's owner, K6 one batch a sort, K7 and K9 half); each process's
    step seconds against 29.1's, its start and ``spmd_guard.verify()``
    over the path.  ``--phase29`` runs phases 1-3 and this one.
30. multi-process execution of the relational ops and re-layout, first
    with one controller on two ranks of cuda:0 (30.1, held to oracles
    independent of the port), then in two processes over gloo, each
    owning one rank on cuda:0 (30.2): phase 14's pipeline (join on the
    partition route, groupby sum, top_k 8, a 16-bin histogram) at 2^26
    f32 fact rows over 2^22 keys; phase 15's inner and outer joins on
    both routes at 2^24 over 2^20; the kernel geometry (2 x 8192 int32
    keys: a groupby sum on K6 and K7, a 256-bin histogram on K8), 2^30
    f32 values into 1024 bins (K8), ``unique`` and the three auto ops
    at the geometry; the redistribute ping-pong at 2^28 f32 (even <->
    a cut a quarter in) on the collective and the host-staged route,
    an 8192^2 matrix re-block from 1024^2 cyclic tiles, and an
    unstructured halo over 2^26 cells with 2^20 indices a rank
    (``exchange()`` and ``reduce("plus")``).  Each child's int64
    digests of its rank's cells (and of the rows every process
    gathers) equal 30.1's bit for bit; it launches K6 as often as 30.1
    (one batch a sort) and K7 and K8 half as often (once a rank);
    ``spmd_guard.verify()`` agrees over the path; each process's step
    seconds against 30.1's, its start and the ping-pong's GB/s across
    processes.  A child that fails, hangs past its deadline or
    disagrees fails the phase.  ``--phase30`` runs phases 1-3 and this
    one.
31. the host layers across processes.  31.1: one controller on two
    ranks of cuda:0 records a deferred region of the main path at
    n = 2^30 f32 (iota, fill, for_each, a halo exchange with halo 512,
    transform, reduce, dot on K3, a 1024-bin histogram on K8 and top_k
    8 of its bins fused into one run; ``inclusive_scan`` on K4, one K2 pass of
    T = 64 with halo 1024 and one K1 pass of k_block 256 opaque), then
    ``dot_n`` (K3) after the flush.  31.2: two processes over gloo,
    each owning one rank on cuda:0, run the same region: each child's
    int64 digests equal 31.1's bit for bit, it launches K1-K4, K7 and
    K8 half as often (once a rank), its ``Plan.stats()`` equals its
    peer's, and ``spmd_guard.verify()`` agrees.  31.3: with
    ``DR_GPU_TUNING_DB`` in a temp directory and the ``joinroute`` /
    ``capinfer`` passes armed, process 0 records a join route threshold
    of 2^26 rows (the broadcast merge, where the default would take the
    partition route) and two ratio hints; ``join`` and ``join_auto`` of
    2^24 fact rows over 2^20 keys route alike on both children, and
    ``groupby_auto`` at the kernel geometry (2 x 8192 int32 keys: K6
    and K7) sizes its output from the hint; every digest equals one
    controller's under the same records, and each child launches K6 as
    often as one controller and K7 half as often.  31.4: a 2^28 f32 vector checkpointed and doubled; child 1
    exits with code 17 after a barrier, child 0 meets the dead peer in a
    ``reduce`` under ``with_deadline``, attributes it to rank 1, shrinks
    onto rank 0 (the vector restored) and runs ``dot_n`` (K3) and
    ``inclusive_scan`` (K4): their digests equal one controller's on
    the same values; the seconds from the failed call to the finished
    rescue, the restore's GB/s and how the dead peer's receive ended.
    ``--phase31`` runs phases 1-3 and this one.
32. the C++ bridge across processes: two processes, each owning one
    rank on cuda:0 over gloo (``thp::session(const distributed&)``, over
    ``init_distributed``).  32.1: ``bridge_mp_demo`` passes in both, and
    each launches its rank's share of the same calls made directly on
    one controller on two ranks of cuda:0 (K3 from ``dot``, K7 from the
    int32 ``reduce``, K6 from the sorts).  32.2: ``bridge_parity --mp``
    from a checkpoint of 2^24 f32 (cut from 27.2's 2^28: every
    ``to_host`` gathers the whole vector through gloo), windowed sorts
    of 2^14 keys (K6), two runs: each process's digests equal
    ``parity_direct``'s on one controller on two ranks of cuda:0 (held
    to the csr sparse route, the one across processes) bit for bit, each
    launches its rank's share of K3, K4, K6 and K7; each process's start
    and each call's least host ms against the direct call's.  A process
    that fails, hangs past its deadline or disagrees fails the phase.
    ``--phase32`` runs phases 1-3 and this one (with ``--phase33``,
    both).
33. the examples (``dr_tpu_torch.examples``, the JAX package's
    ``examples/`` scripts): all 15 through ``main([...])`` in this
    process at their defaults on one rank of cuda:0 (33.1) and on 4
    logical ranks (``--ranks 4``; ``sort_example -n 65536``, so its
    sort and ``windows_example``'s put 16384 keys on a rank, K6's
    geometry) (33.2), each returning 0; again under the plain versions,
    which launch nothing and print the same results within the
    examples' own oracles; K3 in ``dot_product`` (one a rank) and CG
    (one a rank a ``dot``), K4 in ``inclusive_scan_example`` and
    ``windows_example``'s windowed scan, K6 in 33.2's sorts and in
    ``windows_example``'s key-value sort (2^15 keys) on one rank too;
    every example's launches and seconds.  ``--phase33`` runs phases 1-3 and
    this one.

``--halo-ab DIR`` times phase 17's halo p50 with the ``dr_tpu_torch`` of
another checkout at ``DIR`` and this one's, in turns, and stops.

Phase 3 also holds K9 (``flash_update``) against its plain version at
small shapes (d = 128 and 256 on the wgmma kernel, d = 768 on the
mma.sync one; s = 200, a ragged q tile; the causal diagonal inside a
tile), and phase 8 times it at BH = 32, s = skv = 32768, group 4,
causal, beside ``F.scaled_dot_product_attention`` as the library call,
and at d = 256, s = skv = 16384 on a line of its own.

Exits non-zero on any failure.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernel
table as one JSON object.
"""

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the
# dense float32 rate outside the tensor cores and the dense bf16
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

W5 = (0.05, 0.25, 0.4, 0.25, 0.05)  # the bench's 5-point stencil
K_BLOCK, MM_HALO = 256, 512
T_BLOCK, BLK_HALO = 64, 1024
STEPS = 512
DOT_ROUNDS = 8
M2D, T2D = 16384, 16          # the 2-D main path's matrix and time block
STEPS2D, ITERS2D = 520, 32    # 32 full passes + one of 8; 32 passes
M4, STEPS4, CYC_TILE = 8192, 64, 1024  # the 2-D four-rank phase
SORT_LOG2 = 28   # the sort path on one rank: 1 GiB of f32 keys
SORT4_LOG2 = 26  # on four ranks, cut so its numpy oracle stays short
# ring attention: Llama-3-8B's attention (32 q heads, 8 K/V heads, head
# dim 128) at a 32k-token context; bench.py's ring_attention_n shape
RA_S, RA_H, RA_HKV, RA_D = 32768, 32, 8, 128
RA4_P = 4
RA_F32 = (4096, 8, 2)              # S, h, hkv of the f32 blockwise check
RAN_S, RAN_H, RAN_ITERS = 8192, 8, (2, 18)
ORACLE_ROWS = 64
K8_BINS = 1024         # K8's timed shape: 2^30 ids over 1024 bins
# the relational pipeline: 2^26 fact rows (about TPC-H SF 10's lineitem)
# over 2^22 keys (bench.py's fan-in 16) on one rank; 2^24 on 4 ranks
REL_FACT_LOG2, REL_CARD_LOG2, REL4_FACT_LOG2 = 26, 22, 24
# halo-exchange p50: bench.py's periodic halo of 1024 cells a side over
# 2^22 cells a rank, 64 exchanges a timed call
HALO_W, HALO_CELLS, HALO_ROUNDS = 1024, 1 << 22, 64
# the sparse path: bench.py's config 5 pattern (32 random columns a row)
# at 2^22 rows, 2^27 nonzeros (a SuiteSparse web or road matrix's scale,
# where bench.py's 2^17 rows were sized for a TPU), spmm with 8 vectors,
# the banded BCSR case at 2^18 rows (half-band 128); 4 ranks at 2^20
# rows, the banded grid with half-band 16
SP_LOG2, SP_K, SP_NV = 22, 32, 8
SPB_LOG2, SPB_HALF = 18, 128
SP4_LOG2, SP4_HALF = 20, 16
# phase 20, on 4 ranks: bench.py's redistribute ping-pong (even <->
# rotated cut) at 2^28 f32, 1 GiB (bench.py's 2^24 was a TPU chip's
# share), a periodic halo-1024 vector at 2^26; an unstructured halo over
# 2^26 cells, 2^20 mirrored indices a rank; checkpoints of a 2^28 f32
# vector, a 2^26 bf16 vector, an 8192^2 matrix in 1024^2 cyclic tiles,
# config 5's pattern at 2^20 rows and a 512 x 512 x 256 mdarray; the
# communicator at 2^24 and an expression transform at 2^28
RDX_LOG2, RDX_HALO_LOG2 = 28, 26
UH_LOG2, UH_GHOSTS_LOG2 = 26, 20
CK_LOG2, CK_BF_LOG2, CK_M, CK_TILE, CK_MD = 28, 26, 8192, 1024, (512, 512,
                                                                  256)
SURF_LOG2, EXPR_LOG2 = 24, 28
UH_OPS = ("plus", "multiplies", "max", "min", "second")
# phase 21 writes its traces here (a gitignored directory)
OBS_DIR = os.path.join(HERE, "chiprun_out", "phase21")
# every log line also goes here (a gitignored directory)
LOG_PATH = os.path.join(HERE, "chiprun_out", "chip_smoke.log")
# phase 22: the chaos battery on 4 ranks of the card: vectors of 2^20
# f32 (2^18 a rank), the sort at K6's geometry (2^14 keys a rank), bf16
# ring attention at S = 2048 with 8 q and 2 K/V heads of dim 128 (K9's
# tiles), a ring gemv over 2^16 rows (4 nonzeros a row); the main-path
# step of the OOM, tap and cost checks at phase 4's 2^30 on one rank
CHAOS_LOG2, CHAOS_SORT_PER = 20, 1 << 14
CHAOS_RA = (2048, 8, 2, 128)
CHAOS_GEMV_LOG2 = 16
CHAOS_DEADLINE = 120.0
GUARD_LOG2 = 30
# phase 23: the small-op region (4 ranks, 2^20 f32 vectors, 64 rounds of
# four ops, 9 timed turns each way) and the scalar checks at 2^20
PLAN_SMALL_LOG2, PLAN_SMALL_ITERS, PLAN_TURNS = 20, 64, 9
PLAN_DTYPES_LOG2 = 20
# phase 24: the fate vectors (f32), the 1-D path's length (a segment a
# multiple of 1024 on 3 and on 4 ranks: K2's geometry), the replayed
# region, the DB-routed join (2^16 fact rows over 2^12 keys, below the
# 2^18 default threshold) and the SpMV turns
EL_LOG2, EL_PATH, EL_REPLAY_LOG2 = 26, 3 << 24, 24
EL_JOIN, EL_SPMV_TURNS = (16, 12), 3


#: a copy of every log line, opened by main(), so the whole log survives
#: where only the end of standard output is kept
LOG_FILE = None


def log(*a):
    print(*a, flush=True)
    if LOG_FILE is not None:
        print(*a, file=LOG_FILE, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, flops, peak=FP32_FLOP_PER_S):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


@contextlib.contextmanager
def plain_versions(kernels):
    """Route the wrappers to their plain PyTorch versions on the card
    (the reference run of the main path; nothing in the port does this)."""
    saved = kernels.on_cuda
    kernels.on_cuda = lambda *t: False
    try:
        yield
    finally:
        kernels.on_cuda = saved


def release(torch):
    """Free what the last phase left, cycles included, and return the
    cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def check(name, err, tol):
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"  {name}: max_abs_err={err!r} tol={tol!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def max_err(a, b, chunk=1 << 26):
    """Largest |a - b| in float64, taken in chunks to bound memory."""
    a, b = a.reshape(-1), b.reshape(-1)
    return max(float((a[i:i + chunk].double() - b[i:i + chunk].double())
                     .abs().max()) for i in range(0, a.numel(), chunk))


def f32_ulp(v):
    """The spacing of f32 values at magnitude |v|."""
    return 2.0 ** (math.frexp(abs(v))[1] - 24)


def step_err(out, x, start, chunk=1 << 26):
    """Largest |(out[i] - out[i-1]) - x[i]| in float64, with out[-1] taken
    as ``start``: every prefix of an add-scan adds exactly its own
    element, so a dropped or doubled element at a block or rank boundary
    shows here at its own size."""
    import torch
    out, x = out.reshape(-1), x.reshape(-1)
    prev = torch.tensor([float(start)], dtype=torch.float64,
                        device=out.device)
    worst = 0.0
    for i in range(0, out.numel(), chunk):
        o = out[i:i + chunk].double()
        d = o - torch.cat([prev, o[:-1]])
        worst = max(worst, float((d - x[i:i + chunk].double()).abs().max()))
        prev = o[-1:]
    return worst


def f64_dot(x, y, salt, chunk=1 << 26):
    """sum(x * (y + salt)) in float64, in chunks."""
    return sum(float((x[i:i + chunk].double() * (y[i:i + chunk].double()
                                                 + salt)).sum())
               for i in range(0, x.numel(), chunk))


def heat_tol(w, steps, scale):
    """Bound on |f32 result - exact| after ``steps`` 3x3 steps with
    nonnegative weights summing to at most 1: a step rounds each of its
    nnz products and nnz-1 sums once, each by at most 2^-24 of a partial
    sum no larger than the data's largest |value| (``scale``; such a step
    never raises it), and such a step does not grow an earlier error.
    Two f32 results of the same steps differ by at most twice this."""
    nnz = int(np.count_nonzero(np.asarray(w)))
    return steps * (2 * nnz - 1) * 2.0 ** -24 * scale


def kernel_checks(dt, n, m2d, gen, results):
    """Phase 3: every kernel against its plain version, same inputs."""
    import torch
    from dr_tpu_torch.ops import (reduce_pallas, scan_pallas,
                                  stencil2d_pallas, stencil_matmul,
                                  stencil_pallas, stencil_step)
    dev = torch.device("cuda", 0)

    # K1 at the main path's row: tolerance — the kernel takes the TPU
    # kernel's three bf16 products on the tensor cores (taps and data
    # split into hi and lo, each product off by ~2^-16 of itself), the
    # plain version an f32 matmul; over 1025 taps of O(1) data the
    # errors average to a few 1e-6, so 1e-5 absolute covers them; and a
    # second launch gives the same bits
    row = torch.randn((1, n + 2 * MM_HALO), generator=gen, device=dev)
    got = stencil_matmul.matmul_stencil_row(row, n, MM_HALO, W5, K_BLOCK)
    ref = stencil_matmul.plain_apply(row, n, MM_HALO, W5, K_BLOCK)
    torch.cuda.synchronize()
    results["stencil_matmul"]["max_abs_err"] = e = max_err(got, ref)
    check("K1 stencil_matmul", e, 1e-5)
    del ref
    check_true("K1 stencil_matmul: a second launch, the same bits",
               torch.equal(got, stencil_matmul.matmul_stencil_row(
                   row, n, MM_HALO, W5, K_BLOCK)))
    del got, row

    # K2: the same separately rounded products and sums in the same
    # order as the plain version, so the same bits: at the main path's
    # row, on one partial tile with 17 taps, and with a margin deep
    # enough (T*r > 2048) for the kernel's shared-memory route
    w17 = tuple(float(k) / 153.0 for k in range(1, 18))
    for tag, seg, halo, w, tsteps in (
            ("", n, BLK_HALO, W5, T_BLOCK),
            (" r=8 T=17 seg=1024", 1024, 1024, w17, 17),
            (" r=8 T=300 shared route", 4096, 3072, w17, 300)):
        row = torch.randn((1, seg + 2 * halo), generator=gen, device=dev)
        got = stencil_pallas.blocked_stencil_row(row, seg, halo, w, tsteps)
        ref = stencil_pallas.plain_blocked(row, seg, halo, w, tsteps)
        torch.cuda.synchronize()
        e = max_err(got, ref)
        if not tag:
            results["stencil_blocked"]["max_abs_err"] = e
        check_equal(f"K2 stencil_blocked{tag}", got, ref)
        del got, ref, row

    # the plain step's kernel: the plain version's separately rounded
    # products and sums in its order, so the same bits, at the main
    # path's row with received ghosts and with ragged ends
    row = torch.randn((1, n + 4), generator=gen, device=dev)
    out = torch.randn((1, n + 4), generator=gen, device=dev)
    ghosts = (row[:, n:n + 2], row[:, 2:4])
    for a, b in ((0, n), (3, n - 5)):
        got = stencil_step.step_row(row, out, W5, 2, n, a, b, *ghosts)
        ref = stencil_step.plain_step_row(row, out, W5, 2, n, a, b, *ghosts)
        torch.cuda.synchronize()
        check_equal(f"stencil_step [{a}, {b})", got, ref)
        del got, ref
    del row, out, ghosts

    # K3: positive data, so the sum has no cancellation.  Two f32
    # reductions of these terms in different orders differ by ~1 absolute
    # at 2^30 (earlier runs measured 0), far below one f32 ulp of the
    # result (32 at ~3.4e8): tolerance 4 ulps of the result against the
    # plain version.  Against a float64 sum the f32 tree's top levels add
    # a few tens more: tolerance 8 ulps.  A lost run of ~1000 elements
    # (~0.3 each) exceeds either.
    x = torch.rand(n, generator=gen, device=dev)
    y = torch.rand(n, generator=gen, device=dev)
    salt = torch.tensor(0.125, device=dev)
    got = reduce_pallas.chunked_dot(x, y, salt=salt)
    ref = reduce_pallas.plain_dot(x, y, salt)
    results["chunked_dot"]["max_abs_err"] = e = max_err(got, ref)
    check("K3 chunked_dot", e, 4 * f32_ulp(float(ref)))
    check("K3 chunked_dot vs float64", abs(float(got) - f64_dot(x, y, 0.125)),
          8 * f32_ulp(float(ref)))
    for dtp in (torch.bfloat16, torch.float16):
        xs, ys = x[:1 << 24].to(dtp), y[:1 << 24].to(dtp)
        g2 = reduce_pallas.chunked_dot(xs, ys, salt=salt)
        r2 = reduce_pallas.plain_dot(xs, ys, salt)
        check(f"K3 chunked_dot {dtp}", max_err(g2, r2),
              4 * f32_ulp(float(r2)))
    del x, y

    # K4: prefixes of N(0,1) data reach ~|3e4|; f32 prefix sums taken
    # in two orders drift by ~1e-6 of the running magnitude per level,
    # tolerance 1e-4 of the largest prefix
    x = torch.randn(n, generator=gen, device=dev)
    carry = torch.tensor(3.5, device=dev)
    got = scan_pallas.chunked_cumsum(x, carry=carry)
    ref = scan_pallas.plain_cumsum(x, carry)
    results["chunked_cumsum"]["max_abs_err"] = e = max_err(got, ref)
    top = float(ref.abs().max())
    check("K4 chunked_cumsum", e, 1e-4 * top)
    # each output adds exactly its element: the roundings of the offsets
    # and outputs at a block boundary sum to at most ~4 ulps of the
    # largest prefix; tolerance 8 ulps (~0.03 at 5.8e4), where a dropped
    # or doubled N(0,1) element is ~0.8
    check("K4 chunked_cumsum steps", step_err(got, x, 3.5),
          8 * f32_ulp(top))
    # one launch with a fixed-order look-back: the same bits every call
    again = scan_pallas.chunked_cumsum(x, carry=carry)
    check_true("K4 chunked_cumsum same bits twice",
               torch.equal(got.view(torch.int32), again.view(torch.int32)))
    del again, ref
    # a start 4 bytes past a 16-byte boundary (a rank view behind a halo),
    # no carry: the same tolerances
    xs = x[1:]
    got = scan_pallas.chunked_cumsum(xs)
    ref = scan_pallas.plain_cumsum(xs)
    top = float(ref.abs().max())
    check("K4 chunked_cumsum 4 bytes off", max_err(got, ref), 1e-4 * top)
    check("K4 chunked_cumsum 4 bytes off steps", step_err(got, xs, 0.0),
          8 * f32_ulp(top))
    del got, ref, xs
    xb = x[:1 << 24].to(torch.bfloat16)
    g2 = scan_pallas.chunked_cumsum(xb, carry=carry)
    r2 = scan_pallas.plain_cumsum(xb, carry)
    # bf16 output rounds each f32 prefix to 8 significant bits: two f32
    # prefixes a hair apart may round to neighbouring bf16 values, so
    # allow two bf16 ulps (2^-6) of the largest prefix
    check("K4 chunked_cumsum bf16", max_err(g2, r2),
          2 ** -6 * float(r2.float().abs().max()))
    g2 = scan_pallas.chunked_cumsum(xb[3:], carry=carry)  # 6 bytes off
    r2 = scan_pallas.plain_cumsum(xb[3:], carry)
    check("K4 chunked_cumsum bf16 6 bytes off", max_err(g2, r2),
          2 ** -6 * float(r2.float().abs().max()))
    del x, xb, g2, r2

    # K5 at the 2-D main path's pass (the cross template): FMA-contracted
    # sums against the plain version's separately rounded ones, within
    # twice heat_tol; then all nine taps (the full template), and the
    # cross at T = 17 with pad > T, each with m and n off the kernel's
    # tiles (a partial last tile in both directions)
    w = dt.heat_step_weights(0.25)
    xp = torch.randn((m2d + 2 * T2D, m2d), generator=gen, device=dev)
    got = stencil2d_pallas.blocked_stencil2d_padded(xp, m2d, w, T2D, T2D)
    ref = stencil2d_pallas.plain_blocked2d(xp, m2d, w, T2D, T2D)
    torch.cuda.synchronize()
    results["stencil2d_blocked"]["max_abs_err"] = e = max_err(got, ref)
    check("K5 stencil2d_blocked", e,
          2 * heat_tol(w, T2D, float(xp.abs().max())))
    del got, ref, xp
    wf = ((0.05, 0.1, 0.05), (0.1, 0.4, 0.1), (0.05, 0.1, 0.05))
    q = m2d // 4 + 77
    xp = torch.randn((q + 10, m2d), generator=gen, device=dev)
    got = stencil2d_pallas.blocked_stencil2d_padded(xp, q, wf, 5, 5)
    ref = stencil2d_pallas.plain_blocked2d(xp, q, wf, 5, 5)
    check("K5 stencil2d_blocked full 3x3", max_err(got, ref),
          2 * heat_tol(wf, 5, float(xp.abs().max())))
    del got, ref, xp
    # drawn from a generator of its own, so the later checks' inputs do
    # not depend on this one
    q, nq, T, pad = m2d // 16 + 3, m2d - 128, 17, 24
    g5 = torch.Generator(device=dev).manual_seed(gen.initial_seed() + 5)
    xp = torch.randn((q + 2 * pad, nq), generator=g5, device=dev)
    got = stencil2d_pallas.blocked_stencil2d_padded(xp, q, w, T, pad)
    ref = stencil2d_pallas.plain_blocked2d(xp, q, w, T, pad)
    check("K5 stencil2d_blocked partial tiles, T=17, pad 24",
          max_err(got, ref), 2 * heat_tol(w, T, float(xp.abs().max())))
    check_true("K5 stencil2d_blocked pad rows and frozen edges",
               torch.equal(got[:pad + 1], xp[:pad + 1])
               and torch.equal(got[pad + q - 1:], xp[pad + q - 1:])
               and torch.equal(got[:, [0, nq - 1]], xp[:, [0, nq - 1]]))
    del got, ref, xp


def bit_diff(got, want):
    """(same bits?, max |got - want| in float64 over the non-NaN cells);
    a NaN matches a NaN at the same position."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    if got.is_floating_point():
        gn, wn = torch.isnan(got), torch.isnan(want)
        if not torch.equal(gn, wn):
            return False, float("inf")
        got, want = got.masked_fill(gn, 0), want.masked_fill(wn, 0)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    same = torch.equal(got.view(ints[got.element_size()]),
                       want.view(ints[want.element_size()]))
    return same, (max_err(got, want) if got.numel() else 0.0)


def check_bits(name, got, want, worst):
    """Bit-for-bit check of kernel against plain; ``worst`` (a one-item
    list) keeps the largest difference seen."""
    same, err = bit_diff(got, want)
    worst[0] = max(worst[0], err)
    if not same:
        log(f"  {name}: FAIL (max_abs_err={err!r})")
        raise AssertionError(f"{name}: kernel and plain version differ")


def k6_inputs(n, gen, dev):
    """Keys of the sort's int32 encoding: random, heavy duplicates, keys
    at the dtype max (the pad key), and f32 values with NaN and +-0."""
    import torch
    from dr_tpu_torch.algorithms.sort import _encode
    imax = torch.iinfo(torch.int32).max
    rnd = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                        device=dev, dtype=torch.int32)
    dup = torch.randint(0, 8, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    top = rnd.clone()
    top[::8] = imax
    f = torch.randn(n, generator=gen, device=dev)
    f[1::7] = 0.0
    f[2::7] = -0.0
    f[3::11] = float("nan")
    return {"random": rnd, "duplicates": dup, "max": top,
            "f32 keys-only": _encode(f, distinct_zeros=True)[0],
            "f32": _encode(f)[0]}


def k6_checks(gen, results, device="cuda:0"):
    """Phase 3, K6: bit for bit against torch.sort of the same encoding,
    keys-only and (key, gid) pairs, at M in {256, 4096, 2^15}, full and
    padded blocks (the KV 2^15 block runs on a two-block cluster), then
    batches of 8 and 133 blocks (more than the SMs) at M in {256, 4096,
    16384, 2^15}."""
    import torch
    from dr_tpu_torch.ops import sort_pallas
    dev = torch.device(device)
    imax = torch.iinfo(torch.int32).max
    worst = [0.0]
    for M in (256, 4096, 1 << 15):
        for n in (M, M - 37):
            for kind, keys in k6_inputs(n, gen, dev).items():
                gid = torch.randperm(n, generator=gen, device=dev).to(
                    torch.int32)
                if kind == "max":  # pad-like pairs: identical, at the max
                    gid[-5:] = imax
                    keys = keys.clone()
                    keys[-5:] = imax
                got = sort_pallas.sort_keys(keys)
                check_bits(f"K6 keys M={M} n={n} {kind}", got,
                           sort_pallas.plain_sort_keys(keys), worst)
                gk, gg = sort_pallas.sort_kv(keys, gid)
                rk, rg = sort_pallas.plain_sort_kv(keys, gid)
                check_bits(f"K6 kv keys M={M} n={n} {kind}", gk, rk, worst)
                check_bits(f"K6 kv gids M={M} n={n} {kind}", gg, rg, worst)
    # batches: one launch sorts every row; 133 rows are more than the SMs
    for M in (256, 4096, 16384, 1 << 15):
        for n in (M, M - 37):
            for b in (8, 133):
                keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, n),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
                keys[:, ::3] = torch.randint(-3, 3, keys[:, ::3].shape,
                                             generator=gen, device=dev,
                                             dtype=torch.int32)
                keys[:, 1::11] = imax
                gid = torch.argsort(torch.rand((b, n), generator=gen,
                                               device=dev), dim=1).to(
                    torch.int32)
                keys[:, -5:] = imax  # pad-like pairs
                gid[:, -5:] = imax
                check_bits(f"K6 batch {b}x{n} keys",
                           sort_pallas.sort_keys(keys),
                           sort_pallas.plain_sort_keys(keys), worst)
                gk, gg = sort_pallas.sort_kv(keys, gid)
                rk, rg = sort_pallas.plain_sort_kv(keys, gid)
                check_bits(f"K6 batch {b}x{n} kv keys", gk, rk, worst)
                check_bits(f"K6 batch {b}x{n} kv gids", gg, rg, worst)
    log("  K6 bitonic_sort: 30 keys-only and 30 KV blocks, 16 keys-only "
        "and 16 KV batches bit-exact ok")
    results["bitonic_sort"]["max_abs_err"] = worst[0]


def k7_columns(n, gen, dev):
    """Four int32 columns (sum, prod, min, max), four float ones (f32
    and bf16 min/max) with +-0, NaN and infinities, and eight 8- and
    16-bit integer and bool ones (reduce's narrow containers)."""
    import torch
    i = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                      device=dev, dtype=torch.int32)
    i8, u8, i16 = i.to(torch.int8), (i >> 8).to(torch.uint8), \
        (i >> 16).to(torch.int16)
    tf = (i & 7) != 0
    f = torch.randn(n, generator=gen, device=dev)
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            float("-inf")], device=dev)
    pos = torch.randint(0, n, (max(n // 8, 1),), generator=gen, device=dev)
    f[pos] = special[torch.randint(0, 5, pos.shape, generator=gen,
                                   device=dev)]
    b = f.to(torch.bfloat16)
    return ([(i, "sum"), (i, "prod"), (i, "min"), (i, "max")],
            [(f, "min"), (f, "max"), (b, "min"), (b, "max")],
            [(i8, "sum"), (i8 | 1, "prod"), (u8, "min"), (i16, "max")],
            [(tf, "sum"), (tf, "prod"), (i16, "sum"), (u8, "max")])


def k7_checks(n, gen, results, device="cuda:0"):
    """Phase 3, K7: bit for bit against its plain version, NaN matching
    NaN: nseg in {1, 127, 128, 129, 2^15} x n in {1, 1000, 2^15} with
    out-of-range ids and empty segments, then ``n`` elements in one
    segment without ids (reduce's use)."""
    import torch
    from dr_tpu_torch.ops import segred_pallas as sr
    dev = torch.device(device)
    worst = [0.0]
    for nseg in (1, 127, 128, 129, 1 << 15):
        for m in (1, 1000, 1 << 15):
            ids = torch.randint(-2, nseg + 2, (m,), generator=gen,
                                device=dev, dtype=torch.int32)
            for cols in k7_columns(m, gen, dev):
                got = sr.segmented(ids, nseg, cols)
                ref = sr.plain_segmented(ids, nseg, cols)
                for (v, op), g, r in zip(cols, got, ref):
                    check_bits(f"K7 {v.dtype} {op} nseg={nseg} n={m}", g, r,
                               worst)
    # n elements, one segment: |randn| with +0.0 and -0.0 planted, so
    # min is -0.0; then a NaN, which both min and max must propagate;
    # and the int32 sum of the same bits (modulo 2^32)
    x = torch.randn(n, generator=gen, device=dev).abs_()
    x[n // 3] = 0.0
    x[n // 2] = -0.0
    x[n - 1] = 0.0
    for tag in ("+-0", "NaN"):
        cols = ((x, "min"), (x, "max"))
        got = sr.segmented(None, 1, cols)
        ref = sr.plain_segmented(None, 1, cols)
        for (v, op), g, r in zip(cols, got, ref):
            check_bits(f"K7 f32 {op} n={n} one segment {tag}", g, r, worst)
        if tag == "+-0" and not torch.signbit(got[0]).item():
            raise AssertionError("K7 min over +-0 is not -0.0")
        x[n // 5] = float("nan")
    xi = x.view(torch.int32)
    check_bits(f"K7 int32 sum n={n} one segment",
               sr.segmented(None, 1, ((xi, "sum"),))[0],
               sr.plain_segmented(None, 1, ((xi, "sum"),))[0], worst)
    k7_unaligned(gen, dev, worst)
    log(f"  K7 segred: bit-exact ok at nseg 1..2^15 and n={n}, unaligned "
        f"starts and ragged tails")
    results["segred"]["max_abs_err"] = worst[0]
    del x, xi


def k7_unaligned(gen, dev, worst):
    """K7 on columns that start 0 to 3 elements (f32, bf16) or 0 to 15
    (int8, bool) past a 16-byte boundary, ids at the same and at another
    offset, n in {1, 15, 17, 2^20 + 3} (ragged tails) and nseg in {none,
    1, 127, 1024, 1025, 2^15} (every route of the kernel), NaN and +-0.0
    in the floats: bit for bit against the plain version."""
    import torch
    from dr_tpu_torch.ops import segred_pallas as sr
    for n in (1, 15, 17, (1 << 20) + 3):
        base = n + 16
        f = torch.randn(base, generator=gen, device=dev)
        special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                                float("-inf")], device=dev)
        pos = torch.randint(0, base, (max(base // 8, 1),), generator=gen,
                            device=dev)
        f[pos] = special[torch.randint(0, 5, pos.shape, generator=gen,
                                       device=dev)]
        h = f.bfloat16()
        i8 = torch.randint(-128, 128, (base,), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        tf = torch.rand(base, generator=gen, device=dev) < 0.7
        for nseg in (None, 1, 127, 1024, 1025, 1 << 15):
            ids = None if nseg is None else torch.randint(
                -2, nseg + 2, (base,), generator=gen, device=dev,
                dtype=torch.int32)
            for off in range(16):
                calls = [((i8[off:off + n], "sum"), (i8[off:off + n], "max"),
                          (tf[off:off + n], "sum"), (tf[off:off + n], "min"))]
                if off < 4:
                    calls.append(((f[off:off + n], "min"),
                                  (f[off:off + n], "max"),
                                  (h[off:off + n], "min"),
                                  (h[off:off + n], "max")))
                for j, cols in enumerate(calls):
                    io = (off + j) % 4
                    seg = None if ids is None else ids[io:io + n]
                    got = sr.segmented(seg, nseg or 1, cols)
                    ref = sr.plain_segmented(seg, nseg or 1, cols)
                    for (v, op), g, r in zip(cols, got, ref):
                        check_bits(f"K7 {v.dtype} {op} n={n} nseg={nseg} "
                                   f"offset={off}", g, r, worst)


def stepper(dt, times):
    """A context manager adding each step's host-clock seconds, ended by
    a fence, to ``times[name]``."""
    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        dt.fence()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
    return step


def main_path(dt, n, seed, times=None, keep_inputs=False):
    """The main path on the current runtime; returns the source vector
    and every result, moved to the host as it is made.  ``times`` (a
    dict) gets each step's host-clock seconds, each ended by a fence.
    ``keep_inputs`` also returns the dot operands (as "x" and "y")."""
    import torch
    step = stepper(dt, {} if times is None else times)
    dev = dt.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    with step("data"):
        src = torch.randn(n, generator=gen, device=dev)
        a = dt.distributed_vector.from_array(
            src, halo=dt.halo_bounds(MM_HALO, MM_HALO, periodic=True))
    with step("stencil_iterate_matmul"):
        dt.stencil_iterate_matmul(a, W5, STEPS, k_block=K_BLOCK)
    with step("host copy"):
        out["matmul"] = a.to_array().cpu()
    del a
    with step("data"):
        b = dt.distributed_vector.from_array(
            src, halo=dt.halo_bounds(BLK_HALO, BLK_HALO, periodic=True))
    with step("stencil_iterate_blocked"):
        dt.stencil_iterate_blocked(b, W5, STEPS, time_block=T_BLOCK)
    with step("host copy"):
        out["blocked"] = b.to_array().cpu()
    del b
    with step("data"):
        x = dt.distributed_vector.from_array(
            torch.rand(n, generator=gen, device=dev))
        y = dt.distributed_vector.from_array(
            torch.rand(n, generator=gen, device=dev))
    with step("dot_n"):
        d = dt.dot_n(x, y, DOT_ROUNDS)
    out["dot_n"] = d.cpu()
    if keep_inputs:
        out["x"], out["y"] = x.to_array().cpu(), y.to_array().cpu()
    del x, y
    with step("data"):
        s = dt.distributed_vector.from_array(src)
        res = dt.distributed_vector(n)
    with step("inclusive_scan"):
        dt.inclusive_scan(s, res)
    with step("host copy"):
        out["scan"] = res.to_array().cpu()
    with step("exclusive_scan"):
        dt.exclusive_scan(s, res)
    with step("host copy"):
        out["exscan"] = res.to_array().cpu()
    del s
    with step("data"):
        small = dt.distributed_vector.from_array(src * 2.0 ** -16)
    with step("inclusive_scan_n"):
        dt.inclusive_scan_n(small, res, 2)
    with step("host copy"):
        out["scan_n"] = res.to_array().cpu()
    return src.cpu(), out


def compare_paths(got, ref, tag):
    """Kernel route vs plain route of the same main path."""
    check(f"{tag} stencil_iterate_matmul", max_err(got["matmul"],
                                                   ref["matmul"]), 1e-5)
    check(f"{tag} stencil_iterate_blocked", max_err(got["blocked"],
                                                    ref["blocked"]), 1e-5)
    d = float(ref["dot_n"])
    # K3 against its plain version, as in phase 3: 4 ulps of the result
    check(f"{tag} dot_n", abs(float(got["dot_n"]) - d), 4 * f32_ulp(d))
    for k in ("scan", "exscan", "scan_n"):
        scale = float(ref[k].abs().max())
        check(f"{tag} {k}", max_err(got[k], ref[k]), 1e-4 * scale)


def periodic_oracle(src64, steps):
    """``steps`` periodic 5-point steps of a float64 vector as one
    circular cross-correlation with the composed taps (by FFT):
    out[i] = sum_j c[j] x[i - R + j]."""
    from dr_tpu_torch.ops.stencil_matmul import composed_taps
    c = composed_taps(W5, steps)
    R = (len(c) - 1) // 2
    n = len(src64)
    kern = np.zeros(n)
    np.add.at(kern, np.arange(-R, R + 1) % n, c)
    return np.fft.irfft(np.fft.rfft(src64) * np.conj(np.fft.rfft(kern)), n)


def four_ranks(dt, n, seed, device="cuda:0"):
    """Phase 5: 4 logical ranks on one device against numpy."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    src, out = main_path(dt, n, seed, keep_inputs=True)
    s64 = src.double().cpu().numpy()
    for k, steps in (("matmul", STEPS), ("blocked", STEPS)):
        ref = periodic_oracle(s64, steps)
        check(f"4 ranks {k} vs numpy", float(np.abs(
            out[k].double().cpu().numpy() - ref).max()), 1e-4)
    cs = np.cumsum(s64)
    scale = float(np.abs(cs).max())
    # f32 prefixes drift from the exact ones by ~1e-6 of the running
    # magnitude: 1e-4 of the largest prefix; the steps (each prefix adds
    # its own element, across blocks and ranks) within 8 f32 ulps of it,
    # as for K4 alone
    check("4 ranks inclusive_scan vs numpy", float(np.abs(
        out["scan"].double().cpu().numpy() - cs).max()), 1e-4 * scale)
    check("4 ranks inclusive_scan steps", step_err(out["scan"], src, 0.0),
          8 * f32_ulp(scale))
    ecs = np.concatenate([[0.0], cs[:-1]])
    check("4 ranks exclusive_scan vs numpy", float(np.abs(
        out["exscan"].double().cpu().numpy() - ecs).max()), 1e-4 * scale)
    shifted = torch.cat([src.new_zeros(1), src[:-1]])
    check("4 ranks exclusive_scan steps",
          step_err(out["exscan"], shifted, 0.0), 8 * f32_ulp(scale))
    # inclusive_scan_n: two chained scans of src * 2^-16, against two
    # chained float64 cumsums; 1e-4 of the largest value, as above
    c2 = np.cumsum(np.cumsum(s64 * 2.0 ** -16))
    check("4 ranks inclusive_scan_n vs numpy", float(np.abs(
        out["scan_n"].double().cpu().numpy() - c2).max()),
        1e-4 * float(np.abs(c2).max()))
    # dot_n: the salted rounds in float64 (the salt, ~1e-31, vanishes
    # against y there too); four rank partials of f32 sums of positive
    # terms, each within ~1 of its exact value, and a 4-term f32 sum:
    # tolerance 4 ulps of the result
    x64 = out["x"].double().numpy()
    y64 = out["y"].double().numpy()
    d = 0.0
    for _ in range(DOT_ROUNDS):
        d = float(x64 @ (y64 + d * 1e-38))
    check("4 ranks dot_n vs numpy", abs(float(out["dot_n"]) - d),
          4 * f32_ulp(d))


def main_path_2d(dt, m, seed, times=None):
    """Phase 6: the 2-D heat path on the current runtime's one rank;
    returns the source matrix and both results, on the card."""
    import torch
    step = stepper(dt, {} if times is None else times)
    dev = dt.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    w = dt.heat_step_weights(0.25)
    out = {}
    with step("data"):
        src = torch.randn((m, m), generator=gen, device=dev)
        M = dt.dense_matrix.from_array(src)
    with step("stencil2d_iterate_blocked"):
        dt.stencil2d_iterate_blocked(M, w, STEPS2D, time_block=T2D)
    out["blocked"] = M.to_array()
    del M
    with step("data"):
        M = dt.dense_matrix.from_array(src)
    with step("stencil2d_n"):
        dt.stencil2d_n(M, w, ITERS2D, time_block=T2D)
    out["n"] = M.to_array()
    return src, out


def compare_2d(dt, src, got, ref, tag):
    """Kernel route vs plain route of the 2-D path: each within twice
    heat_tol of the other, finite and of the matrix's shape."""
    w = dt.heat_step_weights(0.25)
    scale = float(src.abs().max())
    for k, steps in (("blocked", STEPS2D), ("n", ITERS2D * T2D)):
        assert got[k].shape == src.shape, (k, got[k].shape)
        check(f"{tag} {k}", max_err(got[k], ref[k]),
              2 * heat_tol(w, steps, scale))


def heat_reference(u, w, steps):
    """``steps`` Jacobi steps of a 3x3 stencil with frozen edges in
    float64, written here independently of the port."""
    import torch
    u = u.double().clone()
    m, n = u.shape
    w = np.asarray(w, dtype=np.float64)
    for _ in range(steps):
        acc = torch.zeros_like(u[1:-1, 1:-1])
        for di in range(3):
            for dj in range(3):
                if w[di, dj]:
                    acc += float(w[di, dj]) * u[di:di + m - 2, dj:dj + n - 2]
        u[1:-1, 1:-1] = acc
    return u


def check_equal(name, got, want):
    import torch
    ok = got.shape == want.shape and bool(torch.equal(got, want))
    log(f"  {name}: bit-exact {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: not bit-exact")


def four_ranks_2d(dt, m, seed, kernels, device="cuda:0"):
    """Phase 7: the 2-D path on 4 logical ranks of one device (a 2x2
    grid) against float64 references."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    times = {}
    step = stepper(dt, times)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    w = dt.heat_step_weights(0.25)
    src = torch.randn((m, m), generator=gen, device=device)
    scale = float(src.abs().max())
    blocked_steps = 2 * T2D + T2D // 2
    ref_b = heat_reference(src, w, blocked_steps)
    ref = heat_reference(ref_b, w, STEPS4 - blocked_steps)
    cyclic = dt.block_cyclic(tile=(CYC_TILE, CYC_TILE))
    for name, part in (("block", None), ("cyclic", cyclic)):
        A = dt.dense_matrix.from_array(src, part)
        B = dt.dense_matrix.from_array(src, part)
        assert A.grid_shape == (2, 2), A.grid_shape
        with step(f"stencil2d_iterate {name}"):
            dt.stencil2d_iterate(A, B, w, STEPS4)
        check(f"4 ranks stencil2d_iterate {name} ({A.grid_tiles} tiles) "
              "vs float64", max_err(A.to_array(), ref),
              heat_tol(w, STEPS4, scale))
        del A, B
    # the blocked path on a single-tile matrix under this runtime: two
    # K5 passes of 16 and one of 8
    k5 = kernels.launches["stencil2d_blocked"]
    S = dt.dense_matrix.from_array(src, dt.block_cyclic(grid=(1, 1)))
    with step("stencil2d_iterate_blocked single tile"):
        dt.stencil2d_iterate_blocked(S, w, blocked_steps, time_block=T2D)
    check("4 ranks single-tile stencil2d_iterate_blocked vs float64",
          max_err(S.to_array(), ref_b), heat_tol(w, blocked_steps, scale))
    if kernels.launches["stencil2d_blocked"] - k5 != 3:
        raise AssertionError("single-tile blocked path did not launch K5 "
                             "three times")
    del S, ref, ref_b
    # gemm: an f32 product of length-k dots is within k * 2^-24 of
    # (|A||B|)_ij of the exact one (TF32 off)
    ga = torch.randn((m, m), generator=gen, device=device)
    gb = torch.randn((m, m), generator=gen, device=device)
    exact = torch.matmul(ga.double(), gb.double())
    mag = torch.matmul(ga.double().abs(), gb.double().abs())
    for name, part in (("block", None), ("cyclic", cyclic)):
        A = dt.dense_matrix.from_array(ga, part)
        B = dt.dense_matrix.from_array(gb, part)
        with step(f"gemm {name}"):
            C = dt.gemm(A, B)
        rel = float(((C.to_array().double() - exact).abs() / mag).max())
        check(f"4 ranks gemm {name} vs float64 (relative to |A||B|)", rel,
              m * 2.0 ** -24)
        del A, B, C
    del exact, mag
    # distributed_mdarray: the graft entry's (2P, 6, 5) cube
    cube = torch.arange(8 * 6 * 5, dtype=torch.float32,
                        device=device).reshape(8, 6, 5)
    M3 = dt.distributed_mdarray.from_array(cube)
    T3 = dt.distributed_mdarray((5, 8, 6))
    dt.transpose(T3, M3, axes=(2, 0, 1))
    check_equal("4 ranks mdarray transpose(2, 0, 1)", T3.to_array(),
                cube.permute(2, 0, 1))
    check_equal("4 ranks mdarray submdspan",
                M3.submdspan(slice(1, 8), slice(2, 5), slice(0, 3))
                .to_array(), cube[1:, 2:5, 0:3])
    log("  4-rank 2-D seconds by step: " + json.dumps(times))


def encoded_host(dt_sort, t, distinct_zeros=True):
    """The sort's int32 order keys of a card tensor, on the host."""
    return dt_sort._encode(t, distinct_zeros=distinct_zeros)[0].cpu().numpy()


def check_true(name, ok):
    log(f"  {name}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(name)


def check_stable(name, src, keys, pay, descending=False):
    """``pay`` is the stable sort permutation of ``src`` and ``keys`` the
    keys in that order: a permutation, ``src[pay]`` equal to ``keys``
    bit for bit (zeros as one key), and rising (falling when descending)
    inside every run of equal keys.  With the keys checked against numpy
    this fixes the result."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    p = pay.long()
    perm = torch.equal(torch.sort(p).values,
                       torch.arange(p.numel(), device=p.device))
    k = dt_sort._encode(keys)[0]
    same = torch.equal(dt_sort._encode(src[p])[0], k)
    tie = k[1:] == k[:-1]
    step = p[1:] - p[:-1]
    order = bool(((step < 0) if descending else (step > 0))[tie].all())
    check_true(f"{name}: permutation, keys, stable ties", perm and same
               and order)


def sort_path(dt, n, seed, times):
    """Phase 9: the sort path on the current runtime's one rank: sort
    (ascending, then descending) with is_sorted after each, sort_by_key
    with an int32 iota payload, argsort, and reduce min / max / int32
    sum.  Returns the results on the card and the source."""
    import torch
    step = stepper(dt, times)
    dev = dt.devices()[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    out = {}
    with step("data"):
        src = torch.randn(n, generator=gen, device=dev)
        v = dt.distributed_vector.from_array(src)
    with step("sort"):
        dt.sort(v)
    with step("is_sorted"):
        out["up_sorted"] = dt.is_sorted(v)
    out["asc"] = v.to_array().clone()
    with step("sort descending"):
        dt.sort(v, descending=True)
    with step("is_sorted"):
        out["down_sorted"] = dt.is_sorted(v)
    out["desc"] = v.to_array().clone()
    del v
    with step("data"):
        k = dt.distributed_vector.from_array(src)
        pay = dt.distributed_vector(n, np.int32)
        dt.iota(pay, 0)
    with step("sort_by_key"):
        dt.sort_by_key(k, pay)
    out["kv_keys"], out["kv_pay"] = k.to_array().clone(), \
        pay.to_array().clone()
    del k, pay
    with step("data"):
        a = dt.distributed_vector.from_array(src)
    with step("argsort"):
        idx = dt.argsort(a)
    out["argsort"] = idx.to_array().clone()
    with step("reduce min"):
        out["min"] = dt.reduce(a, op=min)
    with step("reduce max"):
        out["max"] = dt.reduce(a, op=max)
    with step("reduce int32 sum"):
        out["isum"] = dt.reduce(idx)
    return src, out


def check_sort_path(src, out):
    """Phase 9's results against numpy sorting the same encoding."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    n = src.numel()
    want = np.sort(encoded_host(dt_sort, src))
    check_true("sort vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, out["asc"]), want))
    check_true("sort descending vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, out["desc"]), want[::-1]))
    check_true("is_sorted after sort, not after descending",
               out["up_sorted"] and not out["down_sorted"])
    # sort_by_key gives both zeros one key (-0.0 is key -1, +0.0 key 0)
    check_true("sort_by_key keys vs numpy (bits)", np.array_equal(
        encoded_host(dt_sort, out["kv_keys"], False),
        np.where(want == -1, 0, want)))
    check_stable("sort_by_key payload", src, out["kv_keys"], out["kv_pay"])
    check_true("argsort equals the sort_by_key permutation",
               torch.equal(out["argsort"], out["kv_pay"]))
    host = src.cpu().numpy()
    for op in ("min", "max"):
        ref = np.float32(getattr(np, op)(host))
        check_true(f"reduce {op} vs numpy (bits)", np.float32(out[op])
                   .view(np.int32) == ref.view(np.int32))
    # the iota permutation's sum modulo 2^32, as an int32
    isum = (n * (n - 1) // 2 + 2 ** 31) % 2 ** 32 - 2 ** 31
    check_true("reduce int32 sum (modulo 2^32)", out["isum"] == isum)


@contextlib.contextmanager
def no_host_sync(name, device):
    """Fail if the body makes a synchronizing CUDA call: the sort keeps
    its matrices, counts and splitters on the card."""
    import torch
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    log(f"  {name}: {'no synchronizing call' if cuda else 'ran'}")


def sort_four_ranks(dt, n, seed, kernels, device="cuda:0"):
    """Phase 10: 4 logical ranks of one device, a block_distribution
    with a zero-size rank: keys-only ascending and descending, a window
    across the empty rank, key-value with the payload on an even
    distribution, and the per-phase seconds of both programs."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    dt.init(dt.get_duplicated_devices(4, [device]))
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    sizes = [n // 2, 0, n // 4, n - n // 2 - n // 4]
    src = torch.randn(n, generator=gen, device=device)
    k6 = kernels.launches["bitonic_sort"]
    want = np.sort(encoded_host(dt_sort, src))
    v = dt.distributed_vector.from_array(src, distribution=sizes)
    with no_host_sync("4 ranks sort", device):
        dt.sort(v)
    check_true("4 ranks sort vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, v.to_array()), want))
    dt.sort(v, descending=True)
    check_true("4 ranks sort descending vs numpy (bits)", np.array_equal(
        encoded_host(dt_sort, v.to_array()), want[::-1]))
    check_true("4 ranks is_sorted", not dt.is_sorted(v))
    del v
    b, e = n // 8, n - n // 8 - 5
    w = dt.distributed_vector.from_array(src, distribution=sizes)
    dt.sort(w[b:e])
    ref = encoded_host(dt_sort, src)
    ref[b:e] = np.sort(ref[b:e])
    check_true("4 ranks window sort vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, w.to_array()), ref))
    check_true("4 ranks is_sorted window", dt.is_sorted(w[b:e]))
    del w
    keys = torch.randint(0, 1000, (n,), generator=gen, device=device).float()
    kd = dt.distributed_vector.from_array(keys, distribution=sizes)
    pd = dt.distributed_vector(n, np.int32)
    dt.iota(pd, 0)
    with no_host_sync("4 ranks sort_by_key", device):
        dt.sort_by_key(kd, pd, descending=True)
    kv_want = np.sort(encoded_host(dt_sort, keys, False))[::-1]
    check_true("4 ranks sort_by_key descending keys vs numpy (bits)",
               np.array_equal(encoded_host(dt_sort, kd.to_array(), False),
                              kv_want))
    check_stable("4 ranks sort_by_key descending payload", keys,
                 kd.to_array(), pd.to_array(), descending=True)
    del kd, pd
    if kernels.launches["bitonic_sort"] != k6:
        raise AssertionError("K6 launched on blocks above its cap")
    phases = {}
    for name, names in (("keys", dt_sort.SORT_PHASES),
                        ("kv", dt_sort.SORTKV_PHASES)):
        prev = 0.0
        for ph in names:
            kd = dt.distributed_vector.from_array(src, distribution=sizes)
            pd = dt.distributed_vector(n, np.int32)
            dt.fence()
            t0 = time.perf_counter()
            if name == "keys":
                dt_sort.sort_phases_n(kd, ph, 1)
            else:
                dt_sort.sort_by_key_phases_n(kd, pd, ph, 1)
            dt.fence()
            t = time.perf_counter() - t0
            phases[f"{name} {ph}"] = t - prev
            prev = t
            del kd, pd
    log("  4-rank sort seconds by phase (prefix differences): "
        + json.dumps(phases))


K6_GEOMS = ((8, 16384), (4, 1 << 15))  # ranks x keys per rank
K6_ROUNDS = 8


def k6_path(dt, seed, device="cuda:0"):
    """Phase 11: the sort at the JAX package's K6 geometry (bench.py's
    16384 keys per rank on 8 ranks) and at the cap (2^15 on 4 ranks):
    sort, sort_by_key and sort_n(8), against numpy; returns the number
    of sorts, the K6 launches the phase must make (the ranks share one
    device, so each sort sorts their blocks in one batch)."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    want_launches = 0
    for ranks, per in K6_GEOMS:
        dt.init(dt.get_duplicated_devices(ranks, [device]))
        gen = torch.Generator(device=device).manual_seed(seed + ranks)
        n = ranks * per
        src = torch.randn(n, generator=gen, device=device)
        want = np.sort(encoded_host(dt_sort, src))
        v = dt.distributed_vector.from_array(src)
        dt.sort(v)
        check_true(f"K6 path {ranks}x{per} sort vs numpy (bits)",
                   np.array_equal(encoded_host(dt_sort, v.to_array()), want))
        keys = torch.randint(0, 50, (n,), generator=gen,
                             device=device).float()
        kd = dt.distributed_vector.from_array(keys)
        pd = dt.distributed_vector(n, np.int32)
        dt.iota(pd, 0)
        dt.sort_by_key(kd, pd)
        check_stable(f"K6 path {ranks}x{per} sort_by_key", keys,
                     kd.to_array(), pd.to_array())
        w = dt.distributed_vector.from_array(src)
        dt.sort_n(w, K6_ROUNDS)
        check_true(f"K6 path {ranks}x{per} sort_n({K6_ROUNDS}) vs numpy",
                   np.array_equal(encoded_host(dt_sort, w.to_array()), want))
        want_launches += 2 + K6_ROUNDS
    return want_launches


def composed_taps2d(w, steps):
    """The 3x3 weights composed with themselves ``steps`` times in
    float64: one cross-correlation with this kernel equals ``steps``
    unmasked steps."""
    w = np.asarray(w, dtype=np.float64)
    c = np.ones((1, 1))
    for _ in range(steps):
        out = np.zeros((c.shape[0] + 2, c.shape[1] + 2))
        for di in range(3):
            for dj in range(3):
                out[di:di + c.shape[0], dj:dj + c.shape[1]] += w[di, dj] * c
        c = out
    return c


def timings(n, gen, results):
    """Phase 6: kernel, plain and library times at the main-path shapes."""
    import torch
    import torch.nn.functional as F
    from dr_tpu_torch.ops import (reduce_pallas, scan_pallas,
                                  stencil_matmul, stencil_pallas)
    dev = torch.device("cuda", 0)
    f = 4  # bytes per f32

    row = torch.randn((1, n + 2 * MM_HALO), generator=gen, device=dev)
    taps = torch.from_numpy(stencil_matmul.composed_taps(
        W5, K_BLOCK).astype(np.float32)).to(dev).reshape(1, 1, -1)
    r = results["stencil_matmul"]
    r["ms"] = events_ms(lambda: stencil_matmul.matmul_stencil_row(
        row, n, MM_HALO, W5, K_BLOCK), 5)
    r["plain_ms"] = events_ms(lambda: stencil_matmul.plain_apply(
        row, n, MM_HALO, W5, K_BLOCK), 3)
    # one library call computing the same banded sum: conv1d (a
    # cross-correlation, so the taps as they are) over the row
    r["library_ms"] = events_ms(lambda: F.conv1d(row[None], taps), 3)
    # the TPU kernel's work: three bf16 passes over the band, at the
    # tensor-core rate
    ntaps = 2 * K_BLOCK * 2 + 1
    work = 3 * 2.0 * ntaps * n
    r["bound_ms"], r["bound_by"] = bound(2 * (n + 2 * MM_HALO) * f, work,
                                         BF16_TC_FLOP_PER_S)
    log(f"  K1 {work / r['ms'] / 1e9!r} TFLOP/s (three bf16 passes), "
        f"{r['bound_ms'] / r['ms']!r} of its bound; "
        f"{stencil_matmul.kernel_parts(W5, K_BLOCK)} bf16 parts")
    for line in ptxas_lines("stencil_matmul"):
        log(f"  K1 ptxas: {line}")
    log(f"  K1 SASS: {sass_count('stencil_matmul', 'HGMMA')} HGMMA")
    del row

    row = torch.randn((1, n + 2 * BLK_HALO), generator=gen, device=dev)
    r = results["stencil_blocked"]
    r["ms"] = events_ms(lambda: stencil_pallas.blocked_stencil_row(
        row, n, BLK_HALO, W5, T_BLOCK), 5)
    r["plain_ms"] = events_ms(lambda: stencil_pallas.plain_blocked(
        row, n, BLK_HALO, W5, T_BLOCK), 2)
    # T steps equal one cross-correlation with the 4T+1 composed taps
    taps = torch.from_numpy(stencil_matmul.composed_taps(
        W5, T_BLOCK).astype(np.float32)).to(dev).reshape(1, 1, -1)
    r["library_ms"] = events_ms(lambda: F.conv1d(row[None], taps), 3)
    r["bound_ms"], r["bound_by"] = bound(
        2 * (n + 2 * BLK_HALO) * f, float(T_BLOCK) * n * (2 * len(W5) - 1))
    # the floor of the bit-exact form: each cell-step issues its 2r+1
    # multiplies and 2r adds as one instruction each (no FMA), at 128
    # lanes a clock on each SM and the card's highest SM clock
    ghz = max_sm_ghz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor = float(T_BLOCK) * n * (2 * len(W5) - 1) / (sms * 128 * ghz * 1e6)
    log(f"  K2 bound_ms={r['bound_ms']!r} ({r['bound_by']}); issue floor "
        f"without FMA {floor!r} ms ({sms} SMs at {ghz} GHz)")
    for line in ptxas_lines("stencil_blocked"):
        log(f"  K2 ptxas: {line}")
    del row

    x = torch.rand(n, generator=gen, device=dev)
    y = torch.rand(n, generator=gen, device=dev)
    salt = torch.tensor(0.0, device=dev)
    r = results["chunked_dot"]
    r["ms"] = events_ms(lambda: reduce_pallas.chunked_dot(x, y, salt=salt),
                        10)
    r["plain_ms"] = events_ms(lambda: reduce_pallas.plain_dot(x, y, salt), 5)
    r["library_ms"] = events_ms(lambda: torch.dot(x, y), 10)
    r["bound_ms"], r["bound_by"] = bound(2 * n * f + f, 3.0 * n)
    del y

    r = results["chunked_cumsum"]
    carry = torch.tensor(0.0, device=dev)
    r["ms"] = events_ms(lambda: scan_pallas.chunked_cumsum(x, carry=carry),
                        10)
    r["plain_ms"] = events_ms(lambda: scan_pallas.plain_cumsum(x, carry), 5)
    r["library_ms"] = events_ms(lambda: torch.cumsum(x, 0), 10)
    r["bound_ms"], r["bound_by"] = bound(2 * n * f, 2.0 * n)
    del x

    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import stencil2d_pallas
    m = M2D
    w = dt.heat_step_weights(0.25)
    xp = torch.randn((m + 2 * T2D, m), generator=gen, device=dev)
    r = results["stencil2d_blocked"]
    r["ms"] = events_ms(lambda: stencil2d_pallas.blocked_stencil2d_padded(
        xp, m, w, T2D, T2D), 10)
    r["plain_ms"] = events_ms(lambda: stencil2d_pallas.plain_blocked2d(
        xp, m, w, T2D, T2D), 2)
    # one library call for the same T steps without the frozen edges:
    # conv2d (a cross-correlation) with the composed (2T+1)^2 kernel
    taps = torch.from_numpy(composed_taps2d(w, T2D).astype(np.float32)).to(
        dev)[None, None]
    r["library_ms"] = events_ms(lambda: F.conv2d(xp[None, None], taps), 3)
    nnz = int(np.count_nonzero(np.asarray(w)))
    r["bound_ms"], r["bound_by"] = bound(
        2 * (m + 2 * T2D) * m * f, float(T2D) * (2 * nnz - 1) * (m - 2) ** 2)
    del xp
    for line in ptxas_lines("stencil2d_blocked"):
        log(f"  K5 ptxas: {line}")


def max_sm_ghz():
    """The card's highest SM clock in GHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) / 1e3


def ptxas_lines(name):
    """The registers and spills ptxas reported when it built one kernel's
    source (the template instances in order)."""
    from dr_tpu_torch.ops import kernels
    so = kernels._target(kernels.CSRC / kernels.SOURCES[name])
    p = kernels.BUILD / f"{so.stem}.ptxas.txt"
    if not p.exists():
        return ["not found"]
    return [line.strip() for line in p.read_text().splitlines()
            if "registers" in line or "spill" in line]


def sass_count(name, op):
    """How many instructions of kind ``op`` one kernel's built library
    holds (``cuobjdump -sass``), or why that cannot be read."""
    from dr_tpu_torch.ops import kernels
    so = kernels._target(kernels.CSRC / kernels.SOURCES[name])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "not counted (no cuobjdump)"
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        return f"not counted (cuobjdump exit {out.returncode})"
    return sum(f" {op}." in line or f" {op} " in line
               for line in out.stdout.splitlines())


def bitonic_ops(M):
    """Operations of a bitonic network over M keys: M/2 compare-exchanges
    in each of log2(M) (log2(M) + 1) / 2 stages, 2 each (a min and a
    max)."""
    lg = int(math.log2(M))
    return 2.0 * (M // 2) * lg * (lg + 1) // 2


def sort_timings(gen, results):
    """Phase 8, K6 and K7: kernel, plain and library times.  K6 at the
    K6 path's blocks: 16384 keys (the row) and 2^15, keys-only and KV,
    and the K6 path's batch of 8 x 16384 in one launch; the library call
    is torch.sort of the same keys (of the packed int64 pairs for KV);
    each row also gives its one-SM floor, the compare-exchanges of one
    row at one SM's share of the fp32 rate (the floor of a design that
    gives each row one SM).  K7 at reduce's shape, 2^30 f32 in one
    segment (library torch.amin), and at n = nseg = 2^15 (library
    scatter_reduce)."""
    import torch
    from dr_tpu_torch.ops import segred_pallas as sr
    from dr_tpu_torch.ops import sort_pallas
    dev = torch.device("cuda", 0)
    one_sm = FP32_FLOP_PER_S / 132
    for b, M in ((1, K6_GEOMS[0][1]), (1, 1 << 15),
                 (K6_GEOMS[0][0], K6_GEOMS[0][1])):
        shape = (M,) if b == 1 else (b, M)
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int32)
        gid = torch.argsort(torch.rand(shape, generator=gen, device=dev),
                            dim=-1).to(torch.int32)
        packed = (keys.long() << 32) | (gid.long() + (1 << 31))
        floor = bitonic_ops(M) / one_sm * 1e3
        row = {
            "ms": events_ms(lambda: sort_pallas.sort_keys(keys), 50),
            "plain_ms": events_ms(lambda: sort_pallas.plain_sort_keys(keys),
                                  50),
            "library_ms": events_ms(lambda: torch.sort(keys), 50)}
        row["bound_ms"], row["bound_by"] = bound(2 * b * M * 4,
                                                 b * bitonic_ops(M))
        row["one_sm_ms"] = floor
        kv = {
            "ms": events_ms(lambda: sort_pallas.sort_kv(keys, gid), 50),
            "plain_ms": events_ms(lambda: sort_pallas.plain_sort_kv(keys,
                                                                    gid), 50),
            "library_ms": events_ms(lambda: torch.sort(packed), 50)}
        kv["bound_ms"], kv["bound_by"] = bound(4 * b * M * 4,
                                               b * bitonic_ops(M))
        kv["one_sm_ms"] = floor
        log(f"  K6 {b}x{M} keys-only {json.dumps(row)}; KV {json.dumps(kv)}")
        if (b, M) == (1, K6_GEOMS[0][1]):
            results["bitonic_sort"].update(
                {k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")})
    n = 1 << 30
    x = torch.randn(n, generator=gen, device=dev)
    r = results["segred"]
    r["ms"] = events_ms(lambda: sr.segmented(None, 1, ((x, "min"),)), 10)
    r["plain_ms"] = events_ms(lambda: sr.plain_segmented(
        None, 1, ((x, "min"),)), 3)
    r["library_ms"] = events_ms(lambda: torch.amin(x), 10)
    r["bound_ms"], r["bound_by"] = bound(4 * n + 4, float(n))
    del x
    m = 1 << 15
    ids = torch.randint(0, m, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = torch.randint(-1000, 1000, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    lids = ids.long()
    small = {
        "ms": events_ms(lambda: sr.segmented(ids, m, ((vals, "sum"),)), 50),
        "plain_ms": events_ms(lambda: sr.plain_segmented(
            ids, m, ((vals, "sum"),)), 50),
        "library_ms": events_ms(lambda: torch.zeros(
            m, dtype=torch.int32, device=dev).scatter_reduce_(
                0, lids, vals, "sum"), 50)}
    small["bound_ms"], small["bound_by"] = bound(m * 8 + m * 4, float(m))
    log(f"  K7 n=nseg=2^15 int32 sum {json.dumps(small)}")


# ------------------------------------------------------- ring attention

def k9_operands(gen, dev, BH, group, s, skv, d):
    """bf16 q/k/v from ``gen`` and the zero (m, l, acc) state."""
    import torch
    q = torch.randn((BH, s, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((BH // group, skv, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    state = (torch.full((BH, s, 1), float("-inf"), device=dev),
             torch.zeros((BH, s, 1), device=dev),
             torch.zeros((BH, s, d), device=dev))
    return q, k, v, state


def normalized(state):
    import torch
    m, l, acc = state
    return acc / torch.where(l > 0, l, 1.0)


def check_allclose(name, got, want, rtol, atol, quiet=False):
    """|got - want| <= atol + rtol |want| everywhere, both finite where
    ``want`` is; returns the max |got - want|.  ``quiet`` logs only a
    failure."""
    import torch
    assert got.shape == want.shape and got.dtype == want.dtype, name
    g, w = got.double(), want.double()
    same_inf = torch.equal(torch.isneginf(g), torch.isneginf(w))
    fin = torch.isfinite(w)
    ex = float(((g - w).abs() - (atol + rtol * w.abs()))[fin].max()) \
        if fin.any() else 0.0
    e = float((g - w).abs()[fin].max()) if fin.any() else 0.0
    ok = same_inf and bool(torch.isfinite(g[fin]).all()) and ex <= 0
    if not (ok and quiet):
        log(f"  {name}: max_abs_err={e!r} (rtol {rtol}, atol {atol}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside tolerance")
    return e


#: bf16 outputs of two orders of the same f32 math: the flash tolerance
#: (2e-3, a bf16 rounding of p may flip between the orders) plus one
#: bf16 ulp of the value (2^-7 relative) for the final rounding
BF16_OUT = dict(rtol=2e-3 + 2.0 ** -7, atol=2e-3)


def k9_close(tag, got, ref):
    """K9's state against its plain version's: m within 1e-6 (one max of
    d-term logits summed in two orders; the difference grows with d, so
    d / 256 times that above d = 256), l within 1e-5 relative (as much
    wider above d = 256), acc / l within rtol = atol = 2e-3 (a bf16
    rounding of p may flip between the orders); returns the acc / l
    error."""
    wide = max(1.0, got[2].shape[-1] / 256)
    check_allclose(f"{tag} m", got[0], ref[0], 1e-6 * wide, 1e-6 * wide,
                   quiet=True)
    check_allclose(f"{tag} l", got[1], ref[1], 1e-5 * wide, 0.0, quiet=True)
    return check_allclose(f"{tag} acc / l", normalized(got), normalized(ref),
                          2e-3, 2e-3, quiet=True)


#: phase 3's K9 shapes (s, d, group): d = 128 and 256 take the wgmma
#: kernel (s = 200 is not a multiple of its 128-row q tile), d = 768 the
#: mma.sync kernel, which stages Q and K in 6 chunks
K9_CHECKS = ((1024, 128, 4), (200, 128, 4), (384, 256, 1), (384, 256, 2),
             (256, 768, 2))


def k9_checks(gen, results, device="cuda:0"):
    """Phase 3, K9 against its plain version (:func:`k9_close`): causal
    and not, GQA, d = 128, 256 and 768, offsets (0, 0), (2s, s), (s, 2s)
    (wholly future when causal) and (s + 37, s) (the causal diagonal
    inside a tile), and a chained second update."""
    import torch
    from dr_tpu_torch.ops import flash_attention as fa
    worst = 0.0
    for s, d, group in K9_CHECKS:
        for causal in (True, False):
            for q_off, k_off in ((0, 0), (2 * s, s), (s, 2 * s),
                                 (s + 37, s)):
                tag = (f"K9 s={s} d={d} group={group} causal={causal} "
                       f"offsets=({q_off}, {k_off})")
                # the K/V block's length is a multiple of 128 (the rule)
                skv = -(-s // 128) * 128
                q, k, v, st = k9_operands(gen, device, 8, group, s, skv, d)
                got = fa.flash_update(q, k, v, *st, q_off, k_off,
                                      causal=causal)
                ref = fa.plain_flash_update(q, k, v, *st, q_off, k_off,
                                            causal=causal)
                if causal and (q_off, k_off) == (s, 2 * s):
                    check_true(f"{tag}: the state stays zero",
                               bool(torch.isneginf(got[0]).all())
                               and not bool(got[1].any())
                               and not bool(got[2].any()))
                k2, v2 = k.flip(1).contiguous(), v.flip(1).contiguous()
                got2 = fa.flash_update(q, k2, v2, *got, q_off, 0,
                                       causal=causal)
                ref2 = fa.plain_flash_update(q, k2, v2, *ref, q_off, 0,
                                             causal=causal)
                for step, g, r in ((1, got, ref), (2, got2, ref2)):
                    worst = max(worst, k9_close(f"{tag} update {step}", g, r))
    log(f"  K9 flash_update: {8 * len(K9_CHECKS)} chained pairs of updates "
        f"within tolerance (s, d, group) {K9_CHECKS}, acc / l max_abs_err "
        f"{worst!r}")
    results["flash_update"]["max_abs_err"] = worst


def flash_timings(gen, results):
    """Phase 8, K9: one update from zero state at BH = 32, s = skv =
    32768, d = 128, group 4, causal, offsets 0 (phase 12's call); the
    library call is F.scaled_dot_product_attention on the same tensors
    (GQA, causal), timed only.  At this shape the kernel's state, causal
    and not, is held against its plain version's (:func:`k9_close`)."""
    import torch
    import torch.nn.functional as F
    from dr_tpu_torch.ops import flash_attention as fa
    BH, group, s, d = RA_H, RA_H // RA_HKV, RA_S, RA_D
    q, k, v, st = k9_operands(gen, "cuda:0", BH, group, s, s, d)
    r = results["flash_update"]
    errs, lerrs = {}, {}
    for causal in (True, False):
        got = fa.flash_update(q, k, v, *st, 0, 0, causal=causal)
        ref = fa.plain_flash_update(q, k, v, *st, 0, 0, causal=causal)
        errs[causal] = k9_close(f"K9 BH={BH} s=skv={s} causal={causal}",
                                got, ref)
        lerrs[causal] = l_rel_err(got, ref)
        del got, ref
    log(f"  K9 at the timed shape vs plain (m 1e-6, l 1e-5 relative, acc / l "
        f"2e-3): acc / l max_abs_err causal {errs[True]!r}, non-causal "
        f"{errs[False]!r}; l max relative error causal {lerrs[True]!r}, "
        f"non-causal {lerrs[False]!r}")
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), *errs.values())
    r["ms"] = events_ms(lambda: fa.flash_update(q, k, v, *st, 0, 0,
                                                causal=True), 5)
    r["plain_ms"] = events_ms(lambda: fa.plain_flash_update(
        q, k, v, *st, 0, 0, causal=True), 1)
    q4, k4, v4 = (x.view(1, -1, s, d) for x in (q, k, v))
    r["library_ms"] = events_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 5)
    ideal = 2.0 * BH * s * s * d          # the causal triangle, two products
    moved = (BH * s * d * 2 + 2 * (BH // group) * s * d * 2   # q, k, v
             + 2 * (2 * BH * s * 4 + BH * s * d * 4))          # state in, out
    r["bound_ms"], r["bound_by"] = bound(moved, ideal, BF16_TC_FLOP_PER_S)
    done = BH * fa.causal_computed_flops(s, s, d, fa.BLOCK_Q, fa.BLOCK_K)
    nc = events_ms(lambda: fa.flash_update(q, k, v, *st, 0, 0,
                                           causal=False), 3)
    log(f"  K9 causal {r['ms']!r} ms: {ideal / r['ms'] / 1e9!r} effective "
        f"TFLOP/s, {done / r['ms'] / 1e9!r} TFLOP/s of the tiles it runs; "
        f"non-causal {nc!r} ms, {2 * ideal / nc / 1e9!r} TFLOP/s; "
        f"SDPA {r['library_ms']!r} ms")
    del q, k, v, st, q4, k4, v4
    flash_timings_d256(gen)


def l_rel_err(got, ref):
    """max |l - l_ref| / l_ref over the rows that attended."""
    lg, lr = got[1].double(), ref[1].double()
    pos = lr > 0
    return float(((lg - lr).abs()[pos] / lr[pos]).max())


def flash_timings_d256(gen):
    """Phase 8, K9 at d = 256: BH = 32, s = skv = 16384, group 4, zero
    state.  The non-causal update (every row attends 16384 keys) is held
    against its plain version (:func:`k9_close`); the causal one is timed
    beside SDPA on the same tensors, logged on its own line.  (Causal at
    this size, a row attending a few keys can show one bf16 flip of p
    above acc / l's 2e-3, the mma.sync design too; phase 3 holds the causal
    d = 256 path at s = 384.)"""
    import torch.nn.functional as F
    from dr_tpu_torch.ops import flash_attention as fa
    BH, group, s, d = RA_H, RA_H // RA_HKV, RA_S // 2, 2 * RA_D
    q, k, v, st = k9_operands(gen, "cuda:0", BH, group, s, s, d)
    got = fa.flash_update(q, k, v, *st, 0, 0, causal=False)
    ref = fa.plain_flash_update(q, k, v, *st, 0, 0, causal=False)
    err = k9_close(f"K9 d={d} BH={BH} s=skv={s} causal=False", got, ref)
    lerr = l_rel_err(got, ref)
    del got, ref
    ms = events_ms(lambda: fa.flash_update(q, k, v, *st, 0, 0,
                                           causal=True), 5)
    nc = events_ms(lambda: fa.flash_update(q, k, v, *st, 0, 0,
                                           causal=False), 3)
    q4, k4, v4 = (x.view(1, -1, s, d) for x in (q, k, v))
    sdpa = events_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 5)
    ideal = 2.0 * BH * s * s * d
    moved = (BH * s * d * 2 + 2 * (BH // group) * s * d * 2
             + 2 * (2 * BH * s * 4 + BH * s * d * 4))
    bms, by = bound(moved, ideal, BF16_TC_FLOP_PER_S)
    log(f"  K9 d={d} BH={BH} s=skv={s} group={group}: causal {ms!r} ms, "
        f"{ideal / ms / 1e9!r} effective TFLOP/s; non-causal {nc!r} ms; "
        f"SDPA causal {sdpa!r} ms; bound {bms!r} ms ({by}); non-causal "
        f"vs plain: acc / l max_abs_err {err!r}, l max relative error "
        f"{lerr!r}")


def ra_inputs(seed, S, h, hkv, d, device, dtype):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((1, S, h, d), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((1, S, hkv, d), generator=gen, device=device)
            .to(dtype) for _ in range(2))
    return q, k, v


def dense_rows(q, k, v, rows, causal):
    """float64 attention of the chosen query rows of every head (rows:
    (h, R) sequence positions), written here independently of the port;
    returns (h, R, d)."""
    import torch
    _, S, h, d = q.shape
    group = h // k.shape[2]
    outs = []
    for hh in range(h):
        qr = q[0, rows[hh], hh].double()                   # (R, d)
        kh = k[0, :, hh // group].double()
        vh = v[0, :, hh // group].double()
        logits = qr @ kh.T / math.sqrt(d)
        if causal:
            pos = torch.arange(S, device=q.device)
            logits = logits.masked_fill(pos[None, :] > rows[hh][:, None],
                                        float("-inf"))
        outs.append(torch.softmax(logits, -1) @ vh)
    return torch.stack(outs)


def check_oracle_rows(name, out, q, k, v, rows, causal, rtol, atol):
    """``out`` at the chosen rows against :func:`dense_rows`."""
    import torch
    want = dense_rows(q, k, v, rows, causal)
    got = torch.stack([out[0, rows[hh], hh].double()
                       for hh in range(out.shape[2])])
    check_allclose(f"{name} vs float64", got, want, rtol, atol)


def ring_one_rank(dt, kernels, seed, results, S=RA_S, device="cuda:0"):
    """Phase 12: ring attention on one rank, causal then non-causal;
    returns the inputs and the causal output for phase 13."""
    import torch
    cuda = torch.device(device).type == "cuda"
    dt.init([device])
    q, k, v = ra_inputs(seed + 12, S, RA_H, RA_HKV, RA_D, device,
                        torch.bfloat16)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = {c: dt.ring_attention(q, k, v, causal=c) for c in (True, False)}
    dt.fence()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    log(f"  ring attention 1 rank, S={S}: both calls {wall:.3f} s, "
        f"launches {counts}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        results["flash_update"]["launches"] = counts["flash_update"]
        if counts["flash_update"] != 2:
            raise AssertionError(f"K9 launched {counts['flash_update']} "
                                 "times for two one-rank calls, expected 2")
        log(f"  peak device memory (ring attention, 1 rank): {peak} bytes "
            f"({peak / 2 ** 30:.2f} GiB; {live} live at the start)")
        for c in (True, False):
            ms = events_ms(lambda: dt.ring_attention(q, k, v, causal=c), 3)
            flops = 2.0 * S * S * RA_H * RA_D * (1 if c else 2)
            log(f"  ring attention 1 rank causal={c}: {ms!r} ms per call, "
                f"{flops / ms / 1e9!r} effective TFLOP/s")
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    rows = torch.randint(0, S, (RA_H, ORACLE_ROWS), generator=gen,
                         device=device)
    worst = 0.0
    for c in (True, False):
        assert out[c].shape == q.shape and out[c].dtype == torch.bfloat16
        with plain_versions(kernels):
            ref = dt.ring_attention(q, k, v, causal=c)
        worst = max(worst, check_allclose(
            f"ring attention 1 rank causal={c} vs plain", out[c], ref,
            **BF16_OUT))
        del ref
        # the flash math against float64 of the bf16 inputs: the
        # reference's bound (tests/test_ring_attention.py:104)
        check_oracle_rows(f"ring attention 1 rank causal={c}", out[c], q, k,
                          v, rows, c, 5e-2, 5e-3)
    if cuda:
        results["flash_update"]["max_abs_err"] = max(
            results["flash_update"].get("max_abs_err", 0.0), worst)
    return (q, k, v), out[True], peak


def ring_four_ranks(dt, kernels, seed, qkv, one_rank, device="cuda:0",
                    f32=RA_F32, ran=(RAN_S, RAN_H, RAN_ITERS)):
    """Phase 13: 4 ranks of one device: the causal call of phase 12
    (16 K9 launches, serial == pipelined), the f32 blockwise route
    against float64, ring_attention_n's rate."""
    import torch
    cuda = torch.device(device).type == "cuda"
    P = RA4_P
    dt.init(dt.get_duplicated_devices(P, [device]))
    q, k, v = qkv
    kernels.reset_counts()
    got = dt.ring_attention(q, k, v, causal=True)
    dt.fence()
    n = kernels.launches["flash_update"]
    log(f"  ring attention {P} ranks S={q.shape[1]}: K9 launches {n}")
    if cuda and n != P * P:
        raise AssertionError(f"K9 launched {n} times on {P} ranks, "
                             f"expected {P * P}")
    check_allclose(f"ring attention {P} ranks vs 1 rank", got, one_rank,
                   **BF16_OUT)
    serial = dt.ring_attention(q, k, v, causal=True, schedule="serial")
    check_equal(f"ring attention {P} ranks serial vs pipelined", serial, got)
    if cuda:
        ms = events_ms(lambda: dt.ring_attention(q, k, v, causal=True), 3)
        flops = 2.0 * q.shape[1] ** 2 * q.shape[2] * q.shape[3]
        log(f"  ring attention {P} ranks causal: {ms!r} ms per call, "
            f"{flops / ms / 1e9!r} effective TFLOP/s")
    del got, serial
    # the f32 blockwise route (TF32 off): the reference's dense bound
    S, h, hkv = f32
    fq, fk, fv = ra_inputs(seed + 14, S, h, hkv, RA_D, device, torch.float32)
    rows = torch.arange(S, device=device).expand(h, S)
    for causal in (True, False):
        full = dt.ring_attention(fq, fk, fv, causal=causal)
        chunked = dt.ring_attention(fq, fk, fv, causal=causal, q_chunk=256)
        for tag, o in (("", full), (" q_chunk=256", chunked)):
            check_oracle_rows(f"f32 ring {P} ranks S={S} h={h} hkv={hkv} "
                              f"causal={causal}{tag}", o, fq, fk, fv, rows,
                              causal, 2e-3, 2e-3)
        # the reference's chunked-vs-unchunked bound
        check_allclose(f"f32 ring causal={causal} q_chunk vs unchunked",
                       chunked, full, 2e-4, 2e-5)
    del fq, fk, fv, full, chunked
    # ring_attention_n at bench.py's shape: the rate from the difference
    # of two chain lengths (K9 launches iters * P * P)
    S, h, iters = ran
    nq, nk, nv = ra_inputs(seed + 15, S, h, h, RA_D, device, torch.bfloat16)
    secs = {}
    for it in iters:
        dt.fence()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = dt.ring_attention_n(nq, nk, nv, it, causal=True)
        dt.fence()
        secs[it] = time.perf_counter() - t0
        n = kernels.launches["flash_update"]
        if cuda and n != it * P * P:
            raise AssertionError(f"ring_attention_n({it}) launched K9 {n} "
                                 f"times, expected {it * P * P}")
        check_true(f"ring_attention_n({it}) finite, shape {tuple(out.shape)}",
                   bool(torch.isfinite(out.float()).all())
                   and out.shape == nq.shape)
    a, b = iters
    per = (secs[b] - secs[a]) / (b - a)
    flops = 2.0 * S * S * h * RA_D
    log(f"  ring_attention_n {P} ranks S={S} h={h} causal: seconds "
        f"{json.dumps(secs)}, {per * 1e3!r} ms per iteration, "
        f"{flops / per / 1e12!r} TFLOP/s (host clock)")


# ------------------------------------------------------------- relational

def k8_checks(n, gen, results, device="cuda:0"):
    """Phase 3, K8: bit for bit against its plain version (scatter_add_):
    n random ids over 1024 bins with 0/1 counts, then 2^15 bins with
    out-of-range ids on both sides, then n ids in one bin."""
    import torch
    from dr_tpu_torch.ops import hist_pallas
    dev = torch.device(device)
    worst = [0.0]
    for bins, lo, hi in ((K8_BINS, 0, K8_BINS), (1 << 15, -3, (1 << 15) + 3),
                         (1, 0, 1)):
        ids = torch.randint(lo, hi, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        cnt = torch.randint(0, 2, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        check_bits(f"K8 bins={bins} n={n}", hist_pallas.bincount(ids, cnt, bins),
                   hist_pallas.plain_bincount(ids, cnt, bins), worst)
        del ids, cnt
    log(f"  K8 hist: bit-exact ok at 1024, 2^15 and 1 bins, n={n}")
    results["hist"]["max_abs_err"] = worst[0]


def hist_timings(gen, results):
    """Phase 8, K8: 2^30 random int32 ids over 1024 bins, counts all
    one (so torch.bincount, the library call, computes the same
    function): kernel, plain and library times; the bound reads the ids
    and counts once and writes the bins."""
    import torch
    from dr_tpu_torch.ops import hist_pallas
    dev = torch.device("cuda", 0)
    n, bins = 1 << 30, K8_BINS
    ids = torch.randint(0, bins, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    check_true("K8 equals torch.bincount", torch.equal(
        hist_pallas.bincount(ids, ones, bins),
        torch.bincount(ids, minlength=bins).to(torch.int32)))
    r = results["hist"]
    r["ms"] = events_ms(lambda: hist_pallas.bincount(ids, ones, bins), 10)
    r["plain_ms"] = events_ms(lambda: hist_pallas.plain_bincount(
        ids, ones, bins), 3)
    r["library_ms"] = events_ms(lambda: torch.bincount(ids, minlength=bins),
                                10)
    r["bound_ms"], r["bound_by"] = bound(8 * n + 4 * bins, float(n))
    # few bins: 16 addresses for every warp's shared atomics (phase 14's
    # 16-bin histogram of the joined values)
    few, m = ids[:1 << 26] % 16, 1 << 26
    row = {"ms": events_ms(lambda: hist_pallas.bincount(few, ones[:m], 16),
                           10),
           "library_ms": events_ms(lambda: torch.bincount(few, minlength=16),
                                   10),
           "bound_ms": bound(8 * m + 64, float(m))[0]}
    log(f"  K8 n=2^26 bins=16: {json.dumps(row)}")
    del few
    log(f"  K8 n=2^30 bins={bins}: {json.dumps({k: r[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')})}")


def relational_data(n_fact, ncard, seed, dev, shift=0):
    """The bench's pipeline data (bench.py:910-931) on the card: f32 fact
    keys over ``ncard`` keys (fan-in n_fact / ncard), N(0,1) fact values,
    a permuted one-row-per-key dimension table (keys ``shift`` up)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    fk = torch.randint(0, ncard, (n_fact,), generator=gen,
                       device=dev).float()
    fv = torch.randn(n_fact, generator=gen, device=dev)
    dk = (torch.randperm(ncard, generator=gen, device=dev) + shift).float()
    dv = torch.randn(ncard, generator=gen, device=dev)
    return fk, fv, dk, dv


def relational_path(dt, data, times):
    """join -> groupby sum over the joined rows -> top_k 8 of the groups,
    then a 16-bin histogram of the joined values over [-3, 3]
    (bench.py:933-961, 1012-1014) on the current runtime; returns the
    counts and the outputs' values."""
    return relational_values(relational_run(dt, data, times))


def relational_values(out):
    """:func:`relational_run`'s counts and its outputs' values (gathered
    on every process)."""
    m, ng = out["m"], out["ng"]
    return {"m": m, "ng": ng,
            **{k: out[k].to_array()[:m] for k in ("jk", "jl", "jr")},
            **{k: out[k].to_array()[:ng] for k in ("gk", "gv")},
            **{k: out[k].to_array() for k in ("tv", "ti", "hb")}}


def relational_run(dt, data, times):
    """:func:`relational_path`'s calls; returns the counts and the
    output containers (nothing gathered)."""
    step = stepper(dt, times)
    fk, fv, dk, dv = data
    n_fact = fk.numel()
    with step("data"):
        F, FV, D, DV = (dt.distributed_vector.from_array(a) for a in data)
        cap = 2 * n_fact  # dim keys are unique: <= 1 match per fact row
        jk, jl, jr, gk, gv = (dt.distributed_vector(cap) for _ in range(5))
        tv = dt.distributed_vector(8)
        ti = dt.distributed_vector(8, np.int32)
        hb = dt.distributed_vector(16, np.int32)
    with step("join"):
        m = dt.join(F, FV, D, DV, jk, jl, jr)
    with step("groupby"):
        ng = dt.groupby_aggregate(jk[0:m], jl[0:m], gk, gv, agg="sum")
    with step("top_k"):
        dt.top_k(gv[0:ng], tv, ti)
    with step("histogram"):
        dt.histogram(jl[0:m], hb, -3.0, 3.0)
    return {"m": m, "ng": ng, "jk": jk, "jl": jl, "jr": jr, "gk": gk,
            "gv": gv, "tv": tv, "ti": ti, "hb": hb}


def hist_oracle(x, bins, lo, hi):
    """numpy's bucket rule in f32 torch ops (right edge in the last
    bucket, out-of-range dropped), counted by torch.bincount.  The edges
    are f32 tensors on the card: divided by a Python scalar, torch's
    CUDA division multiplies by the reciprocal, which rounds otherwise."""
    import torch
    lo, hi = (torch.tensor(v, device=x.device) for v in (lo, hi))
    inr = (x >= lo) & (x <= hi)
    b = torch.floor((x[inr] - lo) * bins / (hi - lo)).long().clamp(
        max=bins - 1)
    return torch.bincount(b, minlength=bins).to(torch.int32)


def join_oracle(data, fill=None):
    """Rows of join(fact, dim) ordered by (key, source, position), built
    from torch ops alone: every fact row (its dimension value, or
    ``fill`` where the key has none), and under ``fill`` (an outer join)
    the unmatched dimension rows after them in key order."""
    import torch
    fk, fv, dk, dv = data
    top = int(max(fk.max(), dk.max())) + 1
    dv_by = torch.zeros(top, device=fk.device)
    has = torch.zeros(top, dtype=torch.bool, device=fk.device)
    dv_by[dk.long()] = dv
    has[dk.long()] = True
    if fill is None:
        keys, lv, rv = fk, fv, dv_by[fk.long()]
    else:
        present = torch.zeros(top, dtype=torch.bool, device=fk.device)
        present[fk.long()] = True
        ru = ~present[dk.long()]
        keys = torch.cat([fk, dk[ru]])
        lv = torch.cat([fv, torch.full_like(dv[ru], fill)])
        rv = torch.cat([torch.where(has[fk.long()], dv_by[fk.long()], fill),
                        dv[ru]])
    order = torch.sort(keys, stable=True).indices
    return keys[order], lv[order], rv[order]


def check_relational(tag, data, out):
    """The pipeline's results against oracles independent of the port:
    joined rows bit for bit, groups and counts bit for bit, each group's
    f32 sum within the recursive-summation bound (count * 2^-24 * the
    sum of |values|) of its float64 sum, top_k's indices equal to a
    stable descending sort of the groups' sums (and to the float64
    sums' top 8), the histogram bit for bit."""
    import torch
    fk, fv, dk, dv = data
    check_true(f"{tag} join count", out["m"] == fk.numel())
    for name, got, want in zip(("keys", "left", "right"),
                               (out["jk"], out["jl"], out["jr"]),
                               join_oracle(data)):
        check_true(f"{tag} join {name} (bits)", torch.equal(
            got.view(torch.int32), want.view(torch.int32)))
    uk, inv, cnt = torch.unique(fk, return_inverse=True, return_counts=True)
    check_true(f"{tag} groupby count", out["ng"] == uk.numel())
    check_true(f"{tag} groupby keys (bits)", torch.equal(out["gk"], uk))
    s64 = torch.zeros(uk.numel(), dtype=torch.float64,
                      device=fk.device).index_add_(0, inv, fv.double())
    a64 = torch.zeros_like(s64).index_add_(0, inv, fv.double().abs())
    err = (out["gv"].double() - s64).abs()
    tol = cnt.double() * 2.0 ** -24 * a64 + 1e-30
    check_true(f"{tag} groupby sums within count * 2^-24 * sum|v| "
               f"(max err {float(err.max())!r})", bool((err <= tol).all()))
    idx = torch.sort(out["gv"], descending=True, stable=True).indices[:8]
    check_true(f"{tag} top_k indices (bits)", torch.equal(
        out["ti"], idx.to(torch.int32)))
    check_true(f"{tag} top_k values (bits)",
               torch.equal(out["tv"], out["gv"][idx]))
    check_true(f"{tag} top_k vs float64 sums' top 8", torch.equal(
        torch.sort(s64, descending=True, stable=True).indices[:8], idx))
    check_true(f"{tag} histogram (bits)",
               torch.equal(out["hb"], hist_oracle(fv, 16, -3.0, 3.0)))


def relational_geometry(dt, ranks, seed, kernels, device="cuda:0"):
    """The bench's kernel geometry (bench.py:1029-1051): 8192 int32 keys
    in [0, 512) a rank with int32 values, groupby sum (K6 sorts the
    ranks' blocks in one batch, K7 reduces each rank's once) and a
    256-bin histogram over [-4, 4] (K8 once a rank), against numpy.  A
    CPU rehearsal launches nothing."""
    import torch
    dt.init(dt.get_duplicated_devices(ranks, [device]))
    want = ranks if torch.device(device).type == "cuda" else 0
    rng = np.random.default_rng(seed)
    nk = 8192 * ranks
    keys = rng.integers(0, 512, nk).astype(np.int32)
    vals = rng.integers(0, 99, nk).astype(np.int32)
    hv = rng.standard_normal(nk).astype(np.float32)
    gk, gv, hvv = (dt.distributed_vector.from_array(a)
                   for a in (keys, vals, hv))
    ok = dt.distributed_vector(1024, np.int32)
    ov = dt.distributed_vector(1024, np.int32)
    hb = dt.distributed_vector(256, np.int32)
    dt.fence()
    before = dict(kernels.launches)
    ng = dt.groupby_aggregate(gk, gv, ok, ov, agg="sum")
    dt.histogram(hvv, hb, -4.0, 4.0)
    dt.fence()
    got = {k: kernels.launches[k] - before[k] for k in before}
    log(f"  kernel geometry {ranks} x 8192: launches {got}")
    wants = {"segred": want, "hist": want, "bitonic_sort": min(want, 1)}
    for k, w in wants.items():
        if got[k] != w:
            raise AssertionError(f"{k} launched {got[k]} times at the "
                                 f"kernel geometry, expected {w}")
    uk, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=vals).astype(np.int32)
    check_true(f"geometry {ranks} ranks groupby vs numpy", ng == len(uk)
               and np.array_equal(dt.to_numpy(ok)[:ng], uk)
               and np.array_equal(dt.to_numpy(ov)[:ng], sums))
    x = hv[(hv >= -4.0) & (hv <= 4.0)]
    b = np.minimum(np.floor((x - np.float32(-4.0)) * np.float32(256)
                            / np.float32(8.0)).astype(np.int64), 255)
    check_true(f"geometry {ranks} ranks histogram vs numpy",
               np.array_equal(dt.to_numpy(hb), np.bincount(b, minlength=256)))


def relational_one_rank(dt, kernels, seed, results, device="cuda:0",
                        sizes=(REL_FACT_LOG2, REL_CARD_LOG2, 30)):
    """Phase 14: the pipeline at n_fact = 2^26 over 2^22 keys (timed on
    its second run), a 1024-bin
    histogram of 2^30 f32 normals over [-4, 4], and the kernel geometry,
    on one rank; returns the peak device memory.  ``sizes`` (the log2 of
    n_fact, of ncard and of the histogram's length) and ``device="cpu"``
    rehearse it on the CPU."""
    import torch
    cuda = torch.device(device).type == "cuda"
    dt.init([device])
    n_fact, ncard = 1 << sizes[0], 1 << sizes[1]
    data = relational_data(n_fact, ncard, seed + 14, device)
    # one warm run, as bench.py's: the first launch of each of torch's
    # kernels loads its module
    relational_path(dt, data, {})
    release(torch)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    times = {}
    t0 = time.perf_counter()
    out = relational_path(dt, data, times)
    step = stepper(dt, times)
    with step("data"):
        x = torch.randn(1 << sizes[2], generator=torch.Generator(
            device=device).manual_seed(seed + 15), device=device)
        hx = dt.distributed_vector.from_array(x)
        hb = dt.distributed_vector(K8_BINS, np.int32)
    with step("histogram 2^30"):
        dt.histogram(hx, hb, -4.0, 4.0)
    counts = dict(kernels.launches)
    log(f"  relational path {time.perf_counter() - t0:.2f} s, launches "
        f"{counts}")
    log("  relational path seconds by step: " + json.dumps(times))
    stages = times["join"] + times["groupby"] + times["top_k"]
    log(f"  pipeline {stages * 1e3!r} ms for {n_fact} fact rows: "
        f"{n_fact / stages!r} rows/s; joined {out['m']}, groups {out['ng']}")
    if counts["segred"] != 0 or counts["hist"] != 2 * cuda:
        raise AssertionError(
            f"relational path launched K7 {counts['segred']} times "
            f"(expected 0: 2^26 scratch keys a rank are above its cap) "
            f"and K8 {counts['hist']} (expected 2, one a histogram)")
    check_relational("1 rank", data, out)
    check_true(f"histogram 2^{sizes[2]} (bits)", torch.equal(
        hb.to_array(), hist_oracle(x, K8_BINS, -4.0, 4.0)))
    del out, data, x, hx, hb
    release(torch)
    relational_geometry(dt, 1, seed, kernels, device)
    results["hist"]["launches"] = kernels.launches["hist"]
    return torch.cuda.max_memory_allocated() if cuda else 0


@contextlib.contextmanager
def broadcast_max(value):
    saved = os.environ.get("DR_GPU_JOIN_BROADCAST_MAX")
    os.environ["DR_GPU_JOIN_BROADCAST_MAX"] = str(value)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["DR_GPU_JOIN_BROADCAST_MAX"]
        else:
            os.environ["DR_GPU_JOIN_BROADCAST_MAX"] = saved


def join_both_routes(dt, data, how, fill, tag):
    """One join on the default route (partition: more than 2^18 rows on
    4 ranks) and on the forced broadcast route: equal bit for bit;
    returns the rows and the two routes."""
    import torch
    from dr_tpu_torch.algorithms import relational as rel
    res = []
    for forced in (False, True):
        F, FV, D, DV = (dt.distributed_vector.from_array(a) for a in data)
        cap = 2 * (data[0].numel() + data[2].numel())
        outs = [dt.distributed_vector(cap) for _ in range(3)]
        with contextlib.ExitStack() as st:
            if forced:
                st.enter_context(broadcast_max(1 << 30))
            dt.fence()
            t0 = time.perf_counter()
            m = dt.join(F, FV, D, DV, *outs, how=how, fill=fill)
            dt.fence()
            secs = time.perf_counter() - t0
        route = rel.last_join_route()
        log(f"  {tag} {how} join {route['impl']}: {secs * 1e3!r} ms, "
            f"route {json.dumps(route)}")
        res.append((m, [o.to_array()[:m].view(torch.int32) for o in outs],
                    route))
    (m0, rows0, r0), (m1, rows1, r1) = res
    if r0["impl"] != "partition" or r1["impl"] != "broadcast":
        raise AssertionError(f"{tag}: routes {r0['impl']}, {r1['impl']}")
    check_true(f"{tag} {how}: partition gathers fewer rows a device than "
               "broadcast", r0["gathered_rows_per_device"]
               < r1["gathered_rows_per_device"])
    check_true(f"{tag} {how}: partition equals broadcast (bits)", m0 == m1
               and all(a.equal(b) for a, b in zip(rows0, rows1)))
    return m0, rows0


def relational_four_ranks(dt, kernels, seed, device="cuda:0",
                          fact_log2=REL4_FACT_LOG2):
    """Phase 15: 4 ranks of one card at n_fact = 2^24 over 2^20 keys: the
    pipeline (partition join), the join on both routes, an outer join
    with keys missing on both sides on both routes, and the kernel
    geometry."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    n_fact, ncard = 1 << fact_log2, 1 << (fact_log2 - 4)
    data = relational_data(n_fact, ncard, seed + 16, device)
    times = {}
    out = relational_path(dt, data, times)
    log("  4-rank relational path seconds by step: " + json.dumps(times))
    check_relational("4 ranks", data, out)
    del out
    join_both_routes(dt, data, "inner", 0, "4 ranks")
    # dimension keys shifted up by ncard / 2: fact keys below it and
    # dimension keys above the fact range have no partner
    odata = relational_data(n_fact, ncard, seed + 17, device,
                            shift=ncard // 2)
    m, rows = join_both_routes(dt, odata, "outer", -1.0, "4 ranks")
    want = join_oracle(odata, fill=-1.0)
    check_true("4 ranks outer join count", m == want[0].numel())
    for name, got, w in zip(("keys", "left", "right"), rows, want):
        check_true(f"4 ranks outer join {name} vs oracle (bits)",
                   torch.equal(got, w.view(torch.int32)))
    del data, odata, rows, want
    release(torch)
    relational_geometry(dt, 4, seed, kernels, device)


# ---------------------------------------------------- entry and dryrun

def entry_phase(dt, kernels, device="cuda:0"):
    """Phase 16: ``entry()``'s step and masked sum on the card against the
    same step on the CPU, on its own input and on random rows; then
    ``dryrun(4)`` on 4 ranks of the card with the launch counts read
    around it.  Returns the counts."""
    import torch
    from dr_tpu_torch import entry as E
    gen = torch.Generator().manual_seed(16)
    fn_c, args_c = E.entry("cpu")
    fn, args = E.entry(device)
    width = args[0][0].shape[1]
    rand = [torch.randn((1, width), generator=gen) for _ in range(2)]
    for tag, a_c, b_c in (("", *args_c), (" random rows", [rand[0]],
                                           [rand[1]])):
        out_c, sum_c = fn_c(a_c, b_c)
        if tag:
            a_d, b_d = [rand[0].to(device)], [rand[1].to(device)]
        else:
            a_d, b_d = args
        out, total = fn(a_d, b_d)
        scale = float(out_c[0].abs().max())
        # the same separately rounded products and sums on both sides
        check(f"entry step{tag} vs CPU", max_err(out[0].cpu(), out_c[0]),
              1e-6 * scale)
        # f32 sums of 2^16 cells in two orders
        check(f"entry masked sum{tag} vs CPU", abs(float(total)
                                                  - float(sum_c)),
              1e-5 * float(out_c[0].abs().sum()))
    dt.final()
    kernels.reset_counts()
    t0 = time.perf_counter()
    E.dryrun(4, [device])
    counts = dict(kernels.launches)
    log(f"  dryrun(4) {time.perf_counter() - t0:.2f} s, launches {counts}")
    for names in (("stencil_matmul",), ("chunked_dot",), ("chunked_cumsum",),
                  ("bitonic_sort", "segred"), ("flash_update",)):
        if sum(counts[k] for k in names) <= 0:
            raise AssertionError(f"dryrun launched no {'/'.join(names)}")
    return counts


# --------------------------------------------------- halo p50 and GB/s

def halo_p50(dt, ranks, device="cuda:0", cells=HALO_CELLS):
    """Phase 17: bench.py's halo-exchange p50 (``bench.py:552-573``): a
    periodic ``halo_bounds(1024, 1024)`` vector of ``cells`` a rank,
    timed calls of ``exchange_n(64)``, 4 calls a batch, 5 batches, by
    CUDA events; returns the median microseconds per exchange.  The
    ghosts are then checked against their owners."""
    import torch
    dt.init(dt.get_duplicated_devices(ranks, [device]))
    n = ranks * cells
    v = dt.distributed_vector(n, np.float32, halo=dt.halo_bounds(
        HALO_W, HALO_W, periodic=True))
    dt.iota(v, 0)
    h = v.halo()
    h.exchange_n(HALO_ROUNDS)  # warm
    torch.cuda.synchronize()
    per = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(4):
            h.exchange_n(HALO_ROUNDS)
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) * 1e3 / (4 * HALO_ROUNDS))
    for r, row in enumerate(v.rows):
        left = ((r - 1) % ranks) * cells + cells - HALO_W
        right = ((r + 1) % ranks) * cells
        want = torch.cat([torch.arange(left, left + HALO_W),
                          torch.arange(r * cells, (r + 1) * cells),
                          torch.arange(right, right + HALO_W)]).float()
        check(f"halo {ranks} ranks rank {r} ghosts",
              max_err(row[0].cpu(), want), 0.0)
    del v, h
    return float(np.median(per)), per


def gbps_lines(n, steps4, results):
    """GB/s/chip of phase 4's steps and phase 8's kernel times, bytes
    counted as bench.py counts them: effective ``2*n*4*steps`` and
    physical ``2*n*4*passes`` for the 1-D stencils
    (``bench.py:261-268``), ``2*n*4`` a dot (``:519``) and a scan."""
    f = 4
    out = {}
    for step, kern, block in (("stencil_iterate_matmul", "stencil_matmul",
                               K_BLOCK),
                              ("stencil_iterate_blocked", "stencil_blocked",
                               T_BLOCK)):
        t = steps4[step]
        passes = -(-STEPS // block)
        out[step] = {
            "seconds": t,
            "effective_gbps": 2.0 * n * f * STEPS / t / 1e9,
            "physical_gbps": 2.0 * n * f * passes / t / 1e9,
            "kernel_physical_gbps": 2.0 * n * f / (results[kern]["ms"]
                                                   * 1e-3) / 1e9}
    t = steps4["dot_n"]
    out["dot_n"] = {"seconds": t,
                    "gbps": 2.0 * n * f * DOT_ROUNDS / t / 1e9,
                    "kernel_gbps": 2.0 * n * f / (
                        results["chunked_dot"]["ms"] * 1e-3) / 1e9}
    t = steps4["inclusive_scan"]
    out["inclusive_scan"] = {"seconds": t, "gbps": 2.0 * n * f / t / 1e9,
                             "kernel_gbps": 2.0 * n * f / (
                                 results["chunked_cumsum"]["ms"] * 1e-3)
                             / 1e9}
    return out


# ------------------------------------------------------------ sparse

def config5_coo(m, k=SP_K, seed=0):
    """bench.py's config 5 pattern (``bench.py:767-800``): ``k`` random
    columns a row from ``default_rng(seed)``, f32 normal values; rows
    sorted, so the host CSR is (indptr, cols, values) directly."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int64), k)
    cols = rng.integers(0, m, size=m * k)
    vals = rng.standard_normal(m * k).astype(np.float32)
    return rows, cols, vals, np.arange(0, m * k + 1, k, dtype=np.int64)


def banded_coo(m, half, seed=1):
    """bench.py's banded BCSR case (``bench.py:879-902``): rows of
    ``2*half+1`` f32 normal values around the diagonal."""
    rng = np.random.default_rng(seed)
    ii = np.repeat(np.arange(m, dtype=np.int64), 2 * half + 1)
    jj = ii + np.tile(np.arange(-half, half + 1), m)
    keep = (jj >= 0) & (jj < m)
    ii, jj = ii[keep], jj[keep]
    vals = rng.standard_normal(len(ii)).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(ii, minlength=m))])
    return ii, jj, vals, indptr


def host_csr(shape, cols, vals, indptr):
    """The float64 scipy matrix and its absolute value."""
    import scipy.sparse as sps
    S = sps.csr_matrix((vals.astype(np.float64), cols, indptr), shape=shape)
    return S, abs(S)


def check_rows(name, got, S, absS, b):
    """Each row within 1e-5 * (|A|·|b|)_i + 1e-6 of the float64 product
    (f32 sums of the row's products in some order)."""
    got = np.asarray(got, dtype=np.float64)
    ref = S @ b.astype(np.float64)
    tol = 1e-5 * (absS @ np.abs(b).astype(np.float64)) + 1e-6
    err = np.abs(got - ref)
    worst = float((err / tol).max())
    log(f"  {name}: max_abs_err={float(err.max())!r} worst err/tol="
        f"{worst!r} {'ok' if worst <= 1 else 'FAIL'}")
    if not worst <= 1:
        raise AssertionError(f"{name}: rows off the float64 product")


def gemv_twice(dt, A, b, m, fmt=None):
    """c = A·b twice from zero (``fmt`` forces a layout); both results on
    the host, which must be the same bits."""
    import importlib
    tg = importlib.import_module("dr_tpu_torch.algorithms.gemv")
    outs = []
    for _ in range(2):
        c = dt.distributed_vector(m)
        if fmt is None:
            dt.gemv(c, A, b)
        else:
            tg._gemv_as(c, A, b, fmt)
        outs.append(c.to_array().cpu())
    if not torch_equal(outs[0], outs[1]):
        raise AssertionError("gemv gave other bits on a second call")
    return outs[0].numpy()


def torch_equal(a, b):
    import torch
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def marginal_ms(run, r1=2, r2=18, samples=3):
    """Milliseconds a round from ``run(r2)`` minus ``run(r1)`` by CUDA
    events (bench.py's marginal: the per-call constant cancels); the
    median of ``samples``."""
    import torch
    run(r1)
    torch.cuda.synchronize()
    vals = []
    for _ in range(samples):
        ts = []
        for r in (r1, r2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(r)
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
        vals.append((ts[1] - ts[0]) / (r2 - r1))
    return float(np.median(vals))


def sparse_one_rank(dt, seed, m_log2=SP_LOG2, mb_log2=SPB_LOG2,
                    timed=True):
    """Phase 18: config 5's pattern at 2^m_log2 rows on one rank: the
    autoselected format (ELL), gemv against float64 scipy and the same
    bits twice, gemv_n GFLOP/s beside the bytes bound and cuSPARSE, spmm
    nv = 8, and the banded BCSR case at 2^mb_log2 rows.  Returns the
    numbers printed."""
    import torch
    import importlib
    tg = importlib.import_module("dr_tpu_torch.algorithms.gemv")
    dev = dt.devices()[0]
    out = {}
    m = 1 << m_log2
    t0 = time.perf_counter()
    rows, cols, vals, indptr = config5_coo(m)
    nnz = len(vals)
    out["host_data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
    fmt = tg.resolved_format(A)
    dt.fence()
    out["build_s"] = time.perf_counter() - t0
    log(f"  m=2^{m_log2} nnz={nnz}: host data {out['host_data_s']:.2f} s, "
        f"card build + ELL layout {out['build_s']:.2f} s, format {A.format}"
        f" -> {fmt}")
    if A.format != "ell" or fmt != "ell":
        raise AssertionError(f"config 5 took {A.format}/{fmt}, not ell")
    S, absS = host_csr((m, m), cols, vals, indptr)
    del rows
    b = np.random.default_rng(seed).standard_normal(m).astype(np.float32)
    check_rows("gemv (ell) vs float64 scipy", gemv_twice(dt, A, b, m),
               S, absS, b)
    B = np.random.default_rng(seed + 1).standard_normal(
        (m, SP_NV)).astype(np.float32)
    Y = dt.spmm(A, B)
    check_rows(f"spmm nv={SP_NV} (ell) vs float64 scipy", Y.cpu().numpy(),
               S, absS, B)
    del Y
    if timed:
        bv = dt.distributed_vector.from_array(torch.from_numpy(b).to(dev))
        c = dt.distributed_vector(m)
        ms = marginal_ms(lambda r: tg.gemv_n(c, A, bv, r))
        out["gemv_ms"] = ms
        out["gemv_gflops"] = 2.0 * nnz / (ms * 1e-3) / 1e9
        out["bound_ms"] = (nnz * 8 + m * 12) / HBM_BYTES_PER_S * 1e3
        Bd = torch.from_numpy(B).to(dev)
        ms = marginal_ms(lambda r: tg.spmm_n(A, Bd, r))
        out["spmm8_ms"] = ms
        out["spmm8_gflops"] = 2.0 * nnz * SP_NV / (ms * 1e-3) / 1e9
        # one cuSPARSE call computing the same product (columns sorted
        # within rows, as its CSR wants; never called by the port)
        key = torch.from_numpy(np.repeat(np.arange(m, dtype=np.int64),
                                         SP_K) * m + cols).to(dev)
        order = torch.sort(key).indices
        col_d = (key[order] % m).to(torch.int32)
        del key
        vals_d = torch.from_numpy(vals).to(dev)[order]
        del order
        crow = torch.from_numpy(indptr.astype(np.int32)).to(dev)
        Acsr = torch.sparse_csr_tensor(crow, col_d, vals_d, size=(m, m))
        bd = torch.from_numpy(b).to(dev)
        check_rows("cuSPARSE vs float64 scipy", (Acsr @ bd).cpu().numpy(),
                   S, absS, b)
        out["cusparse_ms"] = events_ms(lambda: Acsr @ bd, 20)
        log(f"  gemv_n {out['gemv_ms']!r} ms a round, "
            f"{out['gemv_gflops']!r} GFLOP/s, bound {out['bound_ms']!r} ms "
            f"(nnz*8 + m*12 bytes); cuSPARSE (torch.sparse_csr_tensor @ b) "
            f"{out['cusparse_ms']!r} ms; spmm_n nv={SP_NV} "
            f"{out['spmm8_ms']!r} ms a round, {out['spmm8_gflops']!r} "
            f"GFLOP/s")
        del Acsr, crow, col_d, vals_d, bv, c, Bd, bd
    del A, S, absS, cols, vals, B
    gc.collect()

    # the banded case: block structure takes BCSR
    mb = 1 << mb_log2
    rows, cols, vals, indptr = banded_coo(mb, SPB_HALF)
    nnzb = len(vals)
    Ab = dt.sparse_matrix.from_coo((mb, mb), rows, cols, vals)
    fmt = tg.resolved_format(Ab)
    log(f"  banded m=2^{mb_log2} half-band {SPB_HALF} nnz={nnzb}: format "
        f"{Ab.format} -> {fmt}, kb={Ab._bcsr_kb}")
    if Ab.format != "bcsr" or fmt != "bcsr":
        raise AssertionError(f"banded matrix took {Ab.format}/{fmt}")
    S, absS = host_csr((mb, mb), cols, vals, indptr)
    bb = np.random.default_rng(seed + 2).standard_normal(mb).astype(
        np.float32)
    check_rows("banded gemv (bcsr) vs float64 scipy",
               gemv_twice(dt, Ab, bb, mb), S, absS, bb)
    if timed:
        bv = dt.distributed_vector.from_array(torch.from_numpy(bb).to(dev))
        c = dt.distributed_vector(mb)
        ms = marginal_ms(lambda r: tg.gemv_n(c, Ab, bv, r))
        out["bcsr_ms"] = ms
        out["bcsr_gflops"] = 2.0 * nnzb / (ms * 1e-3) / 1e9
        out["bcsr_bound_ms"] = (nnzb * 8 + mb * 12) / HBM_BYTES_PER_S * 1e3
        log(f"  banded gemv_n {ms!r} ms a round, {out['bcsr_gflops']!r} "
            f"GFLOP/s, bound {out['bcsr_bound_ms']!r} ms")
    return out


def sparse_four_ranks(dt, seed, device="cuda:0", m_log2=SP4_LOG2,
                      half=SP4_HALF):
    """Phase 19: 4 ranks of the card at 2^m_log2 rows against float64
    scipy: row tiles (ELL), the ring layout with serial equal to
    pipelined bit for bit, a 2x2 block-cyclic grid, the banded matrix on
    the grid (BCSR), a skewed matrix (one dense row: csr) and spmm on
    the grid."""
    import os
    dt.init(dt.get_duplicated_devices(4, [device]))
    m = 1 << m_log2
    rows, cols, vals, indptr = config5_coo(m, seed=seed)
    S, absS = host_csr((m, m), cols, vals, indptr)
    b = np.random.default_rng(seed + 3).standard_normal(m).astype(np.float32)
    A = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
    log(f"  row tiles: format {A.format}, ring viable {A.ensure_ring()}")
    if A.format != "ell" or not A.ensure_ring():
        raise AssertionError("config 5 on 4 ranks must be ell, ring-viable")
    check_rows("4 ranks gemv (ell) vs float64 scipy",
               gemv_twice(dt, A, b, m), S, absS, b)
    ring = {}
    saved = os.environ.get("DR_GPU_RING_SCHEDULE")
    try:
        for sched in ("serial", "pipelined"):
            os.environ["DR_GPU_RING_SCHEDULE"] = sched
            ring[sched] = gemv_twice(dt, A, b, m, fmt="ring")
    finally:
        if saved is None:
            os.environ.pop("DR_GPU_RING_SCHEDULE", None)
        else:
            os.environ["DR_GPU_RING_SCHEDULE"] = saved
    check_rows("4 ranks gemv (ring) vs float64 scipy", ring["serial"], S,
               absS, b)
    check_true("4 ranks ring serial == pipelined, bit for bit",
               np.array_equal(ring["serial"].view(np.int32),
                              ring["pipelined"].view(np.int32)))
    del A
    grid = dt.block_cyclic(grid=(2, 2))
    G = dt.sparse_matrix.from_coo((m, m), rows, cols, vals, partition=grid)
    log(f"  2x2 grid: format {G.format}")
    check_rows("2x2 grid gemv vs float64 scipy", gemv_twice(dt, G, b, m), S,
               absS, b)
    B = np.random.default_rng(seed + 4).standard_normal(
        (m, SP_NV)).astype(np.float32)
    check_rows(f"2x2 grid spmm nv={SP_NV} vs float64 scipy",
               dt.spmm(G, B).cpu().numpy(), S, absS, B)
    del G, S, absS, rows, cols, vals
    gc.collect()
    rows, cols, vals, indptr = banded_coo(m, half, seed=seed + 5)
    S, absS = host_csr((m, m), cols, vals, indptr)
    Gb = dt.sparse_matrix.from_coo((m, m), rows, cols, vals, partition=grid)
    log(f"  banded 2x2 grid (half-band {half}): format {Gb.format}")
    if Gb.format != "bcsr":
        raise AssertionError(f"banded grid took {Gb.format}")
    check_rows("2x2 grid banded gemv (bcsr) vs float64 scipy",
               gemv_twice(dt, Gb, b, m), S, absS, b)
    del Gb, S, absS, rows, cols, vals
    # one dense row defeats the ELL padding gate: csr
    rng = np.random.default_rng(seed + 6)
    rows = np.concatenate([np.zeros(m, np.int64),
                           np.repeat(np.arange(m, dtype=np.int64), 4)])
    cols = np.concatenate([np.arange(m), rng.integers(0, m, 4 * m)])
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    import scipy.sparse as sps
    S = sps.csr_matrix((vals.astype(np.float64), (rows, cols)),
                       shape=(m, m))
    K = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
    log(f"  skewed (one dense row): format {K.format}")
    if K.format != "csr":
        raise AssertionError(f"skewed matrix took {K.format}")
    check_rows("4 ranks skewed gemv (csr) vs float64 scipy",
               gemv_twice(dt, K, b, m), S, abs(S), b)


# -------------------------------------- re-layout, halo and checkpoint

def rows_equal(a, b):
    """The rank rows of two f32 vectors, bit for bit."""
    return len(a.rows) == len(b.rows) and all(
        torch_equal(x, y) for x, y in zip(a.rows, b.rows))


def host_ms(run, iters, fence):
    """Milliseconds a call of ``run`` by the host clock, ``fence()``
    before and after, after one warm-up call."""
    run()
    fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    fence()
    return (time.perf_counter() - t0) / iters * 1e3


def redistribute_phase(dt, seed, device="cuda:0", log2=RDX_LOG2,
                       halo_log2=RDX_HALO_LOG2, timed=True):
    """Phase 20 (a): bench.py's redistribute configuration on 4 ranks:
    every hop's rows equal between the collective and the host-staged
    route, the value the source's, bit for bit; then both routes' GB/s
    by bench.py's count, and a halo vector moved and exchanged."""
    import torch
    from dr_tpu_torch.parallel import redistribute as rdx
    from dr_tpu_torch.parallel.runtime import Runtime
    rt = dt.init(dt.get_duplicated_devices(4, [device]))
    P, n = 4, 1 << log2
    gen = torch.Generator(device=device).manual_seed(seed + 20)
    src = torch.randn(n, generator=gen, device=device)
    base = n // P
    rot = [base // 2, base, base, n - base // 2 - 2 * base]
    cuts = np.sort(np.random.default_rng(seed + 20).integers(0, n + 1, P - 1))
    uneven = [int(b - a) for a, b in zip(np.r_[0, cuts], np.r_[cuts, n])]
    va = dt.distributed_vector.from_array(src)
    vb = dt.distributed_vector.from_array(src)
    for tag, d in (("the rotated cut", rot), ("even", None),
                   ("a team on rank 2", [0, 0, n, 0]),
                   (f"a seeded uneven cut {uneven}", uneven),
                   ("even", None)):
        rdx._collective(va, d, rt)
        rdx._host_staged(vb, d, rt)
        check_true(f"redistribute to {tag}: collective rows == "
                   "host-staged rows (bits)", rows_equal(va, vb))
        check_true(f"redistribute to {tag}: values == source (bits)",
                   torch_equal(va.to_array(), src))
    del vb
    two = Runtime(rt.devices[:2])
    dt.redistribute(va, [n // 4, n - n // 4], runtime=two)
    check_true("redistribute onto 2 ranks (host-staged): values == source "
               "(bits)", va.nshards == 2 and torch_equal(va.to_array(), src))
    dt.redistribute(va, None)
    check_true("redistribute back onto 4 ranks: values == source (bits)",
               va.nshards == 4 and torch_equal(va.to_array(), src))
    out = {"n": n, "hops_per_iter": 2, "rotated_cut": rot}
    if timed:
        def pingpong(route):
            def run():
                route(va, rot, rt)
                route(va, None, rt)
            return run

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        ms = events_ms(pingpong(lambda v, d, r: dt.redistribute(v, d)), 10)
        peak = torch.cuda.max_memory_allocated()
        ms_host = host_ms(pingpong(rdx._host_staged), 2, rt.fence)
        out.update({
            "collective_ms_per_iter": ms,
            "collective_gbps": 2 * n * 4 / (ms * 1e-3) / 1e9,
            "host_staged_ms_per_iter": ms_host,
            "host_staged_gbps": 2 * n * 4 / (ms_host * 1e-3) / 1e9,
            "collective_peak_bytes": peak,
            "collective_peak_above_live_bytes": peak - live})
        log(f"  redistribute ping-pong: collective {ms!r} ms an iteration "
            f"({out['collective_gbps']!r} GB/s), host-staged {ms_host!r} ms "
            f"({out['host_staged_gbps']!r} GB/s); collective peak {peak} "
            f"bytes, {peak - live} above the {live} live")
        check_true("after the timed ping-pong: values == source (bits)",
                   torch_equal(va.to_array(), src))
    del va
    nh = 1 << halo_log2
    hv = dt.distributed_vector.from_array(src[:nh], halo=dt.halo_bounds(
        HALO_W, HALO_W, periodic=True))
    dt.redistribute(hv, None)
    hv.halo().exchange()
    cells = nh // P
    ok = True
    for r, row in enumerate(hv.rows):
        left = ((r - 1) % P) * cells + cells - HALO_W
        right = ((r + 1) % P) * cells
        want = torch.cat([src[left:left + HALO_W],
                          src[r * cells:(r + 1) * cells],
                          src[right:right + HALO_W]])
        ok = ok and torch_equal(row[0], want)
    check_true(f"halo vector (2^{halo_log2}, halo {HALO_W}) redistributed "
               "and exchanged: every row == its owners (bits)", ok)
    return out


def ghost_map(n, P, k, rng):
    """Each rank mirrors ``k`` global indices: half from its neighbours'
    blocks, half uniform over the vector, duplicates included."""
    seg = n // P
    out = {}
    for r in range(P):
        nb = rng.choice([(r - 1) % P, (r + 1) % P], k // 2)
        near = nb * seg + rng.integers(0, seg, k // 2)
        out[r] = np.concatenate([near, rng.integers(0, n, k - k // 2)])
    return out


def numpy_fold(base, flat, ghosts, op):
    want = base.copy()
    if op == "second":
        want[flat] = ghosts
    else:
        {"plus": np.add, "multiplies": np.multiply, "max": np.maximum,
         "min": np.minimum}[op].at(want, flat, ghosts)
    return want


def uhalo_phase(dt, seed, device="cuda:0", log2=UH_LOG2,
                ghosts_log2=UH_GHOSTS_LOG2, timed=True):
    """Phase 20 (b): an unstructured halo on 4 ranks: ``exchange()``
    against numpy's gather and every ``reduce`` op against numpy's
    ``ufunc.at`` / fancy assignment, bit for bit and the same bits on a
    second call; ms per ``exchange()`` and per ``reduce("plus")``."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    P, n, k = 4, 1 << log2, 1 << ghosts_log2
    rng = np.random.default_rng(seed + 21)
    src = rng.standard_normal(n).astype(np.float32)
    gmap = ghost_map(n, P, k, rng)
    flat = np.concatenate([gmap[r] for r in range(P)])
    contrib = {r: rng.standard_normal(k).astype(np.float32) for r in range(P)}
    ghosts = np.concatenate([contrib[r] for r in range(P)])
    depth = int(np.bincount(flat, minlength=n).max())
    src_dev = torch.from_numpy(src).to(device)
    v = dt.distributed_vector.from_array(src_dev)
    t0 = time.perf_counter()
    uh = dt.unstructured_halo(v, gmap)
    build = time.perf_counter() - t0
    log(f"  unstructured halo: {P} x 2^{ghosts_log2} indices over 2^{log2} "
        f"cells, {len(flat) - len(np.unique(flat))} repeats, deepest "
        f"column {depth}; built in {build:.3f} s")
    uh.exchange()
    check_true("unstructured exchange: every rank's ghosts == numpy gather "
               "(bits)", all(np.array_equal(
                   uh.ghost_values(r).cpu().numpy().view(np.int32),
                   src[gmap[r]].view(np.int32)) for r in range(P)))
    for op in UH_OPS:
        want = numpy_fold(src, flat, ghosts, op).view(np.int32)
        outs = []
        for _ in range(2):
            v.assign_array(src_dev)
            for r in range(P):
                uh.set_ghost_values(r, contrib[r])
            uh.reduce(op)
            outs.append(v.to_array().cpu().numpy().view(np.int32))
        check_true(f"unstructured reduce {op} == numpy (bits)",
                   np.array_equal(outs[0], want))
        check_true(f"unstructured reduce {op}: the same bits on a second "
                   "call", np.array_equal(outs[0], outs[1]))
    out = {"n": n, "indices_per_rank": k, "deepest_column": depth}
    if timed:
        out["exchange_ms"] = events_ms(uh.exchange, 20)
        out["reduce_plus_ms"] = events_ms(lambda: uh.reduce("plus"), 20)
        log(f"  unstructured halo: exchange {out['exchange_ms']!r} ms, "
            f"reduce plus {out['reduce_plus_ms']!r} ms")
    return out


def checkpoint_phase(dt, seed, device="cuda:0", log2=CK_LOG2,
                     bf_log2=CK_BF_LOG2, m=CK_M, tile=CK_TILE,
                     sp_log2=SP4_LOG2, md=CK_MD):
    """Phase 20 (c): save and load on 4 ranks, each round trip bit for
    bit, with seconds and file bytes; a truncated file is refused."""
    import tempfile
    import torch
    from dr_tpu_torch.utils import checkpoint as ck
    from dr_tpu_torch.utils.resilience import CheckpointCorruptError
    rt = dt.init(dt.get_duplicated_devices(4, [device]))
    gen = torch.Generator(device=device).manual_seed(seed + 22)
    rng = np.random.default_rng(seed + 22)
    out = {}

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def same_values(a, b):
        return a.dtype == b.dtype and torch.equal(bits(a.to_array()),
                                                  bits(b.to_array()))

    def same_triples(a, b):
        sa, sb = ck.snapshot(a)[1], ck.snapshot(b)[1]
        return all(np.array_equal(sa[k], sb[k]) for k in sa)

    with tempfile.TemporaryDirectory() as td:
        def roundtrip(tag, c, same):
            path = os.path.join(td, tag + ".npz")
            rt.fence()
            t0 = time.perf_counter()
            ck.save(path, c)
            t1 = time.perf_counter()
            back = ck.load(path)
            back.block_until_ready()
            t2 = time.perf_counter()
            out[tag] = {"save_s": t1 - t0, "load_s": t2 - t1,
                        "bytes": os.path.getsize(path)}
            log(f"  checkpoint {tag}: save {t1 - t0:.3f} s, load "
                f"{t2 - t1:.3f} s, {out[tag]['bytes']} bytes")
            check_true(f"checkpoint {tag}: round trip (bits)",
                       same(c, back))
            return path, back

        n = 1 << log2
        cuts = np.sort(rng.integers(0, n + 1, 3))
        sizes = [int(b - a) for a, b in zip(np.r_[0, cuts], np.r_[cuts, n])]
        v = dt.distributed_vector.from_array(
            torch.randn(n, generator=gen, device=device), distribution=sizes)
        path, back = roundtrip(f"f32 vector 2^{log2}", v, same_values)
        check_true("  the loaded vector keeps its distribution",
                   back.layout == v.layout)
        os.unlink(path)
        del v, back
        b = dt.distributed_vector.from_array(torch.randn(
            1 << bf_log2, generator=gen, device=device).to(torch.bfloat16))
        path, back = roundtrip(f"bf16 vector 2^{bf_log2}", b, same_values)
        with open(path, "rb") as fh:
            head = fh.read(os.path.getsize(path) // 2)
        torn = os.path.join(td, "torn.npz")
        with open(torn, "wb") as fh:
            fh.write(head)
        try:
            ck.load(torn)
            refused = False
        except CheckpointCorruptError:
            refused = True
        check_true("a truncated copy raises CheckpointCorruptError", refused)
        for p_ in (path, torn):
            os.unlink(p_)
        del b, back, head
        M = dt.dense_matrix.from_array(
            torch.randn((m, m), generator=gen, device=device),
            dt.block_cyclic(tile=(tile, tile), grid=(2, 2)))
        path, back = roundtrip(f"{m}^2 matrix, {tile}^2 cyclic tiles", M,
                               same_values)
        check_true("  the loaded matrix keeps its partition",
                   back.partition == M.partition and not back.is_block)
        os.unlink(path)
        del M, back
        ms = 1 << sp_log2
        rows, cols, vals, _ = config5_coo(ms, seed=seed)
        S = dt.sparse_matrix.from_coo((ms, ms), rows, cols, vals)
        del rows, cols, vals
        path, back = roundtrip(f"config 5 sparse 2^{sp_log2} rows", S,
                               same_triples)
        os.unlink(path)
        del S, back
        A = dt.distributed_mdarray.from_array(
            torch.randn(md, generator=gen, device=device))
        path, back = roundtrip("mdarray " + "x".join(map(str, md)), A,
                               same_values)
        os.unlink(path)
    return out


def surface_phase(dt, seed, device="cuda:0", log2=SURF_LOG2,
                  expr_log2=EXPR_LOG2):
    """Phase 20 (d): the communicator, ``rma_window``, an expression
    transform and the views on 4 ranks, against numpy or torch, bit for
    bit."""
    import torch
    from dr_tpu_torch import views
    from dr_tpu_torch.utils.expr import op_from_expr
    dt.init(dt.get_duplicated_devices(4, [device]))
    P, n = 4, 1 << log2
    k = n // P
    rng = np.random.default_rng(seed + 23)
    v = rng.standard_normal(n).astype(np.float32)
    comm = dt.default_comm()
    sh = comm.scatter(v)
    check_true("communicator scatter / gather at 2^%d (bits)" % log2,
               all(s.device == torch.device(device) for s in sh)
               and np.array_equal(comm.gather(sh), v))
    blocks = v.reshape(P, k)
    for periodic in (False, True):
        for name, step, edge in (("shift_forward", 1, 0),
                                 ("shift_backward", -1, -1)):
            want = np.roll(blocks, step, 0)
            if not periodic:
                want[edge] = 0
            got = comm.gather(getattr(comm, name)(sh, periodic=periodic))
            check_true(f"communicator {name} periodic={periodic} == numpy "
                       "(bits)", np.array_equal(got, want.reshape(-1)))
    mw = 4096
    kk = n // (P * P * mw)
    mat = v.reshape(P * kk, P, mw)
    got = comm.gather(comm.alltoall(comm.scatter(mat)))
    want = mat.reshape(P, kk, P, mw).transpose(2, 0, 1, 3).reshape(
        P * P, kk, mw)
    check_true("communicator alltoall == numpy (bits)",
               np.array_equal(got, want))
    dv = dt.distributed_vector(n)
    win = dt.rma_window(dv)
    idx = rng.choice(n, 1 << 16, replace=False)
    vals = rng.standard_normal(1 << 16).astype(np.float32)
    win.put(idx, vals)
    win.fence()
    host = dt.to_numpy(dv)
    check_true("rma_window put / fence / get (bits)",
               np.array_equal(win.get(idx).cpu().numpy(), vals)
               and np.array_equal(host[idx], vals)
               and np.count_nonzero(host) == np.count_nonzero(vals))
    x = torch.randn(1 << expr_log2, generator=torch.Generator(
        device=device).manual_seed(seed + 23), device=device)
    xv = dt.distributed_vector.from_array(x)
    xo = dt.distributed_vector(1 << expr_log2)
    dt.transform(xv, xo, op_from_expr("(x0 * 2.0 + 1.0)", 1))
    check_true(f"op_from_expr transform at 2^{expr_log2} == torch "
               "(bits)", torch_equal(xo.to_array(), x * 2.0 + 1.0))
    del x, xv, xo
    vd = dt.distributed_vector.from_array(v)
    for tag, e in (("enumerate", views.enumerate(vd)),
                   ("| enumerate()", vd | views.enumerate())):
        ids, vals_ = e.to_array()
        check_true(f"views {tag} == numpy", ids.dtype == torch.int32
                   and np.array_equal(ids.cpu().numpy(), np.arange(n))
                   and np.array_equal(vals_.cpu().numpy(), v))
    ranks, vals_ = views.ranked_view(vd).to_array()
    check_true("views ranked_view == numpy", np.array_equal(
        ranks.cpu().numpy(), np.repeat(np.arange(P), k))
        and np.array_equal(vals_.cpu().numpy(), v))
    check_true("ranked_view segments: int32 ranks on each rank's device",
               all(dt.local(s)[0].device == torch.device(device)
                   and dt.local(s)[0].dtype == torch.int32
                   and bool((dt.local(s)[0] == dt.rank(s)).all())
                   for s in dt.segments(views.ranked_view(vd))))
    for tag, r, want in (
            ("| take | drop", vd | views.take(n - 5) | views.drop(7),
             v[7:n - 5]),
            ("| slice_view", vd | views.slice_view((3, k + 9)), v[3:k + 9]),
            ("| transform", vd | views.transform(lambda t: t * 3.0),
             v * np.float32(3.0))):
        check_true(f"views {tag} == numpy (bits)",
                   np.array_equal(dt.to_numpy(r), want))
    return {"n": n, "expr_n": 1 << expr_log2}


# ------------------------------------------- phase 21: observability

#: the __global__ kernel that begins one call of each wrapper on the main
#: path (dot.cu follows each dot_partials* with one sum_partials)
CALL_KERNELS = {
    "stencil_matmul": ("stencil_matmul_kernel",),
    "stencil_blocked": ("window_kernel", "shared_kernel"),
    "chunked_dot": ("dot_partials", "dot_partials_f32x4"),
    "chunked_cumsum": ("scan_tiles",),
}
K_OF = {"stencil_matmul": "K1", "stencil_blocked": "K2",
        "chunked_dot": "K3", "chunked_cumsum": "K4",
        "stencil2d_blocked": "K5", "bitonic_sort": "K6", "segred": "K7",
        "flash_update": "K9"}
#: the Chrome-trace categories of host work that a gap can overlap
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
REL_SPANS = ("relational.join", "relational.groupby",
             "relational.histogram", "relational.top_k")
REL_PHASES = ("sort_left", "sort_right", "merge", "sort", "aggregate")


def global_kernels():
    """``__global__`` function name -> launch counter, read from
    ``dr_tpu_torch/csrc/*.cu``."""
    from dr_tpu_torch.ops import kernels
    pat = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*"
                     r"(\w+)\s*\(")
    out = {}
    for counter, src in kernels.SOURCES.items():
        for m in pat.finditer((kernels.CSRC / src).read_text()):
            out[m.group(1)] = counter
    return out


def kernel_base(name):
    """The function name of a kernel name as the profiler gives it
    (demangled): ``void (anonymous namespace)::scan_tiles<float>(float
    const*, ...)`` -> ``scan_tiles``."""
    s = name.replace("(anonymous namespace)::", "")
    s = s.split("(", 1)[0].split("<", 1)[0].strip()
    return s.split("::")[-1].split()[-1] if s else name


def analyse_trace(path, gk, top=5):
    """The device's idle share over one Chrome trace of
    ``torch.profiler``: 1 - (the union of kernel, memcpy and memset
    intervals) / (first device event's start to the last one's end);
    the ``top`` device operations by total time; the ``top`` longest
    idle gaps with the host operations overlapping each; and the
    launches of each wrapper counted from its kernels."""
    from dr_tpu_torch.utils.profiling import DEVICE_CATS
    with open(path, encoding="utf-8") as fh:
        evs = json.load(fh)["traceEvents"]
    dev = sorted((e for e in evs if e.get("cat") in DEVICE_CATS
                  and "dur" in e), key=lambda e: float(e["ts"]))
    if not dev:
        raise AssertionError(f"{path}: no device event in the trace")
    host = [e for e in evs if e.get("cat") in HOST_CATS and "dur" in e]
    busy, gaps = 0.0, []
    s0 = float(dev[0]["ts"])
    cur_s, cur_e = s0, s0 + float(dev[0]["dur"])
    for e in dev[1:]:
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    window = cur_e - s0

    def label(e):
        base = kernel_base(e["name"])
        if e["cat"] == "kernel" and base in gk:
            return f"{K_OF.get(gk[base], gk[base])} {base}"
        return f"{e['cat']} {e['name'][:70]}"

    by = {}
    for e in dev:
        t, c = by.get(label(e), (0.0, 0))
        by[label(e)] = (t + float(e["dur"]), c + 1)
    ops = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    longest = []
    for g, a, b in sorted(gaps, reverse=True)[:top]:
        over = {}
        for h in host:
            hs, he = float(h["ts"]), float(h["ts"]) + float(h["dur"])
            ov = min(he, b) - max(hs, a)
            if ov > 0:
                key = f"{h['cat']}:{h['name'][:60]}"
                over[key] = over.get(key, 0.0) + ov
        longest.append({"gap_us": g, "at_us": a - s0, "host": [
            k for k, _ in sorted(over.items(), key=lambda kv: -kv[1])[:4]]})
    bases = [kernel_base(e["name"]) for e in dev if e["cat"] == "kernel"]
    launches = {c: sum(b in ks for b in bases)
                for c, ks in CALL_KERNELS.items()}
    return {"idle_share": 1.0 - busy / window, "window_us": window,
            "busy_us": busy, "device_events": len(dev), "gaps": len(gaps),
            "top_ops": [{"op": k, "us": t, "n": c} for k, (t, c) in ops],
            "longest_gaps": longest, "launches": launches,
            "sum_partials": sum(b == "sum_partials" for b in bases)}


def traced_main_step(dt, kernels, n, ranks, seed, logdir, card,
                     device="cuda:0"):
    """One step of the 1-D main path (a ``stencil_iterate_matmul`` call
    of one K1 step, a ``stencil_iterate_blocked`` pass, ``dot_n`` of one
    round and ``inclusive_scan``, halo exchanges included) under
    ``profiling.trace``, after one warm step; the trace's kernels mapped
    to K1-K4 and counted against the launch counters over the same
    window.  Returns the analysis."""
    import torch
    from dr_tpu_torch.utils import profiling
    dt.init(dt.get_duplicated_devices(ranks, [device]))
    gen = torch.Generator(device=device).manual_seed(seed + 21)
    src = torch.randn(n, generator=gen, device=device)
    a = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(MM_HALO, MM_HALO, periodic=True))
    b = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(BLK_HALO, BLK_HALO, periodic=True))
    x = dt.distributed_vector.from_array(
        torch.rand(n, generator=gen, device=device))
    s = dt.distributed_vector.from_array(src)
    res = dt.distributed_vector(n)
    del src

    def step():
        with profiling.annotate("stencil_iterate_matmul"):
            dt.stencil_iterate_matmul(a, W5, K_BLOCK, k_block=K_BLOCK)
        with profiling.annotate("stencil_iterate_blocked"):
            dt.stencil_iterate_blocked(b, W5, T_BLOCK, time_block=T_BLOCK)
        with profiling.annotate("dot_n"):
            dt.dot_n(x, s, 1)
        with profiling.annotate("inclusive_scan"):
            dt.inclusive_scan(s, res)
        dt.fence()

    step()
    os.makedirs(logdir, exist_ok=True)
    for old in os.listdir(logdir):
        os.remove(os.path.join(logdir, old))
    kernels.reset_counts()
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        step()
    secs = time.perf_counter() - t0
    counts = dict(kernels.launches)
    (name,) = os.listdir(logdir)
    path = os.path.join(logdir, name)
    info = analyse_trace(path, global_kernels())
    tag = f"{ranks} rank(s), n=2^{n.bit_length() - 1}"
    log(f"  [{card}] traced main step, {tag}: idle share "
        f"{info['idle_share']!r} of {info['window_us']!r} us "
        f"({info['device_events']} device events, {info['gaps']} gaps; "
        f"{secs!r} s by the host clock under the profiler; trace "
        f"{os.path.relpath(path, HERE)}, {os.path.getsize(path)} bytes)")
    for op in info["top_ops"]:
        log(f"  [{card}]   device op {op['op']}: {op['us']!r} us in "
            f"{op['n']}")
    for g in info["longest_gaps"]:
        log(f"  [{card}]   idle gap {g['gap_us']!r} us at +{g['at_us']!r} "
            f"us; host: {'; '.join(g['host'])}")
    want = {c: counts[c] for c in CALL_KERNELS}
    log(f"  {tag}: launches in the trace {info['launches']}, counters "
        f"{want}, sum_partials {info['sum_partials']}")
    for c in CALL_KERNELS:
        if counts[c] <= 0:
            raise AssertionError(f"{K_OF[c]} ({c}) never launched on the "
                                 f"traced main step ({tag})")
    check_true(f"{tag}: kernel launches in the trace == the launch "
               "counters (K1-K4)", info["launches"] == want
               and info["sum_partials"] == want["chunked_dot"])
    info["trace"] = os.path.relpath(path, HERE)
    info["launch_counters"] = want
    del a, b, x, s, res
    dt.final()
    return info


def relational_outputs_equal(tag, off, on):
    """Two runs of ``relational_path``: the same counts and every output
    the same bits."""
    import torch
    differ = [k for k in ("jk", "jl", "jr", "gk", "gv", "tv", "ti", "hb")
              if not torch.equal(off[k].view(torch.int32),
                                 on[k].view(torch.int32))]
    check_true(f"{tag}: outputs traced == untraced (bits; differing: "
               f"{differ})", off["m"] == on["m"] and off["ng"] == on["ng"]
               and not differ)


def relational_spans(tag, evs, want_phases=REL_PHASES):
    names = {e["name"] for e in evs}
    phases = {e["args"]["phase"] for e in evs
              if e["name"] == "relational.phase"}
    check_true(f"{tag}: the trace holds {list(REL_SPANS)}",
               set(REL_SPANS) <= names)
    check_true(f"{tag}: relational.phase names include "
               f"{list(want_phases)} (got {sorted(phases)})",
               set(want_phases) <= phases)
    spans = {e["id"] for e in evs if e["name"] in REL_SPANS}
    check_true(f"{tag}: every phase hangs under its op's span", all(
        e["args"].get("parent") in spans for e in evs
        if e["name"] == "relational.phase"))
    return [e["args"].get("route") for e in evs
            if e["name"] == "relational.phase"
            and e["args"]["phase"] == "merge"]


def traced_run(obs, fn):
    """``fn()`` with tracing armed; returns its result and the events it
    added to the ring (which keeps the phase's events for the export)."""
    start = obs.size()
    obs.arm(True)
    try:
        out = fn()
    finally:
        obs.arm(False)
    return out, obs.events()[start:]


def join_medians(dt, obs, data, reps=5):
    """Median seconds of ``reps`` joins of the pipeline's tables, traced
    and untraced in turns (host clock, fenced; a join reads its row
    count on the host)."""
    F, FV, D, DV = (dt.distributed_vector.from_array(a) for a in data)
    outs = [dt.distributed_vector(2 * data[0].numel()) for _ in range(3)]

    def once():
        dt.fence()
        t0 = time.perf_counter()
        dt.join(F, FV, D, DV, *outs)
        dt.fence()
        return time.perf_counter() - t0

    once()
    times = {"untraced": [], "traced": []}
    for _ in range(reps):
        times["untraced"].append(once())
        times["traced"].append(traced_run(obs, once)[0])
    return {k: float(np.median(v)) for k, v in times.items()}, times


def relational_obs(dt, obs, kernels, seed, card, device="cuda:0",
                   sizes=(REL_FACT_LOG2, REL_CARD_LOG2, REL4_FACT_LOG2)):
    """Phase 21 (a): the relational pipeline of phase 14 untraced and
    traced on one rank (the same bits, the four spans and their phases,
    the join's median of 5 both ways), then phase 15's on 4 ranks through
    the partition and the forced broadcast join.  Returns the numbers."""
    import torch
    out = {}
    dt.init([device])
    n_fact, ncard = 1 << sizes[0], 1 << sizes[1]
    data = relational_data(n_fact, ncard, seed + 14, device)
    off = relational_path(dt, data, {})
    kernels.reset_counts()
    on, evs = traced_run(obs, lambda: relational_path(dt, data, {}))
    log(f"  1 rank, n_fact=2^{sizes[0]}: launches {dict(kernels.launches)} "
        f"traced, {len(evs)} events")
    relational_outputs_equal(f"1 rank 2^{sizes[0]}", off, on)
    relational_spans(f"1 rank 2^{sizes[0]}", evs)
    del off, on
    med, times = join_medians(dt, obs, data)
    out["join_1rank_s"] = med
    log(f"  [{card}] join n_fact=2^{sizes[0]} 1 rank, median of 5 "
        f"(host clock, fenced): untraced {med['untraced']!r} s, traced "
        f"{med['traced']!r} s; runs {json.dumps(times)}")
    del data
    release(torch)
    dt.final()

    dt.init(dt.get_duplicated_devices(4, [device]))
    n4 = 1 << sizes[2]
    data = relational_data(n4, n4 >> 4, seed + 16, device)
    off = relational_path(dt, data, {})
    on, evs = traced_run(obs, lambda: relational_path(dt, data, {}))
    relational_outputs_equal(f"4 ranks 2^{sizes[2]} partition join",
                             off, on)
    routes = relational_spans(f"4 ranks 2^{sizes[2]}", evs,
                              REL_PHASES + ("partition_plan",))
    check_true(f"4 ranks: the pipeline's join took the partition route "
               f"({routes})", routes == ["partition"])
    with broadcast_max(1 << 30):
        off_b = relational_path(dt, data, {})
        on_b, evs = traced_run(obs, lambda: relational_path(dt, data, {}))
    relational_outputs_equal(f"4 ranks 2^{sizes[2]} broadcast join",
                             off_b, on_b)
    routes = relational_spans(f"4 ranks 2^{sizes[2]} broadcast", evs)
    check_true(f"4 ranks: the forced join took the broadcast route "
               f"({routes})", routes == ["broadcast"])
    check_true("4 ranks: partition rows == broadcast rows (bits)",
               all(torch.equal(on[k].view(torch.int32),
                               on_b[k].view(torch.int32))
                   for k in ("jk", "jl", "jr")))
    del off, on, off_b, on_b
    med, times = join_medians(dt, obs, data)
    out["join_4ranks_partition_s"] = med
    log(f"  [{card}] join n_fact=2^{sizes[2]} 4 ranks (partition), median "
        f"of 5: untraced {med['untraced']!r} s, traced {med['traced']!r} "
        f"s; runs {json.dumps(times)}")
    del data
    release(torch)
    dt.final()
    return out


def redistribute_obs(dt, obs, seed, card, device="cuda:0", log2=RDX_LOG2):
    """Phase 21 (b): phase 20's 2^28 f32 re-layout on 4 ranks with
    tracing armed: the collective hop to the rotated cut (span impl,
    phases plan -> exchange -> rebind, bytes_moved == plan_moves' moved
    elements x 4) and a host-staged hop onto 2 ranks (span impl host,
    no bytes), each equal bit for bit with the same hop untraced.
    Returns the numbers."""
    import torch
    from dr_tpu_torch.parallel.redistribute import plan_moves
    from dr_tpu_torch.parallel.runtime import Runtime
    rt = dt.init(dt.get_duplicated_devices(4, [device]))
    P, n = 4, 1 << log2
    gen = torch.Generator(device=device).manual_seed(seed + 20)
    src = torch.randn(n, generator=gen, device=device)
    base = n // P
    rot = [base // 2, base, base, n - base // 2 - 2 * base]
    ref = dt.distributed_vector.from_array(src)
    dt.redistribute(ref, rot)
    v = dt.distributed_vector.from_array(src)
    even = v.layout
    counter = obs.metrics.counter("redistribute.bytes_moved")
    b0 = counter.value
    _, evs = traced_run(obs, lambda: dt.redistribute(v, rot))
    moved_bytes = counter.value - b0
    _, moved = plan_moves(even, v.layout)
    span = [e for e in evs if e["name"] == "redistribute"]
    phases = [e["args"]["phase"] for e in evs
              if e["name"] == "redistribute.phase"]
    check_true(f"collective hop: one span, impl collective "
               f"({[e['args'] for e in span]})", len(span) == 1
               and span[0]["args"]["impl"] == "collective")
    check_true(f"collective hop: phases {phases} == plan, exchange, rebind",
               phases == ["plan", "exchange", "rebind"])
    check_true(f"collective hop: bytes_moved {moved_bytes} == moved "
               f"elements {moved} x 4", moved_bytes == moved * 4 > 0)
    check_true("collective hop traced: rows == untraced rows (bits)",
               rows_equal(v, ref))
    span_us = [span[0]["dur"]]
    two = Runtime(rt.devices[:2])
    cut = [n // 4, n - n // 4]
    dt.redistribute(ref, cut, runtime=two)
    b0 = counter.value
    _, evs = traced_run(obs, lambda: dt.redistribute(v, cut, runtime=two))
    span = [e for e in evs if e["name"] == "redistribute"]
    phases = [e["args"]["phase"] for e in evs
              if e["name"] == "redistribute.phase"]
    check_true(f"host-staged hop onto 2 ranks: span impl host, phases "
               f"{phases}", len(span) == 1
               and span[0]["args"]["impl"] == "host"
               and phases == ["host_staged"])
    check_true("host-staged hop: no bytes counted",
               counter.value == b0)
    check_true("host-staged hop traced: rows == untraced rows (bits), "
               "values == source", rows_equal(v, ref)
               and torch_equal(v.to_array(), src))
    span_us.append(span[0]["dur"])
    log(f"  [{card}] redistribute 2^{log2} f32, 4 ranks: bytes_moved "
        f"{moved_bytes} ({moved} elements); the spans' host-clock us "
        f"(collective, host-staged) {span_us}")
    del v, ref, src
    dt.final()
    return {"bytes_moved": moved_bytes, "moved_elements": moved,
            "span_us": span_us}


def export_obs(obs, path):
    """Phase 21 (c): the ring's events (those of (a) and (b)) through
    ``obs.write()``, the file read back (its non-metadata events ==
    ``obs.size()``) and read by ``tools/trace_view.py`` in a
    subprocess."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    size = obs.size()
    written = obs.write(path)
    with open(written, encoding="utf-8") as fh:
        doc = json.load(fh)
    body = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    check_true(f"export {os.path.relpath(written, HERE)}: loads, "
               f"{len(body)} events == obs.size() {size}",
               len(body) == size > 0)
    view = subprocess.run([sys.executable, os.path.join(HERE, "tools",
                                                         "trace_view.py"),
                           written], capture_output=True, text=True,
                          timeout=120)
    check_true(f"tools/trace_view.py reads it (rc {view.returncode})",
               view.returncode == 0
               and "spans by self-time" in view.stdout)
    for line in view.stdout.splitlines()[:12]:
        log(f"    {line}")
    obs.reset()
    return os.path.relpath(written, HERE)


def profiling_obs(dt, seed, card, device="cuda:0", log2=30, sort_log2=24,
                  marginal=(2, 10, 3, 0.1)):
    """Phase 21 (e): ``profiling.device_timer`` of ``dot_n`` at 2^30 on
    one rank (ms a round), and ``profiling.profile_phases`` of the sample
    sort on 4 ranks at 2^24 f32 through ``sort_phases_n``'s
    ``stop_after``.  Returns the ms and the breakdown."""
    import torch
    from dr_tpu_torch.algorithms import sort as dt_sort
    from dr_tpu_torch.utils import profiling
    dt.init([device])
    gen = torch.Generator(device=device).manual_seed(seed + 22)
    x = dt.distributed_vector.from_array(
        torch.rand(1 << log2, generator=gen, device=device))
    y = dt.distributed_vector.from_array(
        torch.rand(1 << log2, generator=gen, device=device))
    ms = 1e3 * profiling.device_timer(lambda r: float(dt.dot_n(x, y, r)),
                                      r1=4, r2=36, samples=5)
    log(f"  [{card}] profiling.device_timer(dot_n, 2^{log2}): {ms!r} ms a "
        "round")
    del x, y
    dt.final()
    dt.init(dt.get_duplicated_devices(4, [device]))
    src = torch.randn(1 << sort_log2, generator=gen, device=device)

    def make_run(i):
        v = dt.distributed_vector.from_array(src)
        phase = dt_sort.SORT_PHASES[i]

        def run(r):
            dt_sort.sort_phases_n(v, phase, r)
            dt.fence()
        return run

    r1, r2, samples, spread = marginal
    bd = profiling.profile_phases(make_run, dt_sort.SORT_PHASES, r1=r1,
                                  r2=r2, samples=samples, min_spread=spread)
    log(f"  [{card}] profiling.profile_phases(sort, 4 ranks, "
        f"2^{sort_log2} f32), dominant {bd.dominant}:")
    for line in bd.table(bytes_per_op=(1 << sort_log2) * 4).splitlines():
        log(f"  {line}")
    dt.final()
    return ms, {"seconds": bd.seconds, "total": bd.total,
                "dominant": bd.dominant}


# ------------------------------------- phase 22: resilience and guards

def chaos_inputs(seed, ranks=4, log2=CHAOS_LOG2, sort_per=CHAOS_SORT_PER,
                 ra=CHAOS_RA, gemv_log2=CHAOS_GEMV_LOG2):
    """The chaos battery's inputs, made on the host by numpy from
    ``seed`` (so the CPU tests and the card run the same data)."""
    rng = np.random.default_rng(seed)
    n, m = 1 << log2, 1 << gemv_log2
    S, h, hkv, d = ra
    bw = -(-m // ranks)
    # one nonzero a row in each column block: the ring layout's buckets
    # hold one entry a row (its gate admits the matrix)
    rows = np.repeat(np.arange(m), ranks)
    cols = np.minimum(np.tile(np.arange(ranks), m) * bw
                      + rng.integers(0, bw, ranks * m), m - 1)
    return {
        "src": rng.standard_normal(n).astype(np.float32),
        "x": rng.random(n, dtype=np.float32),
        "y": rng.random(n, dtype=np.float32),
        "sort": rng.standard_normal(ranks * sort_per).astype(np.float32),
        "a2a": rng.standard_normal((ranks, ranks, 4)).astype(np.float32),
        "coo": (m, rows, cols,
                rng.standard_normal(ranks * m).astype(np.float32)),
        "b": rng.standard_normal(m).astype(np.float32),
        "q": rng.standard_normal((1, S, h, d)).astype(np.float32),
        "kv": rng.standard_normal((2, 1, S, hkv, d)).astype(np.float32),
    }


def _plan_scale(x, c):
    return x * c


def chaos_battery(dt, inp, path, device="cuda:0", ranks=4, k_block=K_BLOCK,
                  mm_halo=MM_HALO):
    """One pass through every site the port fires, on ``ranks`` ranks of
    ``device`` (the counterpart of ``tests/test_chaos.py``'s battery):
    init -> halo exchange and reduce -> the communicator's shift and
    all-to-all -> a sort (K6) -> a scan (K4) -> ``dot_n`` (K3) -> a
    stencil block (K1) -> a ring gemv -> bf16 ring attention (K9) ->
    a deferred region (``plan.flush``, ``sanitize.verify``) -> three
    collective re-layouts -> a checkpoint write and read at ``path`` ->
    an elastic shrink of the last rank and the grow back
    (``mesh.shrink``, ``device.recover``, ``mesh.grow``).  Every
    dispatch rides the tap (``dispatch.cache``, ``device.lost``), every
    launch ``kernel.build``.  Returns the results on the host."""
    import torch
    from dr_tpu_torch.algorithms import gemv as dt_gemv
    dt.init(dt.get_duplicated_devices(ranks, [device]))
    dev = torch.device(device)
    out = {}

    def put(t):
        return torch.from_numpy(t).to(dev)

    src = put(inp["src"])
    n = src.numel()
    v = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(1, 1, periodic=True))
    h = dt.halo(v)
    h.exchange()
    h.reduce_plus()
    out["halo"] = torch.cat(v.rows).cpu()
    comm = dt.default_comm()
    out["shift"] = torch.cat(comm.shift_forward(v.rows, periodic=True)).cpu()
    out["a2a"] = torch.cat(comm.alltoall(comm.scatter(put(inp["a2a"])))).cpu()
    sv = dt.distributed_vector.from_array(put(inp["sort"]))
    dt.sort(sv)
    out["sort"] = sv.to_array().cpu()
    sc = dt.distributed_vector(n)
    dt.inclusive_scan(dt.distributed_vector.from_array(src), sc)
    out["scan"] = sc.to_array().cpu()
    x = dt.distributed_vector.from_array(put(inp["x"]))
    y = dt.distributed_vector.from_array(put(inp["y"]))
    out["dot"] = dt.dot_n(x, y, 1).reshape(1).cpu()
    del x, y, sc, sv
    a = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(mm_halo, mm_halo, periodic=True))
    dt.stencil_iterate_matmul(a, W5, k_block, k_block=k_block)
    out["stencil"] = a.to_array().cpu()
    del a
    m, rows, cols, vals = inp["coo"]
    A = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
    if not A.ensure_ring():
        raise AssertionError("chaos battery: the ring layout refused the "
                             "matrix")
    c = dt.distributed_vector(m)
    dt.fill(c, 0.0)
    dt_gemv._gemv_as(c, A, put(inp["b"]), "ring")
    out["gemv"] = c.to_array().cpu()
    del A, c
    q = put(inp["q"]).bfloat16()
    k, vv = (put(t).bfloat16() for t in inp["kv"])
    out["attention"] = dt.ring_attention(q, k, vv, causal=True).float().cpu()
    del q, k, vv
    pv = dt.distributed_vector.from_array(src)
    with dt.deferred():
        dt.for_each(pv, _plan_scale, 2.0)
        total = dt.reduce(pv)
    out["plan"] = torch.cat([pv.to_array(), total.device().reshape(1)]).cpu()
    del pv
    rdv = dt.distributed_vector.from_array(src)
    dt.redistribute(rdv, [n] + [0] * (ranks - 1))
    dt.redistribute(rdv, [1] * (ranks - 1) + [n - (ranks - 1)])
    dt.redistribute(rdv, None)
    out["redistribute"] = rdv.to_array().cpu()
    dt.checkpoint.save(path, rdv)
    out["checkpoint"] = dt.checkpoint.load(path).to_array().cpu()
    # the elastic leg, last (it shrinks the runtime): mesh.shrink fires
    # in the rescue, device.recover at the grow's probe and mesh.grow in
    # the grow; a team vector off the lost rank rides both bit for bit,
    # a vector with a segment there is lost and stays lost
    from dr_tpu_torch.utils import elastic, resilience as R
    esrc = src[:4 * ranks]
    team = dt.distributed_vector.from_array(
        esrc, distribution=[esrc.numel()] + [0] * (ranks - 1))
    gone = dt.distributed_vector.from_array(esrc)
    rep = elastic.rescue_session(R.DeviceLostError(
        "chaos battery: simulated loss", rank=ranks - 1))
    if rep.nprocs_after != ranks - 1 or dt.nprocs() != ranks - 1:
        raise AssertionError(f"chaos battery: the shrink left "
                             f"{dt.nprocs()} ranks")
    out["shrink"] = team.to_array().cpu()
    grown = elastic.grow_session(reason="chaos battery: the rank returned")
    if grown.nprocs_after != ranks or dt.nprocs() != ranks:
        raise AssertionError(f"chaos battery: the grow left {dt.nprocs()} "
                             "ranks")
    out["grow"] = team.to_array().cpu()
    for when in ("shrink", "grow"):
        try:
            dt.to_numpy(gone)
        except R.DeviceLostError:
            continue
        raise AssertionError(f"chaos battery: the lost vector answered "
                             f"after the {when}")
    return out


def same_bits(got, want) -> bool:
    """Every result of ``got`` has ``want``'s shape, dtype and bits."""
    import torch
    return got.keys() == want.keys() and all(
        got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        and torch.equal(got[k].contiguous().view(torch.uint8),
                        want[k].contiguous().view(torch.uint8))
        for k in want)


#: the serving daemon's site prefixes: phase 25.3 drives them against a
#: live daemon; the library calls of phase 22's battery never reach them
SERVE_SITES = ("serve.", "arena.")
#: the router's site prefix: phase 26.3 drives it against a live fleet
ROUTER_SITES = ("router.",)


def port_sites(faults):
    """(site, kind) of every injection the port's library fires, in table
    order (the daemon's sites: :func:`serve_sites`; the router's:
    :func:`router_sites`)."""
    return [(s, k) for s, kinds in faults.sites().items()
            if s not in faults.PORT_PENDING
            and not s.startswith(SERVE_SITES + ROUTER_SITES)
            for k in kinds]


def router_sites(faults):
    """(site, kind) of every injection the replica router fires."""
    return [(s, k) for s, kinds in faults.sites().items()
            if s not in faults.PORT_PENDING and s.startswith(ROUTER_SITES)
            for k in kinds]


def serve_sites(faults):
    """(site, kind) of every injection the serving daemon fires."""
    return [(s, k) for s, kinds in faults.sites().items()
            if s not in faults.PORT_PENDING and s.startswith(SERVE_SITES)
            for k in kinds]


def chaos_phase(dt, seed, tmpdir, device="cuda:0", deadline=CHAOS_DEADLINE,
                **sizes):
    """Phase 22.1: the battery clean, with visit counting (every fired
    site reached; ``kernel.build`` only on the card), then once for each
    (site, kind) the port fires, under ``with_deadline``: the run ends in
    a classified error raised at that site (a torn checkpoint as the
    classified corrupt file), never a hang or an unclassified traceback.
    Then a ``transient`` injected once at each site and ``retry``: the
    same bits as the clean run.  Returns the outcome of each case."""
    from dr_tpu_torch.utils import faults, resilience as R
    bat = {k: sizes.pop(k) for k in ("ranks", "k_block", "mm_halo")
           if k in sizes}
    inp = chaos_inputs(seed, **sizes)
    path = os.path.join(tmpdir, "chaos.npz")

    def run():
        return chaos_battery(dt, inp, path, device, **bat)

    t0 = time.perf_counter()
    clean = run()
    t_clean = time.perf_counter() - t0
    faults.clear()
    faults.arm_counting()
    try:
        counted = run()
        visits = faults.stats()
    finally:
        faults.clear()
    check_true("chaos battery: counting changes no bit",
               same_bits(counted, clean))
    on_card = device.startswith("cuda")
    combos = port_sites(faults)
    missing = sorted({s for s, _ in combos if not visits.get(s)}
                     - (set() if on_card else {"kernel.build"}))
    check_true(f"chaos battery visits every site the port fires "
               f"(visits {json.dumps(visits, sort_keys=True)}; missing "
               f"{missing})", not missing)
    outcomes = {}
    for site, kind in combos:
        with faults.injected(site, kind, times=1) as sp:
            try:
                got = R.with_deadline(run, deadline,
                                      site=f"chaos:{site}:{kind}",
                                      dump=False)
            except R.DeadlineExpired:
                raise AssertionError(f"chaos {site}:{kind}: a hang")
            except R.ResilienceError as e:
                outcomes[f"{site}:{kind}"] = type(e).__name__
                want = "checkpoint.read" if kind == "truncate" else site
                check_true(f"chaos {site}:{kind} -> {type(e).__name__} "
                           f"at {e.site}", e.site == want
                           and sp.fired == 1)
                continue
        if on_card or site != "kernel.build":
            raise AssertionError(f"chaos {site}:{kind} ran clean: the site "
                                 "never fired")
        # a CPU tensor takes the plain version, fault or not
        outcomes[f"{site}:{kind}"] = "plain route"
        check_true(f"chaos {site}:{kind} on the CPU: plain route, same "
                   "bits", sp.fired == 0 and same_bits(got, clean))
    t1 = time.perf_counter()
    for site in dict.fromkeys(s for s, k in combos if k == "transient"):
        if site == "kernel.build" and not on_card:
            continue
        with faults.injected(site, "transient", times=1) as sp:
            got = R.retry(run, attempts=2, sleep=lambda s: None)
        outcomes[f"{site}:transient retried"] = "same bits"
        check_true(f"chaos {site}: transient once, retried, same bits",
                   sp.fired == 1 and same_bits(got, clean))
    log(f"  chaos battery: clean {t_clean:.2f} s, {len(combos)} "
        f"(site, kind) cases, retries {time.perf_counter() - t1:.2f} s")
    dt.final()
    return outcomes


def kernel_build_faults(kernels, gen, device="cuda:0", n=1 << 20, m=2048):
    """Phase 22.2: every kernel's wrapper on CUDA tensors under an
    injected ``kernel.build`` fault of each kind: the classified error
    with site ``kernel.build``, the launch counter unmoved, no plain
    version run; then the same call unfaulted gives the clean bits."""
    import torch
    from dr_tpu_torch.ops import (flash_attention as fa, hist_pallas,
                                  reduce_pallas, scan_pallas, segred_pallas,
                                  sort_pallas, stencil2d_pallas,
                                  stencil_matmul, stencil_pallas,
                                  stencil_step)
    from dr_tpu_torch.utils import faults, resilience as R
    dev = torch.device(device)
    w2 = ((0.0, 0.25, 0.0), (0.25, 0.0, 0.25), (0.0, 0.25, 0.0))
    row1 = torch.randn((1, n + 2 * MM_HALO), generator=gen, device=dev)
    row2 = torch.randn((1, n + 2 * BLK_HALO), generator=gen, device=dev)
    x = torch.rand(n, generator=gen, device=dev)
    y = torch.rand(n, generator=gen, device=dev)
    xp = torch.randn((m + 2 * T2D, m), generator=gen, device=dev)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 1 << 14), generator=gen,
                         device=dev, dtype=torch.int32)
    ids = torch.randint(0, K8_BINS, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    cnt = torch.ones(n, device=dev, dtype=torch.int32)
    q, k, v, st = k9_operands(gen, dev, 8, 1, 256, 256, 128)
    calls = {
        "stencil_matmul": (stencil_matmul, lambda: stencil_matmul
                           .matmul_stencil_row(row1, n, MM_HALO, W5,
                                               K_BLOCK)),
        "stencil_blocked": (stencil_pallas, lambda: stencil_pallas
                            .blocked_stencil_row(row2, n, BLK_HALO, W5,
                                                 T_BLOCK)),
        "chunked_dot": (reduce_pallas, lambda: reduce_pallas.chunked_dot(
            x, y).reshape(1)),
        "chunked_cumsum": (scan_pallas, lambda: scan_pallas.chunked_cumsum(
            x)),
        "stencil2d_blocked": (stencil2d_pallas, lambda: stencil2d_pallas
                              .blocked_stencil2d_padded(xp, m, w2, T2D,
                                                        T2D)),
        "bitonic_sort": (sort_pallas, lambda: sort_pallas.sort_keys(keys)),
        "segred": (segred_pallas, lambda: segred_pallas.segmented(
            None, 1, ((ids, "max"),))[0]),
        "hist": (hist_pallas, lambda: hist_pallas.bincount(ids, cnt,
                                                           K8_BINS)),
        "flash_update": (fa, lambda: fa.flash_update(
            q, k, v, *st, 0, 0, causal=True)[2]),
        "stencil_step": (stencil_step, lambda: stencil_step.step_row(
            row2, row2, W5, BLK_HALO, n, 0, n)),
    }
    for name, (mod, call) in calls.items():
        clean = call()
        torch.cuda.synchronize()
        plain = [a for a in dir(mod) if a.startswith("plain_")]
        ran = []
        saved = {a: getattr(mod, a) for a in plain}
        for a, fn in saved.items():
            setattr(mod, a, lambda *x, _a=a, _f=fn, **kw:
                    (ran.append(_a), _f(*x, **kw))[1])
        try:
            for kind, cls in (("transient", R.TransientBackendError),
                              ("program", R.ProgramError)):
                before = dict(kernels.launches)
                with faults.injected("kernel.build", kind) as sp:
                    try:
                        call()
                        raised = None
                    except R.ResilienceError as e:
                        raised = e
                check_true(
                    f"kernel.build {kind} at {name}: "
                    f"{type(raised).__name__} at "
                    f"{getattr(raised, 'site', None)}, launches unmoved, "
                    f"plain versions run {ran}",
                    isinstance(raised, cls) and raised.site == "kernel.build"
                    and sp.fired == 1 and kernels.launches == before
                    and not ran)
        finally:
            for a, fn in saved.items():
                setattr(mod, a, fn)
        again = call()
        check_equal(f"kernel.build {name}: unfaulted call after the faults",
                    again, clean)


def step_input(n, seed, device="cuda:0"):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=gen, device=device)


def one_step(dt, src):
    """One block of each of phase 4's main-path steps on the current
    runtime's one rank, from ``src``: a K1 block, a K2 block, ``dot_n(1)``
    and a scan; the results stay on the device, fenced."""
    out = {}
    a = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(MM_HALO, MM_HALO, periodic=True))
    dt.stencil_iterate_matmul(a, W5, K_BLOCK, k_block=K_BLOCK)
    out["matmul"] = a.to_array()
    del a
    b = dt.distributed_vector.from_array(
        src, halo=dt.halo_bounds(BLK_HALO, BLK_HALO, periodic=True))
    dt.stencil_iterate_blocked(b, W5, T_BLOCK, time_block=T_BLOCK)
    out["blocked"] = b.to_array()
    del b
    x = dt.distributed_vector.from_array(src)
    out["dot_n"] = dt.dot_n(x, x, 1).reshape(1)
    s = dt.distributed_vector(len(x))
    dt.inclusive_scan(x, s)
    out["scan"] = s.to_array()
    dt.fence()
    return out


def real_oom(dt, seed, n, device="cuda:0"):
    """Phase 22.3: an allocation above the card's memory (and so above
    its free memory) comes back from ``classified`` as ``DeviceOOM``; a
    main-path step after it gives the bits of the one before it."""
    import torch
    from dr_tpu_torch.utils import resilience as R
    dt.init([device])
    src = step_input(n, seed, device)
    before = one_step(dt, src)
    release(torch)
    free, total = torch.cuda.mem_get_info()
    err = None
    try:  # above the card's memory: above what is free, whatever is cached
        torch.empty(total + (1 << 30), dtype=torch.uint8, device=device)
    except Exception as e:  # the raw error, to be classified
        err = R.classified(e, site="chip_smoke.oom")
    check_true(f"allocating {total + (1 << 30)} bytes ({free} free of "
               f"{total}) -> {type(err).__name__}: "
               f"{str(err).splitlines()[0][:120] if err else ''}",
               isinstance(err, R.DeviceOOM))
    del err
    release(torch)
    after = one_step(dt, src)
    check_true("main-path step after the OOM: the same bits as before it",
               same_bits(after, before))
    del before, after, src
    dt.final()


def dispatch_tap_checks(dt, n, seed, device="cuda:0"):
    """Phase 22.4: ``entry.dryrun(4)`` under one ``spmd_guard`` on card
    ranks and on CPU ranks records the same digest (a key holding a
    device would differ); the second main-path step inserts no key
    (``sanitize.zero_recompile``) and records the same trace as the
    first."""
    from dr_tpu_torch import entry as E
    from dr_tpu_torch.utils import sanitize, spmd_guard
    digests = {}
    for devs in ([device], ["cpu"]):
        with spmd_guard.guard() as g:
            E.dryrun(4, devs)
        digests[devs[0]] = (g.digest(), len(g.trace))
        dt.final()
    check_true(f"dryrun(4) digest on {device} ranks and cpu ranks: "
               f"{digests}", len(set(digests.values())) == 1)
    dt.init([device])
    src = step_input(n, seed, device)
    with spmd_guard.guard() as g1:
        one_step(dt, src)
    with spmd_guard.guard() as g2:
        with sanitize.zero_recompile("the second main-path step"):
            one_step(dt, src)
    del src
    check_true(f"second main-path step: no new key, the same "
               f"{len(g1.trace)} dispatches", g1.trace == g2.trace)
    dt.final()
    return {"dryrun_digest": digests[device][0],
            "dryrun_dispatches": digests[device][1],
            "step_dispatches": len(g1.trace)}


def tap_cost_us(reps=100000):
    """Host microseconds of one ``TappedCache`` lookup (a hit)."""
    from dr_tpu_torch.utils.spmd_guard import TappedCache
    c = TappedCache()
    key = ("exchange", 0, 4, 1 << 22, HALO_W, HALO_W, True, 1 << 24, None, 1)
    c.tap(key)
    t0 = time.perf_counter()
    for _ in range(reps):
        c.tap(key)
    return (time.perf_counter() - t0) / reps * 1e6


GUARD_MODES = ("nothing armed", "guard active", "tracing armed")


@contextlib.contextmanager
def guard_mode(mode):
    """Nothing armed, an active ``spmd_guard``, or ``obs`` armed."""
    from dr_tpu_torch import obs
    from dr_tpu_torch.utils import spmd_guard
    if mode == "guard active":
        with spmd_guard.guard():
            yield
    elif mode == "tracing armed":
        obs.arm(True)
        try:
            yield
        finally:
            obs.arm(False)
            obs.reset()
    else:
        yield


def in_turns(run, rounds):
    """``run()`` under each of :data:`GUARD_MODES` in turn, ``rounds``
    times; the median of each mode's readings and the readings."""
    per = {m: [] for m in GUARD_MODES}
    for _ in range(rounds):
        for m in GUARD_MODES:
            with guard_mode(m):
                per[m].append(run())
    return {m: float(np.median(v)) for m, v in per.items()}, per


def guard_costs(dt, n, seed, card, device="cuda:0", rounds=(5, 15)):
    """Phase 22.5: phase 4's step (one block of each op at ``n``), phase
    17's halo exchange (1 and 4 ranks) and one TappedCache lookup, each
    timed under the three :data:`GUARD_MODES` in turns (mode after mode,
    round after round, so drift falls on all three alike)."""
    import torch
    out = {}
    src = step_input(n, seed, device)
    dt.init([device])
    one_step(dt, src)  # warm

    def step():
        t0 = time.perf_counter()
        one_step(dt, src)
        return (time.perf_counter() - t0) * 1e3

    out["step_ms"], out["step_ms_all"] = in_turns(step, rounds[0])
    del src
    dt.final()
    release(torch)
    for ranks in (1, 4):
        dt.init(dt.get_duplicated_devices(ranks, [device]))
        v = dt.distributed_vector(ranks * HALO_CELLS, np.float32,
                                  halo=dt.halo_bounds(HALO_W, HALO_W,
                                                      periodic=True))
        dt.iota(v, 0)
        h = v.halo()
        h.exchange_n(HALO_ROUNDS)  # warm

        def batch():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(4):
                h.exchange_n(HALO_ROUNDS)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) * 1e3 / (4 * HALO_ROUNDS)

        out[f"halo_p50_us_{ranks}"], out[f"halo_us_{ranks}_all"] = \
            in_turns(batch, rounds[1])
        del v, h
        dt.final()
    out["tap_us"], out["tap_us_all"] = in_turns(tap_cost_us, 3)
    for m in GUARD_MODES:
        log(f"  [{card}] {m}: step {out['step_ms'][m]!r} ms, halo p50 "
            f"{out['halo_p50_us_1'][m]!r} / {out['halo_p50_us_4'][m]!r} us "
            f"(1 / 4 ranks), TappedCache lookup "
            f"{out['tap_us'][m]!r} us")
    release(torch)
    return out


def resilience_phase(dt, kernels, gen, seed, card):
    """Phase 22 (the counts reset just before it): the chaos battery,
    ``kernel.build`` on every wrapper, a real OOM, the dispatch tap's
    digests and the guards' cost.  Returns its numbers."""
    import tempfile
    import torch
    log("phase 22: resilience and guards: the chaos battery on 4 ranks of "
        f"cuda:0 (2^{CHAOS_LOG2} f32 vectors, the sort at 4 x "
        f"{CHAOS_SORT_PER}, bf16 ring attention S, h, hkv, d = {CHAOS_RA}, "
        f"a ring gemv of 2^{CHAOS_GEMV_LOG2} rows), kernel.build on K1-K9, "
        f"a real OOM, the dispatch tap and the guards' cost at 2^{GUARD_LOG2}")
    out = {"card": card}
    t0 = time.perf_counter()
    kernels.reset_counts()
    with tempfile.TemporaryDirectory() as td:
        out["chaos"] = chaos_phase(dt, seed, td)
    out["chaos_launches"] = dict(kernels.launches)
    log(f"  phase 22.1 {time.perf_counter() - t0:.1f} s, launches "
        f"{out['chaos_launches']}")
    for k in ("stencil_matmul", "chunked_dot", "chunked_cumsum",
              "bitonic_sort", "flash_update"):
        check_true(f"the chaos battery launched {k}",
                   out["chaos_launches"][k] > 0)
    release(torch)
    t1 = time.perf_counter()
    kernel_build_faults(kernels, gen)
    log(f"  phase 22.2 {time.perf_counter() - t1:.1f} s")
    release(torch)
    t1 = time.perf_counter()
    real_oom(dt, seed, 1 << (GUARD_LOG2 - 4))
    log(f"  phase 22.3 {time.perf_counter() - t1:.1f} s")
    release(torch)
    t1 = time.perf_counter()
    out["tap"] = dispatch_tap_checks(dt, 1 << GUARD_LOG2, seed)
    log(f"  phase 22.4 {time.perf_counter() - t1:.1f} s")
    release(torch)
    t1 = time.perf_counter()
    out["costs"] = guard_costs(dt, 1 << GUARD_LOG2, seed, card)
    log(f"  phase 22.5 {time.perf_counter() - t1:.1f} s")
    release(torch)
    log(f"  phase 22 {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------- phase 23: deferred plans

def _pl_scale(x, c):
    return x * c


def _pl_shift(x, c):
    return x + c


def plan_vectors(dt, n, halo):
    """The three vectors of the recorded main path, one halo each."""
    hb = dt.halo_bounds(halo, halo, periodic=True)
    return tuple(dt.distributed_vector(n, np.float32, halo=hb)
                 for _ in range(3))


def plan_region(dt, x, a, res, stencil):
    """The main path as one sequence of calls (recorded inside a region):
    iota and a for_each into ``x``, K4's inclusive scan of ``x`` into
    ``res``, a transform into ``a``, a halo exchange, ``stencil`` (K1
    "matmul" or K2 "blocked") on ``a``, dot(a, a) and dot_n(x, x, 1) on
    K3, which reads the rows and so flushes a recording plan.  Three
    runs: the first touches ``x`` alone, whose rows stay put, so its
    second flush captures; the stencil and the scan replace the rows of
    ``a`` and ``res``, so the runs over ``a`` run in order every time.
    Returns (dot, dot_n)."""
    dt.iota(x, 0)
    dt.for_each(x, _pl_scale, 2.0 ** -20)
    dt.inclusive_scan(x, res)
    dt.transform(x, a, _pl_shift, -0.5)
    dt.halo(a).exchange()
    if stencil == "matmul":
        dt.stencil_iterate_matmul(a, W5, K_BLOCK, k_block=K_BLOCK)
    else:
        dt.stencil_iterate_blocked(a, W5, T_BLOCK, time_block=T_BLOCK)
    d = dt.dot(a, a)
    return d, dt.dot_n(x, x, 1)


def plan_main(dt, kernels, n, ranks, stencil, halo, device="cuda:0"):
    """Phase 23.1: the recorded main path against the same calls made
    eagerly: every row and both scalars bit for bit, and the K1/K2/K3/K4
    launch counts equal, on two deferred passes (the second replays the
    runs' CUDA graphs).  Returns its numbers."""
    import torch
    dt.init(dt.get_duplicated_devices(ranks, [device]))
    x, a, res = plan_vectors(dt, n, halo)
    kernels.reset_counts()
    t0 = time.perf_counter()
    d, dn = plan_region(dt, x, a, res, stencil)
    dt.fence()
    eager_s = time.perf_counter() - t0
    want = [[r.clone() for r in v.rows] for v in (x, a, res)]
    want_counts = dict(kernels.launches)
    out = {"eager_s": eager_s, "launches": want_counts, "passes": []}
    plan = dt.plan.Plan()
    for k in range(2):
        kernels.reset_counts()
        t0 = time.perf_counter()
        with plan.record():
            pd, pdn = plan_region(dt, x, a, res, stencil)
            got_d = float(pd)
        dt.fence()
        out["passes"].append(time.perf_counter() - t0)
        counts = dict(kernels.launches)
        tag = f"23.1 {ranks} rank(s) 2^{n.bit_length() - 1} pass {k + 1}"
        for name, v, w in zip("x a res".split(), (x, a, res), want):
            check_true(f"{tag}: {name} rows bit for bit",
                       all(torch.equal(g, e) for g, e in zip(v.rows, w)))
        check_true(f"{tag}: dot {got_d!r} == eager {d!r}", got_d == d)
        check_true(f"{tag}: dot_n bit for bit", torch.equal(pdn, dn))
        check_true(f"{tag}: launches {counts} == eager {want_counts}",
                   counts == want_counts)
    for k in ("stencil_matmul" if stencil == "matmul" else
              "stencil_blocked", "chunked_dot", "chunked_cumsum"):
        check_true(f"23.1: {k} launched", want_counts[k] > 0)
    out["stats"] = plan.stats()
    check_true(f"23.1: the second pass replayed the run over x alone "
               f"({out['stats']['graph_replays']} replay)",
               out["stats"]["graph_replays"] == 1
               and out["stats"]["graph_captures"] == 1)
    log(f"  23.1 {ranks} rank(s): eager {eager_s:.3f} s, deferred "
        f"{out['passes']} s, stats {json.dumps(out['stats'])}")
    log("  " + plan.explain().replace("\n", "\n  "))
    dt.final()
    return out


def small_region(dt, a, b, iters):
    """64 x (for_each, halo exchange, transform, reduce) on ``a``, ``b``;
    returns the reductions (floats, or PlanScalars in a region)."""
    dt.iota(a, 0)
    dt.for_each(a, _pl_scale, 2.0 ** -20)
    sums = []
    for _ in range(iters):
        dt.for_each(a, _pl_scale, 1.001)
        dt.halo(a).exchange()
        dt.transform(a, b, _pl_shift, 0.5)
        sums.append(dt.reduce(b))
    return sums


def trace_launches(dt, logdir, fn):
    """(kernels on the card, kernel-launch calls, graph-launch calls, ms
    of the card's work: kernels, copies and memsets) in a
    ``profiling.trace`` of ``fn``.  A graph's copies between rows run as
    kernels; eagerly they are ``cudaMemcpyAsync`` calls."""
    import glob
    os.makedirs(logdir, exist_ok=True)
    before = set(glob.glob(os.path.join(logdir, "*.json")))
    with dt.profiling.trace(logdir):
        fn()
    [path] = set(glob.glob(os.path.join(logdir, "*.json"))) - before
    with open(path, encoding="utf-8") as f:
        evs = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in evs]
    busy = sum(e.get("dur", 0) for e in evs
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return (sum(1 for e in evs if e.get("cat") == "kernel"),
            sum(1 for x in names if x.startswith("cudaLaunchKernel")),
            sum(1 for x in names if x.startswith("cudaGraphLaunch")),
            busy / 1e3)


def plan_small(dt, card, device="cuda:0", log2=PLAN_SMALL_LOG2,
               iters=PLAN_SMALL_ITERS, turns=PLAN_TURNS, logdir=None):
    """Phase 23.2: the many-small-ops region on 4 ranks, eager and
    deferred in turns (one plan, so every flush after the second replays
    the graph captured once): host ms of each (the deferred one with its
    recording and its flush), the median of ``turns``; the card's kernel
    and launch counts of each from a profiler trace; the plan's stats.
    Every turn's sums and rows equal the first eager turn's bits."""
    import torch
    dt.init(dt.get_duplicated_devices(4, [device]))
    n = 1 << log2
    hb = dt.halo_bounds(1, 1, periodic=True)
    a = dt.distributed_vector(n, np.float32, halo=hb)
    b = dt.distributed_vector(n, np.float32, halo=hb)
    plan = dt.plan.Plan()

    def eager():
        dt.fence()
        t0 = time.perf_counter()
        sums = small_region(dt, a, b, iters)
        return (time.perf_counter() - t0) * 1e3, sums

    recording = []

    def deferred():
        dt.fence()
        t0 = time.perf_counter()
        with plan.record():
            pending = small_region(dt, a, b, iters)
            recording.append((time.perf_counter() - t0) * 1e3)
        sums = [float(s) for s in pending]
        return (time.perf_counter() - t0) * 1e3, sums

    _, want = eager()
    want_rows = [r.clone() for v in (a, b) for r in v.rows]

    def same(sums, tag):
        ok = sums == want and all(torch.equal(g, w) for g, w in zip(
            [r for v in (a, b) for r in v.rows], want_rows))
        if not ok:
            raise AssertionError(f"23.2 {tag}: not the eager bits")

    for _ in range(2):  # the in-order first flush, then the capture
        same(deferred()[1], "warm-up")
    times = {"eager": [], "deferred": []}
    for _ in range(turns):
        for name, fn in (("eager", eager), ("deferred", deferred)):
            ms, sums = fn()
            same(sums, name)
            times[name].append(ms)
    out = {"card": card, "n": n, "iters": iters,
           "eager_ms": float(np.median(times["eager"])),
           "deferred_ms": float(np.median(times["deferred"])),
           "record_ms": float(np.median(recording[2:])),
           "eager_ms_all": times["eager"],
           "deferred_ms_all": times["deferred"]}
    if logdir is not None:
        out["eager_trace"] = trace_launches(dt, os.path.join(logdir, "eager"),
                                            eager)
        out["deferred_trace"] = trace_launches(
            dt, os.path.join(logdir, "deferred"), deferred)
    out["stats"] = plan.stats()
    check_true(f"23.2: {out['stats']['graph_replays']} graph replays over "
               f"{out['stats']['flushes']} flushes under one key",
               out["stats"]["graph_replays"] >= turns
               and out["stats"]["graph_captures"] == 1)
    log(f"  [{card}] 23.2 small-op region (4 ranks, 2^{log2} f32, {iters} x "
        f"for_each/halo/transform/reduce): host ms eager "
        f"{out['eager_ms']!r} vs deferred {out['deferred_ms']!r} (medians "
        f"of {turns}; recording {out['record_ms']!r} of it); trace "
        "(kernels, cudaLaunchKernel, cudaGraphLaunch, card ms) "
        f"eager {out.get('eager_trace')} deferred "
        f"{out.get('deferred_trace')}; stats {json.dumps(out['stats'])}")
    dt.final()
    return out


def plan_scalars(dt, device="cuda:0", log2=PLAN_DTYPES_LOG2):
    """Phase 23.3: a fill + for_each flushed three times with scalars
    (1.1, 3.3) (in order, captured, replayed), then twice with (2.2,
    0.7) (in order: new values; then captured), in f32, bf16 and f16,
    against the same eager calls, bit for bit."""
    import torch
    dt.init([device])
    n = 1 << log2
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        v = dt.distributed_vector(n, dtype)
        w = dt.distributed_vector(n, dtype)
        plan = dt.plan.Plan()
        for fv, cv in ((1.1, 3.3),) * 3 + ((2.2, 0.7),) * 2:
            with plan.record():
                dt.fill(v, fv)
                dt.for_each(v, _pl_scale, cv)
            dt.fill(w, fv)
            dt.for_each(w, _pl_scale, cv)
            check_true(f"23.3 {dtype} ({fv}, {cv}) bit for bit",
                       torch.equal(v.rows[0], w.rows[0]))
        st = plan.stats()
        check_true(f"23.3 {dtype}: {st['graph_replays']} replays, "
                   f"{st['graph_captures']} captures",
                   st["graph_replays"] == 3 and st["graph_captures"] == 2)
        out[str(dtype)] = st
    dt.final()
    return out


def plan_faults(dt, seed, device="cuda:0", log2=PLAN_SMALL_LOG2):
    """Phase 23.4: ``plan.flush`` armed transient drops the queue (rows
    as before, the pending scalar raises) and a retry gives the clean
    bits; under ``DR_GPU_SANITIZE=1`` the verifier and the oracle pass on
    the recorded main path (4 ranks, K2) and a NaN a run makes raises at
    ``check_finite``."""
    import torch
    from dr_tpu_torch.plan import plansan
    from dr_tpu_torch.utils import faults, resilience as R, sanitize
    from dr_tpu_torch.utils import spmd_guard
    dt.init(dt.get_duplicated_devices(4, [device]))
    n = 1 << log2
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.randn(n, generator=gen, device=device)
    hb = dt.halo_bounds(1, 1, periodic=True)
    a = dt.distributed_vector.from_array(src, halo=hb)
    ref = dt.distributed_vector.from_array(src, halo=hb)
    dt.for_each(ref, _pl_scale, 2.0)
    dt.halo(ref).exchange()
    want = dt.reduce(ref)
    before = [r.clone() for r in a.rows]
    handles = []

    def region():
        with dt.deferred():
            dt.for_each(a, _pl_scale, 2.0)
            dt.halo(a).exchange()
            handles.append(dt.reduce(a))
        return float(handles[-1])

    out = {}
    with faults.injected("plan.flush", "transient", times=1):
        try:
            region()
            raise AssertionError("23.4: the armed plan.flush did not fire")
        except R.TransientBackendError as e:
            out["fault"] = f"{type(e).__name__} at {e.site}"
    check_true("23.4: rows as before the faulted flush",
               all(torch.equal(g, w) for g, w in zip(a.rows, before)))
    try:
        float(handles[-1])
        raise AssertionError("23.4: a dropped scalar resolved")
    except RuntimeError:
        pass
    with faults.injected("plan.flush", "transient", times=1):
        got = R.retry(region, attempts=2, sleep=lambda s: None)
    check_true(f"23.4: the retry's sum {got!r} == eager {want!r} and rows",
               got == want and all(torch.equal(g, w)
                                   for g, w in zip(a.rows, ref.rows)))
    dt.final()
    # the sanitizer, armed as DR_GPU_SANITIZE=1 arms it at import
    os.environ["DR_GPU_SANITIZE"] = "1"
    hooks = (spmd_guard._compile_hook, spmd_guard._canon_check_hook)
    try:
        check_true("23.4: the sanitizer arms", sanitize.install())
        dt.init(dt.get_duplicated_devices(4, [device]))
        x, av, res = plan_vectors(dt, 1 << 22, BLK_HALO)
        v0 = len(plansan._verified)
        with dt.deferred() as p:
            plan_region(dt, x, av, res, "blocked")
        out["verified_runs"] = len(plansan._verified) - v0
        check_true(f"23.4: verify_run passed {out['verified_runs']} run "
                   "key(s), check_serializable the queue",
                   out["verified_runs"] >= 2 and not p.log[0].get("error"))
        try:
            with dt.deferred():
                dt.for_each(x, _pl_scale, float("nan"))
            raise AssertionError("23.4: a NaN run passed check_finite")
        except sanitize.SanitizeError as e:
            out["nan"] = str(e)[:80]
        dt.final()
    finally:
        del os.environ["DR_GPU_SANITIZE"]
        sanitize._installed = False
        spmd_guard._compile_hook, spmd_guard._canon_check_hook = hooks
    return out


def plan_traced(dt, device="cuda:0"):
    """Phase 23.5: a traced region shows ``plan.flush`` > ``plan.run`` /
    ``plan.opaque`` and the plan counters."""
    from dr_tpu_torch import obs
    dt.init(dt.get_duplicated_devices(4, [device]))
    x, a, res = plan_vectors(dt, 1 << 22, BLK_HALO)
    obs.reset()
    obs.arm(True)
    try:
        plan_region(dt, x, a, res, "blocked")   # eager: no plan span
        with dt.deferred():
            plan_region(dt, x, a, res, "blocked")
        evs = obs.events()
        snap = obs.snapshot()
    finally:
        obs.arm(False)
        obs.reset()
    flush = [e for e in evs if e["name"] == "plan.flush" and e["ph"] == "X"]
    kids = [e for e in evs if e["name"] in ("plan.run", "plan.opaque")]
    check_true(f"23.5: {len(flush)} plan.flush span(s), reason "
               f"{flush[0]['args']['reason'] if flush else None}",
               len(flush) == 1 and flush[0]["args"]["reason"] == "dot_n")
    check_true(f"23.5: {len(kids)} child spans under it",
               kids and all(e["args"]["parent"] == flush[0]["id"]
                            for e in kids))
    c = snap["counters"]
    out = {k: c.get(k) for k in ("plan.flushes", "plan.fused_ops",
                                 "plan.opaque_ops")}
    check_true(f"23.5: counters {out}", out["plan.flushes"] == 1
               and out["plan.fused_ops"] == 5
               and out["plan.opaque_ops"] == 2)
    out["spans"] = [(e["name"], e["args"].get("op", e["args"].get("ops")))
                    for e in kids]
    dt.final()
    return out


def plans_phase(dt, kernels, seed, card):
    """Phase 23: deferred plans on the card.  Returns its numbers."""
    import torch
    log("phase 23: deferred plans: the main path as one recorded region "
        "(2^30 on 1 rank with K1, 2^26 on 4 ranks with K2), the small-op "
        f"region (4 ranks, 2^{PLAN_SMALL_LOG2} f32, {PLAN_SMALL_ITERS} x 4 "
        "ops), scalars in f32/bf16/f16, faults and the sanitizer, a traced "
        "region")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {"card": card}
    for key, n, ranks, stencil, halo in (
            ("main_1", 1 << 30, 1, "matmul", MM_HALO),
            ("main_4", 1 << 26, 4, "blocked", BLK_HALO)):
        t1 = time.perf_counter()
        out[key] = plan_main(dt, kernels, n, ranks, stencil, halo)
        dt.plan._plan_cache.clear()   # the graphs' pools go with them
        release(torch)
        log(f"  phase 23.1 {key}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["small"] = plan_small(dt, card, logdir=os.path.join(
        HERE, "chiprun_out", "phase23"))
    log(f"  phase 23.2: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["scalars"] = plan_scalars(dt)
    log(f"  phase 23.3: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["faults"] = plan_faults(dt, seed)
    log(f"  phase 23.4: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["traced"] = plan_traced(dt)
    log(f"  phase 23.5: {time.perf_counter() - t1:.1f} s")
    dt.plan._plan_cache.clear()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  [{card}] phase 23 peak device memory {out['peak_bytes']} bytes "
        f"({out['peak_bytes'] / 2 ** 30:.2f} GiB), "
        f"{time.perf_counter() - t0:.1f} s")
    release(torch)
    return out


# ------------------------------ phase 24: the tuning DB and elastic sessions

def _el_scale(x, c):
    return x * c


def env_set(**kw):
    """``utils.env.env_override`` of the port (None unsets)."""
    from dr_tpu_torch.utils.env import env_override
    return env_override(**kw)


def tuning_phase(dt, seed, tmpdir, device="cuda:0", m_log2=SP_LOG2,
                 join=EL_JOIN, turns=EL_SPMV_TURNS):
    """Phase 24.1: the tuning DB on the card.  ``tuning.context()`` on a
    CUDA runtime; phase 18's matrix timed in the ELL and CSR formats in
    turns (``gemv_n``, forced by ``DR_GPU_SPMV_FORMAT``), the faster
    recorded in a DB under ``tmpdir``, read back in a fresh session by
    the format picker, and a pin beating it; ``join.broadcast_max = 0``
    recorded, so a 4-rank join below the default threshold takes the
    partition route with the broadcast route's bits; ``join_auto``
    twice under ``DR_GPU_PLAN_OPT=all``, the second skipping its count
    probe (the ratio the first noted).  Returns its numbers."""
    import importlib
    import torch
    from dr_tpu_torch import obs, tuning
    from dr_tpu_torch.algorithms import relational as rel
    tg = importlib.import_module("dr_tpu_torch.algorithms.gemv")
    on_card = torch.device(device).type == "cuda"
    out = {}
    db = os.path.join(tmpdir, "tuning_db.json")
    with env_set(DR_GPU_TUNING_DB=db, DR_GPU_TUNING_DIR=None,
                 DR_GPU_SPMV_FORMAT=None, DR_GPU_JOIN_BROADCAST_MAX=None,
                 DR_GPU_PLAN_OPT=None):
        tuning.clear_session()
        tuning.reload()
        dt.init([device])
        ctx = out["context"] = tuning.context()
        log(f"  24.1 tuning.context(): {json.dumps(ctx)}")
        want_kind = (torch.cuda.get_device_name(torch.device(device).index
                                                or 0).replace(" ", "_")
                     if on_card else "cpu")
        check_true("24.1 the context names this runtime",
                   ctx == {"backend": torch.device(device).type,
                           "kind": want_kind, "nshards": 1})
        m = 1 << m_log2
        rows, cols, vals, _ = config5_coo(m)
        A = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
        del rows, cols, vals
        b = dt.distributed_vector.from_array(torch.from_numpy(
            np.random.default_rng(seed).standard_normal(m).astype(
                np.float32)).to(device))
        c = dt.distributed_vector(m)
        ms = {"ell": [], "csr": []}
        for _ in range(turns):
            for fmt in ms:
                with env_set(DR_GPU_SPMV_FORMAT=fmt):
                    check_true(f"24.1 the pin takes {fmt}",
                               tg.resolved_format(A) == fmt)
                    if on_card:
                        ms[fmt].append(marginal_ms(
                            lambda r: tg.gemv_n(c, A, b, r)))
                    else:
                        ms[fmt].append(host_ms(lambda: tg.gemv_n(c, A, b, 1),
                                               1, dt.fence))
        med = {f: float(np.median(v)) for f, v in ms.items()}
        win = min(med, key=med.get)
        lose = "csr" if win == "ell" else "ell"
        out["spmv_ms"], out["spmv_ms_all"], out["spmv_winner"] = med, ms, win
        key = tuning.record("spmv", "format", win,
                            source="chip_smoke phase 24.1")
        log(f"  24.1 gemv_n on config 5 (2^{m_log2} rows) in turns: ELL "
            f"{med['ell']!r} ms, CSR {med['csr']!r} ms a round (all "
            f"{json.dumps(ms)}); recorded {key} = {win!r}")
        tuning.reload()
        tuning.clear_session()
        check_true("24.1 the DB's winner is picked in a fresh session",
                   tg._pick_format(A) == win
                   and tg.resolved_format(A) == win)
        with env_set(DR_GPU_SPMV_FORMAT=lose):
            check_true("24.1 a DR_GPU_SPMV_FORMAT pin beats the DB",
                       tg._pick_format(A) == lose)
        del A, b, c
        release(torch)

        dt.init(dt.get_duplicated_devices(4, [device]))
        data = relational_data(1 << join[0], 1 << join[1], seed, device)
        tuning.record("join", "broadcast_max", 0,
                      source="chip_smoke phase 24.1")
        tuning.reload()
        tuning.clear_session()
        res = {}
        for forced in (False, True):
            F, FV, D, DV = (dt.distributed_vector.from_array(a)
                            for a in data)
            outs = [dt.distributed_vector(2 * (1 << join[0]))
                    for _ in range(3)]
            with contextlib.ExitStack() as st:
                if forced:
                    st.enter_context(env_set(
                        DR_GPU_JOIN_BROADCAST_MAX=str(1 << 30)))
                mm = dt.join(F, FV, D, DV, *outs)
            res[forced] = (rel.last_join_route()["impl"], mm,
                           [o.to_array()[:mm].cpu() for o in outs])
        log(f"  24.1 join of 2^{join[0]} fact rows over 2^{join[1]} keys on "
            f"4 ranks: DB route {res[False][0]}, pinned route "
            f"{res[True][0]}")
        check_true("24.1 join.broadcast_max = 0 in the DB takes the "
                   "partition route", res[False][0] == "partition"
                   and res[True][0] == "broadcast")
        check_true("24.1 partition route (from the DB) equals broadcast "
                   "(bits)", res[False][1] == res[True][1] and all(
                       torch_equal(x, y) for x, y in zip(res[False][2],
                                                         res[True][2])))
        F, FV, D, DV = (dt.distributed_vector.from_array(a) for a in data)
        runs = {"probe": [], "hint": []}
        with env_set(DR_GPU_PLAN_OPT="all"):
            dt.join_auto(F, FV, D, DV).count  # warm-up
            for _ in range(turns + 2):
                for mode in runs:
                    if mode == "probe":
                        tuning.clear_session()  # no hint: the probe runs
                    obs.reset()
                    obs.arm(True)
                    try:
                        dt.fence()
                        t0 = time.perf_counter()
                        r = dt.join_auto(F, FV, D, DV)
                        cnt = r.count
                        dt.fence()
                        secs = time.perf_counter() - t0
                        evs = obs.events()
                    finally:
                        obs.arm(False)
                        obs.reset()
                    probes = sum(1 for e in evs if e.get("args", {}).get(
                        "phase") == "cap_probe")
                    runs[mode].append((secs * 1e3, cnt, probes, [
                        torch.from_numpy(a) for a in r.arrays()]))
        med = {k: float(np.median([x[0] for x in v]))
               for k, v in runs.items()}
        out["join_auto_ms"] = med
        out["join_auto_ms_all"] = {k: [x[0] for x in v]
                                   for k, v in runs.items()}
        log(f"  24.1 join_auto (DR_GPU_PLAN_OPT=all), {turns + 2} turns: "
            f"{med['probe']!r} ms with its count probe, {med['hint']!r} ms "
            f"on the noted hint (all {json.dumps(out['join_auto_ms_all'])}; "
            f"{runs['probe'][0][1]} rows)")
        first = runs["probe"][0]
        check_true("24.1 join_auto after a noted ratio skips its probe, "
                   "same bits", all(
                       x[2] == 1 for x in runs["probe"]) and all(
                       x[2] == 0 and x[1] == first[1] == res[True][1]
                       and all(torch_equal(a, b)
                               for a, b in zip(x[3], first[3]))
                       for x in runs["hint"]))
        tuning.clear_session()
        tuning.reload()
    dt.final()
    return out


def elastic_path(dt, xs, ys, t_block=T_BLOCK, halo=BLK_HALO):
    """The 1-D path of phase 24.2: one K2 pass of ``t_block`` steps over
    a periodic halo-``halo`` copy of ``xs``, ``dot_n`` (K3) of the result
    with ``ys``, and its inclusive scan (K4); results on the host."""
    hb = dt.halo_bounds(halo, halo, periodic=True)
    x = dt.distributed_vector.from_array(xs, halo=hb)
    y = dt.distributed_vector.from_array(ys, halo=hb)  # dot_n: x's layout
    dt.stencil_iterate_blocked(x, W5, t_block, time_block=t_block)
    d = dt.dot_n(x, y, 1)
    s = dt.distributed_vector(len(x))
    dt.inclusive_scan(x, s)
    return {"stencil": x.to_array().cpu(), "dot": d.reshape(1).cpu(),
            "scan": s.to_array().cpu()}


def captured_graphs(dt, rt, n=1 << 20):
    """A deferred for_each flushed twice on ``rt``'s ranks of one card:
    the second flush captures a CUDA graph.  Returns (weak reference,
    memory pool) of each graph cached for ``rt``."""
    import weakref
    from dr_tpu_torch.core.pinning import pinned_id
    w = dt.distributed_vector(n)
    for _ in range(2):
        with dt.deferred():
            dt.for_each(w, _el_scale, 2.0)
    pid = pinned_id(rt)
    return [(weakref.ref(e.graph), e.graph.pool())
            for k, e in dt.plan._plan_cache.items()
            if k[1] == pid and e.graph is not None]


def pool_bytes(pool):
    """Bytes the caching allocator holds in the private pool ``pool``
    (None when its snapshot does not name the pools)."""
    import torch
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


def fate_line(rep, nbytes, what):
    """Log a report's wall time and each container's GB/s."""
    per = [f"{f[0]} {f[1]} {s!r} s ({nbytes / s / 1e9!r} GB/s)"
           for f, s in zip(rep.fates, rep.seconds)]
    log(f"  {what}: wall {rep.wall_s!r} s; " + "; ".join(per))
    return [{"fate": f[0], "s": s, "gbps": nbytes / s / 1e9}
            for f, s in zip(rep.fates, rep.seconds)]


def elastic_sessions(dt, kernels, seed, tmpdir, device="cuda:0",
                     log2=EL_LOG2, path_n=EL_PATH, replay_log2=EL_REPLAY_LOG2,
                     t_block=T_BLOCK, halo=BLK_HALO):
    """Phases 24.2-24.4 on 4 ranks of ``device``, in this order: the
    shrink under ``retry`` (24.2), a faulted grow and the grow (24.4.1-2),
    the mid-flush replay (24.3) and the grow by the region-exit poll
    (24.4.3), then the story (24.4.4).  Returns its numbers."""
    import torch
    from dr_tpu_torch.utils import elastic, faults, resilience as R
    on_card = torch.device(device).type == "cuda"
    out = {}
    n = 1 << log2
    nbytes = 4 * n
    g = torch.Generator(device=device).manual_seed(seed)
    team_src, ck_src, gone_src = (torch.randn(n, generator=g, device=device)
                                  for _ in range(3))
    ck_want = ck_src.clone()
    ck_want[:8] = 99.0
    # the path's bits on a fresh 3-rank runtime over the values it reads
    # after the shrink
    dt.init(dt.get_duplicated_devices(3, [device]))
    ref = elastic_path(dt, ck_want[:path_n], team_src[:path_n], t_block,
                       halo)
    rt = dt.init(dt.get_duplicated_devices(4, [device]))
    elastic.reset()
    release(torch)
    graphs = captured_graphs(dt, rt) if on_card else []
    check_true(f"24.2 a deferred run captured {len(graphs)} graph(s) on "
               "the 4-rank runtime", len(graphs) > 0 or not on_card)
    pools = [pool_bytes(p) for _w, p in graphs]
    team = dt.distributed_vector.from_array(team_src,
                                            distribution=[n, 0, 0, 0])
    ck = dt.distributed_vector.from_array(ck_src)
    t0 = time.perf_counter()
    dt.checkpoint.save(os.path.join(tmpdir, "ck.npz"), ck)
    out["save_s"] = time.perf_counter() - t0
    ck.put(np.arange(8), np.full(8, 99.0, np.float32))  # rank 0's window
    gone = dt.distributed_vector.from_array(gone_src)
    del ck_src, gone_src
    dt.fence()
    reserved = torch.cuda.memory_reserved() if on_card else 0
    before = dict(kernels.launches)
    with env_set(DR_GPU_ELASTIC="1"):
        with faults.injected("device.lost", "device_lost", times=1) as sp:
            t0 = time.perf_counter()
            got = R.retry(lambda: elastic_path(
                dt, ck.to_array()[:path_n], team.to_array()[:path_n],
                t_block, halo), attempts=2, sleep=lambda s: None)
            out["retry_s"] = time.perf_counter() - t0
    rep = elastic.last_report()
    launched = {k: kernels.launches[k] - before[k] for k in before}
    log(f"  24.2 device.lost once under retry (DR_GPU_ELASTIC=1): the path "
        f"{out['retry_s']!r} s on {dt.nprocs()} ranks, fates rescued / "
        f"restored / lost {rep.rescued} / {rep.restored} / {rep.lost}, "
        f"launches {json.dumps(launched)}")
    check_true("24.2 the path finished on 3 ranks after one injected loss",
               sp.fired == 1 and dt.nprocs() == 3 and rep.nprocs_after == 3)
    check_true("24.2 fates 1 / 1 / 1",
               (rep.rescued, rep.restored, rep.lost) == (1, 1, 1))
    check_true("24.2 rescued and restored values bit for bit",
               torch_equal(team.to_array(), team_src)
               and torch_equal(ck.to_array(), ck_want))
    try:
        dt.to_numpy(gone)
        lost_raises = False
    except R.DeviceLostError:
        lost_raises = True
    check_true("24.2 the lost vector raises DeviceLostError", lost_raises)
    check_true("24.2 K2, K3 and K4 on the shrunken runtime: the bits of a "
               "fresh 3-rank runtime", all(torch_equal(got[k], ref[k])
                                           for k in ref))
    if on_card:
        check_true("24.2 the path launched K2, K3 and K4 on 3 ranks",
                   all(launched[k] > 0 for k in ("stencil_blocked",
                                                 "chunked_dot",
                                                 "chunked_cumsum")))
    out["shrink_wall_s"] = rep.wall_s
    out["shrink_fates"] = fate_line(rep, nbytes, "24.2 shrink 4 -> 3")
    del got, ref
    release(torch)
    if on_card:
        after = [pool_bytes(p) for _w, p in graphs]
        out["reserved_before"] = reserved
        out["reserved_after"] = torch.cuda.memory_reserved()
        out["graph_pool_bytes"] = [pools, after]
        log(f"  24.2 memory reserved {reserved} bytes before the shrink, "
            f"{out['reserved_after']} after; graph pool bytes {pools} -> "
            f"{after}")
        check_true("24.2 the shrink released the 4-rank runtime's graphs",
                   all(w() is None for w, _p in graphs))
        check_true("24.2 ... and their pools", all(
            b == 0 for b in after if b is not None))
    with faults.injected("mesh.grow", "transient", times=1):
        try:
            elastic.grow_session()
            grow_fault = None
        except R.TransientBackendError as e:
            grow_fault = e.site
    check_true("24.4.2 mesh.grow injected: classified, the session stays on "
               "3 ranks with its values", grow_fault == "mesh.grow"
               and dt.nprocs() == 3 and elastic.grow_count() == 0
               and torch_equal(team.to_array(), team_src)
               and torch_equal(ck.to_array(), ck_want))
    from dr_tpu_torch.parallel import runtime as rtm
    found = rtm.probe_recovered()
    check_true(f"24.4.1 the probe finds the dropped slot on {device}: "
               f"{found}", found == [torch.device(device)])
    grep = elastic.grow_session()
    check_true("24.4.1 back on 4 ranks, the moved values bit for bit, the "
               "lost one still lost", dt.nprocs() == 4
               and (grep.moved, grep.kept) == (2, 0)
               and torch_equal(team.to_array(), team_src)
               and torch_equal(ck.to_array(), ck_want)
               and elastic.is_lost(gone))
    out["grow_wall_s"] = grep.wall_s
    out["grow_fates"] = fate_line(grep, nbytes, "24.4.1 grow 3 -> 4")
    del team, ck, gone, team_src, ck_want
    release(torch)

    nr = 1 << replay_log2
    v = dt.distributed_vector.from_array(
        torch.arange(nr, dtype=torch.float32, device=device))
    dt.checkpoint.save(os.path.join(tmpdir, "v.npz"), v)
    with env_set(DR_GPU_ELASTIC="1"):
        with faults.injected("device.lost", "device_lost", times=1) as sp:
            t0 = time.perf_counter()
            with dt.deferred() as p:
                dt.fill(v, 2.0)
                dt.for_each(v, _el_scale, 0.5)
                tot = dt.reduce(v)
            total = float(tot)
            out["replay_s"] = time.perf_counter() - t0
    e = dt.distributed_vector(nr)
    dt.fill(e, 2.0)
    dt.for_each(e, _el_scale, 0.5)
    eager = float(dt.reduce(e))
    reasons = [x["reason"] for x in p.log]
    log(f"  24.3 device.lost at the flush of a fill / for_each / reduce "
        f"region (2^{replay_log2}): {out['replay_s']!r} s, flushes "
        f"{reasons}, replayed {[x.get('elastic_replayed') for x in p.log]}")
    check_true("24.3 the replay equals the eager chain on 3 ranks",
               sp.fired == 1 and dt.nprocs() == 3 and total == eager == nr
               and rows_equal(v, e))
    check_true("24.3 the log holds the elastic replay",
               "elastic replay" in reasons
               and any(x.get("elastic_replayed") for x in p.log))
    del e
    with env_set(DR_GPU_ELASTIC_GROW="1", DR_GPU_ELASTIC_GROW_PROBE_S="0"):
        with dt.deferred():
            dt.for_each(v, _el_scale, 0.5)
    last = elastic.last_grow_report()
    check_true("24.4.3 the region exit's maybe_grow re-admitted the slot",
               dt.nprocs() == 4 and elastic.grow_count() == 2
               and last.moved == 1 and torch_equal(
                   v.to_array(), torch.full((nr,), 0.5, device=device)))
    out["poll_grow_wall_s"] = last.wall_s
    story = out["story"] = R.session_story()
    log(f"  24.4.4 session_story(): {json.dumps(story)}")
    check_true("24.4.4 the story carries both chapters",
               story["shrink"]["shrinks"] == 2
               and story["grow"]["grows"] == 2
               and story["shrink"]["rescued"] == 1
               and story["shrink"]["restored"] == 2
               and story["shrink"]["lost"] == 1)
    del v
    elastic.reset()
    dt.final()
    release(torch)
    return out


def elastic_phase(dt, kernels, seed, card):
    """Phase 24 (the counts reset just before it): the tuning DB and
    the elastic sessions on the card.  Returns its numbers."""
    import tempfile
    import torch
    log(f"phase 24: the tuning DB (config 5's SpMV at 2^{SP_LOG2} rows, a "
        f"4-rank join of 2^{EL_JOIN[0]} rows) and elastic sessions on 4 "
        f"ranks of cuda:0 (f32 vectors of 2^{EL_LOG2}; the path at "
        f"{EL_PATH}; the replay at 2^{EL_REPLAY_LOG2})")
    out = {"card": card}
    t0 = time.perf_counter()
    kernels.reset_counts()
    with tempfile.TemporaryDirectory() as td:
        t1 = time.perf_counter()
        out["tuning"] = tuning_phase(dt, seed, td)
        log(f"  phase 24.1 {time.perf_counter() - t1:.1f} s")
        release(torch)
        t1 = time.perf_counter()
        out["elastic"] = elastic_sessions(dt, kernels, seed, td)
        log(f"  phases 24.2-24.4 {time.perf_counter() - t1:.1f} s")
    log(f"  [{card}] phase 24 {time.perf_counter() - t0:.1f} s, launches "
        f"{dict(kernels.launches)}")
    return out


# -------------------------------------------- phase 25: the serving daemon

#: the request mix of one tenant in phase 25.1 (op, count): 64 requests
#: over the tenant's two residents ``a`` and ``b`` and its inline
#: operands
SV_MIX = (("dot", 12), ("reduce", 11), ("histogram", 10), ("topk", 10),
          ("scan", 2), ("sort", 1), ("sort_k6", 3), ("scale", 4),
          ("fill", 2), ("groupby_sum", 2), ("groupby_min", 2),
          ("groupby_min_k7", 1), ("unique", 2), ("join", 2))
#: the ops whose reply is one kernel on the same rows in a fixed order:
#: bit-identical to the direct call (top_k by its values)
SV_FIXED = ("dot", "reduce", "histogram", "topk", "scan", "sort")


def sv_inputs(seed, t, res_log2, inline_log2, k6_n, device):
    """Tenant ``t``'s data, from the seed: residents ``a``, ``b`` of
    2^res_log2 f32 normals (drawn on ``device``, read back to the
    host); inline operands of 2^inline_log2 rows (a vector, fact keys
    with 16 rows a key and their values, a dimension table of one row a
    key), ``k6_n`` keys for K6's sort and a groupby of ``k6_n`` rows,
    a size K7 takes."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed * 1000 + t)
    rng = np.random.default_rng([seed, 25, t])
    n, m = 1 << res_log2, 1 << inline_log2
    nk = max(1, m >> 4)
    return {"a": torch.randn(n, generator=gen, device=device).cpu().numpy(),
            "b": torch.randn(n, generator=gen, device=device).cpu().numpy(),
            "x": rng.standard_normal(m, dtype=np.float32),
            "keys": rng.integers(0, nk, m).astype(np.float32),
            "vals": rng.standard_normal(m, dtype=np.float32),
            "dk": rng.permutation(nk).astype(np.float32),
            "dv": rng.standard_normal(nk, dtype=np.float32),
            "k6": rng.standard_normal(k6_n, dtype=np.float32),
            "gk": rng.integers(0, max(1, k6_n >> 4), k6_n)
            .astype(np.float32),
            "gv": rng.standard_normal(k6_n, dtype=np.float32)}


def sv_request(c, ref, op, inp, bins, k):
    """One request of the mix through client ``c`` (``ref``: its Ref)."""
    if op == "dot":
        return c.dot(ref("a"), ref("b"))
    if op == "reduce":
        return c.reduce(ref("a"))
    if op == "histogram":
        return c.histogram(ref("a"), bins, -4.0, 4.0)
    if op == "topk":
        return c.top_k(ref("a"), k)
    if op == "scan":
        return c.scan(ref("a"))
    if op == "sort":
        return c.sort(ref("b"))
    if op == "sort_k6":
        return c.sort(inp["k6"])
    if op == "scale":
        return c.scale(inp["x"], a=1.5, b=-0.5)
    if op == "fill":
        return c.fill(len(inp["x"]), 0.25)
    if op in ("groupby_sum", "groupby_min"):
        return c.groupby(inp["keys"], inp["vals"], agg=op[8:])
    if op == "groupby_min_k7":
        return c.groupby(inp["gk"], inp["gv"], agg="min")
    if op == "unique":
        return c.unique(inp["keys"])
    if op == "join":
        return c.join(inp["keys"], inp["vals"], inp["dk"], inp["dv"])
    raise ValueError(op)


def sv_direct(dt, op, inp, ra, rb, bins, k):
    """The port's direct call for ``op`` on the same containers (the
    residents ``ra``, ``rb``) or the same inputs: what the reply must
    equal."""
    from dr_tpu_torch.serve.daemon import _op_scale
    f32, vec = np.float32, dt.distributed_vector
    if op == "dot":
        return float(dt.dot(ra, rb))
    if op == "reduce":
        return float(dt.reduce(ra))
    if op == "histogram":
        out = vec(bins, np.int32)
        dt.histogram(ra, out, -4.0, 4.0)
        return dt.to_numpy(out)
    if op == "topk":
        tv, ti = vec(k, f32), vec(k, np.int32)
        dt.top_k(ra, tv, ti)
        return [dt.to_numpy(tv), dt.to_numpy(ti)]
    if op == "scan":
        out = vec(len(ra), f32)
        dt.inclusive_scan(ra, out)
        return dt.to_numpy(out)
    if op == "sort":
        s = vec(len(rb), rb.dtype)
        dt.copy(rb, s)
        dt.sort(s)
        return dt.to_numpy(s)
    if op == "sort_k6":
        v = vec.from_array(inp["k6"])
        dt.sort(v)
        return dt.to_numpy(v)
    if op == "scale":
        v = vec.from_array(inp["x"])
        dt.for_each(v, _op_scale, 1.5, -0.5)
        return dt.to_numpy(v)
    if op == "fill":
        v = vec(len(inp["x"]), f32)
        dt.fill(v, 0.25)
        return dt.to_numpy(v)
    if op in ("groupby_sum", "groupby_min", "groupby_min_k7"):
        small = op == "groupby_min_k7"
        kk = vec.from_array(inp["gk" if small else "keys"])
        vv = vec.from_array(inp["gv" if small else "vals"])
        ok, ov = vec(len(kk), f32), vec(len(kk), f32)
        m = int(dt.groupby_aggregate(kk, vv, ok, ov,
                                     agg="min" if small else op[8:]))
        return [dt.to_numpy(ok)[:m], dt.to_numpy(ov)[:m]]
    if op == "unique":
        v = vec.from_array(inp["keys"])
        out = vec(len(v), f32)
        m = int(dt.unique(v, out))
        return dt.to_numpy(out)[:m]
    if op == "join":
        lk, lv = vec.from_array(inp["keys"]), vec.from_array(inp["vals"])
        rk, rv = vec.from_array(inp["dk"]), vec.from_array(inp["dv"])
        cap = 4 * (len(lk) + len(rk))
        ok, ol, orr = vec(cap, f32), vec(cap, f32), vec(cap, f32)
        m = int(dt.join(lk, lv, rk, rv, ok, ol, orr))
        return [dt.to_numpy(ok)[:m], dt.to_numpy(ol)[:m],
                dt.to_numpy(orr)[:m]]
    raise ValueError(op)


def sv_same(got, want) -> bool:
    """Bit for bit: scalars, arrays and lists of arrays (top_k by its
    values, and its indices pointing at them)."""
    if isinstance(want, float):
        return isinstance(got, float) and \
            np.float32(got).view(np.int32) == np.float32(want).view(np.int32)
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    return len(got) == len(want) and all(
        np.asarray(g).dtype == np.asarray(w).dtype
        and np.asarray(g).shape == np.asarray(w).shape
        and np.array_equal(np.asarray(g).view(np.uint8),
                           np.asarray(w).view(np.uint8))
        for g, w in zip(got, want))


def pct(xs, q):
    """The ``q``-th percentile of ``xs`` (nearest rank), or None."""
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))]


def sv_shm_bytes():
    """The size of ``/dev/shm`` (0 without one)."""
    import shutil
    try:
        return shutil.disk_usage("/dev/shm").total
    except OSError:
        return 0


def serve_one_rank(dt, kernels, seed, state_dir, device="cuda:0",
                   tenants=8, res_log2=25, reqs=SV_MIX, inline_log2=20,
                   k6_n=1 << 14, bins=1024, k=1024):
    """Phase 25.1: an in-process daemon on one rank of ``device``, 8
    tenants each with two residents put over the wire and one client
    thread sending the mix in a seeded order.  Every reply against the
    direct call on the same containers (or inputs), the kernels' launch
    counts against the counts the direct calls make, per-op client
    latency, the daemon's histograms.  Returns ``(server, numbers,
    inputs)``; the server is still serving."""
    import threading
    import torch
    from dr_tpu_torch import serve
    from dr_tpu_torch.obs import metrics as om
    on_card = device.startswith("cuda")
    dt.init([device])
    shm = sv_shm_bytes()
    res_bytes = tenants * 2 * 4 << res_log2
    arena = min(1 << 31, (shm // 2) & ~((1 << 20) - 1))
    env = {"DR_GPU_SERVE_RESIDENT_BYTES": str(res_bytes + (1 << 30)),
           "DR_GPU_SERVE_ARENA": "1" if arena >= 1 << 20 else "0",
           "DR_GPU_SERVE_ARENA_BYTES": str(max(arena, 1 << 20))}
    log(f"  25.1 /dev/shm {shm} bytes; arena "
        f"{env['DR_GPU_SERVE_ARENA_BYTES'] if arena >= 1 << 20 else 'off'}"
        f" bytes; residents {tenants} x 2 x 2^{res_log2} f32 = "
        f"{res_bytes} bytes")
    t0 = time.perf_counter()
    inputs = [sv_inputs(seed, t, res_log2, inline_log2, k6_n, device)
              for t in range(tenants)]
    log(f"  25.1 inputs {time.perf_counter() - t0:.1f} s; the journal in "
        f"{os.path.join(state_dir, 'state')}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with env_set(**env):
        srv = serve.Server(os.path.join(state_dir, "d.sock"),
                           cpu=not on_card, batch_window=0.002,
                           state_dir=os.path.join(state_dir, "state"))
        srv.start()
    check_true(f"25.1 claim: the runtime on {device} kept "
               f"({srv.stats()['route']})",
               dt.nprocs() == 1 and srv.devices == [torch.device(device)])
    clients = [serve.Client(srv.path, timeout=300.0, tenant=f"t{t}",
                            arena=True) for t in range(tenants)]
    t0 = time.perf_counter()
    ok = True
    for t, c in enumerate(clients):
        for name in ("a", "b"):
            r = c.put(name, inputs[t][name])
            ok = ok and r["bytes"] == inputs[t][name].nbytes \
                and not r["cached"]
    put_s = time.perf_counter() - t0
    check_true(f"25.1 {2 * tenants} residents put, none cached", ok)
    log(f"  25.1 {2 * tenants} puts over the wire {put_s:.2f} s "
        f"({res_bytes / put_s / 1e9:.3f} GB/s)")
    # the direct calls on the same containers, with their launches: the
    # daemon is idle, so the main thread may use the card
    want, per = {}, {}
    t0 = time.perf_counter()
    for t in range(tenants):
        ra = srv._resident.get(f"t{t}", "a").cont
        rb = srv._resident.get(f"t{t}", "b").cont
        for op, _n in reqs:
            kernels.reset_counts()
            want[t, op] = sv_direct(dt, op, inputs[t], ra, rb, bins, k)
            if on_card:
                torch.cuda.synchronize()
            per[t, op] = dict(kernels.launches)
    log(f"  25.1 direct calls {time.perf_counter() - t0:.1f} s")
    implied = {name: sum(per[t, op][name] * n for t in range(tenants)
                         for op, n in reqs) for name in kernels.COUNTERS}
    plan = [[op for op, n in reqs for _ in range(n)]
            for _t in range(tenants)]
    for t, p in enumerate(plan):
        np.random.default_rng([seed, 251, t]).shuffle(p)
    lat = {op: [] for op, _n in reqs}
    bad, errs = [], []
    lock = threading.Lock()

    def client(t):
        c = clients[t]
        try:
            for op in plan[t]:
                t1 = time.perf_counter()
                got = sv_request(c, serve.Ref, op, inputs[t], bins, k)
                ms = (time.perf_counter() - t1) * 1e3
                ok = sv_same(got, want[t, op])
                with lock:
                    lat[op].append(ms)
                    if not ok:
                        bad.append((t, op))
        except Exception as e:  # reported below, never swallowed
            with lock:
                errs.append(f"t{t}: {type(e).__name__}: {e}")

    om.reset()  # the daemon's histograms and counters: this run's alone
    st0 = srv.stats()
    kernels.reset_counts()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(tenants)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    st = srv.stats()
    nreq = sum(len(p) for p in plan)
    check_true(f"25.1 every client got every answer ({errs[:3]})",
               not errs and sum(len(v) for v in lat.values()) == nreq)
    check_true(f"25.1 every reply equals the direct call bit for bit "
               f"(mismatches {sorted(set(bad))[:8]})", not bad)
    for name in kernels.COUNTERS:
        if implied[name] or launched[name]:
            check_true(f"25.1 {name} launches {launched[name]} == "
                       f"{implied[name]} the mix implies",
                       launched[name] == implied[name])
    if on_card:
        for name in ("chunked_dot", "chunked_cumsum", "bitonic_sort",
                     "segred", "hist"):
            check_true(f"25.1 {name} launched from the daemon",
                       launched[name] > 0)
    hists = st["obs"]["histograms"]
    counters = st["obs"].get("counters", {})
    out = {"requests": nreq, "wall_s": wall, "req_per_s": nreq / wall,
           "put_s": put_s, "launches": launched, "implied": implied,
           "ops": {op: {"n": len(v), "p50_ms": pct(v, 50),
                        "p99_ms": pct(v, 99)} for op, v in lat.items()},
           "daemon": {h: {q: hists.get(h, {}).get(q)
                          for q in ("count", "p50", "p95", "p99", "max")}
                      for h in ("serve.queue_wait_ms", "serve.service_ms",
                                "serve.flush_ms")},
           "batch_hw": st["batch_hw"], "flushes": st["flushes"] -
           st0["flushes"], "errors": st["errors"] - st0["errors"],
           "plan": {k_: st["plan"][k_] - st0["plan"][k_]
                    for k_ in st["plan"]},
           "resident_hits": counters.get("serve.resident.hits", 0),
           "shm_bytes": shm, "arena_fallbacks": st["arena_fallbacks"]}
    ar = st.get("arena")
    if ar is not None and (ar["allocs"] or
                           counters.get("serve.arena.maps", 0)):
        out["arena"] = {"size": ar["size"], "allocs": ar["allocs"],
                        "high_water": ar["high_water"],
                        "exhaustions": ar["exhaustions"],
                        "mapped_bytes": counters.get(
                            "serve.arena.mapped_bytes", 0),
                        "maps": counters.get("serve.arena.maps", 0)}
        carried = "the arena (and the inline wire past its room)"
    else:
        carried = "the inline wire"
    out["carried_by"] = carried
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    for op, v in out["ops"].items():
        log(f"  25.1 {op}: {v['n']} requests, client p50 "
            f"{v['p50_ms']!r} ms, p99 {v['p99_ms']!r} ms")
    log(f"  25.1 {nreq} requests in {wall:.3f} s = "
        f"{out['req_per_s']!r} requests/s; bytes carried by {carried}")
    log(f"  25.1 daemon {json.dumps(out['daemon'])}; batch high-water "
        f"{out['batch_hw']}; flushes {out['flushes']}; plan "
        f"{json.dumps(out['plan'])}; resident hits "
        f"{out['resident_hits']}; arena "
        f"{json.dumps(out.get('arena'))}; fallbacks "
        f"{out['arena_fallbacks']}; peak device memory "
        f"{out.get('peak_bytes')} bytes")
    log(f"  25.1 launches {json.dumps(launched)}")
    for c in clients:
        c.close()
    return srv, out, inputs


def sv_probe(site, kind, path, serve, faults, x, big):
    """One (site, kind) injected once against the live daemon at
    ``path``: the call that reaches the site, and its outcome, which must
    be a classified error or the right answer."""
    from dr_tpu_torch.utils import resilience as R
    with faults.injected(site, kind, times=1) as sp:
        try:
            if site == "serve.accept":
                with serve.Client(path, timeout=60.0) as c:
                    got = c.scale(x, a=2.0)
            elif site == "serve.drain":
                with serve.Client(path, timeout=60.0) as c:
                    c.drain()
                got = None  # a drain that went through: not expected
            elif site == "serve.journal":
                with serve.Client(path, timeout=60.0) as c:
                    c.put("chaos", x)
                    got = c.get("chaos") * 2.0
            elif site == "arena.release":
                with serve.Client(path, timeout=60.0, arena=True) as c:
                    c.scale(big, a=1.0)  # its reply slot is owed back
                    got = c.scale(x, a=2.0)
            elif site == "arena.map":
                with serve.Client(path, timeout=60.0, arena=True) as c:
                    got = c.scale(big, a=2.0)[:len(x)]
            else:
                with serve.Client(path, timeout=60.0) as c:
                    got = c.scale(x, a=2.0)
            outcome = "correct" if got is not None and np.array_equal(
                got, x * np.float32(2.0)) else "WRONG"
        except R.ResilienceError as e:
            outcome = f"{type(e).__name__}@{e.site}"
        fired = sp.fired
    with serve.Client(path, timeout=60.0) as c:  # the daemon serves on
        alive = np.array_equal(c.scale(x, a=3.0), x * np.float32(3.0))
    return outcome, fired, alive


def serve_chaos(srv, serve, faults, chip_sites):
    """Phase 25.3 (chaos): each ``serve.*`` / ``arena.*`` (site, kind),
    once, against the live daemon: a classified error or the right
    answer, and the daemon serving on after it."""
    x = np.arange(1 << 12, dtype=np.float32)
    big = np.arange(1 << 16, dtype=np.float32)
    out = {}
    for site, kind in chip_sites:
        outcome, fired, alive = sv_probe(site, kind, srv.path, serve,
                                         faults, x, big)
        out[f"{site}:{kind}"] = outcome
        check_true(f"25.3 chaos {site}:{kind} -> {outcome} (fired "
                   f"{fired}); the daemon serves on",
                   outcome != "WRONG" and alive
                   and not srv.draining())
    return out


def serve_restart(dt, srv, inputs, serve, state_dir, device="cuda:0"):
    """Phase 25.3 (lifecycle): ``drain`` the daemon of 25.1, start a new
    one on the same state directory: its journal brings every resident
    back bit-equal.  Returns the replay's seconds and GB/s."""
    with serve.Client(srv.path, timeout=120.0) as c:
        check_true("25.3 drain acknowledged",
                   c.drain().get("draining") is True)
    check_true("25.3 the drained daemon stopped",
               srv._stopped.wait(120.0))
    nbytes = sum(inputs[t][n].nbytes for t in range(len(inputs))
                 for n in ("a", "b"))
    t0 = time.perf_counter()
    # the resident budget of 25.1's daemon, or the replay evicts
    with env_set(DR_GPU_SERVE_RESIDENT_BYTES=str(srv._resident.budget)):
        srv2 = serve.Server(srv.path, cpu=not device.startswith("cuda"),
                            state_dir=os.path.join(state_dir, "state"))
        srv2.start()
    replay_s = time.perf_counter() - t0
    try:
        same = all(np.array_equal(
            dt.to_numpy(srv2._resident.get(f"t{t}", n).cont).view(
                np.int32), inputs[t][n].view(np.int32))
            for t in range(len(inputs)) for n in ("a", "b"))
        st = srv2.stats()["journal"]
        with serve.Client(srv2.path, timeout=120.0, tenant="t0") as c:
            wire = np.array_equal(c.get("a").view(np.int32),
                                  inputs[0]["a"].view(np.int32))
        check_true(f"25.3 restart on the same state dir: "
                   f"{st['replayed']} residents replayed, the "
                   f"{2 * len(inputs)} of 25.1 bit-equal (one read back "
                   "over the wire)", same and wire)
    finally:
        srv2.stop()
    gbs = nbytes / replay_s / 1e9
    log(f"  25.3 replay: {nbytes} bytes in {replay_s:.3f} s = "
        f"{gbs!r} GB/s (start, journal read, decode, rebuild)")
    return {"replay_s": replay_s, "replay_gb_s": gbs,
            "replayed": st["replayed"]}


def serve_subprocess(state_dir, cpu=False):
    """Phase 25.3 (entry point): ``python -m dr_tpu_torch.serve --socket
    P`` on the device route answers a ``scale``, then exits 0 on
    ``shutdown``."""
    from dr_tpu_torch import serve
    path = os.path.join(state_dir, "sub.sock")
    env = dict(os.environ)
    env.pop("DR_GPU_FAULT_SPEC", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dr_tpu_torch.serve", "--socket", path]
        + (["--cpu"] if cpu else []), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=HERE)
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        ready = json.loads(line) if line.strip() else {}
        if ready.get("serving") != path:
            proc.kill()
            err = proc.communicate(timeout=30)[1]
            raise AssertionError(f"25.3 subprocess daemon did not start: "
                                 f"{line.strip()} {err[-2000:]}")
        log(f"  25.3 subprocess daemon ready: {line.strip()}")
        x = np.arange(1 << 16, dtype=np.float32)
        with serve.Client(path, timeout=120.0) as c:
            got = c.scale(x, a=2.0, b=1.0)
            route = c.route()
            c.shutdown()
        rc = proc.wait(timeout=120)
        check_true(f"25.3 subprocess: scale right on the {route} route, "
                   f"exit {rc} after shutdown",
                   np.array_equal(got, x * np.float32(2.0) + np.float32(1.0))
                   and rc == 0 and route["current"] ==
                   ("cpu" if cpu else "device"))
        return {"seconds": time.perf_counter() - t0, "route": route}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def sv4_inputs(seed, log2):
    rng = np.random.default_rng([seed, 252])
    n = 1 << log2
    return {"x": rng.standard_normal(n, dtype=np.float32),
            "y": rng.standard_normal(n, dtype=np.float32)}


#: phase 25.2's requests: one fused batch of batchable ops
SV4_OPS = ("dot", "reduce", "scan", "histogram", "topk", "scale")


def sv4_request(c, op, inp):
    x, y = inp["x"], inp["y"]
    if op == "dot":
        return c.dot(x, y)
    if op == "reduce":
        return c.reduce(x)
    if op == "scan":
        return c.scan(x)
    if op == "histogram":
        return c.histogram(x, 1024, -4.0, 4.0)
    if op == "topk":
        return c.top_k(x, 1024)
    return c.scale(x, a=1.5, b=-0.5)


def sv4_direct(dt, op, inp):
    """The same op, eagerly, on fresh containers of the runtime."""
    vec = dt.distributed_vector
    if op == "dot":
        return sv_direct(dt, "dot", None, vec.from_array(inp["x"]),
                         vec.from_array(inp["y"]), 1024, 1024)
    if op == "scale":
        return sv_direct(dt, "scale", inp, None, None, 1024, 1024)
    return sv_direct(dt, op, None, vec.from_array(inp["x"]), None, 1024,
                     1024)


def serve_four_ranks(dt, seed, state_dir, device="cuda:0", log2=22):
    """Phase 25.2: a daemon on 4 ranks of one card (``init`` before the
    claim), ``DR_GPU_ELASTIC=1``, a device loss injected in the middle
    of a held batch of six clients' requests: every client gets its
    answer with the bits a fresh 3-rank runtime gives, ``shrinks == 1``
    and the story's serve chapter set; then, with the grow armed, the
    mesh grows back between batches and the answers take the fresh
    4-rank runtime's bits again."""
    import threading
    from dr_tpu_torch import serve
    from dr_tpu_torch.utils import elastic, faults
    inp = sv4_inputs(seed, log2)
    want = {}
    for p in (3, 4):
        dt.init([device] * p)
        want[p] = {op: sv4_direct(dt, op, inp) for op in SV4_OPS}
    dt.init([device] * 4)
    elastic.reset()
    out = {}
    with env_set(DR_GPU_ELASTIC="1"):
        srv = serve.Server(os.path.join(state_dir, "d4.sock"),
                           cpu=not device.startswith("cuda"),
                           batch_window=0.0).start()
        try:
            check_true("25.2 claim: the 4-rank runtime kept",
                       dt.nprocs() == 4)
            srv.hold()
            got, errs = {}, []

            def client(op):
                try:
                    with serve.Client(srv.path, timeout=300.0,
                                      tenant=op) as c:
                        got[op] = sv4_request(c, op, inp)
                except Exception as e:
                    errs.append(f"{op}: {type(e).__name__}: {e}")

            threads = [threading.Thread(target=client, args=(op,))
                       for op in SV4_OPS]
            for th in threads:
                th.start()
            deadline = time.monotonic() + 60.0
            while len(srv._queue) < len(SV4_OPS) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            faults.inject("device.lost", "device_lost", times=1)
            t0 = time.perf_counter()
            srv.release()
            for th in threads:
                th.join()
            out["loss_batch_s"] = time.perf_counter() - t0
            faults.clear()
            st = srv.stats()
            story = dt.resilience.session_story() or {}
            check_true(f"25.2 every client answered across the loss "
                       f"({errs})", not errs and len(got) == len(SV4_OPS))
            check_true(f"25.2 shrinks {st['shrinks']} == 1, "
                       f"{dt.nprocs()} ranks, batch of {st['batch_hw']}",
                       st["shrinks"] == 1 and dt.nprocs() == 3)
            check_true("25.2 the story's serve chapter: "
                       f"{story.get('serve')}",
                       (story.get("serve") or {}).get("reason", "")
                       .startswith("serve: device loss"))
            for op in SV4_OPS:
                check_true(f"25.2 {op} after the loss: a fresh 3-rank "
                           "runtime's bits", sv_same(got[op], want[3][op]))
            with env_set(DR_GPU_ELASTIC_GROW="1",
                         DR_GPU_ELASTIC_GROW_PROBE_S="0.01"):
                t0 = time.perf_counter()
                with serve.Client(srv.path, timeout=300.0) as c:
                    while time.perf_counter() - t0 < 60.0:
                        r = sv4_request(c, "reduce", inp)
                        if c.stats()["grows"]:
                            break
                        time.sleep(0.02)
                    out["grow_s"] = time.perf_counter() - t0
                    st = c.stats()
                    after = {op: sv4_request(c, op, inp) for op in SV4_OPS}
            check_true(f"25.2 grew back between batches: grows "
                       f"{st['grows']}, {dt.nprocs()} ranks, degraded "
                       f"{st['degraded']!r}", st["grows"] == 1
                       and dt.nprocs() == 4 and st["degraded"] is None)
            for op in SV4_OPS:
                check_true(f"25.2 {op} after the grow: a fresh 4-rank "
                           "runtime's bits",
                           sv_same(after[op], want[4][op]))
            out["story"] = story
        finally:
            faults.clear()
            srv.stop()
            serve.reset()
            elastic.reset()
    log(f"  25.2 loss batch {out['loss_batch_s']:.3f} s, grow back "
        f"{out['grow_s']:.3f} s")
    return out


def serve_phase(dt, kernels, seed, card, device="cuda:0", **sizes):
    """Phase 25 (the counts reset just before each part): the serving
    daemon on the card.  25.1 on one rank at full size, 25.3 chaos and
    lifecycle against it, then 25.2 on 4 ranks.  Returns its numbers."""
    import tempfile
    import torch
    from dr_tpu_torch import serve
    from dr_tpu_torch.utils import faults
    log("phase 25: the serving daemon: 8 tenants x 2 residents of 2^25 "
        "f32 (2 GiB) on one rank, 64 requests a tenant from 8 client "
        "threads; chaos, drain and journal restart, the entry point; 4 "
        "ranks with a device loss and the grow back")
    out = {"card": card}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        srv, out["one_rank"], inputs = serve_one_rank(
            dt, kernels, seed, td, device=device, **sizes)
        log(f"  phase 25.1 {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        try:
            out["chaos"] = serve_chaos(srv, serve, faults,
                                       serve_sites(faults))
            out["restart"] = serve_restart(dt, srv, inputs, serve, td,
                                           device=device)
        finally:
            srv.stop()
            serve.reset()
        del inputs
        release(torch)
        out["subprocess"] = serve_subprocess(
            td, cpu=not device.startswith("cuda"))
        log(f"  phase 25.3 {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        out["four_ranks"] = serve_four_ranks(dt, seed, td, device=device)
        log(f"  phase 25.2 {time.perf_counter() - t1:.1f} s")
    dt.final()
    release(torch)
    log(f"  [{card}] phase 25 {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------- phase 26: the replica router

#: the mix's ops with no resident operand: the traffic of a rolling
#: restart, which a tenant may ride onto a replica without its residents
SV_INLINE = ("sort_k6", "scale", "fill", "groupby_sum", "groupby_min",
             "groupby_min_k7", "unique", "join")
#: the class each injected kind raises
KIND_CLASS = {"transient": "TransientBackendError",
              "program": "ProgramError"}


def fleet_env(tenants, res_log2, replicas):
    """``(resident bytes, env)`` of a fleet: each replica's resident
    budget holds every tenant's residents (the ring may home them all on
    one), and its arena takes its share of half of ``/dev/shm``."""
    shm = sv_shm_bytes()
    res_bytes = tenants * 2 * 4 << res_log2
    arena = min(1 << 31, (shm // (2 * replicas)) & ~((1 << 20) - 1))
    return res_bytes, {
        "DR_GPU_SERVE_RESIDENT_BYTES": str(res_bytes + (1 << 30)),
        "DR_GPU_SERVE_ARENA": "1" if arena >= 1 << 20 else "0",
        "DR_GPU_SERVE_ARENA_BYTES": str(max(arena, 1 << 20))}


def fleet_orders(seed, tenants, reqs, salt):
    """Each tenant's requests of ``reqs`` in a seeded order."""
    orders = {}
    for t in range(tenants):
        orders[t] = [op for op, n in reqs for _ in range(n)]
        np.random.default_rng([seed, salt, t]).shuffle(orders[t])
    return orders


def proc_cpu_s(pid):
    """CPU seconds (user + system) process ``pid`` has used so far."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def cpu_share(run, pids=()):
    """``run()``, and the CPU seconds over wall seconds it took in this
    process and in each of ``pids``: how near one core each came."""
    c0, p0 = time.process_time(), [proc_cpu_s(p) for p in pids]
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    return out, {"clients": (time.process_time() - c0) / wall,
                 "replicas": [(proc_cpu_s(p) - a) / wall
                              for p, a in zip(pids, p0)]}


#: what a spawned replica pays before it serves, step by step
_SPAWN_COST = """
import json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device={device!r})
torch.cuda.synchronize() if {device!r}.startswith("cuda") else None
t2 = time.perf_counter()
sys.path.insert(0, {here!r})
import dr_tpu_torch as dt
t3 = time.perf_counter()
dt.init([{device!r}])
t4 = time.perf_counter()
print(json.dumps({{"import_torch_s": t1 - t0, "device_context_s": t2 - t1,
                  "import_dr_tpu_torch_s": t3 - t2, "init_s": t4 - t3}}))
"""


def spawn_cost(device):
    """A fresh interpreter's steps to a claimed rank, in seconds (the
    part of a replica's start that is not the daemon's own)."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", _SPAWN_COST.format(device=device, here=HERE)],
        capture_output=True, text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    got["process_s"] = time.perf_counter() - t0
    return got


def fleet_traffic(rcs, orders, inputs, want, serve, bins, k):
    """One thread a tenant of ``orders`` sends its requests through its
    ``RouterClient``; every reply against ``want``.  Returns ``(wall
    seconds, requests, mismatches, errors)``."""
    import threading
    bad, errs, lock = [], [], threading.Lock()

    def client(t):
        try:
            for op in orders[t]:
                got = sv_request(rcs[t], serve.Ref, op, inputs[t], bins, k)
                if not sv_same(got, want[t, op]):
                    with lock:
                        bad.append((t, op))
        except Exception as e:  # reported by the caller, never swallowed
            with lock:
                errs.append(f"t{t}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(t,)) for t in orders]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return (time.perf_counter() - t0, sum(len(o) for o in orders.values()),
            sorted(set(bad)), errs)


def fleet_homes(paths, home):
    """The tenants each replica homes, by replica path."""
    return {p: [t for t, h in enumerate(home) if h == p] for p in paths}


def fleet_one_rank(dt, kernels, seed, state_dir, card, device="cuda:0",
                   replicas=3, tenants=12, res_log2=25, reqs=SV_MIX,
                   inline_log2=20, k6_n=1 << 14, bins=1024, k=1024):
    """Phase 26.1: a ``Router`` of in-process replicas on one rank of
    ``device``; each tenant puts two residents through its
    ``RouterClient`` and one thread a tenant sends the mix in a seeded
    order.  Every reply against the direct call on the same containers,
    each tenant's residents on its ring's replica alone, the launch
    counts against the counts the direct calls make.  Returns ``(fleet,
    clients, inputs, want, numbers)``; the fleet is still serving."""
    import torch
    from dr_tpu_torch import serve
    from dr_tpu_torch.obs import metrics as om
    on_card = device.startswith("cuda")
    dt.init([device])
    res_bytes, env = fleet_env(tenants, res_log2, replicas)
    log(f"  26.1 {replicas} in-process replicas on one rank of {device}; "
        f"residents {tenants} x 2 x 2^{res_log2} f32 = {res_bytes} bytes; "
        f"arena {env['DR_GPU_SERVE_ARENA_BYTES']} bytes a replica")
    t0 = time.perf_counter()
    inputs = [sv_inputs(seed, t, res_log2, inline_log2, k6_n, device)
              for t in range(tenants)]
    log(f"  [{card}] 26.1 inputs {time.perf_counter() - t0:.1f} s")
    with env_set(**env):
        fleet = serve.Router(os.path.join(state_dir, "f"), replicas,
                             cpu=not on_card, batch_window=0.002).start()
    servers = {s.path: s for s in fleet._servers}
    check_true(f"26.1 claim: {replicas} replicas on the runtime of "
               f"{device}", dt.nprocs() == 1 and all(
                   s.devices == [torch.device(device)]
                   and s.stats()["route"]["current"] ==
                   ("cpu" if not on_card else "device")
                   for s in servers.values()))
    rcs = [serve.RouterClient(fleet.paths(), tenant=f"t{t}", timeout=300.0,
                              arena=True) for t in range(tenants)]
    home = [rc.route() for rc in rcs]
    homes = fleet_homes(fleet.paths(), home)
    log("  26.1 tenants by replica: " + json.dumps(
        {os.path.basename(p): ts for p, ts in homes.items()}))
    t0 = time.perf_counter()
    ok = True
    for t, rc in enumerate(rcs):
        for name in ("a", "b"):
            r = rc.put(name, inputs[t][name])
            ok = ok and r["bytes"] == inputs[t][name].nbytes \
                and not r["cached"]
    put_s = time.perf_counter() - t0
    check_true(f"26.1 {2 * tenants} residents put, none cached", ok)
    st = rcs[0].stats()
    check_true("26.1 each tenant's residents on its ring's replica alone "
               "(stats: " + json.dumps(
                   {os.path.basename(p): st[p]["resident"]["entries"]
                    for p in fleet.paths()}) + ")",
               all(st[p]["resident"]["entries"] == 2 * len(homes[p])
                   for p in fleet.paths())
               and all((servers[p]._resident.get(f"t{t}", n) is not None)
                       == (home[t] == p) for p in fleet.paths()
                       for t in range(tenants) for n in ("a", "b")))
    log(f"  [{card}] 26.1 {2 * tenants} puts {put_s:.2f} s "
        f"({res_bytes / put_s / 1e9:.3f} GB/s)")
    # the direct calls on the same containers, with their launches: the
    # fleet is idle, so the main thread may use the card
    want, per = {}, {}
    t0 = time.perf_counter()
    for t in range(tenants):
        srv = servers[home[t]]
        ra = srv._resident.get(f"t{t}", "a").cont
        rb = srv._resident.get(f"t{t}", "b").cont
        for op, _n in reqs:
            kernels.reset_counts()
            want[t, op] = sv_direct(dt, op, inputs[t], ra, rb, bins, k)
            if on_card:
                torch.cuda.synchronize()
            per[t, op] = dict(kernels.launches)
    log(f"  [{card}] 26.1 direct calls {time.perf_counter() - t0:.1f} s")
    implied = {name: sum(per[t, op][name] * n for t in range(tenants)
                         for op, n in reqs) for name in kernels.COUNTERS}
    orders = fleet_orders(seed, tenants, reqs, 261)
    om.reset()
    st0 = {p: s.stats() for p, s in servers.items()}
    kernels.reset_counts()
    (wall, nreq, bad, errs), cpu = cpu_share(lambda: fleet_traffic(
        rcs, orders, inputs, want, serve, bins, k))
    launched = dict(kernels.launches)
    st1 = {p: s.stats() for p, s in servers.items()}
    check_true(f"26.1 every client got every answer ({errs[:3]})",
               not errs)
    check_true(f"26.1 every reply equals the direct call bit for bit "
               f"(mismatches {bad[:8]})", not bad)
    for name in kernels.COUNTERS:
        if implied[name] or launched[name]:
            check_true(f"26.1 {name} launches {launched[name]} == "
                       f"{implied[name]} the mix implies",
                       launched[name] == implied[name])
    if on_card:
        for name in ("chunked_dot", "chunked_cumsum", "bitonic_sort",
                     "segred", "hist"):
            check_true(f"26.1 {name} launched from the fleet",
                       launched[name] > 0)
    per_replica = {os.path.basename(p): {
        "tenants": len(homes[p]),
        "requests": st1[p]["requests"] - st0[p]["requests"],
        "flushes": st1[p]["flushes"] - st0[p]["flushes"],
        "batch_hw": st1[p]["batch_hw"],
        "plan": {q: st1[p]["plan"][q] - st0[p]["plan"][q]
                 for q in st1[p]["plan"]}} for p in fleet.paths()}
    out = {"requests": nreq, "wall_s": wall, "req_per_s": nreq / wall,
           "cpu_share": cpu["clients"], "put_s": put_s,
           "launches": launched, "implied": implied,
           "replicas": per_replica}
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  [{card}] 26.1 {nreq} requests in {wall:.3f} s = "
        f"{out['req_per_s']!r} requests/s through {replicas} in-process "
        f"replicas, the process at {cpu['clients']!r} cores; per replica "
        f"{json.dumps(per_replica)}")
    log(f"  26.1 launches {json.dumps(launched)}")
    return fleet, rcs, inputs, want, out


def probe_notes(obs, path):
    """The classes of the probes of ``path`` that failed classified, from
    the ``serve.note`` events the router recorded."""
    pat = re.compile(rf"probe of {re.escape(path)} failed classified "
                     r"\((\w+)\)")
    return [m.group(1) for e in obs.events() if e.get("name") == "serve.note"
            for m in [pat.search(str(e.get("args", {}).get("msg", "")))]
            if m]


def fleet_chaos(fleet, rcs, inputs, want, serve, faults, sites):
    """Phase 26.3: each ``router.*`` (site, kind) once against the fleet
    of 26.1.  ``router.route``: the lookup fails classified at its site
    before any replica is touched, and a retried transient answers with
    the direct call's bits.  ``router.probe``: a replica stopped and
    restarted, the tenant re-hashed; the faulted half-open probe fails
    classified at its site, the replica stays out and the request is
    answered right by a survivor; the next probe re-admits it."""
    from dr_tpu_torch import obs
    from dr_tpu_torch.utils import resilience as R
    out = {}
    t = 0
    rc = rcs[t]
    ref = serve.Ref
    for site, kind in sites:
        if site != "router.route":
            continue
        with faults.injected(site, kind, times=1) as sp:
            try:
                rc.reduce(ref("a"))
                outcome = "answered"
            except R.ResilienceError as e:
                outcome = f"{type(e).__name__}@{e.site}"
            fired = sp.fired
        out[f"{site}:{kind}"] = outcome
        check_true(f"26.3 chaos {site}:{kind} -> {outcome} (fired {fired})",
                   outcome == f"{KIND_CLASS[kind]}@{site}" and fired == 1)
        if kind == "transient":
            with faults.injected(site, kind, times=1) as sp:
                got = R.retry(lambda: rc.reduce(ref("a")), attempts=2,
                              base=0.01, seed=0)
                fired = sp.fired
            check_true(f"26.3 {site}:{kind} retried: the direct call's "
                       f"bits (fired {fired})",
                       sv_same(got, want[t, "reduce"]) and fired == 1)
    probe = [k_ for s_, k_ in sites if s_ == "router.probe"]
    if not probe:
        return out
    path = rc.route()
    vi = fleet.paths().index(path)
    was = obs.armed()
    obs.arm(True)
    try:
        with env_set(DR_GPU_SERVE_PROBE_S="0.0"):
            fleet._servers[vi].stop()  # abrupt: no drain
            check_true("26.3 the stopped replica's tenant re-hashed, "
                       "answered right",
                       sv_same(rc.scale(inputs[t]["x"], a=1.5, b=-0.5),
                               want[t, "scale"]) and rc.rehashes == 1
                       and path not in rc.live_replicas())
            fleet.restart_replica(vi)
            for kind in probe:
                obs.reset()
                with faults.injected("router.probe", kind, times=1) as sp:
                    got = rc.scale(inputs[t]["x"], a=1.5, b=-0.5)
                    fired = sp.fired
                seen = probe_notes(obs, path)
                outcome = (f"{seen[0]}@router.probe" if seen
                           else "not classified")
                out[f"router.probe:{kind}"] = outcome
                check_true(f"26.3 chaos router.probe:{kind} -> {outcome} "
                           f"(fired {fired}); the replica stays out, a "
                           "survivor answers right",
                           outcome == f"{KIND_CLASS[kind]}@router.probe"
                           and fired == 1 and path not in
                           rc.live_replicas()
                           and sv_same(got, want[t, "scale"]))
            got = rc.scale(inputs[t]["x"], a=1.5, b=-0.5)
            check_true("26.3 the next probe re-admits the replica; the "
                       "tenant re-hashes back and answers right",
                       path in rc.live_replicas() and rc.route() == path
                       and rc.recoveries == 1
                       and sv_same(got, want[t, "scale"]))
    finally:
        obs.arm(was)
    return out


def fleet_spawned(dt, inputs, want, seed, state_dir, card, device="cuda:0",
                  replicas=3, res_log2=25, reqs=SV_MIX, bins=1024, k=1024,
                  **_sizes):
    """Phase 26.2: ``replicas`` spawned daemons on one state directory,
    serving the tenants of 26.1's ``inputs`` (``want``: 26.1's direct
    calls).  Puts and one round of the mix (every replica on the
    requested route), the mix of one replica's tenants through that
    replica alone, a SIGKILL of the replica homing the most tenants with
    its re-hash, lost ``Ref`` and re-put, ``poll()``'s respawn replaying
    its journal and the probe re-admitting it, then
    ``rolling_restart()`` under one client thread a tenant.  ``_sizes``:
    the rest of 26.1's sizes, which ``inputs`` already fixes."""
    import signal
    import threading
    from dr_tpu_torch import serve
    from dr_tpu_torch.utils import resilience as R
    on_card = device.startswith("cuda")
    route = "device" if on_card else "cpu"
    tenants = len(inputs)
    dt.init([device])
    res_bytes, env = fleet_env(tenants, res_log2, replicas)
    log(f"  26.2 {replicas} spawned replicas (python -m dr_tpu_torch.serve"
        f"{'' if on_card else ' --cpu'}), one state directory; residents "
        f"{tenants} x 2 x 2^{res_log2} f32 = {res_bytes} bytes")
    out = {}
    ref = serve.Ref
    env["DR_GPU_SERVE_PROBE_S"] = "0.1"
    with env_set(**env):
        t0 = time.perf_counter()
        fleet = serve.Router(os.path.join(state_dir, "s"), replicas,
                             cpu=not on_card, spawn=True,
                             state_dir=os.path.join(state_dir, "state26"))
        fleet.start()
        out["start_s"] = time.perf_counter() - t0
        rcs = []
        try:
            routes = []
            for p in fleet.paths():
                with serve.Client(p, timeout=60.0) as c:
                    routes.append(c.route())
            check_true(f"26.2 every replica serves on the {route} route "
                       f"({routes})", all(r == {"requested": route,
                                                "current": route}
                                          for r in routes))
            log(f"  [{card}] 26.2 {replicas} replicas started in "
                f"{out['start_s']:.2f} s")
            rcs = [serve.RouterClient(fleet.paths(), tenant=f"t{t}",
                                      timeout=300.0, arena=True)
                   for t in range(tenants)]
            home = [rc.route() for rc in rcs]
            homes = fleet_homes(fleet.paths(), home)
            log("  26.2 tenants by replica: " + json.dumps(
                {os.path.basename(p): ts for p, ts in homes.items()}))
            t0 = time.perf_counter()
            bad_puts = []

            def put(t):
                for name in ("a", "b"):
                    r = rcs[t].put(name, inputs[t][name])
                    if r["bytes"] != inputs[t][name].nbytes or r["cached"]:
                        bad_puts.append((t, name))

            threads = [threading.Thread(target=put, args=(t,))
                       for t in range(tenants)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            out["put_s"] = time.perf_counter() - t0
            check_true(f"26.2 {2 * tenants} residents put from {tenants} "
                       f"threads, none cached ({bad_puts[:3]})",
                       not bad_puts and sum(
                           s["resident"]["entries"]
                           for s in rcs[0].stats().values()) == 2 * tenants)
            log(f"  [{card}] 26.2 puts {out['put_s']:.2f} s "
                f"({res_bytes / out['put_s'] / 1e9:.3f} GB/s)")
            orders = fleet_orders(seed, tenants, reqs, 262)
            pids = [proc.pid for proc in fleet._procs]
            (wall, nreq, bad, errs), cpu = cpu_share(
                lambda: fleet_traffic(rcs, orders, inputs, want, serve,
                                      bins, k), pids)
            check_true(f"26.2 one round of the mix through {replicas} "
                       f"replicas: every reply right ({bad[:4]}, "
                       f"{errs[:2]})", not bad and not errs)
            out["rate_all"] = {"replicas": replicas, "requests": nreq,
                               "wall_s": wall, "req_per_s": nreq / wall,
                               "cpu_share": cpu}
            victim = max(fleet.paths(), key=lambda p: len(homes[p]))
            vi = fleet.paths().index(victim)
            lost = homes[victim]
            (wall1, n1, bad, errs), cpu1 = cpu_share(
                lambda: fleet_traffic(rcs, {t: orders[t] for t in lost},
                                      inputs, want, serve, bins, k),
                [pids[vi]])
            check_true(f"26.2 the mix of the {len(lost)} tenants of "
                       f"{os.path.basename(victim)} through it alone: "
                       f"every reply right", not bad and not errs)
            out["rate_one"] = {"replicas": 1, "tenants": len(lost),
                               "requests": n1, "wall_s": wall1,
                               "req_per_s": n1 / wall1, "cpu_share": cpu1}
            log(f"  [{card}] 26.2 requests/s: {nreq / wall!r} through "
                f"{replicas} spawned replicas ({nreq} requests, {tenants} "
                f"tenants) vs {n1 / wall1!r} through 1 ({n1} requests, its "
                f"{len(lost)} tenants), ratio "
                f"{(nreq / wall) / (n1 / wall1)!r}; cores busy (clients' "
                f"process, replicas): {json.dumps(cpu)} vs "
                f"{json.dumps(cpu1)}")
            # SIGKILL: the replica homing the most tenants
            fleet._procs[vi].send_signal(signal.SIGKILL)
            fleet._procs[vi].wait(timeout=30)
            t_kill = time.perf_counter()
            seen = {}
            for t in lost:
                try:
                    rcs[t].reduce(ref("a"))
                    seen[t] = "answered"
                except R.ResilienceError as e:
                    seen[t] = f"{type(e).__name__}@{e.site}"
            story = (dt.resilience.session_story() or {}).get("serve") or {}
            check_true(f"26.2 SIGKILL of {os.path.basename(victim)}: its "
                       f"{len(lost)} tenants re-hashed (breakers open, a Ref "
                       f"to a lost resident {sorted(set(seen.values()))}); "
                       f"the story: router_dead {story.get('router_dead')}, "
                       f"{story.get('router_reason')!r}",
                       all(rcs[t].rehashes == 1 and victim not in
                           rcs[t].live_replicas() and
                           rcs[t].breaker_states()[victim] == "open"
                           and rcs[t].route() != victim
                           and seen[t] == "ProgramError@serve.request"
                           for t in lost)
                       and story.get("router_dead", 0) >= len(lost)
                       and "re-hashed" in (story.get("router_reason") or ""))
            ok = True
            for t in lost:
                for name in ("a", "b"):
                    rcs[t].put(name, inputs[t][name])
                for op in ("dot", "reduce", "histogram", "topk"):
                    ok = ok and sv_same(sv_request(rcs[t], ref, op,
                                                   inputs[t], bins, k),
                                        want[t, op])
            check_true("26.2 re-put residents on the survivors answer "
                       "right", ok)
            # the respawn: the supervisor's poll, then a probe re-admits
            while True:
                t0 = time.perf_counter()
                back = fleet.poll()
                if back:
                    break
                if time.perf_counter() - t_kill > 120.0:
                    raise AssertionError("26.2 no respawn within 120 s")
                time.sleep(0.02)
            out["respawn_s"] = time.perf_counter() - t0
            deadline = time.monotonic() + 60.0
            while any(victim not in rcs[t].live_replicas() for t in lost) \
                    and time.monotonic() < deadline:
                for t in lost:
                    rcs[t].scale(inputs[t]["x"], a=1.5, b=-0.5)
                time.sleep(0.01)
            out["kill_to_readmitted_s"] = time.perf_counter() - t_kill
            ok = all(rcs[t].route() == victim and rcs[t].recoveries == 1
                     for t in lost)
            for t in lost:
                for op in ("dot", "reduce", "histogram", "topk"):
                    ok = ok and sv_same(sv_request(rcs[t], ref, op,
                                                   inputs[t], bins, k),
                                        want[t, op])
            with serve.Client(victim, timeout=300.0, tenant=f"t{lost[0]}",
                              arena=True) as c:
                ok = ok and np.array_equal(
                    c.get("a").view(np.int32),
                    inputs[lost[0]]["a"].view(np.int32))
                replayed = c.stats().get("journal", {}).get("replayed")
            story = (dt.resilience.session_story() or {}).get("serve") or {}
            check_true(f"26.2 respawned by poll() ({back}), {replayed} "
                       f"residents replayed from the journal, re-admitted by "
                       f"a probe; its tenants re-hashed back and read their "
                       f"residents bit for bit; story respawns "
                       f"{story.get('respawns')}, recovered "
                       f"{story.get('router_recovered')}",
                       ok and back == [victim] and
                       fleet.stats()["respawns"] == 1 and
                       story.get("respawns", 0) >= 1)
            log(f"  [{card}] 26.2 respawn (spawn, claim, journal replay "
                f"of {replayed} residents) {out['respawn_s']!r} s; SIGKILL "
                f"to re-admitted {out['kill_to_readmitted_s']!r} s")
            out["spawn_cost"] = spawn_cost(device)
            log(f"  [{card}] 26.2 a fresh interpreter to a claimed rank: "
                f"{json.dumps(out['spawn_cost'])}")
            # the rolling restart under one client thread a tenant
            done = threading.Event()
            lock = threading.Lock()
            tally = {"requests": 0, "bad": [], "errors": []}

            def traffic(t):
                i = 0
                while not done.is_set():
                    op = SV_INLINE[(t + i) % len(SV_INLINE)]
                    i += 1
                    try:
                        got = sv_request(rcs[t], ref, op, inputs[t], bins, k)
                        right = sv_same(got, want[t, op])
                        with lock:
                            tally["requests"] += 1
                            if not right:
                                tally["bad"].append((t, op))
                    except Exception as e:
                        with lock:
                            tally["errors"].append(
                                f"t{t} {op}: {type(e).__name__}: {e}")

            threads = [threading.Thread(target=traffic, args=(t,))
                       for t in range(tenants)]
            for th in threads:
                th.start()
            try:
                time.sleep(0.2)
                t0 = time.perf_counter()
                restarted = fleet.rolling_restart()
                out["rolling_restart_s"] = time.perf_counter() - t0
                time.sleep(0.2)
            finally:
                done.set()
                for th in threads:
                    th.join(timeout=300.0)
            check_true(f"26.2 rolling_restart of {len(restarted)} replicas "
                       f"under {tenants} client threads: "
                       f"{tally['requests']} requests, classified errors "
                       f"{tally['errors'][:3]}, wrong "
                       f"{tally['bad'][:3]}", len(restarted) == replicas
                       and not tally["errors"] and not tally["bad"]
                       and tally["requests"] > 0)
            deadline = time.monotonic() + 60.0
            while any(len(rc.live_replicas()) < replicas for rc in rcs) \
                    and time.monotonic() < deadline:
                for t, rc in enumerate(rcs):
                    rc.scale(inputs[t]["x"], a=1.5, b=-0.5)
                time.sleep(0.01)
            ok = all(len(rc.live_replicas()) == replicas for rc in rcs)
            for t, rc in enumerate(rcs):
                for op in ("dot", "reduce"):
                    ok = ok and sv_same(sv_request(rc, ref, op, inputs[t],
                                                   bins, k), want[t, op])
            check_true("26.2 after the roll every breaker closed again and "
                       "every tenant's residents (journal-replayed) answer "
                       "right", ok)
            out["rolling_requests"] = tally["requests"]
            log(f"  [{card}] 26.2 rolling restart {out['rolling_restart_s']!r}"
                f" s, {tally['requests']} requests answered right during it")
        finally:
            for rc in rcs:
                rc.close()
            fleet.stop()
            serve.reset()
    return out


#: phase 26's residents: cut from 2^25 (3 GiB over 12 tenants) to keep
#: the phase near its 120 s budget, most of which the spawned replicas'
#: starts and journal replays take
ROUTER_RES_LOG2 = 24


def router_phase(dt, kernels, seed, card, device="cuda:0", **sizes):
    """Phase 26 (the counts reset just before each part): the replica
    router on the card.  26.1 in process, 26.3 the router's fault sites
    against it, then 26.2 spawned, over the same tenants.  Returns its
    numbers."""
    import tempfile
    import torch
    from dr_tpu_torch import serve
    from dr_tpu_torch.utils import faults
    sizes.setdefault("res_log2", ROUTER_RES_LOG2)
    log(f"phase 26: the replica router: 3 in-process replicas on one rank, "
        f"12 tenants x 2 residents of 2^{sizes['res_log2']} f32, 64 "
        f"requests a tenant from 12 client threads; the router's fault "
        f"sites; 3 spawned replicas: SIGKILL, respawn, journal, rolling "
        f"restart")
    if sizes["res_log2"] < 25:
        log(f"  phase 26 residents cut from 2^25 to 2^{sizes['res_log2']} "
            f"f32 to keep the phase near its 120 s budget")
    out = {"card": card}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        fleet, rcs, inputs, want, out["in_process"] = fleet_one_rank(
            dt, kernels, seed, td, card, device=device, **sizes)
        log(f"  [{card}] phase 26.1 {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        try:
            out["chaos"] = fleet_chaos(fleet, rcs, inputs, want, serve,
                                       faults, router_sites(faults))
        finally:
            for rc in rcs:
                rc.close()
            fleet.stop()
            serve.reset()
        log(f"  [{card}] phase 26.3 {time.perf_counter() - t1:.1f} s")
        release(torch)
        t1 = time.perf_counter()
        out["spawned"] = fleet_spawned(dt, inputs, want, seed, td, card,
                                       device=device, **sizes)
        log(f"  [{card}] phase 26.2 {time.perf_counter() - t1:.1f} s")
    dt.final()
    release(torch)
    out["seconds"] = time.perf_counter() - t0
    log(f"  [{card}] phase 26 {out['seconds']:.1f} s")
    return out


# ------------------------------------------------ phase 27: the C++ bridge

#: phase 27.2: the parity driver's input (2^28 f32, 1 GiB: phase 9's sort
#: size), its windowed sorts (2^14 keys: K6's geometry on one rank) and
#: its runs (results from the last, each call's least host time)
BRIDGE_LOG2, BRIDGE_WINDOW, BRIDGE_REPS = 28, 1 << 14, 3
#: the statement the bridge programs run after each timed call, and the
#: one that prints the child's launch counts
BRIDGE_SYNC = "import dr_tpu_torch as _dt; _dt.fence()"
BRIDGE_COUNTS = ("import json\nfrom dr_tpu_torch.ops import kernels\n"
                 "print('launches ' + json.dumps(kernels.launches), "
                 "flush=True)\n")
_U64 = (1 << 64) - 1


def _s64(c):
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(z, k):
    """Logical right shift of an int64 tensor."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def bridge_digest(t, chunk=1 << 26):
    """``bridge_parity``'s digest of a result's f64 bytes, computed on
    the tensor's device in int64 (wrapping as uint64 does): the sum over
    i of a splitmix64 finaliser of bits(t[i]) + (i + 1) * golden."""
    import torch
    t = t.reshape(-1)
    h = 0
    for s in range(0, t.numel(), chunk):
        w = t[s:s + chunk].to(torch.float64).contiguous().view(torch.int64)
        i = torch.arange(s + 1, s + 1 + w.numel(), dtype=torch.int64,
                         device=w.device)
        z = w + i * _s64(0x9E3779B97F4A7C15)
        z = (z ^ _lsr(z, 30)) * _s64(0xBF58476D1CE4E5B9)
        z = (z ^ _lsr(z, 27)) * _s64(0x94D049BB133111EB)
        h = (h + int((z ^ _lsr(z, 31)).sum())) & _U64
    return f"{t.numel()} {h:016x}"


def mt19937_64(seed, count):
    """The first ``count`` draws of C++'s ``std::mt19937_64(seed)``
    (uint64), the twist vectorised in three slices."""
    n, m, a = 312, 156, np.uint64(0xB5026F5AA96619E9)
    upper, lower = np.uint64(0xFFFFFFFF80000000), np.uint64(0x7FFFFFFF)
    state = [seed & _U64]
    for i in range(1, n):
        prev = state[-1]
        state.append((6364136223846793005 * (prev ^ (prev >> 62)) + i)
                     & _U64)
    mt = np.array(state, dtype=np.uint64)
    one = np.uint64(1)

    def mix(hi, lo):
        x = (hi & upper) | (lo & lower)
        return (x >> one) ^ np.where(x & one, a, np.uint64(0))

    out = []
    for _ in range(-(-count // n)):
        mt[:n - m] = mt[m:] ^ mix(mt[:n - m], mt[1:n - m + 1])
        mt[n - m:n - 1] = mt[:m - 1] ^ mix(mt[n - m:n - 1], mt[n - m + 1:])
        mt[n - 1] = mt[m - 1] ^ mix(mt[n - 1:], mt[:1])[0]
        y = mt.copy()
        y ^= (y >> np.uint64(29)) & np.uint64(0x5555555555555555)
        y ^= (y << np.uint64(17)) & np.uint64(0x71D67FFFEDA60000)
        y ^= (y << np.uint64(37)) & np.uint64(0xFFF7EEE000000000)
        y ^= y >> np.uint64(43)
        out.append(y)
    return np.concatenate(out)[:count]


class _Draws:
    """``bridge_parity``'s draws: ``std::mt19937_64(seed)`` in order."""

    def __init__(self, seed, count=1 << 17):
        self.g, self.k = mt19937_64(seed, count), 0

    def take(self, k):
        self.k += k
        return self.g[self.k - k:self.k]

    def uniform(self, k, lo, hi):
        # lo + (hi - lo) * (double)(g >> 11) * 2^-53, in C++'s order
        u = (self.take(k) >> np.uint64(11)).astype(np.float64)
        return lo + (hi - lo) * u * 2.0 ** -53


def parity_direct(dt, ckpt, seed=1, window=0, reps=1, sync=None):
    """``bridge_parity``'s sequence made directly from Python, with the
    same arguments (Python floats where the bridge passes doubles, the
    same DSL strings); returns ({name: digest} of the last run, {call:
    least host ms over the runs})."""
    import torch
    from dr_tpu_torch.utils.expr import op_from_expr as E
    f32 = np.float32
    times = {}
    for rep in range(reps):
        last = rep == reps - 1
        digests = {}

        def tm(name, fn):
            t0 = time.perf_counter()
            r = fn()
            ms = (time.perf_counter() - t0) * 1e3
            if sync is not None:
                sync()
            times[name] = min(ms, times.get(name, ms))
            return r

        def emit(name, c):
            """Digest a container (on the last run only), or a list
            of scalars."""
            if not last:
                return
            if isinstance(c, list):
                t = torch.tensor(c, dtype=torch.float64)
            elif hasattr(c, "to_array"):
                t = c.to_array()
            else:
                t = torch.from_numpy(np.ascontiguousarray(c.materialize()))
            digests[name] = bridge_digest(t)

        def vec(n, **kw):
            return dt.distributed_vector(n, dtype=kw.pop("dtype", f32), **kw)

        def copy_of(x):
            c = vec(len(x))
            dt.transform(x, c, E("x0", 1))
            return c

        x = tm("load_vector", lambda: dt.checkpoint.load(ckpt))
        n = len(x)
        w = window or min(n // 4, 1 << 14)
        tm("to_host", lambda: np.asarray(dt.to_numpy(x), dtype=np.float64))
        emit("input", x)

        y, z = vec(n), vec(n)
        tm("transform", lambda: dt.transform(x, y, E("((x0 * 0.5) - 1.25)",
                                                      1)))
        emit("transform", y)
        d = tm("dot", lambda: dt.dot(x, y))
        emit("dot", [d])
        tm("transform2", lambda: dt.transform(
            dt.views.zip(x, y), z, E("((maximum(x0, x1) * 2) - x1)", 2)))
        emit("transform2", z)
        tm("for_each", lambda: dt.for_each(
            z, E("(sqrt(abs(x0)) + (x0 * 0.25))", 1)))
        emit("for_each", z)
        tr = tm("transform_reduce", lambda: dt.transform_reduce(
            x, transform_op=E("(x0 * x0)", 1)))
        emit("transform_reduce", [tr])

        sc = vec(n)
        tm("inclusive_scan", lambda: dt.inclusive_scan(x, sc))
        emit("inclusive_scan", sc)
        tm("exclusive_scan", lambda: dt.exclusive_scan(x, sc, 0.5))
        emit("exclusive_scan", sc)
        ln = n // 2
        dt.fill(sc, -1.0)
        tm("inclusive_scan_window", lambda: dt.inclusive_scan(
            x[n // 4 + 3:n // 4 + 3 + ln], sc[7:7 + ln]))
        emit("inclusive_scan_window", sc)
        tm("exclusive_scan_window", lambda: dt.exclusive_scan(
            x[5:5 + ln], sc[n // 3:n // 3 + ln], -2.0))
        emit("exclusive_scan_window", sc)
        del sc

        t = copy_of(x)
        tm("sort", lambda: dt.sort(t, descending=False))
        emit("sort", t)
        a = tm("is_sorted", lambda: dt.is_sorted(t))
        emit("is_sorted", [float(a), float(dt.is_sorted(x))])
        t = copy_of(x)
        tm("sort_desc", lambda: dt.sort(t, descending=True))
        emit("sort_desc", t)
        lo1, lo2 = n // 8 + 3, n // 2 + 5
        t = copy_of(x)
        tm("sort_window", lambda: dt.sort(t[lo1:lo1 + w], descending=False))
        tm("sort_window_desc", lambda: dt.sort(t[lo2:lo2 + w],
                                               descending=True))
        emit("sort_windows", t)
        a = tm("is_sorted_window", lambda: dt.is_sorted(t[lo1:lo1 + w]))
        emit("is_sorted_windows",
             [float(a), float(dt.is_sorted(t[lo2:lo2 + w]))])
        keys, vals = copy_of(x), vec(n)
        dt.transform(x, vals, E("(x0 * -2)", 1))
        tm("sort_by_key", lambda: dt.sort_by_key(keys, vals,
                                                 descending=False))
        emit("sort_by_key_keys", keys)
        emit("sort_by_key_values", vals)
        lo = n // 3 + 1
        keys, vals = copy_of(x), vec(n)
        dt.iota(vals, 0.0)
        tm("sort_by_key_window", lambda: dt.sort_by_key(
            keys[lo:lo + w], vals[lo:lo + w], descending=True))
        emit("sort_by_key_window_keys", keys)
        emit("sort_by_key_window_values", vals)
        del t, keys, vals
        perm = tm("argsort", lambda: dt.argsort(x, descending=False))
        emit("argsort", perm)
        del perm

        hb = dt.halo_bounds(2, 2, False)
        a, b = vec(n, halo=hb), vec(n, halo=hb)
        dt.transform(x, a, E("x0", 1))
        r = tm("stencil_iterate", lambda: dt.stencil_iterate(
            a, b, [0.05, 0.25, 0.4, 0.25, 0.05], 6))
        emit("stencil_iterate", r)
        del a, b, r

        g = _Draws(seed)
        m = k = 4096
        per_row = 8
        rows, cols, vv = [], [], []
        for i in range(m):
            c0 = int(g.take(1)[0] % np.uint64(k - per_row))
            rows += [i] * per_row
            cols += range(c0, c0 + per_row)
            vv.append(g.uniform(per_row, -1.0, 1.0))
        A = dt.sparse_matrix.from_coo(
            (m, k), np.array(rows, np.int64), np.array(cols, np.int64),
            np.concatenate(vv).astype(f32))
        bv, cv = vec(k), vec(m)
        dt.iota(bv, 1.0)
        dt.for_each(bv, E("((x0 * 0.001) - 2)", 1))
        dt.fill(cv, 0.5)
        tm("gemv", lambda: dt.gemv(cv, A, bv))
        emit("gemv", cv)
        mm, kk, pp = 256, 128, 192
        da = g.uniform(mm * kk, -1.0, 1.0).astype(f32).reshape(mm, kk)
        db = g.uniform(kk * pp, -1.0, 1.0).astype(f32).reshape(kk, pp)
        Am, Bm = dt.dense_matrix.from_array(da), dt.dense_matrix.from_array(db)
        Cm = dt.dense_matrix((mm, pp))
        tm("gemm", lambda: dt.gemm(Am, Bm, Cm))
        emit("gemm", Cm)
        shape = (24, 20, 16)
        d3 = g.uniform(24 * 20 * 16, -8.0, 8.0).astype(f32).reshape(shape)
        M = dt.distributed_mdarray.from_array(d3)
        T = dt.distributed_mdarray((16, 24, 20))
        tm("transpose", lambda: dt.transpose(T, M, (2, 0, 1)))
        emit("transpose", T)
        W = tm("submdspan", lambda: M.submdspan(slice(3, 19), slice(2, 17),
                                                slice(1, 13)))
        emit("submdspan", W)

        iv = vec(n, dtype=np.int32)
        dt.iota(iv, 3.0 - float(n // 2))
        dt.for_each(iv, E("((x0 * 3) - 1)", 1))
        r = tm("reduce_i32", lambda: dt.reduce(iv))
        emit("reduce_i32", [float(r)])
        emit("i32", iv)
        del iv, x, y, z
    return digests, times


def demo_direct(dt, n=1 << 14):
    """``bridge_demo``'s device calls made directly from Python, in its
    order and with its sizes (host reads left out: they launch
    nothing)."""
    import tempfile
    from dr_tpu_torch.utils.expr import op_from_expr as E, op_from_source as S
    f32 = np.float32

    def vec(k, **kw):
        return dt.distributed_vector(k, dtype=kw.pop("dtype", f32), **kw)

    P = dt.nprocs()
    a, b = vec(n), vec(n)
    dt.iota(a, 1.0)
    dt.reduce(a)
    dt.fill(b, 2.0)
    dt.dot(a, b)
    vsum = vec(n)
    dt.transform(dt.views.zip(a, b), vsum, E("(x0 + x1)", 2))
    dt.reduce(vsum)
    t = vec(n)
    dt.transform(a, t, E("((x0 * 2) + 1)", 1))
    dt.reduce(t)
    dt.for_each(t, E("sqrt((abs((x0 - 1)) / 2))", 1))
    dt.reduce(t)
    dt.transform_reduce(b, transform_op=E("(x0 * x0)", 1))
    sc = vec(n)
    dt.inclusive_scan(a, sc)
    dt.exclusive_scan(a, sc, 10.0)
    wi, wo = vec(96), vec(96)
    dt.iota(wi, 1.0)
    dt.fill(wo, -1.0)
    dt.inclusive_scan(wi[0:50], wo[7:57])
    dt.exclusive_scan(wi[10:40], wo[0:30], 5.0)
    sizes = [0] * P
    sizes[0] = 10
    if P > 2:
        each = 47 // (P - 2)
        for r in range(2, P):
            sizes[r] = each
        sizes[P - 1] += 47 - each * (P - 2)
    else:
        sizes[P - 1] += 47
    uv = vec(57, distribution=sizes)
    dt.iota(uv, 1.0)
    dt.reduce(uv)
    dt.sort(uv, descending=True)
    us = vec(57, distribution=sizes)
    dt.inclusive_scan(uv, us)
    sv = vec(n)
    dt.iota(sv, 0.0)
    dt.for_each(sv, E("(0 - x0)", 1))
    dt.sort(sv, descending=False)
    dt.sort(sv, descending=True)
    pv = vec(n)
    dt.iota(pv, 0.0)
    dt.sort_by_key(sv, pv, descending=False)
    dt.is_sorted(sv)
    dt.is_sorted(pv)
    wv = vec(64)
    dt.iota(wv, 0.0)
    dt.sort(wv[5:40], descending=True)
    dt.is_sorted(wv[5:40])
    dt.is_sorted(wv[40:64])
    ov = vec(64)
    dt.iota(ov, 0.0)
    dt.for_each(ov, E("(x0 * -1)", 1))
    dt.sort_by_key(ov[0:20], ov[10:30], descending=False)
    dt.argsort(sv, descending=False)
    hb = dt.halo_bounds(1, 1, False)
    x, y = vec(n, halo=hb), vec(n, halo=hb)
    dt.iota(x, 0.0)
    dt.iota(y, 0.0)
    dt.stencil_iterate(x, y, [1.0 / 3] * 3, 4)
    m = 1024
    ri, ci, vv = [], [], []
    for i in range(m):
        for dj in (-1, 0, 1):
            if 0 <= i + dj < m:
                ri.append(i)
                ci.append(i + dj)
                vv.append(1.0 + 0.001 * i + 0.01 * dj)
    A = dt.sparse_matrix.from_coo((m, m), np.array(ri, np.int64),
                                  np.array(ci, np.int64),
                                  np.array(vv).astype(f32))
    bv, cv = vec(m), vec(m)
    dt.iota(bv, 1.0)
    dt.fill(cv, 0.5)
    dt.gemv(cv, A, bv)
    mm, kk, pp = 96, 64, 80
    da = (0.01 * (np.arange(mm * kk) % 37) - 0.1).astype(f32)
    db = (0.02 * (np.arange(kk * pp) % 29) - 0.2).astype(f32)
    dt.gemm(dt.dense_matrix.from_array(da.reshape(mm, kk)),
            dt.dense_matrix.from_array(db.reshape(kk, pp)),
            dt.dense_matrix((mm, pp)))
    dm = (np.arange(64 * 48) * 0.5 - 3.0).astype(f32).reshape(64, 48)
    dt.transpose(dt.distributed_mdarray((48, 64)),
                 dt.distributed_mdarray.from_array(dm))
    d3 = (np.arange(960) * 0.25 - 40.0).astype(f32).reshape(12, 10, 8)
    M = dt.distributed_mdarray.from_array(d3)
    dt.transpose(dt.distributed_mdarray((8, 12, 10)), M, (2, 0, 1))
    dt.transpose(dt.distributed_mdarray((8, 10, 12)), M)
    M.submdspan(slice(2, 9), slice(1, 6), slice(3, 8)).materialize()
    with tempfile.TemporaryDirectory() as td:
        v = vec(777)
        dt.iota(v, 3.0)
        dt.checkpoint.save(os.path.join(td, "v.npz"), v)
        dt.checkpoint.load(os.path.join(td, "v.npz"))
        cin, cout, cz = vec(64), vec(64), vec(64)
        dt.iota(cin, -32.0)
        dt.transform(cin, cout, S(
            "lambda x0: torch.where(x0 > 0, x0, 0.01 * x0)", 1))
        dt.transform(dt.views.zip(cin, cout), cz,
                     S("lambda x0, x1: torch.where(x0 > x1, x0, x1)", 2))
        dt.reduce(cz)
        dt.transform_reduce(cin, transform_op=S(
            "lambda x0: torch.clip(x0, 0.0, 6.0)", 1))
        vec(64)
        iv = vec(100, dtype=np.int32)
        dt.iota(iv, 0.0)
        dt.reduce(iv)
        dv = vec(64, dtype=np.float64)
        dt.iota(dv, 16777216.5)
        dt.reduce(dv)
        dt.argsort(dv, descending=True)
        for tag, src in (("f64", dv), ("i32", iv)):
            path = os.path.join(td, f"{tag}.npz")
            dt.checkpoint.save(path, src)
            dt.checkpoint.load(path)


def bridge_programs():
    """Build the port's demo and parity driver (two g++ processes at
    once); returns their paths and the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor
    from dr_tpu_torch import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        demo, parity = ex.map(native.build, [
            native.HERE / "bridge_demo.cpp",
            native.HERE / "bridge_parity.cpp"])
    return demo, parity, time.perf_counter() - t0


def run_child(args, timeout=900):
    """Run a bridge program with ``native.env()``; raise unless it exits
    0; returns its standard output."""
    from dr_tpu_torch import native
    res = subprocess.run([str(a) for a in args], env=native.env(),
                         capture_output=True, text=True, timeout=timeout,
                         cwd=HERE)
    if res.returncode != 0:
        raise AssertionError(f"{os.path.basename(str(args[0]))} exited "
                             f"{res.returncode}: {res.stdout[-3000:]}"
                             f"{res.stderr[-3000:]}")
    return res.stdout


def child_lines(out, tag):
    """The ``tag ...`` lines of a bridge program's output, as
    {name: rest}."""
    got = {}
    for line in out.splitlines():
        parts = line.split(" ", 2)
        if parts[0] == tag and len(parts) == 3:
            got[parts[1]] = parts[2]
    return got


def child_counts(out):
    lines = [x for x in out.splitlines() if x.startswith("launches ")]
    if len(lines) != 1:
        raise AssertionError(f"no launch counts in the child's output: "
                             f"{out[-2000:]}")
    return json.loads(lines[0][len("launches "):])


def check_counts(tag, child, direct, device):
    """The child's launch counts equal the direct calls'; on the card,
    K3, K4, K6 and K7 launched."""
    log(f"  {tag} launches: bridge {child}, direct {direct}")
    if child != direct:
        raise AssertionError(f"{tag}: the bridge launched {child}, the "
                             f"direct calls {direct}")
    if device != "cpu":
        for k in ("chunked_dot", "chunked_cumsum", "bitonic_sort", "segred"):
            if child[k] <= 0:
                raise AssertionError(f"{tag}: kernel {k} never launched "
                                     f"from the C++ process")


def bridge_phase(dt, kernels, seed, card, device="cuda:0", ranks=None,
                 log2=BRIDGE_LOG2, window=BRIDGE_WINDOW, reps=BRIDGE_REPS,
                 demo_n=1 << 14):
    """Phase 27: the C++ bridge.  27.1 ``bridge_demo`` in a child on
    ``session(0)`` (the card; ``ranks`` CPU ranks when given), its
    launch counts against ``demo_direct``'s; 27.2 ``bridge_parity`` at
    2^``log2`` f32 from one checkpoint, its digests and launch counts
    against ``parity_direct``'s, and the host ms of every call both
    ways.  Returns its numbers."""
    import tempfile
    import torch
    log(f"phase 27: the C++ bridge: bridge_demo on session("
        f"{ranks or 0}), bridge_parity at 2^{log2} f32 (windowed sorts of "
        f"{window} keys, {reps} runs) against the same calls made "
        f"directly")
    child_ranks = 0 if ranks is None else ranks
    devices = None if ranks is None else [device] * ranks
    out = {"card": card}
    t0 = time.perf_counter()
    demo, parity, out["build_s"] = bridge_programs()
    log(f"  [{card}] bridge programs built in {out['build_s']:.1f} s")

    steps = out["steps_s"] = {}
    t1 = time.perf_counter()
    text = run_child([demo, child_ranks, demo_n])
    steps["27.1 child"] = time.perf_counter() - t1
    if "bridge demo PASSED" not in text:
        raise AssertionError(f"bridge_demo did not pass: {text[-3000:]}")
    dt.init(devices)
    kernels.reset_counts()
    demo_direct(dt, demo_n)
    direct = dict(kernels.launches)
    dt.final()
    release(torch)
    check_counts("27.1 bridge_demo", child_counts(text), direct, device)
    out["demo_launches"] = direct

    n = 1 << log2
    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "x.npz")
        dt.init(devices)
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(n, generator=gen, device=device)
        dt.checkpoint.save(ckpt, dt.distributed_vector.from_array(x))
        del x
        dt.final()
        release(torch)
        t1 = time.perf_counter()
        text = run_child([parity, child_ranks, ckpt, "-", "--window",
                          window, "--reps", reps, "--seed", seed % 1000,
                          "--sync", BRIDGE_SYNC, "--after", BRIDGE_COUNTS])
        steps["27.2 child"] = time.perf_counter() - t1
        got = child_lines(text, "digest")
        b_times = {k: float(v) for k, v in child_lines(text, "time").items()}
        dt.init(devices)
        kernels.reset_counts()
        t1 = time.perf_counter()
        want, d_times = parity_direct(dt, ckpt, seed % 1000, window, reps,
                                      sync=dt.fence)
        steps["27.2 direct"] = time.perf_counter() - t1
        direct = dict(kernels.launches)
        dt.final()
        release(torch)
    if got != want:
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        raise AssertionError(f"27.2 bridge_parity digests differ from the "
                             f"direct calls' at {bad}: {got} vs {want}")
    log(f"  27.2 bridge_parity at 2^{log2}: {len(got)} digests equal to "
        f"the direct calls'")
    check_counts("27.2 bridge_parity", child_counts(text), direct, device)
    start = b_times.pop("start")
    calls = {k: {"bridge_ms": b_times[k], "direct_ms": d_times[k]}
             for k in d_times}
    for k, v in calls.items():
        log(f"  [{card}] {k}: bridge {v['bridge_ms']!r} ms, direct "
            f"{v['direct_ms']!r} ms")
    log(f"  [{card}] child start (Py_Initialize + import torch + init): "
        f"{start!r} ms")
    log(f"  [{card}] phase 27 seconds by step: " + json.dumps(steps))
    out.update(parity_launches=direct, calls=calls, child_start_ms=start,
               digests=got, seconds=time.perf_counter() - t0)
    return out


_HALO_AB = """
import importlib.util, json, sys
sys.path.insert(0, {tree!r})
import dr_tpu_torch as dt
spec = importlib.util.spec_from_file_location("chip_smoke", {script!r})
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
out = {{}}
for ranks in (1, 4):
    out[ranks] = [chip_smoke.halo_p50(dt, ranks)[0] for _ in range(3)]
    dt.final()
print("HALO_AB " + json.dumps(out))
"""


def halo_ab(parent, card):
    """Phase 17's halo p50 (1 and 4 ranks, three readings each) with
    another tree's ``dr_tpu_torch`` (``parent``) and this one's, in
    turns (parent, this, this, parent, ..., ten processes), each in a
    process of its own; returns every reading, in order."""
    trees = {"parent": os.path.abspath(parent), "change": HERE}
    got = {"parent": {1: [], 4: []}, "change": {1: [], 4: []}}
    for side in ("parent", "change", "change", "parent") * 2 + (
            "parent", "change"):
        code = _HALO_AB.format(tree=trees[side],
                               script=os.path.abspath(__file__))
        res = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, cwd=HERE)
        line = [x for x in res.stdout.splitlines()
                if x.startswith("HALO_AB ")]
        if res.returncode != 0 or not line:
            raise AssertionError(f"halo A/B ({side}) failed: "
                                 f"{res.stderr[-2000:]}")
        for ranks, vals in json.loads(line[0][8:]).items():
            got[side][int(ranks)].extend(vals)
    for ranks in (1, 4):
        log(f"  [{card}] halo p50 {ranks} rank(s), parent "
            f"{sorted(got['parent'][ranks])} us, this tree "
            f"{sorted(got['change'][ranks])} us; medians "
            f"{float(np.median(got['parent'][ranks]))!r} / "
            f"{float(np.median(got['change'][ranks]))!r}")
    return got


MP_LOG2, MP_HOST_LOG2 = 30, 24
#: seconds the two children of phase 28 may take together
MP_DEADLINE = 240.0
MP_KERNELS = ("stencil_matmul", "stencil_blocked", "chunked_dot",
              "chunked_cumsum")


def mp_path(dt, n, seed, times=None):
    """Phase 28's path: phase 4's main path (the same calls, sizes and
    seed as :func:`main_path`) on the current runtime, one controller
    or one process of several.  Returns ``{"<result>/<rank>": digest}``
    for each rank this process holds (``bridge_digest`` of the rank's
    owned cells, so nothing crosses the process boundary to be
    checked) and the digest of ``dot_n``'s scalar under ``"dot_n"``."""
    import torch
    step = stepper(dt, {} if times is None else times)
    rt = dt.runtime()
    dev = rt.home
    gen = torch.Generator(device=dev).manual_seed(seed)
    dig = {}

    def keep(name, v):
        rank_digests(dig, rt, name, v)

    with step("data"):
        src = torch.randn(n, generator=gen, device=dev)
        a = dt.distributed_vector.from_array(
            src, halo=dt.halo_bounds(MM_HALO, MM_HALO, periodic=True))
    with step("stencil_iterate_matmul"):
        dt.stencil_iterate_matmul(a, W5, STEPS, k_block=K_BLOCK)
    keep("matmul", a)
    del a
    with step("data"):
        b = dt.distributed_vector.from_array(
            src, halo=dt.halo_bounds(BLK_HALO, BLK_HALO, periodic=True))
    with step("stencil_iterate_blocked"):
        dt.stencil_iterate_blocked(b, W5, STEPS, time_block=T_BLOCK)
    keep("blocked", b)
    del b
    with step("data"):
        x = dt.distributed_vector.from_array(
            torch.rand(n, generator=gen, device=dev))
        y = dt.distributed_vector.from_array(
            torch.rand(n, generator=gen, device=dev))
    with step("dot_n"):
        d = dt.dot_n(x, y, DOT_ROUNDS)
    dig["dot_n"] = bridge_digest(d)
    del x, y
    with step("data"):
        s = dt.distributed_vector.from_array(src)
        res = dt.distributed_vector(n)
    with step("inclusive_scan"):
        dt.inclusive_scan(s, res)
    keep("scan", res)
    with step("exclusive_scan"):
        dt.exclusive_scan(s, res)
    keep("exscan", res)
    del s
    with step("data"):
        small = dt.distributed_vector.from_array(src * 2.0 ** -16)
    with step("inclusive_scan_n"):
        dt.inclusive_scan_n(small, res, 2)
    keep("scan_n", res)
    return dig


def mp_halo_p50(dt, cells=HALO_CELLS):
    """Phase 17's halo p50 across processes: a periodic
    ``halo_bounds(1024, 1024)`` vector of ``cells`` a rank,
    ``exchange_n(64)``, 4 calls a batch, 5 batches, on the host clock
    (a gloo exchange waits on the host, which CUDA events would not
    see); each process checks its rank's ghosts against the owners."""
    import torch
    rt = dt.runtime()
    P = rt.nprocs
    v = dt.distributed_vector(P * cells, np.float32, halo=dt.halo_bounds(
        HALO_W, HALO_W, periodic=True))
    dt.iota(v, 0)
    h = v.halo()
    h.exchange_n(HALO_ROUNDS)  # warm
    dt.barrier()
    per = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(4):
            h.exchange_n(HALO_ROUNDS)
        dt.fence()
        per.append((time.perf_counter() - t0) * 1e6 / (4 * HALO_ROUNDS))
    for r in rt.local_ranks:
        left = ((r - 1) % P) * cells + cells - HALO_W
        right = ((r + 1) % P) * cells
        want = torch.cat([torch.arange(left, left + HALO_W),
                          torch.arange(r * cells, (r + 1) * cells),
                          torch.arange(right, right + HALO_W)]).float()
        check(f"process {rt.process_index} halo rank {r} ghosts",
              max_err(v.rows[r][0].cpu(), want), 0.0)
    return float(np.median(per)), per


def d2h_us(device, reps=200):
    """Median host microseconds of one device-to-host copy of a
    1024-cell f32 slice: what each cross-process edge send pays under
    gloo before its message leaves."""
    import torch
    x = torch.zeros((1, 4096), device=device)
    x[:, :1024].cpu()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x[:, :1024].cpu()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def mp_child(argv):
    """One process of phase 28: ``--mp-child PID NPROC PORT OUT SEED
    DEVICE LOG2 HOST_LOG2 CELLS``.  Joins the group (gloo, one rank on
    DEVICE), runs :func:`mp_path` at 2^LOG2, then ``to_host`` at
    2^HOST_LOG2 and the halo p50 at CELLS a rank, and writes its numbers
    to ``OUT/child<PID>.json``; raises on any disagreement."""
    pid, nproc, port, out, seed, device = (
        int(argv[0]), int(argv[1]), argv[2], argv[3], int(argv[4]), argv[5])
    log2, host_log2, cells = int(argv[6]), int(argv[7]), int(argv[8])
    import torch
    sys.path.insert(0, HERE)
    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import kernels
    from dr_tpu_torch.utils.host import to_host
    global LOG_FILE
    LOG_FILE = open(os.path.join(out, f"child{pid}.log"), "w",
                    encoding="utf-8")
    rt = dt.init_distributed(f"localhost:{port}", nproc, pid,
                             backend="gloo", device=device,
                             timeout_s=MP_DEADLINE)
    ready = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    assert rt.local_ranks == [pid], rt
    kernels.reset_counts()
    steps = {}
    t0 = time.perf_counter()
    dig = mp_path(dt, 1 << log2, seed, steps)
    path_s = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in MP_KERNELS}
    n24 = 1 << host_log2
    gen = torch.Generator(device=device).manual_seed(seed + 28)
    src = torch.randn(n24, generator=gen, device=device)
    v = dt.distributed_vector.from_array(src)
    dt.barrier()
    t0 = time.perf_counter()
    host = to_host(v)
    th_s = time.perf_counter() - t0
    if not np.array_equal(host.view(np.int32),
                          src.cpu().numpy().view(np.int32)):
        raise AssertionError(f"process {pid}: to_host at 2^{host_log2} "
                             "differs from the source")
    del v, src, host
    p50, per = mp_halo_p50(dt, cells)
    dt.barrier()  # both processes copy at once, as in an exchange
    d2h = d2h_us(device)
    with open(os.path.join(out, f"child{pid}.json"), "w") as fh:
        json.dump({"pid": pid, "ready": ready, "digests": dig, "d2h_us": d2h,
                   "launches": counts, "steps": steps, "path_s": path_s,
                   "to_host_s": th_s, "to_host_gbps": n24 * 4 / th_s / 1e9,
                   "halo_p50_us": p50, "halo_batches_us": per}, fh)
    dt.barrier()
    dt.final()
    return 0


def free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def mp_spawn(nproc, seed, out, args, child="--mp-child", tag="phase 28",
             exits=None):
    """Start the children of a multi-process phase (``child`` names the
    entry, phase 28's by default); wait for all, under MP_DEADLINE; a
    child that exits non-zero gets its peers killed (they would wait in
    a collective), and so does the deadline.  ``exits`` maps a child to
    the exit code it must end with instead (a child that kills itself,
    which writes no record).  Raises unless every child exits as
    expected; returns their JSON records and their start times (None
    for a child of ``exits``)."""
    exits = exits or {}
    port = free_port()
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t_spawn = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), child,
         str(pid), str(nproc), str(port), out, str(seed)] + args,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE) for pid in range(nproc)]
    deadline = time.monotonic() + MP_DEADLINE
    failed = None
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in procs):
            break
        bad = [i for i, p in enumerate(procs)
               if p.poll() not in (None, exits.get(i, 0))]
        if bad:
            failed = bad[0]
            time.sleep(2)  # let the peers fail and flush on their own
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    outs = [p.communicate()[0] for p in procs]
    for pid, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != exits.get(pid, 0):
            why = ("failed" if failed is not None else
                   f"missed the {MP_DEADLINE} s deadline")
            raise AssertionError(f"{tag}: process {pid} {why} (exit "
                                 f"{p.returncode}): {o[-3000:]}")
    recs = []
    for pid in range(nproc):
        if pid in exits:
            recs.append(None)
            continue
        with open(os.path.join(out, f"child{pid}.json")) as fh:
            recs.append(json.load(fh))
    return recs, [None if r is None else r["ready"] - t_spawn
                  for r in recs]


def mp_phase(dt, kernels, seed, card, log2=MP_LOG2, nproc=2,
             device="cuda:0", host_log2=MP_HOST_LOG2, cells=HALO_CELLS):
    """Phase 28 (see the module docstring); returns its numbers.  On
    the CPU (``device="cpu"``, small ``log2``) it rehearses the phase;
    its launch checks then compare 0 with 0."""
    n = 1 << log2
    import torch
    out = {"card": card, "n": n, "processes": nproc}
    log(f"phase 28.1: the path with one controller on {nproc} ranks of "
        f"{device}, n=2^{int(math.log2(n))}")
    dt.init(dt.get_duplicated_devices(nproc, [device]))
    kernels.reset_counts()
    steps = {}
    t0 = time.perf_counter()
    want = mp_path(dt, n, seed, steps)
    out["single_s"] = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in MP_KERNELS}
    out["single_steps"] = steps
    out["single_launches"] = counts
    log(f"  28.1 {out['single_s']:.2f} s, launches {counts}, steps "
        + json.dumps(steps))
    per_rank = {}
    for k, c in counts.items():
        # every call of the path launches its kernel once a rank
        if (c <= 0 and device != "cpu") or c % nproc:
            raise AssertionError(f"phase 28.1: {k} launched {c} times on "
                                 f"{nproc} ranks")
        per_rank[k] = c // nproc
    out["single_d2h_us"] = d2h_us(device)
    dt.final()
    release(torch)
    log(f"phase 28.2: {nproc} processes (gloo), one rank each on {device}")
    t0 = time.perf_counter()
    recs, starts = mp_spawn(
        nproc, seed, os.path.join(HERE, "chiprun_out", "phase28"),
        [device, str(log2), str(host_log2), str(cells)])
    out["spawn_s"] = time.perf_counter() - t0
    out["starts_s"] = starts
    for rec in recs:
        pid = rec["pid"]
        mine = {k: v for k, v in want.items()
                if k == "dot_n" or k.endswith(f"/{pid}")}
        if rec["digests"] != mine:
            bad = sorted(k for k in mine if rec["digests"].get(k) != mine[k])
            raise AssertionError(f"phase 28: process {pid}'s digests differ "
                                 f"from the single controller's: {bad}")
        log(f"  process {pid}: {len(mine)} digests equal bit for bit")
        if rec["launches"] != per_rank:
            raise AssertionError(f"phase 28: process {pid} launched "
                                 f"{rec['launches']}, its rank "
                                 f"{per_rank} with one controller")
        log(f"  process {pid} launches {rec['launches']} == its rank's")
        for k in ("steps", "path_s", "to_host_gbps", "halo_p50_us",
                  "halo_batches_us", "d2h_us"):
            out[f"p{pid}_{k}"] = rec[k]
        log(f"  process {pid}: start {starts[pid]!r} s, path "
            f"{rec['path_s']!r} s, to_host 2^{host_log2} "
            f"{rec['to_host_gbps']!r} GB/s, halo p50 "
            f"{rec['halo_p50_us']!r} us, a 4 KiB device-to-host copy "
            f"{rec['d2h_us']!r} us (one controller: "
            f"{out['single_d2h_us']!r}); steps " + json.dumps(rec["steps"]))
    log(f"  phase 28 {out['spawn_s']:.1f} s for the processes")
    return out


# phase 29: multi-process execution of the other kernel paths (sizes at
# the phase's full width; names the cuts PERF.md lists)
MP29_SORT_LOG2 = 26        # phase 10's 4-rank sort size, f32
MP29_K6 = 16384            # K6's geometry: int32 keys a rank
MP29_WIN = 1 << 14         # the windowed sort
MP29_RED_LOG2 = 28         # K7's reduce min / max, f32
MP29_K5 = (16384, 16, 4)   # K5: one-tile m x m, time block, passes
MP29_TILED = (8192, 8)     # the tiled stencil on a 2 x 1 grid, steps
MP29_MD = 8192             # the transposed mdarray, m x m f32
MP29_SP_LOG2 = 20          # config 5's pattern, cut from 2^22 rows
MP29_SP_ROUNDS, MP29_SP_NV, MP29_SP_ITERS = 8, 8, 2
# ring attention: Llama-3-8B's attention at 32k tokens; ring_attention_n
# chains v through the output, so it runs the 8 K/V heads as q heads
MP29_RA = (RA_S, RA_H, RA_HKV, RA_D)
MP29_RAN = (RA_S, RA_HKV, 2)
MP29_KERNELS = ("stencil2d_blocked", "bitonic_sort", "segred",
                "flash_update")


def mp29_sizes(small=False):
    """Phase 29's sizes; ``small`` gives a CPU rehearsal's."""
    if small:
        return {"sort": 12, "k6": 256, "win": 128, "red": 12,
                "k5": (256, 4, 2), "tiled": (64, 3), "md": 64, "sp": 10,
                "ra": (1024, 4, 2, 128), "ran": (1024, 2, 2)}
    return {"sort": MP29_SORT_LOG2, "k6": MP29_K6, "win": MP29_WIN,
            "red": MP29_RED_LOG2, "k5": MP29_K5, "tiled": MP29_TILED,
            "md": MP29_MD, "sp": MP29_SP_LOG2, "ra": MP29_RA,
            "ran": MP29_RAN}


def mp29_path(dt, seed, sz, times=None):
    """Phase 29's path on the current runtime (one controller or one
    process of several): the sort family, K7's reduce, the 2-D paths
    (K5 on one tile, the tiled stencil, a transpose), the sparse csr
    gemv / spmm and ring attention (K9).  Returns ``{"<result>/<rank>":
    digest}`` for the cells of each rank this process holds
    (``bridge_digest``), and ``{"<result>": digest}`` for the scalars,
    which every process holds; ``times`` gets each step's seconds."""
    import torch
    from dr_tpu_torch.algorithms import gemv as tg
    from dr_tpu_torch.algorithms import sort as dt_sort
    times = {} if times is None else times
    step = stepper(dt, times)
    rt = dt.runtime()
    dev = rt.home
    P = rt.nprocs
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    dig = {}

    def keep(name, v):
        rank_digests(dig, rt, name, v)

    def keep_blocks(name, blocks):
        for r in rt.local_ranks:
            if r < len(blocks):
                dig[f"{name}/{r}"] = bridge_digest(blocks[r])

    def keep_rows(name, t, dim=0):
        s = t.shape[dim] // P
        for r in rt.local_ranks:
            dig[f"{name}/{r}"] = bridge_digest(t.narrow(dim, r * s, s))

    # ---- the sort family (K6 at its geometry; torch.sort above the cap)
    n = 1 << sz["sort"]
    with step("data"):
        src = torch.randn(n, generator=gen, device=dev)
    with step("sort"):
        v = dt.distributed_vector.from_array(src)
        dt.sort(v)
    keep("sort", v)
    with step("is_sorted"):
        dig["is_sorted"] = bridge_digest(torch.tensor(
            [dt.is_sorted(v), dt.is_sorted(dt.distributed_vector.from_array(
                src))]))
    del v
    with step("sort_by_key"):
        kd = dt.distributed_vector.from_array(src)
        pd = dt.distributed_vector(n, np.int32)
        dt.iota(pd, 0)
        dt.sort_by_key(kd, pd)
    keep("sbk_keys", kd)
    keep("sbk_vals", pd)
    del kd, pd
    with step("argsort"):
        idx = dt.argsort(dt.distributed_vector.from_array(src))
    keep("argsort", idx)
    del idx
    ph = {}
    for cut in ("splitter", "exchange"):
        w = dt.distributed_vector.from_array(src)
        dt.barrier()
        t0 = time.perf_counter()
        dt_sort.sort_phases_n(w, cut, 1)
        dt.fence()
        ph[cut] = time.perf_counter() - t0
        del w
    times["sort exchange (prefix difference)"] = ph["exchange"] - \
        ph["splitter"]
    del src
    k6n = P * sz["k6"]
    with step("data"):
        keys = torch.randint(-(1 << 30), 1 << 30, (k6n,), generator=gen,
                             device=dev, dtype=torch.int32)
    with step("k6 sort"):
        v = dt.distributed_vector.from_array(keys)
        dt.sort(v)
    keep("k6_sort", v)
    with step("k6 sort, a second call"):  # a process's first K6 call warms
        dt.sort(dt.distributed_vector.from_array(keys))
    with step("k6 sort_by_key"):
        kd = dt.distributed_vector.from_array(keys % 1000)
        pd = dt.distributed_vector(k6n, np.int32)
        dt.iota(pd, 0)
        dt.sort_by_key(kd, pd)
    keep("k6_sbk_keys", kd)
    keep("k6_sbk_vals", pd)
    with step("k6 window sort"):
        w = dt.distributed_vector.from_array(keys)
        b = (k6n - sz["win"]) // 2
        dt.sort(w[b:b + sz["win"]])
    keep("k6_window", w)
    del v, kd, pd, w, keys
    # ---- K7: reduce min / max
    with step("data"):
        x = dt.distributed_vector.from_array(
            torch.randn(1 << sz["red"], generator=gen, device=dev))
    with step("reduce min max"):
        mm = [dt.reduce(x, None, torch.minimum),
              dt.reduce(x, None, torch.maximum)]
    dig["reduce_minmax"] = bridge_digest(torch.stack(
        [torch.as_tensor(a).reshape(()).float().cpu() for a in mm]))
    with step("reduce min max, a second call"):  # K7's first call warms
        dt.reduce(x, None, torch.minimum)
        dt.reduce(x, None, torch.maximum)
    del x
    # ---- 2-D: K5 on one tile, the tiled stencil, a transpose
    w9 = dt.heat_step_weights(0.2)
    m, tb, passes = sz["k5"]
    with step("data"):
        u = torch.randn((m, m), generator=gen, device=dev)
        one = dt.dense_matrix.from_array(u, dt.block_cyclic(grid=(1, 1)))
    del u
    with step("stencil2d_n (K5)"):
        dt.stencil2d_n(one, w9, passes, time_block=tb)
    keep_blocks("k5", one.shards)
    del one
    mt, steps = sz["tiled"]
    with step("data"):
        u = torch.randn((mt, mt), generator=gen, device=dev)
        part = dt.block_cyclic(grid=(P, 1))
        A = dt.dense_matrix.from_array(u, part)
        B = dt.dense_matrix.from_array(u, part)
    del u
    with step("stencil2d_iterate (tiled)"):
        dt.stencil2d_iterate(A, B, w9, steps)
    keep_blocks("tiled", A.shards)
    del A, B
    md = sz["md"]
    with step("data"):
        M = dt.distributed_mdarray.from_array(
            torch.randn((md, md), generator=gen, device=dev))
        T = dt.distributed_mdarray((md, md))
    with step("transpose"):
        dt.transpose(T, M)
    keep_blocks("transpose", T.blocks)
    del M, T
    # ---- sparse: config 5's pattern on the csr route
    ms = 1 << sz["sp"]
    with step("data"):
        rows, cols, vals, _ = config5_coo(ms, seed=seed)
        A = dt.sparse_matrix.from_coo((ms, ms), rows, cols, vals)
        del rows, cols, vals
        bvec = torch.randn(ms, generator=gen, device=dev)
        Bm = torch.randn((ms, MP29_SP_NV), generator=gen, device=dev)
    if tg.resolved_format(A) != "csr" or tg.resolved_spmm_format(A) != "csr":
        raise AssertionError(f"phase 29: the sparse path took "
                             f"{tg.resolved_format(A)} / "
                             f"{tg.resolved_spmm_format(A)}, not csr")
    with step("gemv_n"):
        c = dt.distributed_vector(ms)
        tg.gemv_n(c, A, bvec, MP29_SP_ROUNDS)
    keep("gemv_n", c)
    with step("spmm_n"):
        Y = tg.spmm_n(A, Bm, MP29_SP_ITERS)
    keep_rows("spmm_n", Y)
    del A, c, Y, bvec, Bm
    # ---- ring attention (K9: the flash ring)
    S, h, hkv, d = sz["ra"]
    with step("data"):
        q = torch.randn((1, S, h, d), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k = torch.randn((1, S, hkv, d), generator=gen, device=dev
                        ).to(torch.bfloat16)
        vv = torch.randn((1, S, hkv, d), generator=gen, device=dev
                         ).to(torch.bfloat16)
    with step("ring_attention"):
        o = dt.ring_attention(q, k, vv, causal=True)
    keep_rows("ring", o, 1)
    del q, k, vv, o
    S, h, iters = sz["ran"]
    with step("data"):
        q, k, vv = (torch.randn((1, S, h, d), generator=gen, device=dev
                                ).to(torch.bfloat16) for _ in range(3))
    with step("ring_attention_n"):
        o = dt.ring_attention_n(q, k, vv, iters, causal=True)
    keep_rows("ring_n", o, 1)
    del q, k, vv, o
    return dig


def mp29_share(single, pid):
    """The launches process ``pid`` must make, from the single
    controller's on two ranks of one device: K5 runs on rank 0's tile
    alone; K6 sorts each device's ranks in one batch, one launch a sort
    on one controller and in each process alike (a process's batch is
    its own rank's block); K7 and K9 launch once a rank a call, so each
    process makes its rank's half."""
    return {"stencil2d_blocked": single["stencil2d_blocked"] if pid == 0
            else 0,
            "bitonic_sort": single["bitonic_sort"],
            "segred": single["segred"] // 2,
            "flash_update": single["flash_update"] // 2}


def guarded_child(argv, names, run):
    """The body of a phase 29 or 30 process: ``argv`` starts with PID
    NPROC PORT OUT SEED DEVICE.  Joins the group (gloo, one rank on
    DEVICE), runs ``run(dt, seed, steps)`` (the path, returning its
    digests) under an ``spmd_guard`` (``verify()`` after it) and writes
    its digests, the launches of the kernels ``names`` and its step
    seconds to ``OUT/child<PID>.json``."""
    pid, nproc, port, out, seed, device = (
        int(argv[0]), int(argv[1]), argv[2], argv[3], int(argv[4]), argv[5])
    import torch
    sys.path.insert(0, HERE)
    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import kernels
    from dr_tpu_torch.utils import spmd_guard
    global LOG_FILE
    LOG_FILE = open(os.path.join(out, f"child{pid}.log"), "w",
                    encoding="utf-8")
    rt = dt.init_distributed(f"localhost:{port}", nproc, pid,
                             backend="gloo", device=device,
                             timeout_s=MP_DEADLINE)
    ready = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    assert rt.local_ranks == [pid], rt
    kernels.reset_counts()
    steps = {}
    t0 = time.perf_counter()
    with spmd_guard.guard() as g:
        dig = run(dt, seed, steps)
        g.verify()
    path_s = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in names}
    with open(os.path.join(out, f"child{pid}.json"), "w") as fh:
        json.dump({"pid": pid, "ready": ready, "digests": dig,
                   "launches": counts, "steps": steps, "path_s": path_s,
                   "guarded": len(g.trace)}, fh)
    dt.barrier()
    dt.final()
    return 0


def mp29_child(argv):
    """One process of phase 29: ``--mp29-child PID NPROC PORT OUT SEED
    DEVICE SMALL``: :func:`mp29_path` in :func:`guarded_child`."""
    sz = mp29_sizes(argv[6] == "1")
    return guarded_child(argv, MP29_KERNELS, lambda dt, seed, steps:
                         mp29_path(dt, seed, sz, steps))


def mp29_phase(dt, kernels, seed, card, nproc=2, device="cuda:0",
               small=False, out_dir=None):
    """Phase 29 (see the module docstring); returns its numbers.  On the
    CPU (``device="cpu"``, ``small=True``) it rehearses the phase; its
    launch checks then compare 0 with 0.  The children write into
    ``out_dir`` (default ``chiprun_out/phase29``)."""
    import torch
    sz = mp29_sizes(small)
    out = {"card": card, "processes": nproc, "sizes": sz}
    log(f"phase 29.1: the kernel paths with one controller on {nproc} "
        f"ranks of {device}: " + json.dumps(sz))
    dt.init(dt.get_duplicated_devices(nproc, [device]))
    kernels.reset_counts()
    steps = {}
    t0 = time.perf_counter()
    with env_set(DR_GPU_SPMV_FORMAT="csr"):  # the one layout across processes
        want = mp29_path(dt, seed, sz, steps)
    out["single_s"] = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in MP29_KERNELS}
    out["single_steps"] = steps
    out["single_launches"] = counts
    log(f"  29.1 {out['single_s']:.2f} s, launches {counts}")
    if device != "cpu" and min(counts.values()) <= 0:
        raise AssertionError(f"phase 29.1: a kernel of the path never "
                             f"launched: {counts}")
    dt.final()
    release(torch)
    log(f"phase 29.2: {nproc} processes (gloo), one rank each on {device}")
    t0 = time.perf_counter()
    recs, starts = mp_spawn(
        nproc, seed, out_dir or os.path.join(HERE, "chiprun_out", "phase29"),
        [device, "1" if small else "0"], child="--mp29-child",
        tag="phase 29")
    out["spawn_s"] = time.perf_counter() - t0
    out["starts_s"] = starts
    for rec in recs:
        pid = rec["pid"]
        mine = {k: v for k, v in want.items()
                if "/" not in k or k.endswith(f"/{pid}")}
        if rec["digests"] != mine:
            bad = sorted(k for k in mine if rec["digests"].get(k) != mine[k])
            raise AssertionError(f"phase 29: process {pid}'s digests differ "
                                 f"from the single controller's: {bad}")
        log(f"  process {pid}: {len(mine)} digests equal bit for bit")
        share = mp29_share(counts, pid)
        if rec["launches"] != share:
            raise AssertionError(f"phase 29: process {pid} launched "
                                 f"{rec['launches']}, its rank's share "
                                 f"{share} of one controller's {counts}")
        log(f"  process {pid} launches {rec['launches']} == its rank's "
            f"share")
        out[f"p{pid}_steps"] = rec["steps"]
        out[f"p{pid}_path_s"] = rec["path_s"]
        out[f"p{pid}_launches"] = rec["launches"]
        log(f"  process {pid}: start {starts[pid]!r} s, path "
            f"{rec['path_s']!r} s (one controller {out['single_s']!r} s), "
            f"{rec['guarded']} guarded dispatches verified, sort exchange "
            f"{rec['steps']['sort exchange (prefix difference)']!r} s "
            f"(one controller "
            f"{steps['sort exchange (prefix difference)']!r} s)")
        for k, t in rec["steps"].items():
            log(f"    {k}: {t!r} s, one controller {steps.get(k)!r} s")
    log(f"  phase 29 {out['spawn_s']:.1f} s for the processes")
    return out


# phase 30: multi-process execution of the relational ops and re-layout
# (sizes at the phase's full width; names the cuts PERF.md lists)
MP30_KERNELS = ("bitonic_sort", "segred", "hist")
MP30_PARTS = ("pipeline", "routes", "geometry", "histogram", "auto",
              "relayout")
MP30_GEO = 8192            # the kernel geometry: int32 keys a rank
MP30_MD = (CK_M, CK_TILE)  # the re-blocked matrix: m x m f32, cyclic tile


def mp30_sizes(small=False):
    """Phase 30's sizes; ``small`` gives a CPU rehearsal's (the routes
    at 2^16 fact rows under a 2^14 route threshold, so the unforced
    join still takes the partition route)."""
    if small:
        return {"rel": (14, 10), "routes": 16, "route_max": 1 << 14,
                "geo": MP30_GEO, "hist": 16, "rdx": 16, "md": (256, 32),
                "uh": (14, 10)}
    return {"rel": (REL_FACT_LOG2, REL_CARD_LOG2), "routes": REL4_FACT_LOG2,
            "route_max": None, "geo": MP30_GEO, "hist": 30,
            "rdx": RDX_LOG2, "md": MP30_MD, "uh": (UH_LOG2, UH_GHOSTS_LOG2)}


def mp30_path(dt, seed, sz, parts=MP30_PARTS, times=None, check=False):
    """Phase 30's path on the current runtime (one controller or one
    process of several): phase 14's relational pipeline, phase 15's
    joins on both routes, the kernel geometry (K6, K7, K8), a 1024-bin
    histogram (K8), ``unique`` and the auto tier, the redistribute
    ping-pong on both routes, a matrix re-block and an unstructured
    halo.  Returns ``{"<result>/<rank>": digest}`` for the cells of each
    rank this process holds and ``{"<result>": value}`` for what every
    process holds (counts, gathered rows); ``times`` gets each step's
    seconds.  ``check`` holds the results against oracles independent
    of the port (one controller does; the processes are held to its
    digests)."""
    import torch
    from dr_tpu_torch.parallel import redistribute as rdx
    times = {} if times is None else times
    step = stepper(dt, times)
    rt = dt.runtime()
    dev = rt.home
    P = rt.nprocs
    dig = {}

    def keep(name, v):
        rank_digests(dig, rt, name, v)

    def keep_all(name, t):
        dig[name] = bridge_digest(t)

    if "pipeline" in parts:  # phase 14's configuration
        fl, cl = sz["rel"]
        data = relational_data(1 << fl, 1 << cl, seed + 14, dev)
        out = relational_run(dt, data, times)
        dig["pipeline m"], dig["pipeline ng"] = out["m"], out["ng"]
        for k in ("jk", "jl", "jr", "gk", "gv", "tv", "ti", "hb"):
            keep(f"pipeline {k}", out[k])
        if check:
            check_relational("30.1", data, relational_values(out))
        del out, data
    if "routes" in parts:  # phase 15's joins on both routes
        fl = sz["routes"]
        limit = contextlib.nullcontext() if sz["route_max"] is None \
            else broadcast_max(sz["route_max"])
        data = relational_data(1 << fl, 1 << (fl - 4), seed + 16, dev)
        with limit, step("join both routes, inner"):
            m, rows = join_both_routes(dt, data, "inner", 0, "phase 30")
        dig["routes inner m"] = m
        keep_all("routes inner", torch.cat(rows))
        del data, rows
        odata = relational_data(1 << fl, 1 << (fl - 4), seed + 17, dev,
                                shift=1 << (fl - 5))
        limit = contextlib.nullcontext() if sz["route_max"] is None \
            else broadcast_max(sz["route_max"])
        with limit, step("join both routes, outer"):
            m, rows = join_both_routes(dt, odata, "outer", -1.0, "phase 30")
        dig["routes outer m"] = m
        keep_all("routes outer", torch.cat(rows))
        if check:
            want = join_oracle(odata, fill=-1.0)
            check_true("30.1 outer join count", m == want[0].numel())
            for name, got, w in zip(("keys", "left", "right"), rows, want):
                check_true(f"30.1 outer join {name} vs oracle (bits)",
                           torch.equal(got, w.view(torch.int32)))
            del want
        del odata, rows
    rng = np.random.default_rng(seed + 30)
    nk = sz["geo"] * P
    keys = rng.integers(0, 512, nk).astype(np.int32)
    vals = rng.integers(0, 99, nk).astype(np.int32)
    if "geometry" in parts:  # the bench's kernel geometry
        hv = rng.standard_normal(nk).astype(np.float32)
        gk, gv, hvv = (dt.distributed_vector.from_array(a)
                       for a in (keys, vals, hv))
        ok = dt.distributed_vector(1024, np.int32)
        ov = dt.distributed_vector(1024, np.int32)
        hb = dt.distributed_vector(256, np.int32)
        with step("geometry groupby sum (K6, K7)"):
            ng = dt.groupby_aggregate(gk, gv, ok, ov, agg="sum")
        with step("geometry histogram 256 bins (K8)"):
            dt.histogram(hvv, hb, -4.0, 4.0)
        dig["geometry ng"] = ng
        for name, v in (("ok", ok), ("ov", ov), ("hb", hb)):
            keep(f"geometry {name}", v)
        if check:
            uk, inv = np.unique(keys, return_inverse=True)
            sums = np.bincount(inv, weights=vals).astype(np.int32)
            check_true("30.1 geometry groupby vs numpy", ng == len(uk)
                       and np.array_equal(dt.to_numpy(ok)[:ng], uk)
                       and np.array_equal(dt.to_numpy(ov)[:ng], sums))
            x = hv[(hv >= -4.0) & (hv <= 4.0)]
            b = np.minimum(np.floor((x - np.float32(-4.0)) * np.float32(256)
                                    / np.float32(8.0)).astype(np.int64), 255)
            check_true("30.1 geometry histogram vs numpy", np.array_equal(
                dt.to_numpy(hb), np.bincount(b, minlength=256)))
        del gk, gv, hvv, ok, ov, hb
    if "histogram" in parts:  # K8's timed shape
        with step("data"):
            x = torch.randn(1 << sz["hist"], generator=torch.Generator(
                device=dev).manual_seed(seed + 15), device=dev)
            hx = dt.distributed_vector.from_array(x)
            hb = dt.distributed_vector(K8_BINS, np.int32)
        with step(f"histogram 2^{sz['hist']}, {K8_BINS} bins (K8)"):
            dt.histogram(hx, hb, -4.0, 4.0)
        keep("histogram", hb)
        if check:
            check_true(f"30.1 histogram 2^{sz['hist']} (bits)", torch.equal(
                hb.to_array(), hist_oracle(x, K8_BINS, -4.0, 4.0)))
        del x, hx, hb
    if "auto" in parts:  # unique and the auto tier at the geometry
        gk, gv = (dt.distributed_vector.from_array(a) for a in (keys, vals))
        u = dt.distributed_vector(1024, np.int32)
        with step("unique (K6, K7)"):
            nu = dt.unique(gk, u)
        dig["unique n"] = nu
        keep("unique", u)
        dk = dt.distributed_vector.from_array(np.arange(0, 512, 3,
                                                        dtype=np.int32))
        with step("join_auto (K6)"):
            ja = dt.join_auto(gk, gv, dk, dk)
            dig["join_auto n"] = ja.count
        with step("groupby_auto (K6, K7)"):
            ga = dt.groupby_auto(gk, gv, "sum")
            dig["groupby_auto n"] = ga.count
        with step("unique_auto (K6, K7)"):
            ua = dt.unique_auto(gk)
            dig["unique_auto n"] = ua.count
        for tag, res in (("join_auto", ja), ("groupby_auto", ga),
                         ("unique_auto", ua)):
            for i, c in enumerate(res.containers):
                keep(f"{tag} {i}", c)
        if check:
            uk, inv = np.unique(keys, return_inverse=True)
            check_true("30.1 unique vs numpy", nu == len(uk) and
                       np.array_equal(dt.to_numpy(u)[:nu], uk))
            sums = np.bincount(inv, weights=vals).astype(np.int32)
            gk_a, gv_a = ga.arrays()
            check_true("30.1 groupby_auto vs numpy", np.array_equal(gk_a, uk)
                       and np.array_equal(gv_a, sums))
            check_true("30.1 unique_auto vs numpy",
                       np.array_equal(ua.arrays()[0], uk))
            hit = keys % 3 == 0
            order = np.argsort(keys[hit], kind="stable")
            jk_a, jl_a, jr_a = ja.arrays()
            check_true("30.1 join_auto vs numpy", ja.count == int(hit.sum())
                       and np.array_equal(jk_a, keys[hit][order])
                       and np.array_equal(jl_a, vals[hit][order])
                       and np.array_equal(jr_a, keys[hit][order]))
        del gk, gv, u, dk, ja, ga, ua
    if "relayout" in parts:
        n = 1 << sz["rdx"]
        with step("data"):
            src = torch.randn(n, generator=torch.Generator(
                device=dev).manual_seed(seed + 20), device=dev)
            va = dt.distributed_vector.from_array(src)
            vb = dt.distributed_vector.from_array(src)
        # even <-> a cut a quarter in: a quarter of the vector changes rank
        cut = [n // 4] + [(n - n // 4) // (P - 1)] * (P - 1)
        cut[-1] += n - sum(cut)
        moved = rdx.plan_moves(va.layout, (
            P, dt.block_distribution(cut).layout_entry(), 0, 0, n))[1]
        for tag, d in (("uneven", cut), ("even", None)):
            dt.barrier()
            with step(f"redistribute collective to {tag}"):
                rdx._collective(va, d, rt)
            dt.barrier()
            with step(f"redistribute host-staged to {tag}"):
                rdx._host_staged(vb, d, rt)
            keep(f"redistribute {tag}", va)
            keep(f"redistribute host {tag}", vb)
            if check:
                check_true(f"30.1 redistribute to {tag}: collective rows == "
                           "host-staged rows (bits)", rows_equal(va, vb))
                check_true(f"30.1 redistribute to {tag}: values == source "
                           "(bits)", torch_equal(va.to_array(), src))
        del vb
        dt.barrier()
        with step("redistribute ping-pong, collective, 2 iterations"):
            for _ in range(2):
                dt.redistribute(va, cut)
                dt.redistribute(va, None)
        keep("redistribute ping-pong", va)
        dig["redistribute moved"] = moved
        del va, src
        m, tile = sz["md"]
        with step("data"):
            u = torch.randn((m, m), generator=torch.Generator(
                device=dev).manual_seed(seed + 31), device=dev)
            D = dt.dense_matrix.from_array(u, dt.block_cyclic(
                tile=(tile, tile)))
        with step("redistribute matrix re-block"):
            dt.redistribute(D)
        keep_all("matrix re-block", D.to_array())
        if check:
            check_true("30.1 matrix re-block == source (bits)",
                       torch_equal(D.to_array(), u))
        del D, u
        n, k = 1 << sz["uh"][0], 1 << sz["uh"][1]
        rng = np.random.default_rng(seed + 21)
        base = rng.standard_normal(n).astype(np.float32)
        gmap = ghost_map(n, P, k, rng)
        contrib = {r: rng.standard_normal(k).astype(np.float32)
                   for r in range(P)}
        v = dt.distributed_vector.from_array(torch.from_numpy(base).to(dev))
        with step("unstructured halo build"):
            uh = dt.unstructured_halo(v, gmap)
        dt.barrier()
        with step("unstructured halo exchange"):
            uh.exchange()
        for r in rt.local_ranks:
            dig[f"uhalo ghosts/{r}"] = bridge_digest(uh.ghost_values(r))
        if check:
            check_true("30.1 unstructured exchange == numpy gather (bits)",
                       all(np.array_equal(
                           uh.ghost_values(r).cpu().numpy().view(np.int32),
                           base[gmap[r]].view(np.int32)) for r in range(P)))
        for r in rt.local_ranks:
            uh.set_ghost_values(r, contrib[r])
        dt.barrier()
        with step("unstructured halo reduce plus"):
            uh.reduce("plus")
        keep("uhalo reduce plus", v)
        if check:
            flat = np.concatenate([gmap[r] for r in range(P)])
            ghosts = np.concatenate([contrib[r] for r in range(P)])
            check_true("30.1 unstructured reduce plus == numpy (bits)",
                       np.array_equal(
                           v.to_array().cpu().numpy().view(np.int32),
                           numpy_fold(base, flat, ghosts, "plus")
                           .view(np.int32)))
        del v, uh
    return dig


def mp30_share(single, pid):
    """The launches process ``pid`` must make, from the single
    controller's on two ranks of one device: K6 sorts each device's
    ranks in one batch, one launch a sort on one controller and in each
    process alike; K7 and K8 launch once a rank a call, so each process
    makes its rank's half."""
    return {"bitonic_sort": single["bitonic_sort"],
            "segred": single["segred"] // 2,
            "hist": single["hist"] // 2}


def mp30_child(argv):
    """One process of phase 30: ``--mp30-child PID NPROC PORT OUT SEED
    DEVICE SMALL PARTS``: :func:`mp30_path` over the comma-separated
    PARTS in :func:`guarded_child`."""
    sz, parts = mp30_sizes(argv[6] == "1"), tuple(argv[7].split(","))
    return guarded_child(argv, MP30_KERNELS, lambda dt, seed, steps:
                         mp30_path(dt, seed, sz, parts, steps))


def rdx_gbps(n, steps, route):
    """The ping-pong's GB/s by bench.py's count (the whole vector twice
    an iteration) from one iteration's two moves."""
    t = (steps[f"redistribute {route} to uneven"]
         + steps[f"redistribute {route} to even"])
    return 2 * n * 4 / t / 1e9


def mp30_phase(dt, kernels, seed, card, nproc=2, device="cuda:0",
               small=False, parts=MP30_PARTS, out_dir=None):
    """Phase 30 (see the module docstring); returns its numbers.  On the
    CPU (``device="cpu"``, ``small=True``) it rehearses the phase; its
    launch checks then compare 0 with 0.  ``parts`` picks sections of
    the path (:data:`MP30_PARTS`); the children write into ``out_dir``
    (default ``chiprun_out/phase30``)."""
    import torch
    from dr_tpu_torch import tuning
    sz = mp30_sizes(small)
    out = {"card": card, "processes": nproc, "sizes": sz,
           "parts": list(parts)}
    log(f"phase 30.1: the relational ops and re-layout with one controller "
        f"on {nproc} ranks of {device}: {json.dumps(sz)}, parts "
        f"{','.join(parts)}")
    dt.init(dt.get_duplicated_devices(nproc, [device]))
    tuning.clear_session()  # the join route from the code default alone
    kernels.reset_counts()
    steps = {}
    t0 = time.perf_counter()
    want = mp30_path(dt, seed, sz, parts, steps, check=True)
    out["single_s"] = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in MP30_KERNELS}
    out["single_steps"] = steps
    out["single_launches"] = counts
    log(f"  30.1 {out['single_s']:.2f} s, launches {counts}")
    if device != "cpu" and min(counts.values()) <= 0:
        raise AssertionError(f"phase 30.1: a kernel of the path never "
                             f"launched: {counts}")
    for k in ("segred", "hist"):
        if counts[k] % nproc:
            raise AssertionError(f"phase 30.1: {k} launched {counts[k]} "
                                 f"times on {nproc} ranks")
    dt.final()
    release(torch)
    log(f"phase 30.2: {nproc} processes (gloo), one rank each on {device}")
    t0 = time.perf_counter()
    recs, starts = mp_spawn(
        nproc, seed, out_dir or os.path.join(HERE, "chiprun_out", "phase30"),
        [device, "1" if small else "0", ",".join(parts)],
        child="--mp30-child", tag="phase 30")
    out["spawn_s"] = time.perf_counter() - t0
    out["starts_s"] = starts
    n = 1 << sz["rdx"]
    if "relayout" in parts:
        out["single_gbps"] = {r: rdx_gbps(n, steps, r)
                              for r in ("collective", "host-staged")}
        log(f"  30.1 redistribute ping-pong at 2^{sz['rdx']} f32: "
            f"{json.dumps(out['single_gbps'])} GB/s (bench.py's count)")
    for rec in recs:
        pid = rec["pid"]
        mine = {k: v for k, v in want.items()
                if "/" not in k or k.endswith(f"/{pid}")}
        if rec["digests"] != mine:
            bad = sorted(k for k in mine if rec["digests"].get(k) != mine[k])
            raise AssertionError(f"phase 30: process {pid}'s digests differ "
                                 f"from the single controller's: {bad}")
        log(f"  process {pid}: {len(mine)} digests equal bit for bit")
        share = mp30_share(counts, pid)
        if rec["launches"] != share:
            raise AssertionError(f"phase 30: process {pid} launched "
                                 f"{rec['launches']}, its rank's share "
                                 f"{share} of one controller's {counts}")
        log(f"  process {pid} launches {rec['launches']} == its rank's "
            f"share")
        out[f"p{pid}_steps"] = rec["steps"]
        out[f"p{pid}_path_s"] = rec["path_s"]
        out[f"p{pid}_launches"] = rec["launches"]
        log(f"  process {pid}: start {starts[pid]!r} s, path "
            f"{rec['path_s']!r} s (one controller {out['single_s']!r} s), "
            f"{rec['guarded']} guarded dispatches verified")
        if "relayout" in parts:
            gb = {r: rdx_gbps(n, rec["steps"], r)
                  for r in ("collective", "host-staged")}
            out[f"p{pid}_gbps"] = gb
            log(f"  process {pid} redistribute ping-pong across processes: "
                f"{json.dumps(gb)} GB/s (bench.py's count; "
                f"{want['redistribute moved'] * 4} bytes change process a "
                f"move)")
        for k, t in rec["steps"].items():
            log(f"    {k}: {t!r} s, one controller {steps.get(k)!r} s")
    log(f"  phase 30 {out['spawn_s']:.1f} s for the processes")
    return out


# phase 31: the host layers across processes (deferred plans, tuning,
# the elastic shrink with the killed-worker leg)
MP31_LOG2 = 30             # 31.1 / 31.2: the region at phase 28's width
MP31_JOIN_LOG2 = 24        # 31.3: join / join_auto fact rows (K6, K7)
MP31_KILL_LOG2 = 28        # 31.4: the checkpointed vector
MP31_BINS, MP31_TOPK = 1024, 8
MP31_KERNELS = ("stencil_matmul", "stencil_blocked", "chunked_dot",
                "chunked_cumsum", "segred", "hist")
#: the tuning records of 31.3: a join route threshold above the sides'
#: rows (the broadcast merge, where the code default takes the
#: partition route) and the inner join's rows/input ratio hint
MP31_RECORDS = (("join", "broadcast_max", 1 << 26),
                ("relational", "cap_ratio_join_inner", 1.0),
                ("relational", "cap_ratio_groupby", 0.05))
KILLED = 17


def mp31_sizes(small=False):
    """Phase 31's sizes; ``small`` gives a CPU rehearsal's.  ``region``:
    (log2 n, K1's k_block and halo, K2's time block and halo)."""
    if small:
        return {"region": (14, 16, 128, 8, 1024), "join": 12, "kill": 12}
    return {"region": (MP31_LOG2, K_BLOCK, MM_HALO, T_BLOCK, BLK_HALO),
            "join": MP31_JOIN_LOG2, "kill": MP31_KILL_LOG2}


def rank_digests(dig, rt, name, v):
    """``bridge_digest`` of each local rank's owned cells of ``v`` into
    ``dig`` under ``<name>/<rank>``."""
    prev = v.halo_bounds.prev
    for r in rt.local_ranks:
        b, e = v._rank_window(r)
        dig[f"{name}/{r}"] = bridge_digest(v.rows[r][0, prev:prev + e - b])


def mp31_region(dt, seed, sz, times):
    """Phase 31.1's deferred region of the main path on the current
    runtime (one controller or one process of several): fill, for_each,
    a halo exchange, transform, reduce, dot (K3), histogram (K8) and
    top_k of the bins (the fullest 8; a top_k of the 2^30 values sorts
    each rank whole, ~30 GiB a process, more than two processes' share
    of the card) fused into one run; ``inclusive_scan`` (K4),
    ``stencil_iterate_blocked`` (K2) and ``stencil_iterate_matmul``
    (K1) recorded opaque; ``dot_n`` (K3) after the flush.  Returns
    ``(digests, the plan's stats)``: each local rank's cells and every
    scalar's bits."""
    import torch
    log2, k_block, mm_halo, t_block, blk_halo = sz["region"]
    n = 1 << log2
    step = stepper(dt, times)
    rt = dt.runtime()
    dev = rt.home
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    dig = {}
    with step("data"):
        hb = dt.halo_bounds(mm_halo, mm_halo, periodic=True)
        a = dt.distributed_vector(n, np.float32, halo=hb)
        b = dt.distributed_vector(n, np.float32, halo=hb)
        x = dt.distributed_vector.from_array(
            torch.rand(n, generator=gen, device=dev))
        bv = dt.distributed_vector.from_array(
            torch.randn(n, generator=gen, device=dev),
            halo=dt.halo_bounds(blk_halo, blk_halo, periodic=True))
        s = dt.distributed_vector(n, np.float32)
        h = dt.distributed_vector(MP31_BINS, np.int32)
        tv = dt.distributed_vector(MP31_TOPK, np.int32)
        ti = dt.distributed_vector(MP31_TOPK, np.int32)
    plan = dt.plan.Plan()
    with step("region"):
        with plan.record():
            dt.iota(a, 0)
            dt.fill(a[n // 3:n // 2], 0.5)
            dt.for_each(a, _pl_scale, 2.0 ** -20)
            dt.halo(a).exchange()
            dt.transform(a, b, _pl_shift, -0.5)
            tot = dt.reduce(b)
            d = dt.dot(a, b)
            dt.histogram(x, h, 0.0, 1.0)
            dt.top_k(h, tv, ti)
            dt.inclusive_scan(x, s)
            dt.stencil_iterate_blocked(bv, W5, t_block, time_block=t_block)
            dt.stencil_iterate_matmul(a, W5, k_block, k_block=k_block)
    with step("dot_n"):
        dn = dt.dot_n(x, x, DOT_ROUNDS)
    for name, sc in (("reduce", tot.device()), ("dot", d.device()),
                     ("dot_n", dn)):
        dig[name] = bridge_digest(torch.as_tensor(sc).reshape(1))
    for name, v in (("a", a), ("b", b), ("scan", s), ("blocked", bv)):
        rank_digests(dig, rt, name, v)
    for name, v in (("hist", h), ("top_v", tv), ("top_i", ti)):
        dig[name] = bridge_digest(v.to_array())
    return dig, plan.stats()


def mp31_joins(dt, seed, sz, db, times):
    """Phase 31.3: the tuning DB at ``db`` armed (``DR_GPU_PLAN_OPT=all``
    for the ``capinfer`` and ``joinroute`` passes); every process
    records :data:`MP31_RECORDS` (process 0 writes them), then ``join``
    and ``join_auto`` of 2^k fact rows over 2^(k-4) keys, and
    ``groupby_auto`` (sum) at the kernel geometry (:data:`MP30_GEO`
    int32 keys a rank over 512 keys: K6 sorts them, K7 sums the
    groups), its capacity from the ``cap_ratio_groupby`` hint.  Returns
    the digests of the joined and grouped rows and counts, the routes
    taken and the answers of the lookups."""
    import torch
    from dr_tpu_torch import tuning
    from dr_tpu_torch.algorithms import relational as rel
    step = stepper(dt, times)
    rt = dt.runtime()
    fl = sz["join"]
    env = {"DR_GPU_TUNING_DB": db, "DR_GPU_PLAN_OPT": "all"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    tuning.clear_session()
    tuning.reload()
    dig = {}
    try:
        for dom, par, val in MP31_RECORDS:
            tuning.record(dom, par, val, source="chip_smoke phase 31")
        dig["lookups"] = [tuning.lookup(dom, par)
                          for dom, par, _ in MP31_RECORDS]
        data = relational_data(1 << fl, 1 << (fl - 4), seed + 31,
                               rt.home)
        F, FV, D, DV = (dt.distributed_vector.from_array(t) for t in data)
        cap = 2 * (data[0].numel() + data[2].numel())
        outs = [dt.distributed_vector(cap) for _ in range(3)]
        with step("join (joinroute)"):
            m = dt.join(F, FV, D, DV, *outs)
        dig["join m"] = m
        dig["join route"] = rel.last_join_route()["impl"]
        for name, o in zip(("keys", "left", "right"), outs):
            rank_digests(dig, rt, f"join {name}", o)
        del outs
        with step("join_auto (capinfer)"):
            res = dt.join_auto(F, FV, D, DV)
            am = int(res.count)
        dig["auto m"] = am
        dig["auto route"] = rel.last_join_route()["impl"]
        for name, o in zip(("keys", "left", "right"), res.containers):
            rank_digests(dig, rt, f"auto {name}", o)
        dig["auto noted"] = tuning.lookup("relational",
                                          "cap_ratio_join_inner")
        del res, F, FV, D, DV, data
        rng = np.random.default_rng(seed + 31)
        nk = MP30_GEO * rt.nprocs
        gk = dt.distributed_vector.from_array(
            rng.integers(0, 512, nk).astype(np.int32))
        gv = dt.distributed_vector.from_array(
            rng.integers(0, 99, nk).astype(np.int32))
        with step("groupby_auto (capinfer; K6, K7)"):
            res = dt.groupby_auto(gk, gv, agg="sum")
            dig["groupby ng"] = int(res.count)
        for name, o in zip(("keys", "sums"), res.containers):
            rank_digests(dig, rt, f"groupby {name}", o)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tuning.clear_session()
        tuning.reload()
    release(torch)
    return dig


def mp31_kill_values(dt, seed, n):
    """31.4's source: 2^k f32 on the home device, from the seed."""
    import torch
    gen = torch.Generator(device=dt.runtime().home).manual_seed(seed + 314)
    return torch.randn(n, generator=gen, device=dt.runtime().home)


def mp31_after(dt, kernels, v, dig):
    """``dot_n`` (K3) and ``inclusive_scan`` (K4) on the restored vector
    ``v`` (one rank), their digests and ``v``'s into ``dig``; returns
    their launches."""
    import torch
    kernels.reset_counts()
    dn = dt.dot_n(v, v, DOT_ROUNDS)
    s = dt.distributed_vector(len(v), np.float32)
    dt.inclusive_scan(v, s)
    dt.fence()
    dig["restored"] = bridge_digest(v.to_array())
    dig["dot_n"] = bridge_digest(torch.as_tensor(dn).reshape(1))
    dig["scan"] = bridge_digest(s.to_array())
    return {k: kernels.launches[k] for k in ("chunked_dot",
                                             "chunked_cumsum")}


def mp31_kill(dt, kernels, pid, seed, sz, ckpt):
    """Phase 31.4 in one process of two: checkpoint a 2^k f32 vector,
    double it, barrier; process 1 exits with :data:`KILLED`.  Process 0
    meets the dead peer in a ``reduce`` under ``with_deadline``,
    attributes the failure to rank 1, shrinks onto rank 0 (the
    vector's rank-1 half restored from the checkpoint) and runs
    :func:`mp31_after`.  Returns process 0's numbers."""
    import torch.distributed as dist
    from dr_tpu_torch.utils import elastic, resilience
    n = 1 << sz["kill"]
    v = dt.distributed_vector.from_array(mp31_kill_values(dt, seed, n))
    t0 = time.perf_counter()
    dt.checkpoint.save(ckpt, v)
    save_s = time.perf_counter() - t0
    dt.for_each(v, _pl_scale, 2.0)
    dt.barrier()
    if pid != 0:
        os._exit(KILLED)
    gc.collect()
    t0 = time.perf_counter()
    try:
        resilience.with_deadline(lambda: float(dt.reduce(v)), 60.0,
                                 site="elastic.multihost", dump=False)
        raise AssertionError("phase 31.4: the dead peer went unnoticed")
    except resilience.DeadlineExpired as e:
        how, err = "deadline", e
    except Exception as e:  # noqa: BLE001 - whatever the backend raised
        how, err = "raised", e
    fail_s = time.perf_counter() - t0
    rep = elastic.rescue_session(elastic.attribute(err, 1))
    rescue_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dist.destroy_process_group()
    destroy_s = time.perf_counter() - t1
    dig = {}
    launches = mp31_after(dt, kernels, v, dig)
    return {"digests": dig, "launches": launches, "how": how,
            "error": f"{type(err).__name__}: {str(err)[:160]}",
            "fail_s": fail_s, "rescue_s": rescue_s, "save_s": save_s,
            "destroy_s": destroy_s, "fates": [rep.rescued, rep.restored,
                                              rep.lost],
            "restore_s": rep.seconds, "restore_gbps": n * 4 /
            sum(rep.seconds) / 1e9, "nprocs": dt.nprocs()}


def mp31_child(argv):
    """One process of phase 31: ``--mp31-child PID NPROC PORT OUT SEED
    DEVICE SMALL LEG TMP``.  LEG ``region``: :func:`mp31_region`, then
    :func:`mp31_joins` with the DB in TMP, each under an
    ``spmd_guard`` (``verify()`` after it), its launches counted apart;
    LEG ``kill``: :func:`mp31_kill` with the checkpoint in TMP (process
    1 exits with :data:`KILLED` and writes nothing).  Writes its
    numbers to ``OUT/child<PID>.json``."""
    pid, nproc, port, out, seed, device = (
        int(argv[0]), int(argv[1]), argv[2], argv[3], int(argv[4]), argv[5])
    sz, leg, tmp = mp31_sizes(argv[6] == "1"), argv[7], argv[8]
    import warnings
    import torch
    sys.path.insert(0, HERE)
    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import kernels
    from dr_tpu_torch.utils import elastic, spmd_guard
    warnings.simplefilter("ignore", elastic.ElasticWarning)
    global LOG_FILE
    LOG_FILE = open(os.path.join(out, f"child{pid}.log"), "w",
                    encoding="utf-8")
    rt = dt.init_distributed(f"localhost:{port}", nproc, pid,
                             backend="gloo", device=device,
                             timeout_s=MP_DEADLINE)
    ready = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    assert rt.local_ranks == [pid], rt
    rec = {"pid": pid, "ready": ready}
    if leg == "kill":
        rec.update(mp31_kill(dt, kernels, pid, seed, sz,
                             os.path.join(tmp, "phase31_kill.npz")))
    else:
        steps = {}
        kernels.reset_counts()
        with spmd_guard.guard() as g:
            t0 = time.perf_counter()
            dig, stats = mp31_region(dt, seed, sz, steps)
            rec["region_s"] = time.perf_counter() - t0
            g.verify()
        rec["launches"] = {k: kernels.launches[k] for k in MP31_KERNELS}
        rec.update(digests=dig, stats=stats, guarded=len(g.trace))
        kernels.reset_counts()
        with spmd_guard.guard() as g:
            t0 = time.perf_counter()
            rec["joins"] = mp31_joins(dt, seed, sz,
                                      os.path.join(tmp, "tuning_db.json"),
                                      steps)
            rec["joins_s"] = time.perf_counter() - t0
            g.verify()
        rec["join_launches"] = {k: kernels.launches[k]
                                for k in MP30_KERNELS}
        rec["steps"] = steps
        dt.barrier()
    with open(os.path.join(out, f"child{pid}.json"), "w") as fh:
        json.dump(rec, fh)
    dt.final()
    return 0


def mp31_phase(dt, kernels, seed, card, nproc=2, device="cuda:0",
               small=False, out_dir=None):
    """Phase 31 (see the module docstring); returns its numbers.  On the
    CPU (``device="cpu"``, ``small=True``) it rehearses the phase; its
    launch checks then compare 0 with 0.  The children write into
    ``out_dir`` (default ``chiprun_out/phase31``); the tuning DB and the
    checkpoint go to a temp directory removed at the end."""
    import shutil
    import tempfile
    import torch
    from dr_tpu_torch import tuning
    sz = mp31_sizes(small)
    out = {"card": card, "processes": nproc, "sizes": sz}
    out_dir = out_dir or os.path.join(HERE, "chiprun_out", "phase31")
    tmp = tempfile.mkdtemp(prefix="dr_gpu_phase31_")
    try:
        log(f"phase 31.1: the deferred region with one controller on "
            f"{nproc} ranks of {device}: {json.dumps(sz)}")
        dt.init(dt.get_duplicated_devices(nproc, [device]))
        tuning.clear_session()
        kernels.reset_counts()
        steps = {}
        t0 = time.perf_counter()
        want, stats = mp31_region(dt, seed, sz, steps)
        out["single_region_s"] = time.perf_counter() - t0
        counts = {k: kernels.launches[k] for k in MP31_KERNELS}
        out.update(single_steps=steps, single_launches=counts,
                   single_stats=stats)
        log(f"  31.1 {out['single_region_s']:.2f} s, launches {counts}, "
            f"stats {json.dumps(stats)}, steps {json.dumps(steps)}")
        for k, c in counts.items():
            if c % nproc or (device != "cpu" and k != "segred"
                             and c <= 0):
                raise AssertionError(f"phase 31.1: {k} launched {c} times "
                                     f"on {nproc} ranks")
        share = {k: c // nproc for k, c in counts.items()}
        log("phase 31.3 (one controller): join, join_auto and "
            "groupby_auto under the tuning DB")
        kernels.reset_counts()
        t0 = time.perf_counter()
        want_j = mp31_joins(dt, seed, sz, os.path.join(tmp, "one_db.json"),
                            steps)
        out["single_joins_s"] = time.perf_counter() - t0
        jcounts = {k: kernels.launches[k] for k in MP30_KERNELS}
        out["single_join_launches"] = jcounts
        log(f"  31.3 one controller {out['single_joins_s']:.2f} s, routes "
            f"{want_j['join route']} / {want_j['auto route']}, lookups "
            f"{want_j['lookups']}, launches {jcounts}")
        dt.final()
        release(torch)
        log(f"phase 31.2-31.3: {nproc} processes (gloo), one rank each on "
            f"{device}")
        t0 = time.perf_counter()
        recs, starts = mp_spawn(nproc, seed, out_dir,
                                [device, "1" if small else "0", "region",
                                 tmp], child="--mp31-child",
                                tag="phase 31")
        out["spawn_s"] = time.perf_counter() - t0
        out["starts_s"] = starts
        for rec in recs:
            pid = rec["pid"]
            mine = {k: v for k, v in want.items()
                    if "/" not in k or k.endswith(f"/{pid}")}
            if rec["digests"] != mine:
                bad = sorted(k for k in mine
                             if rec["digests"].get(k) != mine[k])
                raise AssertionError(f"phase 31.2: process {pid}'s digests "
                                     f"differ from one controller's: {bad}")
            log(f"  process {pid}: {len(mine)} region digests equal bit "
                f"for bit")
            if rec["launches"] != share:
                raise AssertionError(f"phase 31.2: process {pid} launched "
                                     f"{rec['launches']}, its rank's share "
                                     f"{share} of {counts}")
            log(f"  process {pid} launches {rec['launches']} == its rank's")
            jmine = {k: v for k, v in want_j.items()
                     if "/" not in k or k.endswith(f"/{pid}")}
            if rec["joins"] != jmine:
                bad = sorted(k for k in jmine
                             if rec["joins"].get(k) != jmine[k])
                raise AssertionError(f"phase 31.3: process {pid}'s joins "
                                     f"differ from one controller's: {bad}")
            if device != "cpu" and min(jcounts[k] for k in
                                       ("bitonic_sort", "segred")) <= 0:
                raise AssertionError(f"phase 31.3: K6 / K7 never launched: "
                                     f"{jcounts}")
            jshare = mp30_share(jcounts, pid)
            if rec["join_launches"] != jshare:
                raise AssertionError(f"phase 31.3: process {pid} launched "
                                     f"{rec['join_launches']}, its rank's "
                                     f"share {jshare} of {jcounts}")
            log(f"  process {pid}: joins routed {rec['joins']['join route']}"
                f" / {rec['joins']['auto route']} (one controller's), "
                f"{len(jmine)} digests equal, launches "
                f"{rec['join_launches']}")
            for k in ("region_s", "joins_s", "steps", "stats", "guarded"):
                out[f"p{pid}_{k}"] = rec[k]
            log(f"  process {pid}: start {starts[pid]!r} s, region "
                f"{rec['region_s']!r} s (one controller "
                f"{out['single_region_s']!r} s), joins {rec['joins_s']!r} s "
                f"(one controller {out['single_joins_s']!r} s), "
                f"{rec['guarded']} guarded dispatches verified, stats "
                f"{json.dumps(rec['stats'])}")
        if any(r["stats"] != recs[0]["stats"] for r in recs):
            raise AssertionError("phase 31.2: the processes' Plan.stats() "
                                 f"differ: {[r['stats'] for r in recs]}")
        if any(r["joins"]["join route"] != recs[0]["joins"]["join route"]
               for r in recs):
            raise AssertionError("phase 31.3: the processes' routes differ")
        release(torch)

        log(f"phase 31.4: the killed-worker leg, 2^{sz['kill']} f32")
        t0 = time.perf_counter()
        recs, starts = mp_spawn(nproc, seed, out_dir,
                                [device, "1" if small else "0", "kill",
                                 tmp], child="--mp31-child",
                                tag="phase 31.4", exits={1: KILLED})
        out["kill_spawn_s"] = time.perf_counter() - t0
        rec = recs[0]
        dt.init([device])
        n = 1 << sz["kill"]
        src = mp31_kill_values(dt, seed, n)
        half = n // nproc
        ref = dt.distributed_vector.from_array(
            torch.cat([src[:half] * 2.0, src[half:]]))
        del src
        want_k = {}
        ref_launches = mp31_after(dt, kernels, ref, want_k)
        del ref
        dt.final()
        release(torch)
        if rec["digests"] != want_k or rec["fates"] != [0, 1, 0] or \
                rec["nprocs"] != 1:
            raise AssertionError(f"phase 31.4: the survivor's {rec} against "
                                 f"one controller's {want_k}")
        if rec["launches"] != ref_launches or (
                device != "cpu" and min(ref_launches.values()) <= 0):
            raise AssertionError(f"phase 31.4: the survivor launched "
                                 f"{rec['launches']}, one controller "
                                 f"{ref_launches}")
        for k in ("how", "error", "fail_s", "rescue_s", "save_s",
                  "destroy_s", "restore_gbps", "launches"):
            out[f"kill_{k}"] = rec[k]
        log(f"  31.4 survivor: the dead peer's reduce {rec['how']} after "
            f"{rec['fail_s']!r} s ({rec['error']}); failed call to "
            f"finished rescue {rec['rescue_s']!r} s, restore "
            f"{rec['restore_gbps']!r} GB/s ({rec['restore_s']} s), "
            f"checkpoint save {rec['save_s']!r} s, destroy_process_group "
            f"{rec['destroy_s']!r} s; digests of the restored vector, "
            f"dot_n and inclusive_scan equal one controller's, launches "
            f"{rec['launches']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# --------------------------- phase 32: the C++ bridge across processes

#: phase 32.2: ``bridge_parity --mp``'s input, cut from 27.2's 2^28 f32
#: (every ``to_host`` gathers the whole vector onto each process through
#: gloo), its windowed sorts (27.2's 2^14 keys, K6) and its runs
MP32_LOG2, MP32_REPS = 24, 2
#: seconds the C++ processes of one step of phase 32 may take together
MP32_DEADLINE = 240.0
#: the kernels phase 32's processes are held to
MP32_KERNELS = ("chunked_dot", "chunked_cumsum", "bitonic_sort", "segred")


def rank_share(single, nproc):
    """The launches each of ``nproc`` processes (one rank each, one
    device) must make, from one controller's on ``nproc`` ranks of that
    device: K6 sorts a device's ranks in one batch, one launch a sort on
    one controller and in each process alike; every other kernel
    launches once a rank a call, so each process makes its rank's
    share."""
    out = {}
    for k, c in single.items():
        if k == "bitonic_sort":
            out[k] = c
            continue
        if c % nproc:
            raise AssertionError(f"{k} launched {c} times on {nproc} "
                                 "ranks: not once a rank a call")
        out[k] = c // nproc
    return out


def spawn_programs(argvs, tag, workdir, deadline=MP32_DEADLINE):
    """Start one C++ bridge program a process (``argvs``, all at once,
    with ``native.env()``), each writing into ``workdir/<pid>.out``;
    wait for all under ``deadline``.  A process that fails gets its
    peers killed (they would wait in a collective), and so does the
    deadline.  Raises unless every process exits 0; returns their
    outputs and the seconds they took."""
    from dr_tpu_torch import native
    env = native.env()
    files = [open(os.path.join(workdir, f"{pid}.out"), "w+",
                  encoding="utf-8") for pid in range(len(argvs))]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([str(a) for a in argv], env=env,
                                  stdout=fh, stderr=subprocess.STDOUT,
                                  cwd=HERE)
                 for argv, fh in zip(argvs, files)]
        end = time.monotonic() + deadline
        failed = False
        while time.monotonic() < end:
            if all(p.poll() is not None for p in procs):
                break
            if any(p.poll() not in (None, 0) for p in procs):
                failed = True
                time.sleep(2)  # let the peers fail and flush on their own
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        seconds = time.perf_counter() - t0
        outs = []
        for fh in files:
            fh.seek(0)
            outs.append(fh.read())
    finally:
        for fh in files:
            fh.close()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            why = "failed" if failed else f"missed the {deadline} s deadline"
            raise AssertionError(f"{tag}: process {pid} {why} (exit "
                                 f"{p.returncode}): {o[-3000:]}")
    return outs, seconds


def mp_demo_direct(dt, nproc):
    """``bridge_mp_demo``'s device calls made directly from Python on one
    controller, in its order and with its sizes (host reads that launch
    nothing left out)."""
    from dr_tpu_torch.utils.expr import op_from_expr as E

    def vec(k, **kw):
        return dt.distributed_vector(k, dtype=kw.pop("dtype", np.float32),
                                     **kw)

    n = 4 * nproc
    v = vec(n)
    dt.iota(v, 1.0)
    dt.reduce(v)
    w = vec(n)
    dt.fill(w, 2.0)
    dt.dot(v, w)
    out = vec(n)
    dt.transform(v, out, E("((x0 * 2) + 1)", 1))
    keys = vec(n)
    dt.transform(v, keys, E("(0 - x0)", 1))
    dt.sort(keys, descending=False)
    dt.is_sorted(keys)
    iv = vec(n, dtype=np.int32)
    dt.iota(iv, 0.0)
    dt.reduce(iv)
    wv = vec(n)
    dt.transform(v, wv, E("(0 - x0)", 1))
    dt.sort(wv[1:n - 1], descending=False)
    dt.is_sorted(wv[1:n - 1])
    sizes = [0] * nproc
    sizes[0] = n - 1
    sizes[-1] += 1
    uv = vec(n, distribution=sizes)
    dt.iota(uv, 1.0)
    dt.reduce(uv)


def check_shares(tag, outs, direct, nproc, device):
    """Each process's launch counts (its ``launches`` line) equal its
    rank's share of ``direct``, one controller's on ``nproc`` ranks."""
    share = rank_share(direct, nproc)
    for pid, text in enumerate(outs):
        got = child_counts(text)
        log(f"  {tag} process {pid} launches {got}")
        if got != share:
            raise AssertionError(f"{tag}: process {pid} launched {got}, its "
                                 f"rank's share {share} of one "
                                 f"controller's {direct}")
    log(f"  {tag}: each process launched its rank's share {share} of one "
        f"controller's {direct}")
    if device != "cpu" and not any(share[k] for k in MP32_KERNELS):
        raise AssertionError(f"{tag}: no kernel launched from the C++ "
                             "processes")
    return share


def bridge_mp_phase(dt, kernels, seed, card, device="cuda:0", nproc=2,
                    log2=MP32_LOG2, window=BRIDGE_WINDOW, reps=MP32_REPS,
                    parity=True):
    """Phase 32: the C++ bridge across processes, ``nproc`` processes
    each owning one rank on ``device`` over gloo.  32.1
    ``bridge_mp_demo``: every process passes and launches its rank's
    share of ``mp_demo_direct`` on one controller; 32.2 (``parity``)
    ``bridge_parity --mp`` at 2^``log2`` f32 from one checkpoint: each
    process's digests equal ``parity_direct``'s on one controller bit
    for bit (the sparse product held to the csr route, the one across
    processes), its launches its rank's share, each call's least host ms
    both ways and each process's start.  Returns its numbers."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from dr_tpu_torch import native
    on_card = device != "cpu"
    out = {"card": card, "processes": nproc}
    t0 = time.perf_counter()
    log(f"phase 32: the C++ bridge across {nproc} processes (gloo), one "
        f"rank each on {device}: bridge_mp_demo, bridge_parity --mp at "
        f"2^{log2} f32 (windowed sorts of {window} keys, {reps} runs)")
    progs = ["bridge_mp_demo"] + (["bridge_parity"] if parity else [])
    with ThreadPoolExecutor(len(progs)) as ex:
        demo, *par = ex.map(native.build,
                            [native.HERE / f"{p}.cpp" for p in progs])
    out["build_s"] = time.perf_counter() - t0
    log(f"  [{card}] {' and '.join(progs)} built in "
        f"{out['build_s']:.1f} s")
    devices = [device] * nproc
    with tempfile.TemporaryDirectory() as td:
        port = free_port()
        outs, out["demo_s"] = spawn_programs(
            [[demo, pid, nproc, port, "cuda" if on_card else "cpu"]
             for pid in range(nproc)], "32.1 bridge_mp_demo", td)
        for pid, text in enumerate(outs):
            if f"bridge_mp_demo pid={pid}/{nproc}: PASSED" not in text:
                raise AssertionError(f"32.1: process {pid} did not pass: "
                                     f"{text[-3000:]}")
        log(f"  [{card}] 32.1 {nproc} bridge_mp_demo processes passed in "
            f"{out['demo_s']:.2f} s")
        dt.init(devices)
        kernels.reset_counts()
        mp_demo_direct(dt, nproc)
        direct = dict(kernels.launches)
        dt.final()
        out["demo_launches"] = direct
        check_shares("32.1 bridge_mp_demo", outs, direct, nproc, device)
        if not parity:
            out["seconds"] = time.perf_counter() - t0
            return out

        n = 1 << log2
        ckpt = os.path.join(td, "x.npz")
        dt.init(devices)
        gen = torch.Generator(device=device).manual_seed(seed + 32)
        x = torch.randn(n, generator=gen, device=device)
        dt.checkpoint.save(ckpt, dt.distributed_vector.from_array(x))
        del x
        dt.final()
        release(torch)
        port = free_port()
        outs, out["parity_s"] = spawn_programs(
            [[par[0], 0 if on_card else 1, ckpt, "-", "--window", window,
              "--reps", reps, "--seed", seed % 1000, "--sync", BRIDGE_SYNC,
              "--after", BRIDGE_COUNTS, "--mp", pid, nproc, port]
             for pid in range(nproc)], "32.2 bridge_parity --mp", td)
        dt.init(devices)
        kernels.reset_counts()
        t1 = time.perf_counter()
        with env_set(DR_GPU_SPMV_FORMAT="csr"):  # the route across processes
            want, d_times = parity_direct(dt, ckpt, seed % 1000, window, reps,
                                          sync=dt.fence)
        out["direct_s"] = time.perf_counter() - t1
        direct = dict(kernels.launches)
        dt.final()
        release(torch)
    for pid, text in enumerate(outs):
        got = child_lines(text, "digest")
        if got != want:
            bad = sorted(k for k in set(got) | set(want)
                         if got.get(k) != want.get(k))
            raise AssertionError(f"32.2: process {pid}'s digests differ "
                                 f"from one controller's at {bad}")
        if f"nprocs {nproc}" not in text:
            raise AssertionError(f"32.2: process {pid} saw another rank "
                                 f"count: {text[-2000:]}")
        log(f"  32.2 process {pid}: {len(got)} digests of 2^{log2} equal "
            f"to one controller's bit for bit")
    out["parity_launches"] = direct
    check_shares("32.2 bridge_parity --mp", outs, direct, nproc, device)
    if on_card:
        for k in MP32_KERNELS:
            if direct[k] <= 0:
                raise AssertionError(f"32.2: kernel {k} never launched on "
                                     f"one controller's sequence {direct}")
    calls = {}
    for pid, text in enumerate(outs):
        b_times = {k: float(v) for k, v in child_lines(text, "time").items()}
        out[f"p{pid}_start_ms"] = b_times.pop("start")
        log(f"  [{card}] 32.2 process {pid} start (Py_Initialize, import "
            f"torch, init_distributed): {out[f'p{pid}_start_ms']!r} ms")
        for k, ms in b_times.items():
            calls.setdefault(k, {"direct_ms": d_times[k]})[f"p{pid}_ms"] = ms
    for k, v in calls.items():
        log(f"  [{card}] 32.2 {k}: " + ", ".join(
            f"process {pid} {v[f'p{pid}_ms']!r} ms" for pid in range(nproc))
            + f"; one controller {v['direct_ms']!r} ms")
    out.update(calls=calls, digests=want, seconds=time.perf_counter() - t0)
    log(f"  [{card}] phase 32 {out['seconds']:.1f} s")
    return out


# ------------------------------------------------ phase 33: the examples

#: the arguments phase 33 gives an example beyond its defaults, by rank
#: count: 2^16 keys over 4 ranks put 16384 on each, K6's geometry
EX_ARGV = {4: {"sort_example": ["-n", "65536"]}}
#: floats on an example's printed lines: one run's against another's
#: within the loosest bound of the example's own oracle (dot: 1e-3
#: relative; CG: resid 1e-3, max_err 1e-2; ring attention: 1e-3)
EX_RTOL, EX_ATOL = 1e-3, 1e-2
#: printed numbers that the order of f32 additions moves beyond that:
#: CG's iteration count (within one), the scan's f32 total printed as an
#: integer (its oracle's 1e-3)
EX_LOOSE = {"iters": (0, 1), "total": (1e-3, 0)}
_TOKEN = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?"
                    r"|[A-Za-z_]+|\S")


def result_tokens(text):
    """The tokens of an example's printed lines, one list a line: numbers
    (int or float), words and single symbols."""
    lines = []
    for line in text.splitlines():
        toks = []
        for t in _TOKEN.findall(line):
            if re.fullmatch(r"[-+]?\d+", t):
                toks.append(int(t))
            elif t[-1].isdigit() or t[-1] == ".":
                toks.append(float(t))
            else:
                toks.append(t)
        lines.append(toks)
    return lines


def tokens_differ(a, b, rtol, atol, loose=None):
    """Where two examples' printed lines differ (None where they agree):
    equal words, equal integers, floats within ``rtol`` / ``atol``; the
    numbers after a word of ``loose`` (word -> (rtol, atol)) within that
    word's bound instead, integers too."""
    ta, tb = result_tokens(a), result_tokens(b)
    if len(ta) != len(tb):
        return f"{len(ta)} lines against {len(tb)}"
    for i, (la, lb) in enumerate(zip(ta, tb)):
        if len(la) != len(lb):
            return f"line {i}: {la} against {lb}"
        word = None
        for x, y in zip(la, lb):
            if isinstance(x, str) or isinstance(y, str):
                if x != y:
                    return f"line {i}: {x!r} against {y!r}"
                if isinstance(x, str) and x.isalpha():
                    word = x
                continue
            if word in (loose or {}):
                rt, at = loose[word]
            elif isinstance(x, int) and isinstance(y, int):
                rt, at = 0, 0
            else:
                rt, at = rtol, atol
            if not abs(x - y) <= at + rt * abs(y):
                return f"line {i}: {word} {x!r} against {y!r}"
    return None


def run_example(name, argv):
    """``dr_tpu_torch.examples.<name>.main(argv)`` in this process;
    returns its exit code, what it printed and its seconds."""
    import importlib
    import io
    mod = importlib.import_module(f"dr_tpu_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return rc, buf.getvalue(), time.perf_counter() - t0


def ex_prediction(name, P, text):
    """The kernels an example is predicted to launch on ``P`` CUDA ranks
    (``text``: what it printed): {kernel: exact count, or None for at
    least one}."""
    if name == "dot_product":
        return {"chunked_dot": P}
    if name == "conjugate_gradient":  # one dot before the loop, two in it
        its = int(re.search(r"iters=(\d+)", text).group(1))
        return {"chunked_dot": P * (1 + 2 * its)}
    if name == "inclusive_scan_example":
        return {"chunked_cumsum": P}
    if name == "windows_example":  # its key-value sort of 2^15 keys: K6
        return {"chunked_cumsum": P, "bitonic_sort": None}
    if name == "sort_example" and P > 1:
        return {"bitonic_sort": None}
    if name == "stencil_1d":  # the plain step's kernel, a rank a step
        its = int(re.search(r"steps=(\d+)", text).group(1))
        return {"stencil_step": P * its}
    return {}


def examples_phase(dt, kernels, card, device="cuda:0", ranks=(1, 4),
                   argv=None):
    """Phase 33: every example of ``dr_tpu_torch.examples`` through its
    ``main`` in this process, at its defaults (``argv``: {name: extra
    arguments}, for a CPU rehearsal), on 1 and on 4 logical ranks of
    ``device`` (33.1, 33.2), the counts reset before each; then again
    under ``plain_versions``.  Each run returns 0, the plain one launches
    nothing, the two print the same results (within the examples' own
    oracles), and each example launches what ``ex_prediction`` says
    (other launches are logged as outside the prediction).  Returns the
    launches and seconds of every example."""
    import torch
    from dr_tpu_torch.examples import NAMES
    on_card = device != "cpu"
    out = {"card": card}
    t0 = time.perf_counter()
    for step, P in zip(("33.1", "33.2"), ranks):
        log(f"phase {step}: the {len(NAMES)} examples on {P} rank(s) of "
            f"{device}")
        dev_arg = ["--ranks", str(P)] if on_card else ["--cpu", str(P)]
        for name in NAMES:
            args = list((argv or {}).get(name, [])) + \
                EX_ARGV.get(P, {}).get(name, []) + dev_arg
            kernels.reset_counts()
            rc, text, secs = run_example(name, args)
            counts = {k: c for k, c in kernels.launches.items() if c}
            dt.final()
            release(torch)
            if rc != 0:
                raise AssertionError(f"{step} {name} {args} returned {rc}: "
                                     f"{text[-2000:]}")
            with plain_versions(kernels):
                kernels.reset_counts()
                prc, ptext, psecs = run_example(name, args)
                plain_counts = {k: c for k, c in kernels.launches.items()
                                if c}
            dt.final()
            release(torch)
            if prc != 0 or plain_counts:
                raise AssertionError(f"{step} {name} under the plain "
                                     f"versions returned {prc}, launched "
                                     f"{plain_counts}: {ptext[-2000:]}")
            why = tokens_differ(text, ptext, EX_RTOL, EX_ATOL, EX_LOOSE)
            if why:
                raise AssertionError(f"{step} {name}: the kernels' run and "
                                     f"the plain versions' differ: {why}")
            pred = ex_prediction(name, P, text) if on_card else {}
            for k, want in pred.items():
                got = counts.get(k, 0)
                if (want is None and got <= 0) or (want is not None
                                                    and got != want):
                    raise AssertionError(
                        f"{step} {name}: {k} launched {got} times, "
                        f"predicted {'some' if want is None else want}")
            extra = {k: c for k, c in counts.items() if k not in pred}
            lines = text.strip().splitlines() or [""]
            shown = " | ".join(dict.fromkeys((lines[0], lines[-1])))
            log(f"  [{card}] {step} {name} {' '.join(args)}: {secs!r} s "
                f"(plain versions {psecs!r} s), launches {counts}"
                + (f", outside the prediction {extra}" if extra else "")
                + f"; {shown}")
            out[f"{step} {name}"] = {"seconds": secs, "plain_s": psecs,
                                     "launches": counts, "args": args}
    out["seconds"] = time.perf_counter() - t0
    log(f"  [{card}] phase 33 {out['seconds']:.1f} s")
    return out


def main(argv):
    if argv[:1] == ["--mp-child"]:  # one process of phase 28
        return mp_child(argv[1:])
    if argv[:1] == ["--mp29-child"]:  # one process of phase 29
        return mp29_child(argv[1:])
    if argv[:1] == ["--mp30-child"]:  # one process of phase 30
        return mp30_child(argv[1:])
    if argv[:1] == ["--mp31-child"]:  # one process of phase 31
        return mp31_child(argv[1:])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "dr_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout holding dr_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import dr_tpu_torch as dt
    from dr_tpu_torch.ops import kernels
    global LOG_FILE
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    LOG_FILE = open(LOG_PATH, "w", encoding="utf-8")

    if "--halo-ab" in argv:  # phase 17's p50 against another tree
        card = card_line()
        log(f"card: {card}")
        log(json.dumps(halo_ab(argv[argv.index("--halo-ab") + 1], card)))
        return 0
    quick = "--quick" in argv
    seed = 20261016
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain K1 in full f32
    torch.backends.cudnn.allow_tf32 = False        # the conv1d yardstick

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernels.last_build_seconds:.1f} s)")
    for p in sorted(kernels.BUILD.glob("*.ptxas.txt")):
        for line in p.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {p.stem.split('-')[0]}: {line.strip()}")

    replaces = {
        "stencil_matmul": ("dr_tpu_torch/csrc/stencil_matmul.cu",
                           "dr_tpu/ops/stencil_matmul.py:209"),
        "stencil_blocked": ("dr_tpu_torch/csrc/stencil_blocked.cu",
                            "dr_tpu/ops/stencil_pallas.py:89"),
        "chunked_dot": ("dr_tpu_torch/csrc/dot.cu",
                        "dr_tpu/ops/reduce_pallas.py:64"),
        "chunked_cumsum": ("dr_tpu_torch/csrc/scan.cu",
                           "dr_tpu/ops/scan_pallas.py:244"),
        "stencil2d_blocked": ("dr_tpu_torch/csrc/stencil2d_blocked.cu",
                              "dr_tpu/ops/stencil2d_pallas.py:48"),
        "bitonic_sort": ("dr_tpu_torch/csrc/bitonic_sort.cu",
                         "dr_tpu/ops/sort_pallas.py:87"),
        "segred": ("dr_tpu_torch/csrc/segred.cu",
                   "dr_tpu/ops/segred_pallas.py:89"),
        # K8 is K7's kernel with one int32 sum column, counted on its own
        "hist": ("dr_tpu_torch/csrc/segred.cu",
                 "dr_tpu/ops/hist_pallas.py:32"),
        # one kernel for the resident (:242) and streaming (:150) variants
        "flash_update": ("dr_tpu_torch/csrc/flash_attention.cu",
                         "dr_tpu/ops/flash_attention.py:242,150"),
    }
    results = {k: {"name": k, "route": "cuda", "source": s,
                   "replaces": rp} for k, (s, rp) in replaces.items()}

    only22 = "--phase22" in argv
    only23 = "--phase23" in argv
    only24 = "--phase24" in argv
    only25 = "--phase25" in argv
    only26 = "--phase26" in argv
    only27 = "--phase27" in argv
    only28 = "--phase28" in argv
    only29 = "--phase29" in argv
    only30 = "--phase30" in argv
    only31 = "--phase31" in argv
    only32 = "--phase32" in argv
    only33 = "--phase33" in argv
    short = (quick or only22 or only23 or only24 or only25 or only26
             or only27 or only28 or only29 or only30 or only31 or only32
             or only33)
    n = 1 << (20 if short else 30)
    m2d = 2048 if short else M2D
    gen = torch.Generator(device="cuda").manual_seed(seed)
    log(f"phase 3: kernels vs plain versions at n={n}, {m2d}x{m2d}")
    kernel_checks(dt, n, m2d, gen, results)
    k6_checks(gen, results)
    k7_checks(n, gen, results)
    k8_checks(n, gen, results)
    k9_checks(gen, results)
    torch.cuda.synchronize()
    if quick:
        log(json.dumps({"quick": True, "checked": list(results)}))
        return 0
    if only22:  # a short run: the checks above, small, then phase 22
        log("  phase 22 numbers: " + json.dumps(
            resilience_phase(dt, kernels, gen, seed, card)))
        return 0
    if only23:  # a short run: the checks above, small, then phase 23
        log("  phase 23 numbers: " + json.dumps(
            plans_phase(dt, kernels, seed, card)))
        return 0
    if only24:  # a short run: the checks above, small, then phase 24
        log("  phase 24 numbers: " + json.dumps(
            elastic_phase(dt, kernels, seed, card)))
        return 0
    if only25:  # a short run: the checks above, small, then phase 25
        log("  phase 25 numbers: " + json.dumps(
            serve_phase(dt, kernels, seed, card)))
        return 0
    if only26:  # a short run: the checks above, small, then phase 26
        log("  phase 26 numbers: " + json.dumps(
            router_phase(dt, kernels, seed, card)))
        return 0
    if only27:  # a short run: the checks above, small, then phase 27
        log("  phase 27 numbers: " + json.dumps(
            bridge_phase(dt, kernels, seed, card)))
        return 0
    if only28:  # a short run: the checks above, small, then phase 28
        log("  phase 28 numbers: " + json.dumps(
            mp_phase(dt, kernels, seed, card)))
        return 0
    if only29:  # a short run: the checks above, small, then phase 29
        log("  phase 29 numbers: " + json.dumps(
            mp29_phase(dt, kernels, seed, card)))
        return 0
    if only30:  # a short run: the checks above, small, then phase 30
        log("  phase 30 numbers: " + json.dumps(
            mp30_phase(dt, kernels, seed, card)))
        return 0
    if only31:  # a short run: the checks above, small, then phase 31
        log("  phase 31 numbers: " + json.dumps(
            mp31_phase(dt, kernels, seed, card)))
        return 0
    if only32 or only33:  # the checks above, small, then 32 and / or 33
        if only32:
            log("  phase 32 numbers: " + json.dumps(
                bridge_mp_phase(dt, kernels, seed, card)))
        if only33:
            log("  phase 33 numbers: " + json.dumps(
                examples_phase(dt, kernels, card)))
        return 0

    log(f"phase 4: main path, 1 rank on cuda:0, n={n}")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    log(f"  device memory live at the start: "
        f"{torch.cuda.memory_allocated()} bytes")
    kernels.reset_counts()
    t0 = time.perf_counter()
    steps = {}
    src, got = main_path(dt, n, seed, steps)
    counts = dict(kernels.launches)
    log(f"  main path {time.perf_counter() - t0:.2f} s, launches {counts}")
    log("  main path seconds by step: " + json.dumps(steps))
    steps4 = steps
    peak = torch.cuda.max_memory_allocated()
    for k in ("stencil_matmul", "stencil_blocked", "chunked_dot",
              "chunked_cumsum"):
        results[k]["launches"] = counts[k]
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the "
                                 "main path")
    with plain_versions(kernels):
        _, ref = main_path(dt, n, seed)
    compare_paths(got, ref, "main path")
    del src, got, ref
    release(torch)

    log("phase 5: main path, 4 ranks on cuda:0, n=2^26")
    four_ranks(dt, 1 << 26, seed)
    dt.final()
    release(torch)

    log(f"phase 6: 2-D heat path, 1 rank on cuda:0, {M2D}x{M2D}")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    log(f"  device memory live at the start: "
        f"{torch.cuda.memory_allocated()} bytes")
    kernels.reset_counts()
    t0 = time.perf_counter()
    steps = {}
    src, got = main_path_2d(dt, M2D, seed, steps)
    counts = dict(kernels.launches)
    log(f"  2-D path {time.perf_counter() - t0:.2f} s, launches {counts}")
    log("  2-D path seconds by step: " + json.dumps(steps))
    peak2 = torch.cuda.max_memory_allocated()
    want = -(-STEPS2D // T2D) + ITERS2D
    results["stencil2d_blocked"]["launches"] = counts["stencil2d_blocked"]
    if counts["stencil2d_blocked"] != want:
        raise AssertionError(f"K5 launched {counts['stencil2d_blocked']} "
                             f"times on the 2-D path, expected {want}")
    with plain_versions(kernels):
        _, ref = main_path_2d(dt, M2D, seed)
    compare_2d(dt, src, got, ref, "2-D path")
    del src, got, ref
    dt.final()
    release(torch)

    log(f"phase 7: 2-D path, 4 ranks on cuda:0, {M4}x{M4}")
    four_ranks_2d(dt, M4, seed, kernels)
    dt.final()
    release(torch)

    log("phase 8: timings")
    timings(n, gen, results)
    sort_timings(gen, results)
    hist_timings(gen, results)
    flash_timings(gen, results)
    release(torch)

    log(f"phase 9: sort path, 1 rank on cuda:0, n=2^{SORT_LOG2} f32")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    log(f"  device memory live at the start: "
        f"{torch.cuda.memory_allocated()} bytes")
    kernels.reset_counts()
    t0 = time.perf_counter()
    steps = {}
    src, out = sort_path(dt, 1 << SORT_LOG2, seed, steps)
    counts = dict(kernels.launches)
    log(f"  sort path {time.perf_counter() - t0:.2f} s, launches {counts}")
    log("  sort path seconds by step: " + json.dumps(steps))
    peak3 = torch.cuda.max_memory_allocated()
    results["segred"]["launches"] = counts["segred"]
    if counts["segred"] != 3 or counts["bitonic_sort"] != 0:
        raise AssertionError(f"sort path launched K7 {counts['segred']} "
                             f"times (expected 3, one per reduce) and K6 "
                             f"{counts['bitonic_sort']} (expected 0)")
    check_sort_path(src, out)
    del src, out
    dt.final()
    release(torch)

    log(f"phase 10: sort path, 4 ranks on cuda:0, n=2^{SORT4_LOG2}")
    sort_four_ranks(dt, 1 << SORT4_LOG2, seed, kernels)
    dt.final()
    release(torch)

    log("phase 11: K6 path, 8 ranks x 16384 and 4 ranks x 2^15 on cuda:0")
    kernels.reset_counts()
    want = k6_path(dt, seed)
    counts = dict(kernels.launches)
    log(f"  K6 path launches {counts}")
    results["bitonic_sort"]["launches"] = counts["bitonic_sort"]
    if counts["bitonic_sort"] != want:
        raise AssertionError(f"K6 launched {counts['bitonic_sort']} times "
                             f"on the K6 path, expected {want}")
    dt.final()
    release(torch)

    log(f"phase 12: ring attention, 1 rank on cuda:0, S={RA_S}, "
        f"h={RA_H}, hkv={RA_HKV}, d={RA_D}, bf16")
    qkv, one_rank, peak4 = ring_one_rank(dt, kernels, seed, results)
    dt.final()
    release(torch)

    log(f"phase 13: ring attention, {RA4_P} ranks on cuda:0")
    ring_four_ranks(dt, kernels, seed, qkv, one_rank)
    del qkv, one_rank
    dt.final()
    release(torch)

    log(f"phase 14: relational path, 1 rank on cuda:0, "
        f"n_fact=2^{REL_FACT_LOG2}, ncard=2^{REL_CARD_LOG2}")
    peak5 = relational_one_rank(dt, kernels, seed, results)
    dt.final()
    release(torch)

    log(f"phase 15: relational path, 4 ranks on cuda:0, "
        f"n_fact=2^{REL4_FACT_LOG2}")
    relational_four_ranks(dt, kernels, seed)
    dt.final()
    release(torch)

    log("phase 16: entry() and dryrun(4) on cuda:0")
    dr_counts = entry_phase(dt, kernels)
    dt.final()
    release(torch)

    log("phase 17: halo-exchange p50 (periodic halo 1024, 2^22 cells a "
        "rank, exchange_n(64), 4 calls x 5 batches) and GB/s/chip")
    for ranks in (1, 4):
        p50, per = halo_p50(dt, ranks)
        log(f"  halo exchange p50 {ranks} rank(s): {p50!r} us per exchange "
            f"(batches {per})")
        dt.final()
    release(torch)
    log("  GB/s/chip (phase 4's host-clock steps; phase 8's kernels): "
        + json.dumps(gbps_lines(n, steps4, results)))

    log(f"phase 18: sparse path, 1 rank on cuda:0, m=2^{SP_LOG2}, "
        f"{SP_K} a row")
    dt.init(["cuda:0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sp = sparse_one_rank(dt, seed)
    peak6 = torch.cuda.max_memory_allocated()
    log(f"  sparse path {time.perf_counter() - t0:.2f} s: " + json.dumps(sp))
    dt.final()
    release(torch)

    log(f"phase 19: sparse path, 4 ranks on cuda:0, m=2^{SP4_LOG2}")
    t0 = time.perf_counter()
    sparse_four_ranks(dt, seed)
    log(f"  4-rank sparse path {time.perf_counter() - t0:.2f} s")
    dt.final()
    release(torch)

    log("phase 20: redistribute, unstructured halo, checkpoint and the "
        "surface, 4 ranks on cuda:0")
    kernels.reset_counts()
    t0 = time.perf_counter()
    relayout = {}
    for name, fn in (("redistribute", redistribute_phase),
                     ("unstructured_halo", uhalo_phase),
                     ("checkpoint", checkpoint_phase),
                     ("surface", surface_phase)):
        t1 = time.perf_counter()
        relayout[name] = fn(dt, seed)
        log(f"  phase 20 {name}: {time.perf_counter() - t1:.1f} s")
        dt.final()
        release(torch)
    log(f"  phase 20 {time.perf_counter() - t0:.1f} s, launches "
        f"{dict(kernels.launches)} (no kernel is on this path)")
    log("  phase 20 numbers: " + json.dumps(relayout))

    log("phase 21: observability: the relational and re-layout spans at "
        "full size, the Chrome export, profiler traces of the 1-D main "
        "path and the profiling helpers")
    from dr_tpu_torch import obs
    t0 = time.perf_counter()
    obs.reset()
    obs21 = {"card": card}
    t1 = time.perf_counter()
    obs21["relational"] = relational_obs(dt, obs, kernels, seed, card)
    log(f"  phase 21 relational: {time.perf_counter() - t1:.1f} s")
    release(torch)
    t1 = time.perf_counter()
    obs21["redistribute"] = redistribute_obs(dt, obs, seed, card)
    log(f"  phase 21 redistribute: {time.perf_counter() - t1:.1f} s")
    release(torch)
    obs21["export"] = export_obs(obs, os.path.join(OBS_DIR,
                                                   "obs_trace.json"))
    for ranks, size in ((1, n), (4, 1 << 26)):
        t1 = time.perf_counter()
        obs21[f"main_trace_{ranks}"] = traced_main_step(
            dt, kernels, size, ranks, seed,
            os.path.join(OBS_DIR, f"main_{ranks}rank"), card)
        log(f"  phase 21 traced main step, {ranks} rank(s): "
            f"{time.perf_counter() - t1:.1f} s")
        release(torch)
    t1 = time.perf_counter()
    dot_ms, obs21["sort_phases"] = profiling_obs(dt, seed, card)
    k3_ms = results["chunked_dot"]["ms"]
    obs21["device_timer_dot_ms"], obs21["k3_events_ms"] = dot_ms, k3_ms
    check(f"[{card}] device_timer(dot_n) {dot_ms!r} ms vs phase 8's K3 "
          f"{k3_ms!r} ms, relative", abs(dot_ms - k3_ms) / k3_ms, 0.10)
    log(f"  phase 21 profiling helpers: {time.perf_counter() - t1:.1f} s")
    release(torch)
    log(f"  phase 21 {time.perf_counter() - t0:.1f} s")
    log("  phase 21 numbers: " + json.dumps(obs21))

    g22 = resilience_phase(dt, kernels, gen, seed, card)
    log("  phase 22 numbers: " + json.dumps(g22))

    g23 = plans_phase(dt, kernels, seed, card)
    log("  phase 23 numbers: " + json.dumps(g23))

    g24 = elastic_phase(dt, kernels, seed, card)
    log("  phase 24 numbers: " + json.dumps(g24))

    g25 = serve_phase(dt, kernels, seed, card)
    log("  phase 25 numbers: " + json.dumps(g25))

    g26 = router_phase(dt, kernels, seed, card)
    log("  phase 26 numbers: " + json.dumps(g26))

    g27 = bridge_phase(dt, kernels, seed, card)
    log("  phase 27 numbers: " + json.dumps(g27))

    t0 = time.perf_counter()
    g28 = mp_phase(dt, kernels, seed, card)
    log(f"  phase 28 {time.perf_counter() - t0:.1f} s")
    log("  phase 28 numbers: " + json.dumps(g28))

    t0 = time.perf_counter()
    g29 = mp29_phase(dt, kernels, seed, card)
    log(f"  phase 29 {time.perf_counter() - t0:.1f} s")
    log("  phase 29 numbers: " + json.dumps(g29))

    t0 = time.perf_counter()
    g30 = mp30_phase(dt, kernels, seed, card)
    log(f"  phase 30 {time.perf_counter() - t0:.1f} s")
    log("  phase 30 numbers: " + json.dumps(g30))

    t0 = time.perf_counter()
    g31 = mp31_phase(dt, kernels, seed, card)
    log(f"  phase 31 {time.perf_counter() - t0:.1f} s")
    log("  phase 31 numbers: " + json.dumps(g31))

    g32 = bridge_mp_phase(dt, kernels, seed, card)
    log("  phase 32 numbers: " + json.dumps(g32))

    g33 = examples_phase(dt, kernels, card)
    log("  phase 33 numbers: " + json.dumps(g33))

    log(f"peak device memory (1-D main path): {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (2-D path): {peak2} bytes "
        f"({peak2 / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (sort path): {peak3} bytes "
        f"({peak3 / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (ring attention, 1 rank): {peak4} bytes "
        f"({peak4 / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (relational path, 1 rank): {peak5} bytes "
        f"({peak5 / 2 ** 30:.2f} GiB)")
    log(f"peak device memory (sparse path, 1 rank): {peak6} bytes "
        f"({peak6 / 2 ** 30:.2f} GiB)")
    log(f"dryrun(4) launches: {json.dumps(dr_counts)}")
    order = ("stencil_matmul", "stencil_blocked", "chunked_dot",
             "chunked_cumsum", "stencil2d_blocked", "bitonic_sort", "segred",
             "hist", "flash_update")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = {"kernels": [{k: results[n_][k] for k in keys}
                         for n_ in order]}
    log(f"card: {card}")
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
