// Multi-process SPMD bridge demo: each OS process builds a thp::session
// from the SAME coordinator (thp::distributed) and runs the SAME
// program in the same order, the reference's MPI-rank discipline
// (mhp/global.hpp:24-28, mpiexec -n {1..4} suites) carried to
// dr_tpu_torch over torch.distributed.  Process p owns rank p.
//
// Usage: bridge_mp_demo <pid> <nproc> <port> [cpu|cuda]
//   cpu   one CPU rank a process
//   cuda  (the default, as session(0) is) the card,
//         cuda:<pid % device_count>; the processes talk over gloo, so
//         several may share one card
// Prints "launches {...}" (the kernels' launch counts in this process)
// before the verdict.  Checks are a local macro, NOT assert(): the
// interpreter's compile flags may define NDEBUG, which would compile
// assert away and turn this into a smoke test that can't fail.
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>

#include "thp_bridge.hpp"

namespace {
int failures = 0;
#define CHECK(cond)                                                   \
  do {                                                                \
    if (!(cond)) {                                                    \
      std::fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__,   \
                   __LINE__, #cond);                                  \
      ++failures;                                                     \
    }                                                                 \
  } while (0)

int run(thp::session& s, int nproc) {
  CHECK((int)s.nprocs() == nproc);

  // every collective result must be valid on EVERY process
  std::size_t n = 4 * (std::size_t)nproc;
  thp::vector v = s.make_vector(n);
  v.iota(1.0);
  double total = v.reduce();
  CHECK(total == (double)n * (n + 1) / 2.0);

  thp::vector w = s.make_vector(n);
  w.fill(2.0);
  double dp = s.dot(v, w);
  CHECK(dp == 2.0 * total);

  // op DSL across the process boundary
  thp::vector out = s.make_vector(n);
  s.transform(v, out, thp::x0 * 2.0 + 1.0);
  std::vector<double> host = out.to_host();
  CHECK(host.size() == n);
  for (std::size_t i = 0; i < n && i < host.size(); ++i)
    CHECK(host[i] == 2.0 * (double)(i + 1) + 1.0);

  // distributed sample sort: splitters gathered, buckets exchanged
  // between the processes
  thp::vector keys = s.make_vector(n);
  s.transform(v, keys, 0.0 - thp::x0);  // descending values
  s.sort(keys);
  std::vector<double> sorted = keys.to_host();
  for (std::size_t i = 1; i < sorted.size(); ++i)
    CHECK(sorted[i - 1] <= sorted[i]);
  CHECK(s.is_sorted(keys));

  // typed container across processes: int32 device dtype
  thp::vector iv = s.make_vector(n, 0, 0, false, thp::dtype::i32);
  iv.iota(0.0);
  CHECK(iv.element_dtype() == thp::dtype::i32);
  CHECK(iv.reduce() == (double)(n * (n - 1) / 2));

  // a windowed sort (the window-coordinate program) and an uneven-teams
  // container with zero-size ranks
  thp::vector wv = s.make_vector(n);
  s.transform(v, wv, 0.0 - thp::x0);  // descending again
  s.sort(wv, 1, n - 1);               // window leaves the ends alone
  std::vector<double> wh = wv.to_host();
  CHECK(wh[0] == -1.0 && wh[n - 1] == -(double)n);
  for (std::size_t i = 2; i + 1 < n; ++i) CHECK(wh[i - 1] <= wh[i]);
  CHECK(s.is_sorted(wv, 1, n - 1));
  std::vector<std::size_t> sizes((std::size_t)nproc, 0);
  sizes[0] = n - 1;
  sizes[(std::size_t)nproc - 1] += 1;
  thp::vector uv = s.make_vector_blocks(sizes);
  uv.iota(1.0);
  CHECK(uv.reduce() == (double)n * (n + 1) / 2.0);

  s.exec(
      "import json\n"
      "from dr_tpu_torch.ops import kernels\n"
      "print('launches ' + json.dumps(kernels.launches), flush=True)\n");
  // no process leaves while a peer may still read from it
  s.exec("import dr_tpu_torch as _dt\n_dt.barrier()\n");
  return failures;
}
}  // namespace

int main(int argc, char** argv) {
  if (argc != 4 && argc != 5) {
    std::fprintf(stderr, "usage: %s <pid> <nproc> <port> [cpu|cuda]\n",
                 argv[0]);
    return 2;
  }
  int pid = std::atoi(argv[1]);
  int nproc = std::atoi(argv[2]);
  bool cpu = argc == 5 && std::strcmp(argv[4], "cpu") == 0;
  if (argc == 5 && !cpu && std::strcmp(argv[4], "cuda") != 0) {
    std::fprintf(stderr, "bridge_mp_demo: device %s is not cpu or cuda\n",
                 argv[4]);
    return 2;
  }
  thp::distributed d;
  d.coordinator = std::string("localhost:") + argv[3];
  d.num_processes = nproc;
  d.process_id = pid;
  d.ncpu_devices = cpu ? 1 : 0;
#ifdef THP_DISTRIBUTED_BACKEND
  d.backend = "gloo";  // the processes may share one card
#endif
  try {
    thp::session s(d);
    std::printf("bridge_mp_demo pid=%d/%d nprocs=%zu\n", pid, nproc,
                s.nprocs());
    std::fflush(stdout);
    if (run(s, nproc)) {
      std::fprintf(stderr, "bridge_mp_demo pid=%d/%d: %d FAILURES\n", pid,
                   nproc, failures);
      return 1;
    }
  } catch (const std::exception& e) {
    std::printf("bridge_mp_demo pid=%d/%d FAILED: %s\n", pid, nproc,
                e.what());
    return 2;
  }
  std::printf("bridge_mp_demo pid=%d/%d: PASSED\n", pid, nproc);
  return 0;
}
