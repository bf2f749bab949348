// bridge_parity: one fixed sequence of thp:: calls whose results are
// written out, so that two builds of it can be compared.  It includes
// only "thp_bridge.hpp" and uses only the surface both bridges share
// (no custom_op, whose source language differs, and no f64), so it
// compiles against either bridge unchanged.
//
// Usage: bridge_parity RANKS CHECKPOINT OUT [--seed S] [--window W]
//                      [--reps R] [--sync STMT] [--after STMT]
//                      [--mp PID NPROC PORT]
//   RANKS       session(RANKS): CPU ranks, 0 = the card(s); with --mp
//               the process's thp::distributed::ncpu_devices (1 = a CPU
//               rank, 0 = the card)
//   CHECKPOINT  a checkpoint of one f32 vector: the input x, length n
//   OUT         a directory: each result's to_host() is written to
//               OUT/<name>.f64 (raw little-endian doubles); "-" prints
//               "digest <name> <count> <16 hex digits>" lines instead
//   --seed      std::mt19937_64 seed of the sparse, dense and mdarray
//               inputs (default 1)
//   --window    length of the windowed sorts (default min(n/4, 2^14))
//   --reps      run the sequence R times (default 1); results come
//               from the last run, each call's time is its least
//   --sync      a statement run (untimed) after every timed call, e.g.
//               one that waits for the device
//   --after     a statement run before the program exits
//   --mp        process PID of NPROC, joined at localhost:PORT (over
//               gloo where the bridge has the backend field, so the
//               processes may share one card): every process runs the
//               sequence, every to_host() gathers the whole result onto
//               each process, so each prints or writes the whole
//               results (give each its own OUT directory)
// Every timed call prints "time <name> <ms>" (host clock, the call
// alone, the least of the runs), and the session's start
// "time start <ms>" (Py_Initialize, the imports and init()).
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <random>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "thp_bridge.hpp"

namespace {

using clock_type = std::chrono::steady_clock;

double ms_since(clock_type::time_point t0) {
  return std::chrono::duration<double, std::milli>(clock_type::now() - t0)
      .count();
}

// order-sensitive 64-bit digest of a result's f64 bytes: a sum over i of
// a splitmix64 finaliser of (bits(v[i]) + (i + 1) * golden), mod 2^64
std::uint64_t digest(const std::vector<double>& v) {
  std::uint64_t h = 0;
  for (std::size_t i = 0; i < v.size(); ++i) {
    std::uint64_t z;
    std::memcpy(&z, &v[i], sizeof z);
    z += (std::uint64_t)(i + 1) * 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    h += z ^ (z >> 31);
  }
  return h;
}

// uniform double in [lo, hi) from the top 53 bits of one draw
double uniform(std::mt19937_64& g, double lo, double hi) {
  return lo + (hi - lo) * (double)(g() >> 11) * 0x1.0p-53;
}

struct options {
  int ranks = 0;
  std::string ckpt, out;
  std::uint64_t seed = 1;
  std::size_t window = 0;
  int reps = 1;
  std::string sync, after;
  int mp_pid = 0, mp_nproc = 0;  // mp_nproc > 0: --mp
  std::string mp_port;
};

class runner {
 public:
  runner(thp::session& s, const options& o) : s_(s), o_(o) {}

  // run one call on the host clock, then the sync statement untimed;
  // keep the least time of each call over the runs
  void timed(const char* name, const std::function<void()>& call) {
    auto t0 = clock_type::now();
    call();
    double ms = ms_since(t0);
    if (!o_.sync.empty()) s_.exec(o_.sync);
    auto it = std::find_if(times_.begin(), times_.end(),
                           [&](const auto& t) { return t.first == name; });
    if (it == times_.end()) times_.emplace_back(name, ms);
    else it->second = std::min(it->second, ms);
  }

  // a container's result is read back (to_host()) on the last run only
  template <class C>
  void emit(const char* name, const C& c) {
    if (last_) emit(name, c.to_host());
  }

  void emit(const char* name, const std::vector<double>& v) {
    if (!last_) return;
    if (o_.out == "-") {
      std::printf("digest %s %zu %016llx\n", name, v.size(),
                  (unsigned long long)digest(v));
      return;
    }
    std::string path = o_.out + "/" + name + ".f64";
    FILE* f = std::fopen(path.c_str(), "wb");
    if (!f || std::fwrite(v.data(), sizeof(double), v.size(), f) !=
                  v.size()) {
      if (f) std::fclose(f);
      throw std::runtime_error("bridge_parity: cannot write " + path);
    }
    std::fclose(f);
  }

  void emit(const char* name, double x) { emit(name, std::vector<double>{x}); }

  void sequence(bool last);

  void print_times() const {
    for (const auto& [name, ms] : times_)
      std::printf("time %s %.6f\n", name.c_str(), ms);
  }

 private:
  thp::vector copy_of(const thp::vector& x) {
    thp::vector c = s_.make_vector(x.size());
    s_.transform(x, c, thp::x0);
    return c;
  }

  thp::session& s_;
  const options& o_;
  bool last_ = false;
  std::vector<std::pair<std::string, double>> times_;
};

void runner::sequence(bool last) {
  last_ = last;
  using thp::x0;
  using thp::x1;
  thp::vector x;
  timed("load_vector", [&] { x = s_.load_vector(o_.ckpt); });
  const std::size_t n = x.size();
  const std::size_t w = o_.window ? o_.window : std::min<std::size_t>(
                                                    n / 4, 1 << 14);
  if (n < 64 || w > n / 4) throw std::runtime_error("bridge_parity: n < 64 "
                                                    "or window > n / 4");
  std::vector<double> xh;
  timed("to_host", [&] { xh = x.to_host(); });
  emit("input", xh);
  xh = {};

  // ---- elementwise, dot, reductions -----------------------------------
  thp::vector y = s_.make_vector(n), z = s_.make_vector(n);
  timed("transform", [&] { s_.transform(x, y, x0 * 0.5 - 1.25); });
  emit("transform", y);
  double d = 0;
  timed("dot", [&] { d = s_.dot(x, y); });
  emit("dot", d);
  timed("transform2", [&] {
    s_.transform2(x, y, z, thp::max(x0, x1) * 2.0 - x1);
  });
  emit("transform2", z);
  timed("for_each", [&] {
    s_.for_each(z, thp::sqrt(thp::abs(x0)) + x0 * 0.25);
  });
  emit("for_each", z);
  double tr = 0;
  timed("transform_reduce", [&] { tr = s_.transform_reduce(x, x0 * x0); });
  emit("transform_reduce", tr);

  // ---- scans, whole and windowed (mismatched in/out offsets) ----------
  thp::vector sc = s_.make_vector(n);
  timed("inclusive_scan", [&] { s_.inclusive_scan(x, sc); });
  emit("inclusive_scan", sc);
  timed("exclusive_scan", [&] { s_.exclusive_scan(x, sc, 0.5); });
  emit("exclusive_scan", sc);
  const std::size_t len = n / 2;
  sc.fill(-1.0);
  timed("inclusive_scan_window", [&] {
    s_.inclusive_scan(x, n / 4 + 3, n / 4 + 3 + len, sc, 7, 7 + len);
  });
  emit("inclusive_scan_window", sc);
  timed("exclusive_scan_window", [&] {
    s_.exclusive_scan(x, 5, 5 + len, sc, n / 3, n / 3 + len, -2.0);
  });
  emit("exclusive_scan_window", sc);
  sc = {};

  // ---- sorts: whole, descending, windows of w keys, key-value ---------
  {
    thp::vector t = copy_of(x);
    timed("sort", [&] { s_.sort(t); });
    emit("sort", t);
    bool a = false, b = false;
    timed("is_sorted", [&] { a = s_.is_sorted(t); });
    b = s_.is_sorted(x);
    emit("is_sorted", std::vector<double>{(double)a, (double)b});
  }
  {
    thp::vector t = copy_of(x);
    timed("sort_desc", [&] { s_.sort(t, /*descending=*/true); });
    emit("sort_desc", t);
  }
  {
    const std::size_t lo1 = n / 8 + 3, lo2 = n / 2 + 5;
    thp::vector t = copy_of(x);
    timed("sort_window", [&] { s_.sort(t, lo1, lo1 + w); });
    timed("sort_window_desc", [&] {
      s_.sort(t, lo2, lo2 + w, /*descending=*/true);
    });
    emit("sort_windows", t);
    bool a = false, b = false;
    timed("is_sorted_window", [&] { a = s_.is_sorted(t, lo1, lo1 + w); });
    b = s_.is_sorted(t, lo2, lo2 + w);
    emit("is_sorted_windows", std::vector<double>{(double)a, (double)b});
  }
  {
    thp::vector keys = copy_of(x), vals = s_.make_vector(n);
    s_.transform(x, vals, x0 * -2.0);  // exact: no rounding to differ
    timed("sort_by_key", [&] { s_.sort_by_key(keys, vals); });
    emit("sort_by_key_keys", keys);
    emit("sort_by_key_values", vals);
  }
  {
    const std::size_t lo = n / 3 + 1;
    thp::vector keys = copy_of(x), vals = s_.make_vector(n);
    vals.iota(0.0);
    timed("sort_by_key_window", [&] {
      s_.sort_by_key(keys, lo, lo + w, vals, lo, lo + w,
                     /*descending=*/true);
    });
    emit("sort_by_key_window_keys", keys);
    emit("sort_by_key_window_values", vals);
  }
  {
    thp::vector perm;
    timed("argsort", [&] { perm = s_.argsort(x); });
    emit("argsort", perm);
  }

  // ---- stencil: 5 points, 6 steps, over a copy of x with halo 2 -------
  {
    thp::vector a = s_.make_vector(n, 2, 2), b = s_.make_vector(n, 2, 2);
    s_.transform(x, a, x0);
    timed("stencil_iterate", [&] {
      s_.stencil_iterate(a, b, {0.05, 0.25, 0.4, 0.25, 0.05}, 6);
    });
    emit("stencil_iterate", a);
  }

  // ---- sparse gemv, dense gemm, mdarray transpose and submdspan -------
  std::mt19937_64 g(o_.seed);
  {
    const std::size_t m = 4096, k = 4096, per_row = 8;
    std::vector<std::int64_t> ri, ci;
    std::vector<double> vv;
    for (std::size_t i = 0; i < m; ++i) {
      std::int64_t c0 = (std::int64_t)(g() % (k - per_row));
      for (std::size_t j = 0; j < per_row; ++j) {
        ri.push_back((std::int64_t)i);
        ci.push_back(c0 + (std::int64_t)j);
        vv.push_back(uniform(g, -1.0, 1.0));
      }
    }
    thp::sparse_matrix A = s_.make_sparse_coo(m, k, ri, ci, vv);
    thp::vector bv = s_.make_vector(k), cv = s_.make_vector(m);
    bv.iota(1.0);
    s_.for_each(bv, x0 * 0.001 - 2.0);
    cv.fill(0.5);
    timed("gemv", [&] { s_.gemv(cv, A, bv); });
    emit("gemv", cv);
  }
  {
    const std::size_t m = 256, k = 128, p = 192;
    std::vector<double> da(m * k), db(k * p);
    for (double& v : da) v = uniform(g, -1.0, 1.0);
    for (double& v : db) v = uniform(g, -1.0, 1.0);
    thp::dense_matrix A = s_.make_dense(m, k, da);
    thp::dense_matrix B = s_.make_dense(k, p, db);
    thp::dense_matrix C = s_.make_dense(m, p);
    timed("gemm", [&] { s_.gemm(A, B, C); });
    emit("gemm", C);
  }
  {
    const std::size_t a = 24, b = 20, c = 16;
    std::vector<double> d3(a * b * c);
    for (double& v : d3) v = uniform(g, -8.0, 8.0);
    thp::mdarray M = s_.make_mdarray({a, b, c}, d3);
    thp::mdarray T = s_.make_mdarray({c, a, b});
    timed("transpose", [&] { s_.transpose(T, M, {2, 0, 1}); });
    emit("transpose", T);
    thp::mdspan W;
    timed("submdspan", [&] {
      W = s_.submdspan(M, {{3, 19}, {2, 17}, {1, 13}});
    });
    emit("submdspan", W);
  }

  // ---- an i32 vector: iota, an integer op, the integer sum ------------
  {
    thp::vector iv = s_.make_vector(n, 0, 0, false, thp::dtype::i32);
    iv.iota(3.0 - (double)(n / 2));
    s_.for_each(iv, x0 * 3.0 - 1.0);
    double r = 0;
    timed("reduce_i32", [&] { r = iv.reduce(); });
    emit("reduce_i32", r);
    emit("i32", iv);
  }
}

[[noreturn]] void usage() {
  std::fprintf(stderr,
               "usage: bridge_parity RANKS CHECKPOINT OUT [--seed S] "
               "[--window W] [--reps R] [--sync STMT] [--after STMT] "
               "[--mp PID NPROC PORT]\n");
  std::exit(2);
}

options parse(int argc, char** argv) {
  if (argc < 4) usage();
  options o;
  o.ranks = std::atoi(argv[1]);
  o.ckpt = argv[2];
  o.out = argv[3];
  for (int i = 4; i < argc;) {
    std::string key = argv[i];
    if (key == "--mp") {
      if (i + 3 >= argc) usage();
      o.mp_pid = std::atoi(argv[i + 1]);
      o.mp_nproc = std::atoi(argv[i + 2]);
      o.mp_port = argv[i + 3];
      if (o.mp_nproc < 1) usage();
      i += 4;
      continue;
    }
    if (i + 1 >= argc) usage();
    const char* val = argv[i + 1];
    if (key == "--seed") o.seed = std::strtoull(val, nullptr, 10);
    else if (key == "--window") o.window = std::strtoull(val, nullptr, 10);
    else if (key == "--reps") o.reps = std::atoi(val);
    else if (key == "--sync") o.sync = val;
    else if (key == "--after") o.after = val;
    else {
      std::fprintf(stderr, "bridge_parity: unknown option %s\n", key.c_str());
      std::exit(2);
    }
    i += 2;
  }
  if (o.reps < 1) {
    std::fprintf(stderr, "bridge_parity: bad options\n");
    std::exit(2);
  }
  return o;
}

// session(RANKS), or with --mp a member of the processes' group
std::unique_ptr<thp::session> open_session(const options& o) {
  if (o.mp_nproc == 0) return std::make_unique<thp::session>(o.ranks);
  thp::distributed d;
  d.coordinator = "localhost:" + o.mp_port;
  d.num_processes = o.mp_nproc;
  d.process_id = o.mp_pid;
  d.ncpu_devices = o.ranks;
#ifdef THP_DISTRIBUTED_BACKEND
  d.backend = "gloo";
#endif
  return std::make_unique<thp::session>(d);
}

}  // namespace

int main(int argc, char** argv) {
  options o = parse(argc, argv);
  try {
    auto t0 = clock_type::now();
    std::unique_ptr<thp::session> sp = open_session(o);
    thp::session& s = *sp;
    std::printf("time start %.6f\n", ms_since(t0));
    std::printf("nprocs %zu\n", s.nprocs());
    runner r(s, o);
    for (int rep = 0; rep < o.reps; ++rep) r.sequence(rep == o.reps - 1);
    r.print_times();
    std::fflush(stdout);
    if (!o.after.empty()) s.exec(o.after);
  } catch (const std::exception& e) {
    std::printf("bridge_parity FAILED: %s\n", e.what());
    return 1;
  }
  std::printf("bridge_parity done\n");
  return 0;
}
