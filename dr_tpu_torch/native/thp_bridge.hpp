// thp_bridge: C++ driver for dr_tpu_torch, the PyTorch/CUDA backend.
//
// The reference's backends bind C++ to MPI (mhp) or SYCL (shp); this
// bridge binds C++ to dr_tpu_torch running in an embedded CPython
// interpreter: a C++ thp:: surface whose containers are dr_tpu_torch
// containers, one padded row tensor a rank on the card (or on the CPU,
// when the session asks for CPU ranks).  The bridge uses the CPython C
// API directly (no pybind11): one interpreter, the GIL held by the
// calling thread, CUDA work queued asynchronously by PyTorch
// underneath.  The surface and names are those of native/bridge/
// thp_bridge.hpp, its multi-process session included: each process
// builds a session from one thp::distributed and owns one rank.
//
// User ops are expressed in a small arithmetic DSL (thp::expr over
// placeholders thp::x0..x3) serialized to a canonical string and
// compiled ONCE on the Python side into a callable over tensors
// (dr_tpu_torch/utils/expr.py).  Equal expression strings share one
// callable, so the algorithm layer's identity-keyed caches are reused
// across bridge calls.
//
// Surface (mirrors the Python dr_tpu_torch API; reference parity
// targets: include/dr/shp/shp.hpp:8-26, include/dr/mhp.hpp:41-59):
//   thp::session s(ncpu_ranks /*0 = the visible CUDA devices*/);
//   thp::session s(thp::distributed{"localhost:29500", 2, pid, 0});
//   thp::vector v = s.make_vector(n, halo_prev, halo_next, periodic);
//   thp::vector u = s.make_vector_blocks({10, 0, 24, 23});  // teams
//   v.iota(0); v.fill(1.0);
//   double r = v.reduce();  double d = s.dot(a, b);
//   s.transform(a, out, thp::x0 * 2.0 + 1.0);          // lazy op DSL
//   s.transform2(a, b, out, thp::x0 * thp::x1);        // zipped binary
//   s.for_each(v, thp::sqrt(thp::abs(thp::x0)));
//   s.inclusive_scan(in, out);  s.exclusive_scan(in, out, init);
//   thp::sparse_matrix A = s.make_sparse_coo(m, n, rows, cols, vals);
//   s.gemv(c, A, b);                                    // c += A·b
//   thp::dense_matrix M = s.make_dense(m, n, host_data);
//   thp::mdarray T = s.make_mdarray({a, b, c}, host_data);  // N-D
//   s.transpose(out_md, in_md, {2, 0, 1});              // all-to-all T
//   thp::mdspan W = s.submdspan(T, {{2, 9}, {0, b}, {3, 8}});
//   s.stencil_iterate(a, b, {w...}, steps);
//   std::vector<double> host = v.to_host();  // buffer-protocol copy
//
// Every failed call throws std::runtime_error; its what() names the
// call and carries the Python exception's type and message.
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace thp {

class session;

// Element dtype of a device container.  The reference templates its
// containers over T (mhp/containers/distributed_vector.hpp:176); the
// bridge keys the DEVICE dtype (what occupies the card's memory) while
// the host interchange stays double: to_host() converts on the way out,
// scalar arguments convert on the way in.  f32 is the default; f64 and
// i32 allocate float64 and int32 tensors on the CPU and on the card
// alike.  A container the bridge did not make (argsort's permutation,
// load_vector's result) reports its real dtype.
enum class dtype { f32, f64, i32 };

// Multi-process SPMD membership: every process builds a session from the
// SAME coordinator and runs the SAME program in the same order (the
// discipline the reference gets from MPI, mhp/global.hpp:24-28).  Backed
// by dr_tpu_torch.init_distributed over torch.distributed: process p
// owns rank p, one rank a process, so the runtime has num_processes
// ranks.  The first four fields are those of native/bridge/
// thp_bridge.hpp, with ncpu_devices read under the one-rank-a-process
// rule:
//   1   a CPU rank (gloo between the processes);
//   0   the card, cuda:<process_id % device_count> (throws without one);
//   any other value throws: a process never holds several ranks.
// A field only this bridge has is declared behind a macro it defines,
// so a program can set it under #ifdef and still compile against the
// other bridge.
#define THP_DISTRIBUTED_BACKEND 1
struct distributed {
  std::string coordinator;   // "host:port" (process 0 binds it)
  int num_processes = 1;
  int process_id = 0;
  int ncpu_devices = 1;      // 1 = a CPU rank, 0 = the card
  // torch.distributed backend; empty = torch's mapping (gloo for a CPU
  // rank, nccl for a card).  Processes that share one card pass "gloo":
  // nccl refuses two ranks on one device.
  std::string backend;
};

// ---------------------------------------------------------------------
// expression DSL: value-semantics nodes serializing to canonical strings
// ---------------------------------------------------------------------
class expr {
 public:
  static expr arg(int i);      // placeholder xi
  static expr lit(double v);   // numeric literal
  const std::string& str() const { return s_; }

  // internal: wraps an already-serialized subexpression (used by the
  // operator overloads; not a user entry point: the grammar is
  // validated Python-side before compilation either way)
  struct raw_t {};
  expr(raw_t, std::string s) : s_(std::move(s)) {}

 private:
  std::string s_;
};

expr operator+(const expr& a, const expr& b);
expr operator-(const expr& a, const expr& b);
expr operator*(const expr& a, const expr& b);
expr operator/(const expr& a, const expr& b);
expr operator-(const expr& a);
expr operator+(const expr& a, double b);
expr operator+(double a, const expr& b);
expr operator-(const expr& a, double b);
expr operator-(double a, const expr& b);
expr operator*(const expr& a, double b);
expr operator*(double a, const expr& b);
expr operator/(const expr& a, double b);
expr operator/(double a, const expr& b);
expr sqrt(const expr& a);
expr exp(const expr& a);
expr log(const expr& a);
expr tanh(const expr& a);
expr abs(const expr& a);
expr min(const expr& a, const expr& b);
expr max(const expr& a, const expr& b);
expr pow(const expr& a, const expr& b);

// ready-made placeholders (x0 = first range/zip component, ...)
extern const expr x0, x1, x2, x3;

// Escape hatch: an op the arithmetic DSL cannot express, written as
// Python source over PyTorch tensors that evaluates to a callable of
// `nargs` placeholders (conditionals, comparisons, clips, casts).
// `torch` and `np` are in scope.  Same trust boundary as session::exec
// (the C++ caller owns the embedded interpreter); compiled once per
// (source, nargs) Python-side (dr_tpu_torch/utils/expr.py
// op_from_source).
//   thp::custom_op leaky{"lambda x0: torch.where(x0 > 0, x0, 0.01 * x0)",
//                        1};
//   s.for_each(v, leaky);
struct custom_op {
  std::string source;
  int nargs = 1;
};

// ---------------------------------------------------------------------
// containers: move-only handles owning a PyObject* of the Python object
// ---------------------------------------------------------------------
namespace detail {
class handle {
 public:
  handle() = default;
  ~handle();
  handle(handle&&) noexcept;
  handle& operator=(handle&&) noexcept;
  handle(const handle&) = delete;
  handle& operator=(const handle&) = delete;

 protected:
  friend class ::thp::session;
  handle(session* s, void* obj) : sess_(s), obj_(obj) {}
  session* sess_ = nullptr;
  void* obj_ = nullptr;  // PyObject*
};
}  // namespace detail

class vector : public detail::handle {
 public:
  vector() = default;
  std::size_t size() const { return n_; }
  dtype element_dtype() const { return dt_; }

  void iota(double start);
  void fill(double value);
  double reduce() const;
  void halo_exchange();
  // host copy: one device-to-host copy of the container (a gather onto
  // every process in a multi-process session), then ONE pass from the
  // array's own buffer into the result, converting f32, i32 and i64 to
  // double on the way; no element boxing
  std::vector<double> to_host() const;

 private:
  friend class session;
  vector(session* s, void* obj, std::size_t n, dtype dt = dtype::f32)
      : handle(s, obj), n_(n), dt_(dt) {}
  std::size_t n_ = 0;
  dtype dt_ = dtype::f32;
};

class dense_matrix : public detail::handle {
 public:
  dense_matrix() = default;
  std::size_t rows() const { return m_; }
  std::size_t cols() const { return n_; }
  std::vector<double> to_host() const;  // row-major m*n

 private:
  friend class session;
  dense_matrix(session* s, void* obj, std::size_t m, std::size_t n)
      : handle(s, obj), m_(m), n_(n) {}
  std::size_t m_ = 0, n_ = 0;
};

class sparse_matrix : public detail::handle {
 public:
  sparse_matrix() = default;
  std::size_t rows() const { return m_; }
  std::size_t cols() const { return n_; }
  std::size_t nnz() const { return nnz_; }

 private:
  friend class session;
  sparse_matrix(session* s, void* obj, std::size_t m, std::size_t n,
                std::size_t nnz)
      : handle(s, obj), m_(m), n_(n), nnz_(nnz) {}
  std::size_t m_ = 0, n_ = 0, nnz_ = 0;
};

class mdarray : public detail::handle {
 public:
  mdarray() = default;
  // N-D: the spec'd surface is arbitrary rank
  // (doc/spec/source/containers/distributed_mdarray.rst:12-23)
  const std::vector<std::size_t>& shape() const { return shape_; }
  std::size_t rank() const { return shape_.size(); }
  // 2-D convenience accessors
  std::size_t rows() const { return shape_.empty() ? 0 : shape_[0]; }
  std::size_t cols() const { return shape_.size() < 2 ? 1 : shape_[1]; }
  std::vector<double> to_host() const;  // row-major, product(shape)

 private:
  friend class session;
  mdarray(session* s, void* obj, std::vector<std::size_t> shape)
      : handle(s, obj), shape_(std::move(shape)) {}
  std::vector<std::size_t> shape_;
};

// Non-owning N-D window over an mdarray (the spec's submdspan;
// Python: distributed_mdspan).  to_host() materializes ONLY the
// window, row-major over the window's shape.
class mdspan : public detail::handle {
 public:
  mdspan() = default;
  const std::vector<std::size_t>& shape() const { return shape_; }
  std::size_t rank() const { return shape_.size(); }
  std::vector<double> to_host() const;

 private:
  friend class session;
  mdspan(session* s, void* obj, std::vector<std::size_t> shape)
      : handle(s, obj), shape_(std::move(shape)) {}
  std::vector<std::size_t> shape_;
};

// ---------------------------------------------------------------------
// session: the embedded runtime + the algorithm surface
// ---------------------------------------------------------------------
class session {
 public:
  // ncpu_ranks > 0: that many ranks on the CPU
  // (dr_tpu_torch.init(["cpu"] * ncpu_ranks), for tests);
  // ncpu_ranks == 0: the visible CUDA devices, one rank each
  // (dr_tpu_torch.init()).  Without a CUDA device the session throws;
  // it never falls back to the CPU.
  explicit session(int ncpu_ranks = 0);
  // multi-process SPMD member (see thp::distributed): joins the
  // coordinator's process group through dr_tpu_torch.init_distributed.
  // Throws on a field outside the rules, on a failed join (with
  // Python's message; nothing retries on another backend or device) and
  // when the runtime's rank count is not num_processes.  The destructor
  // leaves the process group alone, as the Python runtime does.
  explicit session(const distributed& d);
  ~session();
  session(const session&) = delete;
  session& operator=(const session&) = delete;

  std::size_t nprocs() const;

  // containers
  vector make_vector(std::size_t n, std::size_t halo_prev = 0,
                     std::size_t halo_next = 0, bool periodic = false,
                     dtype dt = dtype::f32);
  // uneven block distribution: rank r owns sizes[r] contiguous
  // elements; zero sizes express "teams" (halo requires the uniform
  // layout, so these take none).  A distinct NAME, not an overload:
  // make_vector({64}) would silently prefer the scalar size_t
  // conversion and drop the distribution intent
  vector make_vector_blocks(const std::vector<std::size_t>& sizes,
                            dtype dt = dtype::f32);
  dense_matrix make_dense(std::size_t m, std::size_t n,
                          const std::vector<double>& row_major = {});
  sparse_matrix make_sparse_coo(std::size_t m, std::size_t n,
                                const std::vector<std::int64_t>& rows,
                                const std::vector<std::int64_t>& cols,
                                const std::vector<double>& values);
  // N-D mdarray over an arbitrary shape; the (m, n) form below is the
  // 2-D convenience.
  mdarray make_mdarray(const std::vector<std::size_t>& shape,
                       const std::vector<double>& row_major = {});
  mdarray make_mdarray(std::size_t m, std::size_t n,
                       const std::vector<double>& row_major = {});
  // half-open [lo, hi) windows, one per dimension (rank must match)
  mdspan submdspan(
      const mdarray& a,
      const std::vector<std::pair<std::size_t, std::size_t>>& box);

  // elementwise / reduction algorithms (op = DSL expression)
  void transform(const vector& in, vector& out, const expr& op);
  void transform2(const vector& a, const vector& b, vector& out,
                  const expr& op);  // zip(a, b) | transform
  void for_each(vector& v, const expr& op);
  double transform_reduce(const vector& v, const expr& op);
  double dot(const vector& a, const vector& b);

  // the same algorithms with the custom-op escape hatch
  void transform(const vector& in, vector& out, const custom_op& op);
  void transform2(const vector& a, const vector& b, vector& out,
                  const custom_op& op);
  void for_each(vector& v, const custom_op& op);
  double transform_reduce(const vector& v, const custom_op& op);

  // prefix scans (add monoid: the reference's inclusive_scan surface)
  void inclusive_scan(const vector& in, vector& out);
  void exclusive_scan(const vector& in, vector& out, double init = 0.0);
  // windowed forms: scan in[ilo, ihi) into out[olo, ohi); equal
  // lengths, offsets and distributions may differ
  void inclusive_scan(const vector& in, std::size_t ilo, std::size_t ihi,
                      vector& out, std::size_t olo, std::size_t ohi);
  void exclusive_scan(const vector& in, std::size_t ilo, std::size_t ihi,
                      vector& out, std::size_t olo, std::size_t ohi,
                      double init = 0.0);

  // distributed sample sort, in place (algorithms/sort.py: local sort,
  // splitters, bucket exchange, rebalance); the _by_key form reorders
  // values by keys, STABLY
  void sort(vector& v, bool descending = false);
  void sort_by_key(vector& keys, vector& values, bool descending = false);
  vector argsort(const vector& v, bool descending = false);  // int32 perm
  bool is_sorted(const vector& v);
  // subrange-window forms: half-open [lo, hi); sort_by_key windows may
  // overlap when keys and values share one vector (payload-last blend
  // order), and key/value windows must have equal lengths
  void sort(vector& v, std::size_t lo, std::size_t hi,
            bool descending = false);
  void sort_by_key(vector& keys, std::size_t klo, std::size_t khi,
                   vector& values, std::size_t vlo, std::size_t vhi,
                   bool descending = false);
  bool is_sorted(const vector& v, std::size_t lo, std::size_t hi);

  // matrix algorithms
  void gemv(vector& c, const sparse_matrix& a, const vector& b);
  void gemm(const dense_matrix& a, const dense_matrix& b,
            dense_matrix& out);
  // out = in permuted by axes (empty = reversed, numpy's default)
  void transpose(mdarray& out, const mdarray& in,
                 const std::vector<std::size_t>& axes = {});

  // stencil: weights.size() must be halo_prev + halo_next + 1
  void stencil_iterate(vector& a, vector& b,
                       const std::vector<double>& weights, int steps);

  // checkpoint / restore (utils/checkpoint.py; the file format is the
  // same on every backend)
  void save(const std::string& path, const vector& v);
  vector load_vector(const std::string& path);

  // escape hatch: run a statement in the embedded interpreter
  void exec(const std::string& code);

 private:
  friend class vector;
  friend class dense_matrix;
  friend class sparse_matrix;
  friend class mdarray;
  friend class mdspan;
  friend class detail::handle;
  struct impl;
  std::unique_ptr<impl> impl_;
};

}  // namespace thp
