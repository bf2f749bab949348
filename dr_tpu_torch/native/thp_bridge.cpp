// thp_bridge implementation: CPython embedding of dr_tpu_torch.
#include "thp_bridge.hpp"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdexcept>

namespace thp {

namespace {

// Throws the call's name with the pending Python exception's type and
// message (a refusal such as init() without a card then reads apart
// from a fault of the bridge); clears the exception.
[[noreturn]] void fail(const char* what) {
  std::string msg = std::string("thp_bridge: ") + what;
  if (PyErr_Occurred()) {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    msg += ": ";
    msg += type ? ((PyTypeObject*)type)->tp_name : "exception";
    PyObject* text = value ? PyObject_Str(value) : nullptr;
    const char* s = text ? PyUnicode_AsUTF8(text) : nullptr;
    if (s && *s) {
      msg += ": ";
      msg += s;
    }
    Py_XDECREF(text);
    Py_XDECREF(tb);
    Py_XDECREF(value);
    Py_XDECREF(type);
    PyErr_Clear();  // a failed str() must not leave an exception behind
  }
  throw std::runtime_error(msg);
}

PyObject* must(PyObject* p, const char* what) {
  if (!p) fail(what);
  return p;
}

// numpy view over host memory (no element boxing); the caller's buffer
// must outlive uses of the returned array: every call site here copies
// into a container/device layout before returning.
PyObject* np_view(PyObject* np, const void* data, std::size_t nbytes,
                  const char* dtype) {
  PyObject* mv = must(
      PyMemoryView_FromMemory(
          const_cast<char*>(static_cast<const char*>(data)),
          (Py_ssize_t)nbytes, PyBUF_READ),
      "memoryview");
  PyObject* arr = must(PyObject_CallMethod(np, "frombuffer", "Os", mv,
                                           dtype),
                       "np.frombuffer");
  Py_DECREF(mv);
  return arr;
}

// the bridge's label of a container's element dtype (its torch dtype)
dtype dtype_of(PyObject* container, const char* what) {
  PyObject* dt = must(PyObject_GetAttrString(container, "dtype"), what);
  PyObject* text = PyObject_Str(dt);
  Py_DECREF(dt);
  if (!text) fail(what);
  const char* utf8 = PyUnicode_AsUTF8(text);
  std::string name = utf8 ? utf8 : "";
  Py_DECREF(text);
  if (!utf8) fail(what);
  if (name == "torch.float32") return dtype::f32;
  if (name == "torch.float64") return dtype::f64;
  if (name == "torch.int32") return dtype::i32;
  throw std::runtime_error(std::string("thp_bridge: ") + what +
                           ": element dtype " + name +
                           " has no thp::dtype");
}

std::size_t len_of(PyObject* obj, const char* what) {
  Py_ssize_t n = PyObject_Length(obj);
  if (n < 0) fail(what);
  return (std::size_t)n;
}

}  // namespace

// ---------------------------------------------------------------------
// session impl
// ---------------------------------------------------------------------
struct session::impl {
  PyObject* dr = nullptr;        // module dr_tpu_torch
  PyObject* views = nullptr;     // module dr_tpu_torch.views.views
  PyObject* stencil_mod = nullptr;
  PyObject* expr_mod = nullptr;  // module dr_tpu_torch.utils.expr
  PyObject* np = nullptr;        // module numpy

  // op DSL -> cached callable over tensors (cache lives Python-side,
  // keyed by the canonical string, so equal exprs share one function)
  PyObject* op(const expr& e, int nargs) {
    return must(PyObject_CallMethod(expr_mod, "op_from_expr", "si",
                                    e.str().c_str(), nargs),
                "op_from_expr");
  }

  // custom-op escape hatch -> cached callable (full Python source over
  // torch; same trust boundary as session::exec)
  PyObject* op(const custom_op& e) {
    return must(PyObject_CallMethod(expr_mod, "op_from_source", "si",
                                    e.source.c_str(), e.nargs),
                "op_from_source");
  }

  // f64 host view -> f32 numpy array (device dtype)
  PyObject* np_f32(const std::vector<double>& v) {
    PyObject* raw = np_view(np, v.data(), v.size() * sizeof(double),
                            "float64");
    PyObject* arr = must(PyObject_CallMethod(raw, "astype", "s",
                                             "float32"),
                         "astype(float32)");
    Py_DECREF(raw);
    return arr;
  }

  PyObject* np_i64(const std::vector<std::int64_t>& v) {
    PyObject* raw = np_view(np, v.data(), v.size() * sizeof(std::int64_t),
                            "int64");
    // copy so the container owns its memory beyond this call
    PyObject* arr = must(PyObject_CallMethod(raw, "copy", nullptr),
                         "np.copy");
    Py_DECREF(raw);
    return arr;
  }

  // step 1: the interpreter and the package
  void start() {
    if (!Py_IsInitialized()) Py_InitializeEx(0);
    dr = must(PyImport_ImportModule("dr_tpu_torch"), "import dr_tpu_torch");
  }

  // step 2 follows the runtime: the modules the calls use
  void import_modules() {
    views = must(PyImport_ImportModule("dr_tpu_torch.views.views"),
                 "import dr_tpu_torch.views.views");
    stencil_mod = must(
        PyImport_ImportModule("dr_tpu_torch.algorithms.stencil"),
        "import dr_tpu_torch.algorithms.stencil");
    expr_mod = must(PyImport_ImportModule("dr_tpu_torch.utils.expr"),
                    "import dr_tpu_torch.utils.expr");
    np = must(PyImport_ImportModule("numpy"), "import numpy");
  }

  // f64 copy-out of a numpy-convertible object: one pass from the
  // array's own C-contiguous buffer (f32, f64, i32, i64: every element
  // type a container of the bridge holds) into the vector's storage
  std::vector<double> to_host_f64(PyObject* arr_like) {
    PyObject* asc = must(
        PyObject_CallMethod(np, "ascontiguousarray", "O", arr_like),
        "ascontiguousarray");
    Py_buffer view;
    if (PyObject_GetBuffer(asc, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT)
        != 0) {
      Py_DECREF(asc);
      fail("buffer protocol");
    }
    const std::string fmt = view.format ? view.format : "B";
    const std::size_t n =
        view.itemsize ? (std::size_t)(view.len / view.itemsize) : 0;
    std::vector<double> out;
    if (fmt == "f" && view.itemsize == 4) {
      const float* p = static_cast<const float*>(view.buf);
      out.assign(p, p + n);
    } else if (fmt == "d" && view.itemsize == 8) {
      const double* p = static_cast<const double*>(view.buf);
      out.assign(p, p + n);
    } else if (fmt == "i" && view.itemsize == 4) {
      const std::int32_t* p = static_cast<const std::int32_t*>(view.buf);
      out.assign(p, p + n);
    } else if ((fmt == "l" || fmt == "q") && view.itemsize == 8) {
      const std::int64_t* p = static_cast<const std::int64_t*>(view.buf);
      out.assign(p, p + n);
    } else {
      PyBuffer_Release(&view);
      Py_DECREF(asc);
      throw std::runtime_error("thp_bridge: to_host: element format '" +
                               fmt + "' has no conversion to double");
    }
    PyBuffer_Release(&view);
    Py_DECREF(asc);
    return out;
  }
};

// CPU ranks when asked for, else dr_tpu_torch.init() (the visible CUDA
// devices; it raises without one)
session::session(int ncpu_ranks) : impl_(new impl) {
  impl_->start();
  PyObject* r;
  if (ncpu_ranks > 0) {
    PyObject* devs = must(PyList_New(ncpu_ranks), "device list");
    for (int i = 0; i < ncpu_ranks; ++i)
      PyList_SET_ITEM(devs, i, PyUnicode_FromString("cpu"));
    r = PyObject_CallMethod(impl_->dr, "init", "O", devs);
    Py_DECREF(devs);
  } else {
    r = PyObject_CallMethod(impl_->dr, "init", nullptr);
  }
  Py_DECREF(must(r, "dr_tpu_torch.init()"));
  impl_->import_modules();
}

session::session(const distributed& d) : impl_(new impl) {
  if (d.ncpu_devices != 0 && d.ncpu_devices != 1)
    throw std::runtime_error(
        "thp_bridge: distributed.ncpu_devices = " +
        std::to_string(d.ncpu_devices) +
        ": the port runs one rank a process (1 = a CPU rank, 0 = the "
        "card); start more processes for more ranks");
  if (d.num_processes < 1 || d.process_id < 0 ||
      d.process_id >= d.num_processes)
    throw std::runtime_error(
        "thp_bridge: distributed.process_id = " +
        std::to_string(d.process_id) + " of num_processes = " +
        std::to_string(d.num_processes) +
        ": one rank a process, process_id in [0, num_processes)");
  impl_->start();
  PyObject* fn = must(PyObject_GetAttrString(impl_->dr, "init_distributed"),
                      "init_distributed");
  PyObject* args = Py_BuildValue("(sii)", d.coordinator.c_str(),
                                 d.num_processes, d.process_id);
  PyObject* kwargs = PyDict_New();
  if (d.ncpu_devices == 1) {
    PyObject* cpu = PyUnicode_FromString("cpu");
    PyDict_SetItemString(kwargs, "device", cpu);
    Py_DECREF(cpu);
  }
  if (!d.backend.empty()) {
    PyObject* be = PyUnicode_FromString(d.backend.c_str());
    PyDict_SetItemString(kwargs, "backend", be);
    Py_DECREF(be);
  }
  PyObject* r = PyObject_Call(fn, args, kwargs);
  Py_DECREF(kwargs);
  Py_DECREF(args);
  Py_DECREF(fn);
  Py_DECREF(must(r, "dr_tpu_torch.init_distributed(...)"));
  impl_->import_modules();
  if (nprocs() != (std::size_t)d.num_processes)
    fail("the distributed runtime's rank count differs from "
         "num_processes (one rank a process)");
}

session::~session() {
  Py_XDECREF(impl_->np);
  Py_XDECREF(impl_->expr_mod);
  Py_XDECREF(impl_->stencil_mod);
  Py_XDECREF(impl_->views);
  Py_XDECREF(impl_->dr);
  // keep the interpreter alive: other sessions/objects may still use it
}

std::size_t session::nprocs() const {
  PyObject* r = must(PyObject_CallMethod(impl_->dr, "nprocs", nullptr),
                     "nprocs()");
  std::size_t n = PyLong_AsSize_t(r);
  Py_DECREF(r);
  return n;
}

void session::exec(const std::string& code) {
  if (PyRun_SimpleString(code.c_str())) fail("exec");
}

// ------------------------------------------------------------ containers

namespace {
const char* np_name(dtype dt) {
  switch (dt) {
    case dtype::f32: return "float32";
    case dtype::i32: return "int32";
    default: return "float64";
  }
}
}  // namespace

vector session::make_vector(std::size_t n, std::size_t prev,
                            std::size_t next, bool periodic, dtype dt) {
  PyObject* hb = nullptr;
  if (prev || next) {
    PyObject* hb_cls = must(
        PyObject_GetAttrString(impl_->dr, "halo_bounds"), "halo_bounds");
    hb = must(PyObject_CallFunction(hb_cls, "nnO", (Py_ssize_t)prev,
                                    (Py_ssize_t)next,
                                    periodic ? Py_True : Py_False),
              "halo_bounds(...)");
    Py_DECREF(hb_cls);
  }
  PyObject* cls = must(
      PyObject_GetAttrString(impl_->dr, "distributed_vector"),
      "distributed_vector");
  PyObject* np_dt = must(
      PyObject_GetAttrString(impl_->np, np_name(dt)), "numpy dtype");
  PyObject* args = Py_BuildValue("(n)", (Py_ssize_t)n);
  PyObject* kwargs = hb
      ? Py_BuildValue("{s:O,s:O}", "dtype", np_dt, "halo", hb)
      : Py_BuildValue("{s:O}", "dtype", np_dt);
  PyObject* obj = must(PyObject_Call(cls, args, kwargs),
                       "distributed_vector(...)");
  Py_DECREF(args);
  Py_DECREF(kwargs);
  Py_XDECREF(hb);
  Py_DECREF(np_dt);
  Py_DECREF(cls);
  return vector(this, obj, n, dt);
}

vector session::make_vector_blocks(
    const std::vector<std::size_t>& sizes, dtype dt) {
  std::size_t n = 0;
  for (std::size_t s : sizes) n += s;
  PyObject* szl = must(PyList_New((Py_ssize_t)sizes.size()),
                       "sizes list");
  for (std::size_t i = 0; i < sizes.size(); ++i)
    PyList_SET_ITEM(szl, (Py_ssize_t)i, PyLong_FromSize_t(sizes[i]));
  PyObject* cls = must(
      PyObject_GetAttrString(impl_->dr, "distributed_vector"),
      "distributed_vector");
  PyObject* np_dt = must(
      PyObject_GetAttrString(impl_->np, np_name(dt)), "numpy dtype");
  PyObject* args = Py_BuildValue("(n)", (Py_ssize_t)n);
  PyObject* kwargs = Py_BuildValue("{s:O,s:O}", "dtype", np_dt,
                                   "distribution", szl);
  PyObject* obj = must(PyObject_Call(cls, args, kwargs),
                       "distributed_vector(distribution=...)");
  Py_DECREF(args);
  Py_DECREF(kwargs);
  Py_DECREF(np_dt);
  Py_DECREF(cls);
  Py_DECREF(szl);
  return vector(this, obj, n, dt);
}

dense_matrix session::make_dense(std::size_t m, std::size_t n,
                                 const std::vector<double>& row_major) {
  PyObject* cls = must(PyObject_GetAttrString(impl_->dr, "dense_matrix"),
                       "dense_matrix");
  PyObject* obj;
  if (row_major.empty()) {
    obj = must(PyObject_CallFunction(cls, "((nn))", (Py_ssize_t)m,
                                     (Py_ssize_t)n),
               "dense_matrix((m, n))");
  } else {
    if (row_major.size() != m * n) fail("make_dense: data size != m*n");
    PyObject* flat = impl_->np_f32(row_major);
    PyObject* arr = must(PyObject_CallMethod(flat, "reshape", "nn",
                                             (Py_ssize_t)m, (Py_ssize_t)n),
                         "reshape");
    obj = must(PyObject_CallMethod(cls, "from_array", "O", arr),
               "dense_matrix.from_array");
    Py_DECREF(arr);
    Py_DECREF(flat);
  }
  Py_DECREF(cls);
  return dense_matrix(this, obj, m, n);
}

sparse_matrix session::make_sparse_coo(
    std::size_t m, std::size_t n, const std::vector<std::int64_t>& rows,
    const std::vector<std::int64_t>& cols,
    const std::vector<double>& values) {
  if (rows.size() != cols.size() || rows.size() != values.size())
    fail("make_sparse_coo: triple lengths differ");
  PyObject* cls = must(PyObject_GetAttrString(impl_->dr, "sparse_matrix"),
                       "sparse_matrix");
  PyObject* ra = impl_->np_i64(rows);
  PyObject* ca = impl_->np_i64(cols);
  PyObject* va = impl_->np_f32(values);
  PyObject* obj = must(
      PyObject_CallMethod(cls, "from_coo", "(nn)OOO", (Py_ssize_t)m,
                          (Py_ssize_t)n, ra, ca, va),
      "sparse_matrix.from_coo");
  Py_DECREF(va);
  Py_DECREF(ca);
  Py_DECREF(ra);
  Py_DECREF(cls);
  return sparse_matrix(this, obj, m, n, values.size());
}

mdarray session::make_mdarray(const std::vector<std::size_t>& shape,
                              const std::vector<double>& row_major) {
  if (shape.empty()) fail("make_mdarray: shape must have rank >= 1");
  std::size_t total = 1;
  for (std::size_t s : shape) total *= s;
  PyObject* shp = must(PyTuple_New((Py_ssize_t)shape.size()),
                       "shape tuple");
  for (std::size_t i = 0; i < shape.size(); ++i)
    PyTuple_SET_ITEM(shp, (Py_ssize_t)i, PyLong_FromSize_t(shape[i]));
  PyObject* cls = must(
      PyObject_GetAttrString(impl_->dr, "distributed_mdarray"),
      "distributed_mdarray");
  PyObject* obj;
  if (row_major.empty()) {
    obj = must(PyObject_CallFunction(cls, "(O)", shp),
               "distributed_mdarray(shape)");
  } else {
    if (row_major.size() != total)
      fail("make_mdarray: data size != product(shape)");
    PyObject* flat = impl_->np_f32(row_major);
    PyObject* arr = must(PyObject_CallMethod(flat, "reshape", "O", shp),
                         "reshape");
    obj = must(PyObject_CallMethod(cls, "from_array", "O", arr),
               "distributed_mdarray.from_array");
    Py_DECREF(arr);
    Py_DECREF(flat);
  }
  Py_DECREF(cls);
  Py_DECREF(shp);
  return mdarray(this, obj, shape);
}

mdarray session::make_mdarray(std::size_t m, std::size_t n,
                              const std::vector<double>& row_major) {
  return make_mdarray(std::vector<std::size_t>{m, n}, row_major);
}

mdspan session::submdspan(
    const mdarray& a,
    const std::vector<std::pair<std::size_t, std::size_t>>& box) {
  if (box.size() != a.rank())
    fail("submdspan: box rank != array rank");
  std::vector<std::size_t> wshape(box.size());
  PyObject* args = must(PyTuple_New((Py_ssize_t)box.size()),
                        "slice tuple");
  for (std::size_t d = 0; d < box.size(); ++d) {
    auto [lo, hi] = box[d];
    if (lo > hi || hi > a.shape()[d])
      fail("submdspan: window out of bounds");
    wshape[d] = hi - lo;
    PyObject* plo = PyLong_FromSize_t(lo);
    PyObject* phi = PyLong_FromSize_t(hi);
    PyObject* sl = must(PySlice_New(plo, phi, nullptr), "slice");
    Py_DECREF(plo);
    Py_DECREF(phi);
    PyTuple_SET_ITEM(args, (Py_ssize_t)d, sl);
  }
  PyObject* fn = must(PyObject_GetAttrString((PyObject*)a.obj_,
                                             "submdspan"),
                      "submdspan attr");
  PyObject* obj = must(PyObject_CallObject(fn, args), "submdspan(...)");
  Py_DECREF(fn);
  Py_DECREF(args);
  return mdspan(this, obj, std::move(wshape));
}

// ------------------------------------------------------------ algorithms

double session::dot(const vector& a, const vector& b) {
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "dot", "OO",
                          (PyObject*)a.obj_, (PyObject*)b.obj_),
      "dot(a, b)");
  double v = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return v;
}

void session::transform(const vector& in, vector& out, const expr& op) {
  PyObject* fn = impl_->op(op, 1);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "transform", "OOO",
                          (PyObject*)in.obj_, (PyObject*)out.obj_, fn),
      "transform");
  Py_DECREF(r);
  Py_DECREF(fn);
}

void session::transform2(const vector& a, const vector& b, vector& out,
                         const expr& op) {
  PyObject* zv = must(
      PyObject_CallMethod(impl_->views, "zip", "OO",
                          (PyObject*)a.obj_, (PyObject*)b.obj_),
      "views.zip");
  PyObject* fn = impl_->op(op, 2);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "transform", "OOO", zv,
                          (PyObject*)out.obj_, fn),
      "transform(zip)");
  Py_DECREF(r);
  Py_DECREF(fn);
  Py_DECREF(zv);
}

void session::for_each(vector& v, const expr& op) {
  PyObject* fn = impl_->op(op, 1);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "for_each", "OO",
                          (PyObject*)v.obj_, fn),
      "for_each");
  Py_DECREF(r);
  Py_DECREF(fn);
}

double session::transform_reduce(const vector& v, const expr& op) {
  PyObject* fn = impl_->op(op, 1);
  PyObject* tr = must(
      PyObject_GetAttrString(impl_->dr, "transform_reduce"),
      "transform_reduce attr");
  PyObject* args = Py_BuildValue("(O)", (PyObject*)v.obj_);
  PyObject* kwargs = Py_BuildValue("{s:O}", "transform_op", fn);
  PyObject* r = must(PyObject_Call(tr, args, kwargs), "transform_reduce");
  double out = PyFloat_AsDouble(r);
  Py_DECREF(r);
  Py_DECREF(kwargs);
  Py_DECREF(args);
  Py_DECREF(tr);
  Py_DECREF(fn);
  return out;
}

// -------------------------------------------- custom-op escape hatch

void session::transform(const vector& in, vector& out,
                        const custom_op& op) {
  PyObject* fn = impl_->op(op);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "transform", "OOO",
                          (PyObject*)in.obj_, (PyObject*)out.obj_, fn),
      "transform(custom)");
  Py_DECREF(r);
  Py_DECREF(fn);
}

void session::transform2(const vector& a, const vector& b, vector& out,
                         const custom_op& op) {
  PyObject* zv = must(
      PyObject_CallMethod(impl_->views, "zip", "OO",
                          (PyObject*)a.obj_, (PyObject*)b.obj_),
      "views.zip");
  PyObject* fn = impl_->op(op);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "transform", "OOO", zv,
                          (PyObject*)out.obj_, fn),
      "transform(zip, custom)");
  Py_DECREF(r);
  Py_DECREF(fn);
  Py_DECREF(zv);
}

void session::for_each(vector& v, const custom_op& op) {
  PyObject* fn = impl_->op(op);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "for_each", "OO",
                          (PyObject*)v.obj_, fn),
      "for_each(custom)");
  Py_DECREF(r);
  Py_DECREF(fn);
}

double session::transform_reduce(const vector& v, const custom_op& op) {
  PyObject* fn = impl_->op(op);
  PyObject* tr = must(
      PyObject_GetAttrString(impl_->dr, "transform_reduce"),
      "transform_reduce attr");
  PyObject* args = Py_BuildValue("(O)", (PyObject*)v.obj_);
  PyObject* kwargs = Py_BuildValue("{s:O}", "transform_op", fn);
  PyObject* r = must(PyObject_Call(tr, args, kwargs),
                     "transform_reduce(custom)");
  double out = PyFloat_AsDouble(r);
  Py_DECREF(r);
  Py_DECREF(kwargs);
  Py_DECREF(args);
  Py_DECREF(tr);
  Py_DECREF(fn);
  return out;
}

namespace {
// v[lo:hi] as a Python subrange view (new reference)
PyObject* py_window(void* obj, std::size_t lo, std::size_t hi) {
  PyObject* plo = PyLong_FromSize_t(lo);
  PyObject* phi = PyLong_FromSize_t(hi);
  PyObject* sl = must(PySlice_New(plo, phi, nullptr), "slice");
  Py_DECREF(plo);
  Py_DECREF(phi);
  PyObject* w = must(PyObject_GetItem((PyObject*)obj, sl), "v[lo:hi]");
  Py_DECREF(sl);
  return w;
}
}  // namespace

void session::inclusive_scan(const vector& in, vector& out) {
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "inclusive_scan", "OO",
                          (PyObject*)in.obj_, (PyObject*)out.obj_),
      "inclusive_scan");
  Py_DECREF(r);
}

void session::exclusive_scan(const vector& in, vector& out, double init) {
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "exclusive_scan", "OOd",
                          (PyObject*)in.obj_, (PyObject*)out.obj_, init),
      "exclusive_scan");
  Py_DECREF(r);
}

void session::inclusive_scan(const vector& in, std::size_t ilo,
                             std::size_t ihi, vector& out,
                             std::size_t olo, std::size_t ohi) {
  if (ilo > ihi || ihi > in.size() || olo > ohi || ohi > out.size() ||
      ihi - ilo != ohi - olo)
    fail("inclusive_scan: bad windows");
  PyObject* iw = py_window(in.obj_, ilo, ihi);
  PyObject* ow = py_window(out.obj_, olo, ohi);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "inclusive_scan", "OO", iw, ow),
      "inclusive_scan(windows)");
  Py_DECREF(r);
  Py_DECREF(ow);
  Py_DECREF(iw);
}

void session::exclusive_scan(const vector& in, std::size_t ilo,
                             std::size_t ihi, vector& out,
                             std::size_t olo, std::size_t ohi,
                             double init) {
  if (ilo > ihi || ihi > in.size() || olo > ohi || ohi > out.size() ||
      ihi - ilo != ohi - olo)
    fail("exclusive_scan: bad windows");
  PyObject* iw = py_window(in.obj_, ilo, ihi);
  PyObject* ow = py_window(out.obj_, olo, ohi);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "exclusive_scan", "OOd", iw, ow,
                          init),
      "exclusive_scan(windows)");
  Py_DECREF(r);
  Py_DECREF(ow);
  Py_DECREF(iw);
}

namespace {
// dr.<name>(*args, descending=...) — the sort family's shared call
// shape (five call sites); returns the result as a NEW reference and
// consumes nothing (caller still owns args)
PyObject* call_descending(PyObject* dr, const char* name, PyObject* args,
                          bool descending) {
  PyObject* fn = must(PyObject_GetAttrString(dr, name), name);
  PyObject* kwargs = Py_BuildValue("{s:O}", "descending",
                                   descending ? Py_True : Py_False);
  PyObject* r = must(PyObject_Call(fn, args, kwargs), name);
  Py_DECREF(kwargs);
  Py_DECREF(fn);
  return r;
}
}  // namespace

void session::sort(vector& v, bool descending) {
  PyObject* args = Py_BuildValue("(O)", (PyObject*)v.obj_);
  Py_DECREF(call_descending(impl_->dr, "sort", args, descending));
  Py_DECREF(args);
}

void session::sort_by_key(vector& keys, vector& values, bool descending) {
  PyObject* args = Py_BuildValue("(OO)", (PyObject*)keys.obj_,
                                 (PyObject*)values.obj_);
  Py_DECREF(call_descending(impl_->dr, "sort_by_key", args, descending));
  Py_DECREF(args);
}

void session::sort(vector& v, std::size_t lo, std::size_t hi,
                   bool descending) {
  if (lo > hi || hi > v.size()) fail("sort: window out of bounds");
  PyObject* w = py_window(v.obj_, lo, hi);
  PyObject* args = Py_BuildValue("(O)", w);
  Py_DECREF(call_descending(impl_->dr, "sort", args, descending));
  Py_DECREF(args);
  Py_DECREF(w);
}

void session::sort_by_key(vector& keys, std::size_t klo, std::size_t khi,
                          vector& values, std::size_t vlo,
                          std::size_t vhi, bool descending) {
  if (klo > khi || khi > keys.size() || vlo > vhi ||
      vhi > values.size() || khi - klo != vhi - vlo)
    fail("sort_by_key: bad windows");
  PyObject* kw = py_window(keys.obj_, klo, khi);
  PyObject* vw = py_window(values.obj_, vlo, vhi);
  PyObject* args = Py_BuildValue("(OO)", kw, vw);
  Py_DECREF(call_descending(impl_->dr, "sort_by_key", args,
                            descending));
  Py_DECREF(args);
  Py_DECREF(vw);
  Py_DECREF(kw);
}

bool session::is_sorted(const vector& v, std::size_t lo,
                        std::size_t hi) {
  if (lo > hi || hi > v.size()) fail("is_sorted: window out of bounds");
  PyObject* w = py_window(v.obj_, lo, hi);
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "is_sorted", "O", w),
      "is_sorted(window)");
  bool ok = PyObject_IsTrue(r) == 1;
  Py_DECREF(r);
  Py_DECREF(w);
  return ok;
}

vector session::argsort(const vector& v, bool descending) {
  PyObject* args = Py_BuildValue("(O)", (PyObject*)v.obj_);
  PyObject* obj = call_descending(impl_->dr, "argsort", args,
                                  descending);
  Py_DECREF(args);
  dtype dt = dtype::f32;
  try {
    dt = dtype_of(obj, "argsort");
  } catch (...) {
    Py_DECREF(obj);
    throw;
  }
  return vector(this, obj, v.size(), dt);
}

bool session::is_sorted(const vector& v) {
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "is_sorted", "O",
                          (PyObject*)v.obj_),
      "is_sorted");
  int t = PyObject_IsTrue(r);
  Py_DECREF(r);
  return t == 1;
}

void session::gemv(vector& c, const sparse_matrix& a, const vector& b) {
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "gemv", "OOO", (PyObject*)c.obj_,
                          (PyObject*)a.obj_, (PyObject*)b.obj_),
      "gemv");
  Py_DECREF(r);
}

void session::gemm(const dense_matrix& a, const dense_matrix& b,
                   dense_matrix& out) {
  PyObject* r = must(
      PyObject_CallMethod(impl_->dr, "gemm", "OOO", (PyObject*)a.obj_,
                          (PyObject*)b.obj_, (PyObject*)out.obj_),
      "gemm");
  Py_DECREF(r);
}

void session::transpose(mdarray& out, const mdarray& in,
                        const std::vector<std::size_t>& axes) {
  PyObject* r;
  if (axes.empty()) {  // numpy default: reversed axes
    r = must(PyObject_CallMethod(impl_->dr, "transpose", "OO",
                                 (PyObject*)out.obj_, (PyObject*)in.obj_),
             "transpose");
  } else {
    if (axes.size() != in.rank())
      fail("transpose: axes rank != array rank");
    PyObject* ax = must(PyTuple_New((Py_ssize_t)axes.size()),
                        "axes tuple");
    for (std::size_t i = 0; i < axes.size(); ++i)
      PyTuple_SET_ITEM(ax, (Py_ssize_t)i, PyLong_FromSize_t(axes[i]));
    r = must(PyObject_CallMethod(impl_->dr, "transpose", "OOO",
                                 (PyObject*)out.obj_, (PyObject*)in.obj_,
                                 ax),
             "transpose(axes)");
    Py_DECREF(ax);
  }
  Py_DECREF(r);
}

void session::save(const std::string& path, const vector& v) {
  PyObject* ckpt = must(PyObject_GetAttrString(impl_->dr, "checkpoint"),
                        "checkpoint module");
  PyObject* r = must(
      PyObject_CallMethod(ckpt, "save", "sO", path.c_str(),
                          (PyObject*)v.obj_),
      "checkpoint.save");
  Py_DECREF(r);
  Py_DECREF(ckpt);
}

vector session::load_vector(const std::string& path) {
  PyObject* ckpt = must(PyObject_GetAttrString(impl_->dr, "checkpoint"),
                        "checkpoint module");
  PyObject* obj = must(
      PyObject_CallMethod(ckpt, "load", "s", path.c_str()),
      "checkpoint.load");
  Py_DECREF(ckpt);
  // a checkpoint can hold any container kind; wrapping a matrix as a
  // vector would fail later with a confusing in-bridge error
  PyObject* cls = must(
      PyObject_GetAttrString(impl_->dr, "distributed_vector"),
      "distributed_vector");
  int is_vec = PyObject_IsInstance(obj, cls);
  Py_DECREF(cls);
  if (is_vec != 1) {
    Py_DECREF(obj);
    fail("load_vector: checkpoint does not hold a distributed_vector");
  }
  std::size_t n = 0;
  dtype dt = dtype::f32;
  try {
    n = len_of(obj, "len(vector)");
    dt = dtype_of(obj, "load_vector");
  } catch (...) {
    Py_DECREF(obj);
    throw;
  }
  return vector(this, obj, n, dt);
}

void session::stencil_iterate(vector& a, vector& b,
                              const std::vector<double>& weights,
                              int steps) {
  PyObject* w = PyList_New((Py_ssize_t)weights.size());
  for (Py_ssize_t i = 0; i < (Py_ssize_t)weights.size(); ++i)
    PyList_SetItem(w, i, PyFloat_FromDouble(weights[i]));
  PyObject* r = must(
      PyObject_CallMethod(impl_->stencil_mod, "stencil_iterate", "OOOi",
                          (PyObject*)a.obj_, (PyObject*)b.obj_, w, steps),
      "stencil_iterate");
  // stencil_iterate returns the buffer holding the final state; callers
  // keep using `a` as "current" — swap handles if needed
  if (r == (PyObject*)b.obj_) std::swap(a.obj_, b.obj_);
  Py_DECREF(r);
  Py_DECREF(w);
}

// ------------------------------------------------------------ handles

namespace detail {
handle::~handle() { Py_XDECREF((PyObject*)obj_); }

handle::handle(handle&& o) noexcept : sess_(o.sess_), obj_(o.obj_) {
  o.obj_ = nullptr;
}

handle& handle::operator=(handle&& o) noexcept {
  if (this != &o) {
    Py_XDECREF((PyObject*)obj_);
    sess_ = o.sess_;
    obj_ = o.obj_;
    o.obj_ = nullptr;
  }
  return *this;
}
}  // namespace detail

void vector::iota(double start) {
  PyObject* r = must(
      PyObject_CallMethod(sess_->impl_->dr, "iota", "Od",
                          (PyObject*)obj_, start),
      "iota");
  Py_DECREF(r);
}

void vector::fill(double value) {
  PyObject* r = must(
      PyObject_CallMethod(sess_->impl_->dr, "fill", "Od",
                          (PyObject*)obj_, value),
      "fill");
  Py_DECREF(r);
}

double vector::reduce() const {
  PyObject* r = must(
      PyObject_CallMethod(sess_->impl_->dr, "reduce", "O",
                          (PyObject*)obj_),
      "reduce");
  double v = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return v;
}

void vector::halo_exchange() {
  PyObject* h = must(
      PyObject_CallMethod(sess_->impl_->dr, "halo", "O", (PyObject*)obj_),
      "halo(v)");
  PyObject* r = must(PyObject_CallMethod(h, "exchange", nullptr),
                     "exchange()");
  Py_DECREF(r);
  Py_DECREF(h);
}

std::vector<double> vector::to_host() const {
  PyObject* arr = must(
      PyObject_CallMethod(sess_->impl_->dr, "to_numpy", "O",
                          (PyObject*)obj_),
      "to_numpy");
  std::vector<double> out = sess_->impl_->to_host_f64(arr);
  Py_DECREF(arr);
  return out;
}

std::vector<double> dense_matrix::to_host() const {
  PyObject* arr = must(
      PyObject_CallMethod((PyObject*)obj_, "materialize", nullptr),
      "materialize");
  std::vector<double> out = sess_->impl_->to_host_f64(arr);
  Py_DECREF(arr);
  return out;
}

std::vector<double> mdarray::to_host() const {
  PyObject* arr = must(
      PyObject_CallMethod((PyObject*)obj_, "materialize", nullptr),
      "materialize");
  std::vector<double> out = sess_->impl_->to_host_f64(arr);
  Py_DECREF(arr);
  return out;
}

std::vector<double> mdspan::to_host() const {
  PyObject* arr = must(
      PyObject_CallMethod((PyObject*)obj_, "materialize", nullptr),
      "materialize");
  std::vector<double> out = sess_->impl_->to_host_f64(arr);
  Py_DECREF(arr);
  return out;
}

}  // namespace thp
