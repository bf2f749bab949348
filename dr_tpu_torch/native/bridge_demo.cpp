// bridge_demo: C++ program driving dr_tpu_torch end to end through the
// port's bridge: the native equivalent of the reference's example set
// (vector-add, dot_product, stencil-1d, inclusive_scan, gemv, transpose)
// asserted against serial C++ oracles (the reference's oracle pattern,
// test/gtest/include/common-tests.hpp:52-81).
// Usage: bridge_demo [ncpu_ranks [n]]  (0 ranks = the visible CUDA
// devices; n = the main vectors' length, default 2^14).  Before PASSED
// it prints the kernels' launch counts as one line,
// "launches {...json...}".
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <filesystem>
#include <string>
#include <unistd.h>
#include <vector>

#include "thp_bridge.hpp"

namespace {

int failures = 0;

void check_close(const char* what, double got, double want,
                 double tol = 1e-4) {
  double scale = std::abs(want) > 1.0 ? std::abs(want) : 1.0;
  if (std::abs(got - want) > tol * scale) {
    std::printf("%s FAIL: got %.8g want %.8g\n", what, got, want);
    ++failures;
  }
}

void check_range(const char* what, const std::vector<double>& got,
                 const std::vector<double>& want, double tol = 1e-4) {
  if (got.size() != want.size()) {
    std::printf("%s FAIL: size %zu vs %zu\n", what, got.size(),
                want.size());
    ++failures;
    return;
  }
  for (std::size_t i = 0; i < got.size(); ++i) {
    double scale = std::abs(want[i]) > 1.0 ? std::abs(want[i]) : 1.0;
    if (std::abs(got[i] - want[i]) > tol * scale) {
      std::printf("%s FAIL at %zu: got %.8g want %.8g\n", what, i,
                  got[i], want[i]);
      ++failures;
      return;
    }
  }
}

// a checkpoint file in the temporary directory ($TMPDIR or /tmp)
std::string ckpt_path(const char* tag) {
  return (std::filesystem::temp_directory_path() /
          ("thp_bridge_ckpt_" + std::to_string((long)getpid()) + "_" + tag +
           ".npz"))
      .string();
}

}  // namespace

int run(int argc, char** argv) {
  // expr DSL serialization: canonical strings ARE the op cache keys
  // (equal strings -> one Python callable -> reused caches), so their
  // exact shape is part of the bridge contract
  if ((thp::x0 * 2.0 + 1.0).str() != "((x0 * 2) + 1)" ||
      thp::max(thp::sqrt(thp::abs(thp::x0)), thp::x1).str() !=
          "maximum(sqrt(abs(x0)), x1)" ||
      (1.5 / thp::x2 - -thp::x3).str() != "((1.5 / x2) - (0 - x3))") {
    std::printf("expr serialization FAIL: %s | %s | %s\n",
                (thp::x0 * 2.0 + 1.0).str().c_str(),
                thp::max(thp::sqrt(thp::abs(thp::x0)), thp::x1)
                    .str().c_str(),
                (1.5 / thp::x2 - -thp::x3).str().c_str());
    return 1;
  }

  int ncpu = argc > 1 ? std::atoi(argv[1]) : 8;
  const std::size_t n =
      argc > 2 ? (std::size_t)std::strtoull(argv[2], nullptr, 10) : 1 << 14;
  thp::session s(ncpu);
  std::printf("nprocs=%zu\n", s.nprocs());

  // ---- iota + reduce --------------------------------------------------
  thp::vector a = s.make_vector(n);
  a.iota(1.0);
  double expect = 0.5 * (double)n * (double)(n + 1);
  check_close("reduce", a.reduce(), expect);

  // ---- dot ------------------------------------------------------------
  thp::vector b = s.make_vector(n);
  b.fill(2.0);
  check_close("dot", s.dot(a, b), 2.0 * expect);

  // ---- vector-add via the zip op DSL (examples/mhp/vector-add.cpp) ----
  thp::vector vsum = s.make_vector(n);
  s.transform2(a, b, vsum, thp::x0 + thp::x1);
  check_close("vector-add reduce", vsum.reduce(), expect + 2.0 * n);

  // ---- unary transform + for_each DSL ---------------------------------
  thp::vector t = s.make_vector(n);
  s.transform(a, t, thp::x0 * 2.0 + 1.0);     // 2*i + 1
  check_close("transform reduce", t.reduce(), 2.0 * expect + n);
  s.for_each(t, thp::sqrt(thp::abs(thp::x0 - 1.0) / 2.0));  // back to
  // sqrt(i): sum over i=1..n of sqrt(i)
  {
    double want = 0.0;
    for (std::size_t i = 1; i <= n; ++i) want += std::sqrt((double)i);
    check_close("for_each reduce", t.reduce(), want);
  }

  // ---- transform_reduce (the dot-product example's workload) ---------
  check_close("transform_reduce x^2",
              s.transform_reduce(b, thp::x0 * thp::x0), 4.0 * n);

  // ---- inclusive / exclusive scan -------------------------------------
  thp::vector sc = s.make_vector(n);
  s.inclusive_scan(a, sc);            // scan of 1..n: i*(i+1)/2
  {
    auto host = sc.to_host();
    std::vector<double> want(n);
    for (std::size_t i = 0; i < n; ++i)
      want[i] = 0.5 * (double)(i + 1) * (double)(i + 2);
    check_range("inclusive_scan", host, want);
  }
  s.exclusive_scan(a, sc, 10.0);      // 10 + i*(i+1)/2 shifted
  {
    auto host = sc.to_host();
    std::vector<double> want(n);
    double run = 10.0;
    for (std::size_t i = 0; i < n; ++i) {
      want[i] = run;
      run += (double)(i + 1);
    }
    check_range("exclusive_scan", host, want);
  }
  {
    // MISMATCHED in/out windows (the Python layer realigns
    // window-coordinate results)
    const std::size_t wn = 96;
    thp::vector wi = s.make_vector(wn);
    thp::vector wo = s.make_vector(wn);
    wi.iota(1.0);
    wo.fill(-1.0);
    s.inclusive_scan(wi, 0, 50, wo, 7, 57);
    auto host = wo.to_host();
    std::vector<double> want(wn, -1.0);
    double run = 0.0;
    for (std::size_t i = 0; i < 50; ++i) {
      run += (double)(i + 1);
      want[7 + i] = run;
    }
    check_range("inclusive_scan windows", host, want);
    s.exclusive_scan(wi, 10, 40, wo, 0, 30, 5.0);
    host = wo.to_host();
    run = 5.0;
    for (std::size_t i = 0; i < 30; ++i) {
      want[i] = run;
      run += (double)(10 + i + 1);
    }
    check_range("exclusive_scan windows", host, want);
  }
  {
    // uneven block distribution (teams) from C++: rank 0 owns 10,
    // rank 1 owns 0 (empty team), the rest splits the tail
    std::size_t P = s.nprocs();
    std::vector<std::size_t> sizes(P, 0);
    const std::size_t un = 57;
    sizes[0] = 10;
    if (P > 2) {
      std::size_t rest = un - 10, each = rest / (P - 2);
      for (std::size_t r = 2; r < P; ++r) sizes[r] = each;
      sizes[P - 1] += rest - each * (P - 2);
    } else {
      sizes[P - 1] += un - 10;
    }
    thp::vector uv = s.make_vector_blocks(sizes);
    uv.iota(1.0);
    check_close("uneven reduce", uv.reduce(),
                0.5 * (double)un * (double)(un + 1));
    s.sort(uv, /*descending=*/true);
    auto host = uv.to_host();
    std::vector<double> want(un);
    for (std::size_t i = 0; i < un; ++i) want[i] = (double)(un - i);
    check_range("uneven sort desc", host, want);
    thp::vector us = s.make_vector_blocks(sizes);
    s.inclusive_scan(uv, us);  // scan of un..1
    host = us.to_host();
    double run = 0.0;
    for (std::size_t i = 0; i < un; ++i) {
      run += (double)(un - i);
      want[i] = run;
    }
    check_range("uneven scan", host, want);
  }

  // ---- distributed sample sort ----------------------------------------
  thp::vector sv = s.make_vector(n);
  sv.iota(0.0);
  s.for_each(sv, 0.0 - thp::x0);      // n descending values -0..-(n-1)
  s.sort(sv);
  {
    auto host = sv.to_host();
    std::vector<double> want(n);
    for (std::size_t i = 0; i < n; ++i)
      want[i] = -(double)(n - 1 - i);
    check_range("sort ascending", host, want);
  }
  s.sort(sv, /*descending=*/true);
  {
    auto host = sv.to_host();
    std::vector<double> want(n);
    for (std::size_t i = 0; i < n; ++i) want[i] = -(double)i;
    check_range("sort descending", host, want);
  }
  // key-value: keys descending 0..-(n-1) after the sort above; payload
  // iota must come out reversed when keys are sorted ascending
  thp::vector pv = s.make_vector(n);
  pv.iota(0.0);
  s.sort_by_key(sv, pv);
  {
    auto hk = sv.to_host();
    auto hp = pv.to_host();
    std::vector<double> wk(n), wp(n);
    for (std::size_t i = 0; i < n; ++i) {
      wk[i] = -(double)(n - 1 - i);
      wp[i] = (double)(n - 1 - i);
    }
    check_range("sort_by_key keys", hk, wk);
    check_range("sort_by_key payload", hp, wp);
  }
  // after sort_by_key the keys are ascending and the payload is the
  // reversed iota: one true case, one false case
  if (!s.is_sorted(sv)) {
    std::fprintf(stderr, "FAIL is_sorted: ascending keys read unsorted\n");
    return 1;
  }
  if (s.is_sorted(pv)) {
    std::fprintf(stderr, "FAIL is_sorted: reversed payload read sorted\n");
    return 1;
  }
  // ---- subrange-window sort family from C++ ---------------------------
  {
    const std::size_t wn = 64;
    thp::vector wv = s.make_vector(wn);
    wv.iota(0.0);
    s.sort(wv, 5, 40, /*descending=*/true);  // window descending
    auto host = wv.to_host();
    std::vector<double> want(wn);
    for (std::size_t i = 0; i < wn; ++i) want[i] = (double)i;
    for (std::size_t i = 5; i < 40; ++i) want[i] = (double)(44 - i);
    check_range("sort window desc", host, want);
    if (s.is_sorted(wv, 5, 40)) {
      std::printf("is_sorted window FAIL: descending read sorted\n");
      ++failures;
    }
    if (!s.is_sorted(wv, 40, wn)) {
      std::printf("is_sorted window FAIL: ascending tail\n");
      ++failures;
    }
    // overlapping key/value windows of ONE vector (payload-last blend)
    thp::vector ov = s.make_vector(wn);
    ov.iota(0.0);
    s.for_each(ov, thp::x0 * -1.0);  // descending data
    auto before = ov.to_host();
    s.sort_by_key(ov, 0, 20, ov, 10, 30);
    auto after = ov.to_host();
    std::vector<double> wantv = before;
    // keys [0,20) ascending; ties impossible; payload [10,30) follows
    std::vector<std::size_t> order(20);
    for (std::size_t i = 0; i < 20; ++i) order[i] = 19 - i;  // reversed
    for (std::size_t i = 0; i < 20; ++i)
      wantv[i] = before[order[i]];
    for (std::size_t i = 0; i < 20; ++i)
      wantv[10 + i] = before[10 + order[i]];
    check_range("sort_by_key overlap windows", after, wantv);
  }
  {
    // argsort of the (now ascending) keys is the identity permutation
    thp::vector perm = s.argsort(sv);
    auto host = perm.to_host();
    std::vector<double> want(n);
    for (std::size_t i = 0; i < n; ++i) want[i] = (double)i;
    check_range("argsort identity", host, want);
  }

  // ---- halo'd stencil, 4 fused steps on device ------------------------
  thp::vector x = s.make_vector(n, 1, 1, false);
  thp::vector y = s.make_vector(n, 1, 1, false);
  x.iota(0.0);
  y.iota(0.0);
  s.stencil_iterate(x, y, {1.0 / 3, 1.0 / 3, 1.0 / 3}, 4);
  {
    auto host = x.to_host();
    // iota is a fixed point of the mean stencil in the interior
    for (std::size_t i = 8; i < n - 8; i += n / 7)
      check_close("stencil interior", host[i], (double)i, 1e-2);
  }

  // ---- sparse gemv (examples/shp/gemv_example.cpp) --------------------
  {
    const std::size_t m = 1024;
    std::vector<std::int64_t> ri, ci;
    std::vector<double> vv;
    for (std::size_t i = 0; i < m; ++i)
      for (std::int64_t dj = -1; dj <= 1; ++dj) {
        std::int64_t j = (std::int64_t)i + dj;
        if (j < 0 || j >= (std::int64_t)m) continue;
        ri.push_back((std::int64_t)i);
        ci.push_back(j);
        vv.push_back(1.0 + 0.001 * (double)i + 0.01 * (double)dj);
      }
    thp::sparse_matrix A = s.make_sparse_coo(m, m, ri, ci, vv);
    thp::vector bv = s.make_vector(m);
    thp::vector cv = s.make_vector(m);
    bv.iota(1.0);
    cv.fill(0.5);
    s.gemv(cv, A, bv);  // c += A·b
    std::vector<double> want(m, 0.5);
    for (std::size_t k = 0; k < vv.size(); ++k)
      want[(std::size_t)ri[k]] += vv[k] * (double)(ci[k] + 1);
    check_range("gemv", cv.to_host(), want);
  }

  // ---- dense gemm ------------------------------------------------------
  {
    const std::size_t m = 96, k = 64, p = 80;
    std::vector<double> da(m * k), db(k * p);
    for (std::size_t i = 0; i < da.size(); ++i)
      da[i] = 0.01 * (double)(i % 37) - 0.1;
    for (std::size_t i = 0; i < db.size(); ++i)
      db[i] = 0.02 * (double)(i % 29) - 0.2;
    thp::dense_matrix A = s.make_dense(m, k, da);
    thp::dense_matrix B = s.make_dense(k, p, db);
    thp::dense_matrix C = s.make_dense(m, p);
    s.gemm(A, B, C);
    std::vector<double> want(m * p, 0.0);
    for (std::size_t i = 0; i < m; ++i)
      for (std::size_t kk = 0; kk < k; ++kk)
        for (std::size_t j = 0; j < p; ++j)
          want[i * p + j] += da[i * k + kk] * db[kk * p + j];
    check_range("gemm", C.to_host(), want, 1e-3);
  }

  // ---- mdarray transpose (examples/mhp/transpose-cpu.cpp) -------------
  {
    const std::size_t m = 64, p = 48;
    std::vector<double> dm(m * p);
    for (std::size_t i = 0; i < dm.size(); ++i)
      dm[i] = (double)i * 0.5 - 3.0;
    thp::mdarray M = s.make_mdarray(m, p, dm);
    thp::mdarray T = s.make_mdarray(p, m);
    s.transpose(T, M);
    std::vector<double> want(p * m);
    for (std::size_t i = 0; i < m; ++i)
      for (std::size_t j = 0; j < p; ++j)
        want[j * m + i] = dm[i * p + j];
    check_range("transpose", T.to_host(), want);
  }

  // ---- N-D mdarray: 3-D axis-permutation transpose + submdspan
  // (the spec'd N-D surface reached from C++,
  // doc/spec/source/containers/distributed_mdarray.rst:12-23) --------
  {
    const std::size_t a = 12, b = 10, c = 8;
    std::vector<double> d3(a * b * c);
    for (std::size_t i = 0; i < d3.size(); ++i)
      d3[i] = (double)i * 0.25 - 40.0;
    thp::mdarray M = s.make_mdarray({a, b, c}, d3);
    if (M.rank() != 3 || M.shape()[1] != b) {
      std::printf("mdarray3d shape FAIL\n");
      ++failures;
    }
    check_range("mdarray3d roundtrip", M.to_host(), d3);
    // permute (a,b,c) -> (c,a,b) via axes {2,0,1}
    thp::mdarray T3 = s.make_mdarray({c, a, b});
    s.transpose(T3, M, {2, 0, 1});
    std::vector<double> want3(c * a * b);
    for (std::size_t i = 0; i < a; ++i)
      for (std::size_t j = 0; j < b; ++j)
        for (std::size_t k3 = 0; k3 < c; ++k3)
          want3[(k3 * a + i) * b + j] = d3[(i * b + j) * c + k3];
    check_range("transpose3d axes(2,0,1)", T3.to_host(), want3);
    // default (reversed) permutation on the same 3-D array
    thp::mdarray TR = s.make_mdarray({c, b, a});
    s.transpose(TR, M);
    std::vector<double> wantr(c * b * a);
    for (std::size_t i = 0; i < a; ++i)
      for (std::size_t j = 0; j < b; ++j)
        for (std::size_t k3 = 0; k3 < c; ++k3)
          wantr[(k3 * b + j) * a + i] = d3[(i * b + j) * c + k3];
    check_range("transpose3d reversed", TR.to_host(), wantr);
    // submdspan window [2,9) x [1,6) x [3,8): materializes ONLY the
    // window, row-major over the window shape
    thp::mdspan W = s.submdspan(M, {{2, 9}, {1, 6}, {3, 8}});
    if (W.rank() != 3 || W.shape()[0] != 7 || W.shape()[1] != 5 ||
        W.shape()[2] != 5) {
      std::printf("submdspan shape FAIL\n");
      ++failures;
    }
    std::vector<double> wantw(7 * 5 * 5);
    for (std::size_t i = 0; i < 7; ++i)
      for (std::size_t j = 0; j < 5; ++j)
        for (std::size_t k3 = 0; k3 < 5; ++k3)
          wantw[(i * 5 + j) * 5 + k3] =
              d3[((i + 2) * b + (j + 1)) * c + (k3 + 3)];
    check_range("submdspan3d", W.to_host(), wantw);
  }

  // ---- checkpoint round-trip ------------------------------------------
  {
    thp::vector v = s.make_vector(777);
    v.iota(3.0);
    const std::string ckpt = ckpt_path("f32");
    s.save(ckpt, v);
    thp::vector w = s.load_vector(ckpt);
    std::remove(ckpt.c_str());
    if (w.size() != 777) {
      std::printf("checkpoint FAIL: size %zu\n", w.size());
      ++failures;
    } else {
      check_range("checkpoint", w.to_host(), v.to_host());
    }
  }

  {
    // custom-op escape hatch: conditionals are outside the arithmetic
    // DSL; leaky relu needs torch.where, expressible only as Python
    // source over tensors
    thp::custom_op leaky{
        "lambda x0: torch.where(x0 > 0, x0, 0.01 * x0)", 1};
    thp::vector cin = s.make_vector(64);
    thp::vector cout = s.make_vector(64);
    cin.iota(-32.0);  // half negative, half positive
    s.transform(cin, cout, leaky);
    std::vector<double> ch = cout.to_host();
    for (std::size_t i = 0; i < ch.size(); ++i) {
      double x = -32.0 + (double)i;
      double want = x > 0 ? x : 0.01 * x;
      if (std::abs(ch[i] - want) > 1e-5) {
        std::printf("custom op FAIL at %zu: got %g want %g\n", i, ch[i],
                    want);
        ++failures;
        break;
      }
    }
    // zipped binary custom op + custom transform_reduce
    thp::custom_op takegt{
        "lambda x0, x1: torch.where(x0 > x1, x0, x1)", 2};
    thp::vector cz = s.make_vector(64);
    s.transform2(cin, cout, cz, takegt);
    check_close("custom zip reduce", cz.reduce(), [&] {
      double acc = 0;
      for (std::size_t i = 0; i < ch.size(); ++i) {
        double x = -32.0 + (double)i;
        acc += x > ch[i] ? x : ch[i];
      }
      return acc;
    }());
    thp::custom_op clip6{"lambda x0: torch.clip(x0, 0.0, 6.0)", 1};
    double clipped = s.transform_reduce(cin, clip6);
    check_close("custom transform_reduce", clipped, [&] {
      double acc = 0;
      for (std::size_t i = 0; i < 64; ++i) {
        double x = -32.0 + (double)i;
        acc += x < 0 ? 0.0 : (x > 6 ? 6.0 : x);
      }
      return acc;
    }());
  }

  {
    // typed containers: the device dtype is selectable; f32 is the
    // default, i32 holds exact integers through iota/reduce/to_host
    thp::vector f = s.make_vector(64);
    if (f.element_dtype() != thp::dtype::f32) {
      std::printf("dtype FAIL: default is not f32\n");
      ++failures;
    }
    thp::vector iv = s.make_vector(100, 0, 0, false, thp::dtype::i32);
    iv.iota(0.0);
    check_close("i32 reduce", iv.reduce(), 100.0 * 99.0 / 2.0);
    std::vector<double> ih = iv.to_host();
    if (ih.size() != 100 || ih[7] != 7.0 || ih[99] != 99.0) {
      std::printf("i32 to_host FAIL\n");
      ++failures;
    }
    // f64 allocates float64 (no switch needed): values no f32 holds
    // come back exactly
    thp::vector dv = s.make_vector(64, 0, 0, false, thp::dtype::f64);
    if (dv.element_dtype() != thp::dtype::f64) {
      std::printf("dtype FAIL: f64 vector not labelled f64\n");
      ++failures;
    }
    const double base = 16777216.5;  // 2^24 + 0.5
    dv.iota(base);
    std::vector<double> dh = dv.to_host();
    for (std::size_t i = 0; i < dh.size(); ++i)
      if (dh[i] != base + (double)i) {
        std::printf("f64 to_host FAIL at %zu: got %.17g\n", i, dh[i]);
        ++failures;
        break;
      }
    if (dv.reduce() != 64.0 * base + 2016.0) {
      std::printf("f64 reduce FAIL: got %.17g\n", dv.reduce());
      ++failures;
    }
    // the labels of containers the bridge did not make: argsort's int32
    // permutation, and load_vector's real dtype
    thp::vector perm = s.argsort(dv, /*descending=*/true);
    if (perm.element_dtype() != thp::dtype::i32) {
      std::printf("argsort label FAIL: not i32\n");
      ++failures;
    }
    std::vector<double> ph = perm.to_host();
    for (std::size_t i = 0; i < ph.size(); ++i)
      if (ph[i] != (double)(63 - i)) {
        std::printf("argsort f64 desc FAIL at %zu: got %g\n", i, ph[i]);
        ++failures;
        break;
      }
    for (auto [tag, src] : {std::pair<const char*, thp::vector*>{"f64", &dv},
                            {"i32", &iv}}) {
      const std::string ckpt = ckpt_path(tag);
      s.save(ckpt, *src);
      thp::vector back = s.load_vector(ckpt);
      std::remove(ckpt.c_str());
      if (back.element_dtype() != src->element_dtype()) {
        std::printf("load_vector label FAIL (%s)\n", tag);
        ++failures;
      }
      check_range(tag, back.to_host(), src->to_host(), 0.0);
    }
  }

  if (failures) {
    std::printf("bridge demo: %d FAILURES\n", failures);
    return 1;
  }
  std::fflush(stdout);
  s.exec("import json\nfrom dr_tpu_torch.ops import kernels\n"
         "print('launches ' + json.dumps(kernels.launches), flush=True)\n");
  std::printf("bridge demo PASSED (n=%zu, all surfaces)\n", n);
  return 0;
}

int main(int argc, char** argv) {
  try {
    return run(argc, argv);
  } catch (const std::exception& e) {
    std::printf("bridge demo FAILED: %s\n", e.what());
    return 2;
  }
}
