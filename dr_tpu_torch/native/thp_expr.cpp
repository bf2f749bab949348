// thp::expr DSL serializer of the PyTorch port's bridge, its own
// translation unit and free of any Python dependency, so a C++ program
// can build and test the serialized grammar with nothing but a C++20
// compiler.  The canonical strings are the op cache keys on the Python
// side (dr_tpu_torch/utils/expr.py): their shape is the bridge's
// contract, the same strings as the bridge under native/bridge/.
#include "thp_bridge.hpp"

#include <cstdio>
#include <string>

namespace thp {

namespace {
std::string num(double v) {
  char buf[64];
  std::snprintf(buf, sizeof buf, "%.17g", v);
  return buf;
}
expr mk(std::string s) { return expr(expr::raw_t{}, std::move(s)); }
}  // namespace

expr expr::arg(int i) { return mk("x" + std::to_string(i)); }
expr expr::lit(double v) { return mk(num(v)); }

expr operator+(const expr& a, const expr& b) {
  return mk("(" + a.str() + " + " + b.str() + ")");
}
expr operator-(const expr& a, const expr& b) {
  return mk("(" + a.str() + " - " + b.str() + ")");
}
expr operator*(const expr& a, const expr& b) {
  return mk("(" + a.str() + " * " + b.str() + ")");
}
expr operator/(const expr& a, const expr& b) {
  return mk("(" + a.str() + " / " + b.str() + ")");
}
expr operator-(const expr& a) { return mk("(0 - " + a.str() + ")"); }
expr operator+(const expr& a, double b) { return a + expr::lit(b); }
expr operator+(double a, const expr& b) { return expr::lit(a) + b; }
expr operator-(const expr& a, double b) { return a - expr::lit(b); }
expr operator-(double a, const expr& b) { return expr::lit(a) - b; }
expr operator*(const expr& a, double b) { return a * expr::lit(b); }
expr operator*(double a, const expr& b) { return expr::lit(a) * b; }
expr operator/(const expr& a, double b) { return a / expr::lit(b); }
expr operator/(double a, const expr& b) { return expr::lit(a) / b; }
expr sqrt(const expr& a) { return mk("sqrt(" + a.str() + ")"); }
expr exp(const expr& a) { return mk("exp(" + a.str() + ")"); }
expr log(const expr& a) { return mk("log(" + a.str() + ")"); }
expr tanh(const expr& a) { return mk("tanh(" + a.str() + ")"); }
expr abs(const expr& a) { return mk("abs(" + a.str() + ")"); }
expr min(const expr& a, const expr& b) {
  return mk("minimum(" + a.str() + ", " + b.str() + ")");
}
expr max(const expr& a, const expr& b) {
  return mk("maximum(" + a.str() + ", " + b.str() + ")");
}
expr pow(const expr& a, const expr& b) {
  return mk("power(" + a.str() + ", " + b.str() + ")");
}

const expr x0 = expr::arg(0);
const expr x1 = expr::arg(1);
const expr x2 = expr::arg(2);
const expr x3 = expr::arg(3);
}  // namespace thp
