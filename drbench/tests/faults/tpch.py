"""Faults planted under the TPC-H family's timed path, for the CPU
tests: each must turn a sound run into one that is not correct.

``faults(traffic)`` names the faults a cell of that traffic mix can
have, by the ops its calls run, so a new mix over these ops needs no
edit here; ``plant(monkeypatch, fault)`` breaks the port underneath the
harness.
"""


def faults(traffic):
    ops = traffic["ops"]
    names = {op["op"] for op in ops}
    out = []
    if "join" in names:
        out += ["join_row_altered", "half_the_rows"]
    if any(op["op"] == "groupby" and op["agg"] == "sum" for op in ops):
        out.append("sum_altered")
    if "top_k" in names:
        out.append("top_altered")
    return out


def plant(monkeypatch, fault):
    import dr_tpu_torch as dt
    if fault == "join_row_altered":
        real = dt.join

        def join(lk, lv, rk, rv, ok, ol, orr, **kw):
            m = real(lk, lv, rk, rv, ok, ol, orr, **kw)
            ol._rows[0][0, m // 2] += 1
            return m
        monkeypatch.setattr(dt, "join", join)
    elif fault == "half_the_rows":
        real = dt.join

        def join(lk, lv, rk, rv, ok, ol, orr, **kw):
            h = len(lk) // 2
            return real(lk[0:h], lv[0:h], rk, rv, ok, ol, orr, **kw)
        monkeypatch.setattr(dt, "join", join)
    elif fault == "sum_altered":
        real = dt.groupby_aggregate

        def groupby(k, v, ok, ov, agg):
            g = real(k, v, ok, ov, agg=agg)
            if agg == "sum":
                ov._rows[0][0, g // 3] *= 1.01
            return g
        monkeypatch.setattr(dt, "groupby_aggregate", groupby)
    elif fault == "top_altered":
        real = dt.top_k

        def top_k(r, out_vals, out_idx=None, **kw):
            real(r, out_vals, out_idx, **kw)
            out_vals._rows[0][0, 3] *= 0.999
            return out_vals
        monkeypatch.setattr(dt, "top_k", top_k)
    else:
        raise ValueError(fault)
