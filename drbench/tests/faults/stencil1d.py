"""Faults planted under the 1-D stencil family's timed path, for the CPU
tests: each must turn a sound run into one that is not correct.

``faults(traffic)`` names the faults a cell of that traffic mix can
have, by the ops its calls run, so a new mix over these ops needs no
edit here; ``plant(monkeypatch, fault)`` breaks the port underneath the
harness.
"""

#: the ops that step the field
STEPS = ("stencil_iterate", "stencil_iterate_matmul",
         "stencil_iterate_blocked")


def faults(traffic):
    ops = {op["op"] for op in traffic["ops"]}
    out = []
    if ops & set(STEPS):
        out += ["state_unchanged", "exchange_left_out"]
    if "dot" in ops:
        out.append("dot_altered")
    if "inclusive_scan" in ops:
        out.append("scan_altered")
    return out


def plant(monkeypatch, fault):
    import dr_tpu_torch as dt
    from dr_tpu_torch.algorithms import stencil
    if fault == "state_unchanged":
        for name in STEPS:
            monkeypatch.setattr(dt, name, lambda a, *x, **k: a)
    elif fault == "exchange_left_out":
        # every route's exchange: the blocked paths' ring refresh, the
        # torch-op step's in-place exchange and the kernel step's
        # received slices (None: each row's own stale ghosts stand)
        monkeypatch.setattr(stencil, "_ring_exchange_full",
                            lambda *a, **k: None)
        monkeypatch.setattr(stencil, "exchange_rows", lambda *a, **k: None)
        monkeypatch.setattr(stencil, "ghost_slices",
                            lambda rows, devices, layout, periodic:
                            ([None] * layout[0], [None] * layout[0]))
    elif fault == "dot_altered":
        real = dt.dot
        monkeypatch.setattr(dt, "dot", lambda a, b: real(a, b) * 1.001)
    elif fault == "scan_altered":
        real = dt.inclusive_scan

        def scan(a, out):
            real(a, out)
            row = out._rows[0]
            row[0, row.shape[-1] // 2] += 1.0
        monkeypatch.setattr(dt, "inclusive_scan", scan)
    else:
        raise ValueError(fault)
