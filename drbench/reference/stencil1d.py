"""Plain reference of the 1-D stencil family, in float64 PyTorch: the
state the op references (``reference/stencil1d/<op>.py``) share.

A step is ``y[i] = sum_j w[j] * x[i + j - r]`` on the periodic ring, so
``S`` steps are one circular correlation whose transfer function is
``H(w)^S``, with ``H(w) = sum_d k[d] e^{i w d}`` over the taps
``k[d] = w[d + r]``.  The weights are the configuration's rounded to
f32, the weights both sides are given.  The reference steps the seed's
field by that product on the FFT grid, takes a dot product of a stepped
field by Parseval's sum over the same grid and the prefix sums by a
float64 cumsum.  Calls continue from one another, so every call is
replayed (``REPLAY = "calls"``): the step ops count the steps and
passes, the other ops mark where they read the field.  It imports
nothing of the program and reads the program's outputs only to judge
them.

The control is the reference in the program's place at the traffic's
``control_precision`` (one precision an op): the field starts rounded
to the step op's precision and every pass (one launch of ``k_block`` or
``time_block`` steps, or one plain step) applies its composed taps
rounded to it; the passes are exact, so the final field and each
sampled dot follow in closed form (leaving out the rounding of the
field between passes, which would only move the control further from
the reference).  The dot and the scan read the final field rounded to
their ops' precisions.
"""

import numpy as np
import torch

REPLAY = "calls"


def rounded(x, precision):
    """``x`` (f32) rounded to nearest-even at ``precision``: ``tf32``
    (10 mantissa bits), ``bf16`` (7) or ``f32`` (unchanged)."""
    if precision == "f32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":
        b = x.contiguous().view(torch.int32)
        drop = 13
        half = (1 << (drop - 1)) - 1
        b = b + half + ((b >> drop) & 1)
        return (b & ~((1 << drop) - 1)).view(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def f32_weights(weights):
    """The weights as the program gets them: rounded to f32, then held
    in float64."""
    return np.asarray(weights, dtype=np.float32).astype(np.float64)


def composed_taps(weights, steps):
    """The ``2 * steps * r + 1`` taps of ``steps`` steps (float64)."""
    c = np.ones(1)
    w = np.asarray(weights, dtype=np.float64)
    for _ in range(steps):
        c = np.convolve(c, w)
    return c


def transfer(taps, n, device):
    """``H(w_k) = sum_s c[s] e^{i w_k s}`` on the rfft grid of ``n``,
    for centred ``taps`` c[-R..R] (complex128)."""
    R = (len(taps) - 1) // 2
    k = torch.zeros(n, dtype=torch.float64, device=device)
    idx = torch.arange(-R, R + 1, device=device) % n
    k.index_add_(0, idx, torch.as_tensor(taps, dtype=torch.float64,
                                         device=device))
    return torch.conj(torch.fft.rfft(k))


def power(X, n):
    """Each rfft bin's share of ``sum x^2`` (Parseval's weights)."""
    m = n // 2 + 1
    wgt = torch.full((m,), 2.0 / n, dtype=torch.float64, device=X.device)
    wgt[0] = 1.0 / n
    if n % 2 == 0:
        wgt[-1] = 1.0 / n
    P = X.real.square() + X.imag.square()
    return P.mul_(wgt)


class State:
    def __init__(self, cfg, traffic, inputs, control):
        self.cfg, self.traffic = cfg, traffic
        self.w = f32_weights(cfg["weights"])
        self.prec = traffic["control_precision"] if control else None
        self.inputs = inputs
        self.n = inputs["field"].numel()
        self.dev = inputs["field"].device
        self.steps = 0
        self.passes = {}
        self.marks = {}
        self.calls = 0

    def step(self, op, block):
        """A step op of ``op["steps"]`` steps in passes of ``block``."""
        self.steps += op["steps"]
        prec = self.prec[op["op"]] if self.prec else "f32"
        full, rest = divmod(op["steps"], block)
        for nst in [block] * full + ([rest] if rest else []):
            self.passes[nst, prec] = self.passes.get((nst, prec), 0) + 1

    def mark(self, name):
        """Where the op ``name`` reads the field this call."""
        self.marks.setdefault(name, []).append(
            (self.steps, dict(self.passes)))

    def exact_dot(self, steps):
        """``sum x_S^2`` after ``steps`` steps by Parseval's sum."""
        if not steps:
            return float(self.P.sum())
        return float((self.P * torch.exp(self.logm2 * steps)).sum())


def start(cfg, traffic, inputs, control=False):
    return State(cfg, traffic, inputs, control)


def check(state, got, limits, sample):
    """``field_drift``: the largest gap of a cell of the program's final
    field from the reference's, over the reference field's RMS and over
    the steps taken (a pass's error is systematic, so the gap grows with
    the passes a window holds; per step it does not).  Leaves
    the program's field (``state.got``) and the spectrum's power
    (``state.P``, ``state.logm2``) for the op checks."""
    x = state.inputs.pop("field")
    n, dev = state.n, state.dev
    X = torch.fft.rfft(x.double())
    del x
    H = transfer(composed_taps(state.w, 1), n, dev)
    logm = torch.log(H.abs())
    ang = torch.angle(H)
    del H
    S = state.steps
    Y = X * torch.polar(torch.exp(logm * S), ang * S) if S else X
    del ang
    want = torch.fft.irfft(Y, n)
    del Y
    state.got = got["field"].double()
    scale = float(want.square().mean().sqrt())
    field_gap = float((state.got - want).abs().max()) / scale
    del want
    field_drift = field_gap / max(S, 1)
    state.P = power(X, n)
    del X
    state.logm2 = logm.mul_(2.0)
    return [("field_drift", field_drift, limits["field_drift"])]


def outputs(state):
    """The control's final field (closed form over the rounded passes);
    leaves the rounded field's power and each pass's log transfer
    (``state.P``, ``state.logs``) for the op controls."""
    x = state.inputs.pop("field")
    n, dev = state.n, state.dev
    step = next(state.prec[op["op"]] for op in state.traffic["ops"]
                if op["op"].startswith("stencil_iterate"))
    X = torch.fft.rfft(rounded(x, step).double())
    del x
    logs = {}
    for nst, prec in state.passes:
        taps = torch.as_tensor(composed_taps(state.w, nst),
                               dtype=torch.float32)
        H = transfer(rounded(taps, prec).double().numpy(), n, dev)
        logs[nst, prec] = (torch.log(H.abs()), torch.angle(H))
        del H
    mag = sum(c * logs[k][0] for k, c in state.passes.items())
    ang = sum(c * logs[k][1] for k, c in state.passes.items())
    state.field = torch.fft.irfft(X * torch.polar(torch.exp(mag), ang),
                                  n).float()
    del mag, ang
    state.P = power(X, n)
    del X
    state.logs = {k: v[0] for k, v in logs.items()}
    return {"field": state.field}
