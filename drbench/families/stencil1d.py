"""The 1-D stencil family: a periodic field of ``n`` f32 cells stepped by
a weight stencil, the reference's loop (``examples/mhp/stencil-1d.cpp``)
at a deployment's size.

The configuration gives the field (``n``, ``weights``, ``periodic``);
the traffic file gives the halo and one call as a list of ops
(``ops/stencil1d/<op>.py``) over that field, which run in order, each
call continuing from the state the last one left.
"""

import torch


def make_inputs(cfg, traffic, seed, device):
    """The field: ``n`` standard normal f32 values drawn on ``device``
    from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {"field": torch.randn(cfg["n"], generator=g, device=device,
                                 dtype=torch.float32)}


class Program:
    """The field as a port ``distributed_vector`` (``a``) with the
    traffic's halo; an op makes any further vector it needs on its first
    call (``vector``), which is the warm call."""

    def __init__(self, dt, cfg, traffic, inputs):
        self.dt, self.cfg, self.traffic = dt, cfg, traffic
        self.w = tuple(float(x) for x in cfg["weights"])
        self.hb = dt.halo_bounds(traffic["halo"], traffic["halo"],
                                 periodic=cfg["periodic"])
        field = inputs["field"]
        self.n, self.dtype = field.numel(), field.dtype
        self.a = dt.distributed_vector.from_array(field, halo=self.hb)
        self.vectors = {}
        self.rec = {}

    def vector(self, name):
        if name not in self.vectors:
            self.vectors[name] = self.dt.distributed_vector(
                self.n, self.dtype, self.hb)
        return self.vectors[name]

    def outputs(self):
        return {"field": self.a.to_array()}


def build(dt, cfg, traffic, inputs):
    return Program(dt, cfg, traffic, inputs)
