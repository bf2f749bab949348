"""The TPC-H family: the tables of a TPC-H database at a stated scale
factor, made on the card by dbgen's rules (TPC-H specification 3.0.1,
clause 4.2.3), and the program's state over them.

Each column is drawn from a generator of its own, seeded from the run's
seed and the column's name, so every mix that reads a column sees the
same values in it.  The traffic file names the columns it reads
(``tables``); only those are made, as int32 or f32 tensors on the card:

- ``customer``: ``c_custkey`` 1..C; ``c_mktsegment`` uniform over the
  five segments, as a code 0-4 in ``dists.dss``'s order (1 is
  BUILDING);
- ``orders``: ``o_orderkey`` dbgen's sparse keys, 8 used in every 32;
  ``o_custkey`` uniform over the customers whose key is not a multiple
  of 3 (dbgen leaves a third of them without orders); ``o_orderdate`` a
  uniform day number over ``date_days`` from 1992-01-01;
- ``lineitem``: 1 to 7 lines an order (one fixed multiset for every
  seed, so every seed carries the same rows); ``l_orderkey`` its order's
  key; ``l_quantity`` 1-50; ``l_extendedprice`` the quantity times the
  retail price of a uniform part key by dbgen's formula, in f32 dollars;
  ``l_discount`` 0.00-0.10 in f32; ``l_shipdate`` the order's date plus
  1 to 121 days;
- each table in a row order drawn from the seed (a table clustered by
  date, not by key).

A column not written here is made by ``families/tpch/<column>.py``, found
by its name: ``make(tables)`` returns it in key order, drawing from
``tables.randint(<column>, lo, hi, n)`` and reading other columns with
``tables.col``.

The program keeps the tables as the user's tensors and a frame of named
results: a tensor, or a port container with the count of its valid
rows.  The ops (``ops/tpch/<op>.py``) read and write the frame.
"""

import importlib.util
import zlib
from pathlib import Path

import torch


def generator(seed, name, device):
    """The generator of one column: the run's seed and the name's CRC
    mixed into 63 bits."""
    s = (int(seed) * 0x9E3779B1 + zlib.crc32(name.encode())) % (1 << 63)
    return torch.Generator(device=device).manual_seed(s)


class Tables:
    """dbgen's columns in key order, made once each on first use."""

    def __init__(self, cfg, seed, device):
        self.cfg, self.seed, self.dev = cfg, seed, device
        self.made = {}

    def g(self, name):
        return generator(self.seed, name, self.dev)

    def randint(self, name, lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=self.g(name),
                             device=self.dev, dtype=torch.int32)

    def col(self, name):
        if name not in self.made:
            make = getattr(self, "_" + name, None)
            self.made[name] = make() if make else _column_file(name)(self)
        return self.made[name]

    # customer
    def _c_custkey(self):
        return torch.arange(1, self.cfg["customers"] + 1, device=self.dev,
                            dtype=torch.int32)

    def _c_mktsegment(self):
        return self.randint("c_mktsegment", 0, self.cfg["segments"],
                            self.cfg["customers"])

    # orders
    def _o_orderkey(self):
        i = torch.arange(self.cfg["orders"], device=self.dev)
        return ((i // 8) * 32 + i % 8 + 1).int()

    def _o_lines(self):
        n = self.cfg["orders"]
        i = torch.arange(n, device=self.dev, dtype=torch.int32)
        return (i % 7 + 1)[torch.randperm(n, generator=self.g("o_lines"),
                                          device=self.dev)]

    def _o_custkey(self):
        c = self.cfg["customers"]
        r = self.randint("o_custkey", 0, c - c // 3, self.cfg["orders"])
        return r + r // 2 + 1

    def _o_orderdate(self):
        return self.randint("o_orderdate", 0, self.cfg["date_days"],
                            self.cfg["orders"])

    # lineitem
    def _per_line(self, name):
        return torch.repeat_interleave(self.col(name), self.col("o_lines"))

    def _l_orderkey(self):
        return self._per_line("o_orderkey")

    def _l_quantity(self):
        return self.randint("l_quantity", 1, 51, self.n_lines())

    def _l_extendedprice(self):
        part = self.randint("l_partkey", 1, self.cfg["parts"] + 1,
                            self.n_lines()).long()
        cents = 90000 + (part // 10) % 20001 + 100 * (part % 1000)
        del part
        return (self.col("l_quantity").long() * cents).double().div_(
            100.0).float()

    def _l_discount(self):
        return (self.randint("l_discount", 0, 11, self.n_lines()).double()
                / 100.0).float()

    def _l_shipdate(self):
        return self._per_line("o_orderdate") + self.randint(
            "l_shipdate", 1, self.cfg["ship_days"] + 1, self.n_lines())

    def n_lines(self):
        return int(self.col("o_lines").sum())

    def table(self, name, columns):
        """The columns of one table, in the seed's row order."""
        n = {"customer": self.cfg["customers"], "orders": self.cfg["orders"],
             "lineitem": self.n_lines()}[name]
        perm = torch.randperm(n, generator=self.g(name + ".rows"),
                              device=self.dev)
        return {c: self.col(c)[perm] for c in columns}


def _column_file(name):
    """``make`` of ``families/tpch/<name>.py``."""
    path = Path(__file__).resolve().parent / "tpch" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"tpch: no column {name!r} (no {path})")
    spec = importlib.util.spec_from_file_location(
        "drbench_tpch_column_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def make_inputs(cfg, traffic, seed, device):
    """``{table: {column: tensor}}`` for the columns the traffic reads."""
    t = Tables(cfg, seed, device)
    out = {name: t.table(name, cols)
           for name, cols in traffic["tables"].items()}
    del t
    return out


class Program:
    """The user's tables on the card and the frame the ops fill."""

    def __init__(self, dt, cfg, traffic, inputs):
        self.dt, self.cfg, self.traffic = dt, cfg, traffic
        self.tables = inputs
        self.frame = {}
        self.rec = {}

    def put(self, name, value, count=None):
        self.frame[name] = (value, count)

    def dtype(self, name):
        return self.frame[name][0].dtype

    def count(self, name):
        v, m = self.frame[name]
        return len(v) if m is None else m

    def tensor(self, name):
        """A frame entry as a tensor of its valid rows."""
        v, m = self.frame[name]
        if torch.is_tensor(v):
            return v
        a = v.to_array()
        return a if m == len(a) else a[:m]

    def vector(self, name):
        """A frame entry as a port range of its valid rows (a tensor is
        handed over with ``distributed_vector.from_array``)."""
        v, m = self.frame[name]
        if torch.is_tensor(v):
            return self.dt.distributed_vector.from_array(v)
        return v if m == len(v) else v[0:m]

    def record(self, op, value):
        self.rec.setdefault(op["as"], []).append(value)

    def outputs(self):
        return {}


def build(dt, cfg, traffic, inputs):
    return Program(dt, cfg, traffic, inputs)
