"""dr_tpu_torch runtime, vocabulary, containers, views and elementwise
algorithms against dr_tpu on the CPU: the same numpy inputs through both
packages, compared rank row by rank row.

Layout and data movement are copies, so those comparisons are exact
(``np.array_equal``); float arithmetic states its tolerance."""

import jax
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu import views as jviews
from dr_tpu_torch import views as tviews


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    return dt.init(["cpu"] * P)


def _jrows(dv):
    return np.asarray(dv._data)


def _trows(dv):
    return np.concatenate([r.numpy() for r in dv.rows])


def test_runtime_cpu_ranks_and_duplication():
    rt = dt.init(["cpu"] * 8)
    assert dt.nprocs() == 8 and rt.devices == [torch.device("cpu")] * 8
    dup = dt.get_duplicated_devices(5, ["cpu", "cpu"])
    assert len(dup) == 5 and all(d.type == "cpu" for d in dup)
    assert dt.init(["cpu"] * 8, nprocs=3).nprocs == 3
    with pytest.raises(ValueError):
        dt.init(["cpu"], nprocs=2)
    dt.barrier()
    dt.fence()


@pytest.mark.parametrize("n", [1, 7, 100, 1001])
def test_layouts_match_reference(mesh_size, n):
    """Layout tuple, row width, segments and rows at every mesh size,
    including uneven n (short and empty tail shards)."""
    _init_both(mesh_size)
    src = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    for hb in (None, (2, 1, False)):
        jh = dr_tpu.halo_bounds(*hb) if hb else None
        th = dt.halo_bounds(*hb) if hb else None
        if hb and -(-n // mesh_size) < 2:
            continue  # segment narrower than the halo: both refuse
        j = dr_tpu.distributed_vector.from_array(src, halo=jh)
        t = dt.distributed_vector.from_array(src, halo=th)
        assert t.layout == j.layout and t.block_width == j.block_width
        assert [(s._rank, s.begin, s.end) for s in dt.segments(t)] == \
            [(s._rank, s.begin, s.end) for s in dr_tpu.segments(j)]
        np.testing.assert_array_equal(_trows(t), _jrows(j))
        np.testing.assert_array_equal(dt.to_numpy(t), src)


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def test_halo_refusals_match_reference(mesh_size):
    """Both packages refuse the same (n, halo) pairs: empty shards under
    a halo, and periodic rings whose last shard is narrower than the
    radius."""
    _init_both(mesh_size)
    refused = []
    for n in (1, 2, 3, 5, 9, 17, 33):
        for hb in ((2, 2, False), (2, 2, True), (3, 1, True), (1, 0, False)):
            jr = _raises(lambda: dr_tpu.distributed_vector(
                n, halo=dr_tpu.halo_bounds(*hb)))
            tr = _raises(lambda: dt.distributed_vector(
                n, halo=dt.halo_bounds(*hb)))
            assert jr == tr, (n, hb)
            refused.append(tr)
    assert any(refused) or mesh_size == 1


@pytest.mark.parametrize("sizes", [[5, 0, 3, 9], [0, 0, 4, 1], [6, 6, 6, 6]])
def test_block_distribution_matches_reference(sizes):
    _init_both(4)
    n = sum(sizes)
    src = np.arange(n, dtype=np.float32) * 0.5
    j = dr_tpu.distributed_vector.from_array(src, distribution=sizes)
    t = dt.distributed_vector.from_array(src, distribution=sizes)
    assert t.layout == j.layout
    assert dt.even_sizes(10, 4) == dr_tpu.even_sizes(10, 4)
    np.testing.assert_array_equal(_trows(t), _jrows(j))
    np.testing.assert_array_equal(dt.to_numpy(t), src)
    with pytest.raises(ValueError):
        dt.distributed_vector(n + 1, distribution=sizes)


def test_from_reference_state_carries_ghosts():
    """A JAX container's exact state (ghosts included) lands in the port."""
    _init_both(8)
    src = np.random.default_rng(1).standard_normal(90).astype(np.float32)
    j = dr_tpu.distributed_vector.from_array(
        src, halo=dr_tpu.halo_bounds(3, 2, periodic=True))
    dr_tpu.halo(j).exchange()
    t = dt.from_reference_state(j.layout, j.halo_bounds, _jrows(j))
    assert t.layout == j.layout and t.halo_bounds.periodic
    np.testing.assert_array_equal(_trows(t), _jrows(j))
    uneven = dr_tpu.distributed_vector.from_array(
        np.arange(11, dtype=np.int32), distribution=[1, 0, 2, 3, 0, 5, 0, 0])
    tu = dt.from_reference_state(uneven.layout, uneven.halo_bounds,
                                 _jrows(uneven))
    assert tu.dtype == torch.int32
    np.testing.assert_array_equal(dt.to_numpy(tu), np.arange(11))


def test_get_put_and_item_access(mesh_size):
    _init_both(mesh_size)
    n = 37
    src = np.arange(n, dtype=np.float32)
    j = dr_tpu.distributed_vector.from_array(src)
    t = dt.distributed_vector.from_array(src)
    idx = np.array([0, 5, n - 1, -2, 17])
    np.testing.assert_array_equal(t.get(idx).numpy(), np.asarray(j.get(idx)))
    j.put(idx, np.full(5, -1.0, np.float32))
    t.put(idx, np.full(5, -1.0, np.float32))
    np.testing.assert_array_equal(_trows(t), _jrows(j))
    t[3] = 42.0
    assert t[3] == 42.0 and t[-1] == -1.0
    with pytest.raises(IndexError):
        t.get([n])


def test_vocabulary_cpos_and_concepts():
    _init_both(4)
    t = dt.distributed_vector.from_array(np.arange(10, dtype=np.float32))
    segs = dt.segments(t)
    assert [dt.rank(s) for s in segs] == [0, 1, 2, 3]
    np.testing.assert_array_equal(dt.local(segs[1]).numpy(), [3, 4, 5])
    assert dt.is_distributed_range(t) and dt.is_distributed_contiguous_range(t)
    assert dt.is_remote_range(segs[0]) and not dt.is_remote_range([1, 2])
    assert dt.local([1, 2]) == [1, 2]  # host objects: identity fallback
    with pytest.raises(TypeError):
        dt.rank(3)
    s = segs[2]
    assert len(s.first(2)) == 2 and s.last(1).materialize().tolist() == [8.0]
    assert s.subspan(1, 2).materialize().tolist() == [7.0, 8.0]


def test_views_match_reference(mesh_size):
    """take/drop/subrange/transform/zip/iota segments and values."""
    _init_both(mesh_size)
    n = 29
    src = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    j = dr_tpu.distributed_vector.from_array(src)
    t = dt.distributed_vector.from_array(src)
    pairs = [
        (jviews.take(j, 11), tviews.take(t, 11)),
        (jviews.drop(j, 4), tviews.drop(t, 4)),
        (j[3:20], t[3:20]),
        (j[3:20][2:9], t[3:20][2:9]),
        (jviews.transform(j, lambda x: x * 2), tviews.transform(t, lambda x: x * 2)),
    ]
    for jv, tv in pairs:
        assert len(tv) == len(jv)
        assert [(dt.rank(s), len(s)) for s in dt.segments(tv)] == \
            [(dr_tpu.rank(s), len(s)) for s in dr_tpu.segments(jv)]
        # elementwise x*2 and slicing are exact in f32
        np.testing.assert_array_equal(dt.to_numpy(tv), dr_tpu.to_numpy(jv))
    z = tviews.zip(t, tviews.iota_view(0, n, like=t))
    assert dt.aligned(t, z) and dt.aligned(t, t[0:n])
    for a, b in ((1, 5), (2, 6)), ((0, 20), (5, 25)):
        assert dt.aligned(t[a[0]:a[1]], t[b[0]:b[1]]) == \
            dr_tpu.aligned(j[a[0]:a[1]], j[b[0]:b[1]])
    locs = dt.local_segments(t[2:9])
    np.testing.assert_array_equal(np.concatenate([x.numpy() for x in locs]),
                                  src[2:9])
    vals = tviews.iota_view(5, n, like=t).materialize()
    np.testing.assert_array_equal(vals, np.arange(5, 5 + n))


def test_elementwise_match_reference(mesh_size):
    """fill / iota / copy / transform / for_each, whole and windowed,
    rows compared bit for bit (ghost and pad cells included)."""
    _init_both(mesh_size)
    n = 45
    rng = np.random.default_rng(7)
    a_np = rng.standard_normal(n).astype(np.float32)
    b_np = rng.standard_normal(n).astype(np.float32)
    hbj, hbt = dr_tpu.halo_bounds(1, 1), dt.halo_bounds(1, 1)
    ja = dr_tpu.distributed_vector.from_array(a_np, halo=hbj)
    jb = dr_tpu.distributed_vector.from_array(b_np, halo=hbj)
    ta = dt.distributed_vector.from_array(a_np, halo=hbt)
    tb = dt.distributed_vector.from_array(b_np, halo=hbt)
    jo = dr_tpu.distributed_vector(n, halo=hbj)
    to = dt.distributed_vector(n, halo=hbt)

    def same():
        np.testing.assert_array_equal(_trows(to), _jrows(jo))

    dr_tpu.fill(jo, 2.5)
    dt.fill(to, 2.5)
    same()
    dr_tpu.iota(jo[3:30], 10)
    dt.iota(to[3:30], 10)
    same()
    # one f32 multiply-add per element, same operands: exact
    dr_tpu.transform(jviews.zip(ja, jb), jo, lambda x, y: x * y + 1.0)
    dt.transform(tviews.zip(ta, tb), to, lambda x, y: x * y + 1.0)
    np.testing.assert_allclose(_trows(to), _jrows(jo), rtol=1e-6, atol=0)
    dr_tpu.transform(ja[5:20], jo[5:20], lambda x, s: x - s, 0.5)
    dt.transform(ta[5:20], to[5:20], lambda x, s: x - s, 0.5)
    np.testing.assert_allclose(_trows(to), _jrows(jo), rtol=1e-6, atol=0)
    dr_tpu.copy(jb, jo)
    dt.copy(tb, to)
    same()
    dr_tpu.copy(np.arange(10, dtype=np.float32), jo[7:17])
    dt.copy(np.arange(10, dtype=np.float32), to[7:17])
    same()
    dr_tpu.for_each(jo, lambda x: x * 3.0)
    dt.for_each(to, lambda x: x * 3.0)
    same()
    host = np.zeros(n, np.float32)
    dt.copy(to, host)
    np.testing.assert_array_equal(host, dr_tpu.to_numpy(jo))


# ------------------------------------------ float-to-integer writes, fill

SAT = np.array([-1.5, -0.2, 255.5, 256.0, 1e10, np.nan, -1e10, 3.7, -3.7],
               np.float32)


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("into", ["uint8", "int8", "int32"])
@pytest.mark.parametrize("src", ["float32", "float16"])
def test_float_to_integer_writes_saturate_as_reference(P, into, src):
    """A float copied or transformed into an integer container converts
    as XLA's convert does (NaN to 0, clamped to the range), not by
    wrapping: bit for bit with dr_tpu."""
    _init_both(P)
    with np.errstate(over="ignore"):  # 1e10 is inf in float16
        vals = SAT.astype(src)
    ja = dr_tpu.distributed_vector.from_array(vals)
    ta = dt.distributed_vector.from_array(vals)
    jb = dr_tpu.distributed_vector(len(vals), dtype=into)
    tb = dt.distributed_vector(len(vals), dtype=into)
    dr_tpu.copy(ja, jb)
    dt.copy(ta, tb)
    want = dr_tpu.to_numpy(jb)
    assert np.array_equal(dt.to_numpy(tb), want), (dt.to_numpy(tb), want)
    dr_tpu.transform(ja, jb, lambda x: x * 2)
    dt.transform(ta, tb, lambda x: x * 2)
    assert np.array_equal(dt.to_numpy(tb), dr_tpu.to_numpy(jb))
    # the unaligned route: a shifted window goes through the gather
    dr_tpu.copy(ja[1:len(vals)], jb[0:len(vals) - 1])
    dt.copy(ta[1:len(vals)], tb[0:len(vals) - 1])
    assert np.array_equal(dt.to_numpy(tb), dr_tpu.to_numpy(jb))


def test_float_to_integer_write_table():
    """ROADMAP's cases: [-1.5, -0.2, 255.5, 256.0, 1e10, nan]."""
    dt.init(["cpu"] * 2)
    vals = SAT[:6]
    for into, want in (("uint8", [0, 0, 255, 255, 255, 0]),
                       ("int8", [-1, 0, 127, 127, 127, 0]),
                       ("int32", [-1, 0, 255, 256, 2147483647, 0])):
        b = dt.distributed_vector(6, dtype=into)
        dt.copy(dt.distributed_vector.from_array(vals), b)
        assert dt.to_numpy(b).tolist() == want, into


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("into,start", [("uint8", 1000.0), ("uint8", -3.0),
                                        ("int8", 1000.0), ("int8", -200.5),
                                        ("int32", 3e9), ("uint8", 7)])
def test_iota_into_integer_rows_saturates(P, into, start):
    _init_both(P)
    jv = dr_tpu.distributed_vector(6, dtype=into)
    tv = dt.distributed_vector(6, dtype=into)
    dr_tpu.iota(jv, start)
    dt.iota(tv, start)
    assert np.array_equal(dt.to_numpy(tv), dr_tpu.to_numpy(jv)), \
        (dt.to_numpy(tv), dr_tpu.to_numpy(jv))


def test_iota_saturation_values():
    dt.init(["cpu"] * 2)
    v = dt.distributed_vector(6, dtype="uint8")
    dt.iota(v, -3.0)
    assert dt.to_numpy(v).tolist() == [0, 0, 0, 0, 1, 2]
    dt.iota(v, 1000.0)
    assert dt.to_numpy(v).tolist() == [255] * 6


FILL_CASES = [(d, v) for d in ("uint8", "int8", "int32")
              for v in (-0.5, -1.5, 300.0, 255.5, 1e10, float("nan"),
                        float("inf"), -2, 300, 2 ** 31, 7, 7.9)]


@pytest.mark.parametrize("dtype,value", FILL_CASES)
def test_fill_refusals_and_values_match_reference(dtype, value):
    """A Python scalar ``fill`` into an integer container: refused where
    dr_tpu refuses (with its exception type, even on an empty window),
    else the same bits."""
    _init_both(4)
    jv = dr_tpu.distributed_vector(9, dtype=dtype)
    tv = dt.distributed_vector(9, dtype=dtype)
    for jr, tr in ((jv, tv), (jv[2:2], tv[2:2])):
        try:
            dr_tpu.fill(jr, value)
        except Exception as e:
            with pytest.raises(type(e)):
                dt.fill(tr, value)
            continue
        dt.fill(tr, value)
    assert np.array_equal(dt.to_numpy(tv), dr_tpu.to_numpy(jv))


def test_fill_fault_cases():
    dt.init(["cpu"] * 2)
    v = dt.distributed_vector(4, dtype="uint8")
    with pytest.raises(OverflowError):
        dt.fill(v, -2)
    with pytest.raises(OverflowError):
        dt.fill(v[1:1], -2)
    dt.fill(v, -0.5)
    assert dt.to_numpy(v).tolist() == [0, 0, 0, 0]
    from dr_tpu_torch.utils import resilience
    with pytest.raises(ValueError) as e:
        dt.fill(v, float("nan"))
    assert resilience.classify(e.value) is resilience.ProgramError
