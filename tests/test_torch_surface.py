"""dr_tpu_torch's single-controller surface against dr_tpu on the CPU:
the rest of the views, ``distributed_span``, ``copy_async`` and
``transform_reduce_async``, the communicator and ``rma_window``,
``drlog``, the debug printers and the expression DSL.

The same numpy inputs, made from a seed, go through both packages.
Views, spans, collectives and integer results are data movement and
compare bit for bit (``np.array_equal``); float reductions state their
tolerance where they are made."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu import views as jviews
from dr_tpu.utils import expr as jexpr
from dr_tpu_torch import views as tviews
from dr_tpu_torch.utils import expr as texpr


def _init_both(P):
    dr_tpu.init(jax.devices()[:P])
    return dt.init(["cpu"] * P)


def _pair(n, seed, dtype=np.int32):
    src = (np.random.default_rng(seed).standard_normal(n) * 100).astype(dtype)
    return (dr_tpu.distributed_vector.from_array(src),
            dt.distributed_vector.from_array(src), src)


def _ranks(r, pkg):
    return [(pkg.rank(s), len(s)) for s in pkg.segments(r)]


# ------------------------------------------------------------------ views

def test_pipe_forms_match_reference(mesh_size):
    _init_both(mesh_size)
    j, t, src = _pair(24, 1)
    for jr, tr, want in (
            (j | jviews.take(20) | jviews.drop(5),
             t | tviews.take(20) | tviews.drop(5), src[5:20]),
            (j | jviews.slice_view((3, 9)), t | tviews.slice_view((3, 9)),
             src[3:9]),
            (jviews.slice_view(j, (2, 11)), tviews.slice_view(t, (2, 11)),
             src[2:11]),
            (jviews.counted(j, 7), tviews.counted(t, 7), src[:7])):
        np.testing.assert_array_equal(dt.to_numpy(tr), want)
        np.testing.assert_array_equal(dt.to_numpy(tr), dr_tpu.to_numpy(jr))
        assert _ranks(tr, dt) == _ranks(jr, dr_tpu)


def test_transform_pipe_matches_reference(mesh_size):
    _init_both(mesh_size)
    j, t, src = _pair(24, 2)
    jr = j | jviews.transform(lambda x: x + 100)
    tr = t | tviews.transform(lambda x: x + 100)
    np.testing.assert_array_equal(dt.to_numpy(tr), src + 100)
    np.testing.assert_array_equal(dt.to_numpy(tr), dr_tpu.to_numpy(jr))
    assert _ranks(tr, dt) == _ranks(jr, dr_tpu)
    with pytest.raises(TypeError):
        tviews.transform(lambda x: x, 0.5)  # the adaptor takes no scalars


def test_enumerate_matches_reference(mesh_size):
    _init_both(mesh_size)
    j, t, src = _pair(24, 3)
    for tr, jr in ((tviews.enumerate(t), jviews.enumerate(j)),
                   (t | tviews.enumerate(), j | jviews.enumerate()),
                   (tviews.enumerate_view(t[3:17]),
                    jviews.enumerate_view(j[3:17]))):
        assert list(tr) == list(jr)
        assert _ranks(tr, dt) == _ranks(jr, dr_tpu)
        for s in dt.segments(tr):
            idx, val = dt.local(s)
            assert idx.dtype == torch.int32
            np.testing.assert_array_equal(idx.numpy(),
                                          np.arange(s.parts[0].begin,
                                                    s.parts[0].end))
    assert list(tviews.enumerate(t))[:3] == [(0, src[0]), (1, src[1]),
                                            (2, src[2])]


def test_ranked_view_matches_reference(mesh_size):
    _init_both(mesh_size)
    j, t, _ = _pair(23, 4)
    for tr, jr in ((tviews.ranked_view(t), jviews.ranked_view(j)),
                   (tviews.ranked_view(t[2:19]), jviews.ranked_view(j[2:19]))):
        pairs = list(tr)
        assert pairs == list(jr)
        for s in dt.segments(tr):
            ranks, _ = dt.local(s)
            assert ranks.dtype == torch.int32
            assert ranks.device == t.runtime.devices[dt.rank(s)]
            assert (ranks == dt.rank(s)).all()
    if mesh_size > 1:  # a shifted zip is misaligned: no segments
        with pytest.raises(ValueError):
            tviews.ranked_view(tviews.zip_view(t[1:], t[:-1]))


def test_segment_ranges_match_reference(mesh_size):
    _init_both(mesh_size)
    j, t, src = _pair(24, 5)
    tsr, jsr = tviews.segment_ranges(t), jviews.segment_ranges(j)
    assert [(s.segment_id, s.segment_size, s.global_offset) for s in tsr] \
        == [(s.segment_id, s.segment_size, s.global_offset) for s in jsr]
    assert [int(x) for sr in tsr for x in sr] == list(range(24))
    assert all(sr.rank() == 0 for sr in tsr)
    assert t[tsr[0][1]] == src[1]
    sr = tviews.segment_range(3, 4, 100)
    assert [x.global_id for x in sr] == [100, 101, 102, 103]
    assert sr[2] == 102 and sr[2].segment == 3 and sr[2].local_id == 2
    assert sr[-1] == tviews.segment_id(3, 3, 103)
    with pytest.raises(IndexError):
        sr[4]


# ------------------------------------------------------------------- span

def test_distributed_span_matches_reference(mesh_size):
    _init_both(mesh_size)
    j, t, src = _pair(40, 6, np.float32)
    tsp, jsp = dt.distributed_span.of(t), dr_tpu.distributed_span.of(j)
    assert len(tsp) == len(jsp) == 40
    for f in (lambda s: s.subspan(7, 20), lambda s: s.subspan(7, 20).first(5),
              lambda s: s.subspan(7, 20).last(3), lambda s: s[11:33],
              lambda s: s.subspan(0, 0)):
        tr, jr = f(tsp), f(jsp)
        np.testing.assert_array_equal(tr.materialize(), jr.materialize())
        assert _ranks(tr, dt) == _ranks(jr, dr_tpu)
    np.testing.assert_array_equal(tsp.subspan(7, 20).to_array().numpy(),
                                  src[7:27])
    assert tsp[5] == src[5]


# ------------------------------------------------------------------ async

def test_async_forms_match_sync(mesh_size):
    _init_both(mesh_size)
    rng = np.random.default_rng(7)
    src = rng.standard_normal(33).astype(np.float32)
    a = dt.distributed_vector.from_array(src)
    b = dt.distributed_vector(33)
    c = dt.distributed_vector(33)
    ev = dt.copy_async(a, b)
    ev.wait()
    dt.copy(a, c)
    np.testing.assert_array_equal(np.concatenate([r.numpy() for r in b.rows]),
                                  np.concatenate([r.numpy() for r in c.rows]))
    w = dt.distributed_vector(20)
    dt.copy_async(a[5:25], w[0:20]).wait()  # a window as the destination
    np.testing.assert_array_equal(dt.to_numpy(w), src[5:25])
    host = np.zeros(33, np.float32)
    dt.copy_async(a, host).wait()
    np.testing.assert_array_equal(host, src)
    t = dt.transform_reduce_async(a, transform_op=lambda x: x * x)
    assert isinstance(t, torch.Tensor) and t.dim() == 0
    assert float(t) == dt.transform_reduce(a, transform_op=lambda x: x * x)
    ja = dr_tpu.distributed_vector.from_array(src)
    jt = dr_tpu.transform_reduce_async(ja, transform_op=lambda x: x * x)
    # f32 sums of 33 squares in two orders: a few ulps of the total
    assert float(t) == pytest.approx(float(jt), rel=1e-6)
    assert float(t) == pytest.approx(float((src * src).sum()), rel=1e-6)


# ----------------------------------------------------------- communicator

def test_communicator_topology(mesh_size):
    _init_both(mesh_size)
    tc, jc = dt.default_comm(), dr_tpu.default_comm()
    assert tc.size == jc.size == mesh_size
    for r in range(mesh_size):
        assert (tc.prev(r), tc.next(r)) == (jc.prev(r), jc.next(r))
    assert (tc.first(), tc.last()) == (jc.first(), jc.last())
    tc.barrier()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_collectives_match_reference(mesh_size, dtype):
    _init_both(mesh_size)
    P = mesh_size
    tc, jc = dt.default_comm(), dr_tpu.default_comm()
    rng = np.random.default_rng(8)
    v = (rng.standard_normal((P * 3, 2)) * 100).astype(dtype)
    ts, js = tc.scatter(v), jc.scatter(v)
    assert len(ts) == P and all(s.shape == (3, 2) for s in ts)
    np.testing.assert_array_equal(tc.gather(ts), jc.gather(js))
    np.testing.assert_array_equal(tc.allgather(ts), v)
    for periodic in (False, True):
        for name in ("shift_forward", "shift_backward"):
            got = tc.gather(getattr(tc, name)(ts, periodic=periodic))
            want = np.asarray(getattr(jc, name)(js, periodic=periodic))
            np.testing.assert_array_equal(got, want, err_msg=name)
    rep = tc.bcast(v[0])
    assert len(rep) == P and all(np.array_equal(r.numpy(), v[0]) for r in rep)
    np.testing.assert_array_equal(np.asarray(jc.bcast(v[0])), v[0])
    if P > 1:
        with pytest.raises(AssertionError):  # the reference's divisibility
            tc.scatter(np.zeros(P * 3 + 1))


def test_alltoall_matches_reference(mesh_size):
    _init_both(mesh_size)
    P = mesh_size
    tc, jc = dt.default_comm(), dr_tpu.default_comm()
    for k in (1, 2):
        mat = np.random.default_rng(9).integers(
            0, 1000, (P * k, P, 3)).astype(np.int32)
        got = tc.gather(tc.alltoall(tc.scatter(mat)))
        want = np.asarray(jc.alltoall(jc.scatter(mat)))
        np.testing.assert_array_equal(got, want)
    # one row a rank: block (i, j) lands on rank j (the transpose)
    mat = np.arange(P * P, dtype=np.float32).reshape(P, P, 1)
    out = tc.gather(tc.alltoall(tc.scatter(mat))).reshape(P, P)
    np.testing.assert_array_equal(out, mat.reshape(P, P).T)


def test_rma_window_matches_reference(mesh_size):
    _init_both(mesh_size)
    tv = dt.distributed_vector(32, dtype=np.float32)
    jv = dr_tpu.distributed_vector(32, dtype=np.float32)
    ix = np.array([1, 17, 31, -2])
    vals = np.random.default_rng(10).standard_normal(4).astype(np.float32)
    for win, v in ((dt.rma_window(tv), tv), (dr_tpu.rma_window(jv), jv)):
        win.put(ix, vals)
        win.fence()
        np.testing.assert_array_equal(np.asarray(win.get(ix)), vals)
        win.flush()
        win.flush(0)
    np.testing.assert_array_equal(dt.to_numpy(tv), dr_tpu.to_numpy(jv))


# --------------------------------------------------------- drlog, printers

def test_drlog_file_sink(tmp_path, monkeypatch):
    from dr_tpu_torch.utils.logging import Logger
    monkeypatch.delenv("DR_GPU_LOG", raising=False)
    log = Logger()
    assert not log.enabled()
    log.debug("never {}", 1)  # disabled: no sink, no output
    path = tmp_path / "dr.log"
    log.set_file(str(path))
    log.debug("hello {}", 42)
    log.debug("plain")
    log.close()
    text = path.read_text()
    assert "hello 42" in text and "plain" in text
    assert "test_torch_surface.py" in text
    monkeypatch.setenv("DR_GPU_LOG", "1")
    assert Logger().enabled()
    assert dt.drlog is dt.utils.logging.drlog


def test_debug_printers_match_reference(capsys):
    _init_both(4)
    src = np.arange(10, dtype=np.float32)
    t = dt.distributed_vector.from_array(src)
    j = dr_tpu.distributed_vector.from_array(src)
    text = dt.print_range(t, "v")
    out = capsys.readouterr().out
    assert "v:" in out and "rank=" in out and "device=cpu" in out
    assert text == dr_tpu.print_range(j, "v")
    capsys.readouterr()
    details = dt.range_details(t, "v")
    jdetails = dr_tpu.range_details(j, "v")
    strip = [line.split(" device=")[0] for line in details.splitlines()]
    assert strip == [line.split(" device=")[0]
                     for line in jdetails.splitlines()]
    assert len(details.splitlines()) == 1 + len(dt.segments(t))
    m = np.eye(4, dtype=np.float32)
    text = dt.print_matrix(dt.dense_matrix.from_array(m), "m")
    assert "shape=(4, 4)" in text
    assert text == dr_tpu.print_matrix(dr_tpu.dense_matrix.from_array(m), "m")
    zipped = dt.range_details(tviews.zip_view(t, t), "z")
    assert "device=cpu" in zipped


# -------------------------------------------------------------------- expr

EXPRS = [
    ("(x0 * 2.0 + 1.0)", 1), ("maximum(sqrt(abs(x0)), tanh(x1))", 2),
    ("(x0 * 1e-3 + 2.5e2)", 1), ("minimum(x0, 0.5) - power(x1, 2)", 2),
    ("exp(-abs(x0)) + log(abs(x1) + 1.0)", 2), ("(x0 % 3.0) / 2", 1),
    ("-x0 ** 2 + +x1", 2), ("maximum(x0, 0) * sqrt(4.0)", 1),
]


@pytest.mark.parametrize("expr,nargs", EXPRS)
def test_expr_matches_reference(expr, nargs):
    rng = np.random.default_rng(len(expr))
    args = [(rng.standard_normal(64) * 3).astype(np.float32)
            for _ in range(nargs)]
    got = texpr.op_from_expr(expr, nargs)(*map(torch.from_numpy, args))
    want = np.asarray(jexpr.op_from_expr(expr, nargs)(
        *map(jnp.asarray, args)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # the same f32 ops; transcendental functions differ by a few ulps
    # between the two libraries' implementations
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("expr,want_dtype", [
    ("(x0 * 2.5)", np.float32), ("(x0 / 2)", np.float32),
    ("(x0 * 3 + 1)", np.int32), ("(x0 % 3)", np.int32),
    ("power(x0, 2)", np.int32), ("minimum(x0, 0.5)", np.float32),
    ("sqrt(abs(x0))", np.float32), ("(x0 ** 0.5)", np.float32)])
def test_expr_int_float_promotion(expr, want_dtype):
    """Mixed int/float promotion: int32 inputs give the JAX package's
    result dtype, and its values (integer and exactly rounded float ops
    bit for bit; sqrt and fractional powers within 1 ulp)."""
    x = np.arange(-7, 9, dtype=np.int32)
    got = texpr.op_from_expr(expr, 1)(torch.from_numpy(x)).numpy()
    want = np.asarray(jexpr.op_from_expr(expr, 1)(jnp.asarray(x)))
    assert got.dtype == want.dtype == want_dtype
    if "sqrt" in expr or "0.5)" in expr and "**" in expr:
        np.testing.assert_allclose(got, want, rtol=1.2e-7, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def test_expr_identity_caching_and_validation():
    assert texpr.op_from_expr("(x0 + x1)", 2) is \
        texpr.op_from_expr("(x0 + x1)", 2)
    assert texpr.op_from_expr("(x0 + x1)", 2) is not \
        texpr.op_from_expr("(x0 - x1)", 2)
    for bad in ("__import__('os')", "open('x')", "x9", "foo(x0)",
                "x0.__class__", "lambda: 1", "x0; x0", "x0, x1",
                "abs(x0, x1)", "minimum(x0)", "sqrt()", "power(x0)",
                "maximum(x0, x1, x0)", "x0 // 2", "x0 < 1"):
        with pytest.raises(ValueError):
            texpr.op_from_expr(bad, 2)
        with pytest.raises(ValueError):
            jexpr.op_from_expr(bad, 2)
    for bad_n in (0, 9):
        with pytest.raises(ValueError):
            texpr.op_from_expr("x0", bad_n)
    assert set(texpr.FUNCTIONS) == set(jexpr.FUNCTIONS)


def test_op_from_source_escape_hatch():
    src = "lambda x0: torch.where(x0 > 0, x0, 0.01 * x0)"
    fn = texpr.op_from_source(src, 1)
    assert fn is texpr.op_from_source(src, 1)
    x = np.asarray([-2.0, 3.0], np.float32)
    want = np.asarray(jexpr.op_from_source(
        "lambda x0: jnp.where(x0 > 0, x0, 0.01 * x0)", 1)(x))
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), want)
    with pytest.raises(ValueError):
        texpr.op_from_source("lambda x0, x1: x0 + x1", 1)
    with pytest.raises(TypeError):
        texpr.op_from_source("42", 1)
    f2 = texpr.op_from_source(
        "lambda x0, alpha=0.5: torch.where(x0 > 0, x0, alpha * x0)", 1)
    assert float(f2(torch.tensor([-2.0]))) == -1.0
    f3 = texpr.op_from_source("lambda *xs: xs[0] + xs[1]", 2)
    assert float(f3(torch.tensor(1.0), torch.tensor(2.0))) == 3.0
    assert float(texpr.op_from_source("torch.abs", 1)(
        torch.tensor(-3.0))) == 3.0
    assert texpr.op_from_source("np.abs", 1)(-3.0) == 3.0


def test_expr_drives_algorithms(mesh_size):
    """An expression op through ``transform`` on both packages: the same
    f32 multiply-add a cell, bit for bit."""
    _init_both(mesh_size)
    src = np.random.default_rng(11).standard_normal(50).astype(np.float32)
    t = dt.distributed_vector.from_array(src)
    j = dr_tpu.distributed_vector.from_array(src)
    to, jo = dt.distributed_vector(50), dr_tpu.distributed_vector(50)
    dt.transform(t, to, texpr.op_from_expr("(x0 * 2.0 + 1.0)", 1))
    dr_tpu.transform(j, jo, jexpr.op_from_expr("(x0 * 2.0 + 1.0)", 1))
    np.testing.assert_array_equal(dt.to_numpy(to), dr_tpu.to_numpy(jo))
    dt.transform(t, to, texpr.op_from_source(
        "lambda x0: torch.clip(x0, 0.0, 0.5)", 1))
    np.testing.assert_array_equal(dt.to_numpy(to), np.clip(src, 0.0, 0.5))
