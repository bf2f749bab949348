"""dr_tpu_torch's ring attention and K9's plain version against dr_tpu on
the CPU, with the same numpy-seeded inputs; every case of
``tests/test_ring_attention.py`` has a counterpart here.

Tolerances:
- the f32 blockwise route against ``dr_tpu.ring_attention``: rtol 2e-4,
  atol 2e-5, the reference's own chunked-vs-unchunked bound (two f32
  matmul orders);
- the flash route (``flash_update``, the flash ring) against the Pallas
  kernel in interpret mode: m within 1e-6 (relative, and absolute near
  0: the same max of logits summed in another order), l within 1e-5
  relative, the normalized output within rtol = atol = 2e-3 (a bf16
  rounding of ``p`` may flip between the two sum orders); a bf16 output
  adds one bf16 ulp of the value (rtol 2^-7);
- against the float64 dense oracle: the reference's bounds (2e-3 for
  f32 inputs, rtol 5e-2 / atol 5e-3 for the bf16 flash math)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import dr_tpu
import dr_tpu_torch as dt
from dr_tpu.ops import flash_attention as jfa
from dr_tpu.ops import ring_attention as jra
from dr_tpu_torch.ops import flash_attention as tfa
from dr_tpu_torch.ops import ring_attention as tra

F32_TOL = dict(rtol=2e-4, atol=2e-5)
FLASH_TOL = dict(rtol=2e-3, atol=2e-3)
FLASH_BF16_TOL = dict(rtol=2e-3 + 2.0 ** -7, atol=2e-3)
ORACLE_BF16_TOL = dict(rtol=5e-2, atol=5e-3)


@pytest.fixture
def P():
    """The reference's 8-device mesh (conftest) and 8 CPU ranks."""
    n = dr_tpu.nprocs()
    dt.init(["cpu"] * n)
    yield n
    dt.final()


def _dense_attention(q, k, v, causal=False):
    B, S, h, d = q.shape
    logits = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64)
    logits /= np.sqrt(d)
    if causal:
        mask = np.tril(np.ones((S, S), bool))
        logits = np.where(mask[None, None], logits, -np.inf)
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bhqd", p, v)
    return np.einsum("bhqd->bqhd", out)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_values(x):
    """f32 data rounded to bf16 (the flash route's inputs), as f64."""
    return torch.from_numpy(x).bfloat16().double().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ------------------------------------------------------ the f32 route

@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense(P, causal):
    rng = np.random.default_rng(0)
    B, S, h, d = 2, 8 * P, 2, 16
    q, k, v = (_randn(rng, B, S, h, d) for _ in range(3))
    got = dt.ring_attention(q, k, v, causal=causal)
    assert got.shape == (B, S, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _dense_attention(q, k, v, causal),
                               rtol=2e-3, atol=2e-3)
    _close(got, dr_tpu.ring_attention(q, k, v, causal=causal), F32_TOL)


def test_ring_attention_long_sequence_constant_local_memory(P):
    rng = np.random.default_rng(1)
    B, S, h, d = 1, 32 * P, 1, 8
    q = _randn(rng, B, S, h, d)
    got = dt.ring_attention(q, q, q, causal=True)
    np.testing.assert_allclose(_np(got), _dense_attention(q, q, q, True),
                               rtol=2e-3, atol=2e-3)
    _close(got, dr_tpu.ring_attention(q, q, q, causal=True), F32_TOL)


@pytest.mark.parametrize("causal,B,per,h,d,chunk,seed", [
    (True, 2, 8, 2, 16, 4, 9),       # the reference's chunked causal case
    (False, 1, 16, 2, 8, 8, 10),     # and its non-causal one
    (True, 1, 24, 2, 8, 5, 12),      # divisor walk: 5 -> 4
])
def test_ring_attention_q_chunked_matches_unchunked(P, causal, B, per, h, d,
                                                    chunk, seed):
    rng = np.random.default_rng(seed)
    S = per * P
    q, k, v = (_randn(rng, B, S, h, d) for _ in range(3))
    full = dt.ring_attention(q, k, v, causal=causal)
    chunked = dt.ring_attention(q, k, v, causal=causal, q_chunk=chunk)
    _close(chunked, full, F32_TOL)
    _close(chunked, dr_tpu.ring_attention(q, k, v, causal=causal,
                                          q_chunk=chunk), F32_TOL)


def test_pick_q_chunk_matches_reference():
    for s in (192, 384, 8192, 131072):
        for budget in (1, 2 ** 20, 512 * 2 ** 20):
            qc = tra._pick_q_chunk(B=8, s=s, h=32, budget_bytes=budget)
            assert qc == jra._pick_q_chunk(B=8, s=s, h=32,
                                           budget_bytes=budget)
            assert 128 <= qc <= s


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_ring_attention_matches_repeated_kv(P, causal):
    rng = np.random.default_rng(13)
    B, S, h, hkv, d = 1, 8 * P, 4, 2, 16
    q = _randn(rng, B, S, h, d)
    k, v = _randn(rng, B, S, hkv, d), _randn(rng, B, S, hkv, d)
    got = dt.ring_attention(q, k, v, causal=causal)
    kr, vr = (np.repeat(x, h // hkv, axis=2) for x in (k, v))
    np.testing.assert_allclose(_np(got), _dense_attention(q, kr, vr, causal),
                               rtol=2e-3, atol=2e-3)
    _close(got, dr_tpu.ring_attention(q, k, v, causal=causal), F32_TOL)


def test_ring_attention_n_matches_reference(P):
    rng = np.random.default_rng(15)
    B, S, h, d = 1, 8 * P, 2, 16
    q, k, v = (_randn(rng, B, S, h, d) for _ in range(3))
    for iters in (0, 1, 3):
        got = dt.ring_attention_n(q, k, v, iters, causal=True)
        _close(got, dr_tpu.ring_attention_n(q, k, v, iters, causal=True),
               F32_TOL)
    once = dt.ring_attention(q, k, v, causal=True)
    twice = dt.ring_attention(q, k, once, causal=True)
    assert torch.equal(dt.ring_attention_n(q, k, v, 2, causal=True), twice)


def test_ring_self_attention_matches_reference(P):
    rng = np.random.default_rng(16)
    B, S, h, d = 1, 8 * P, 2, 8
    e = h * d
    x = _randn(rng, B, S, e)
    wq, wk, wv = (_randn(rng, e, h, d) / np.float32(np.sqrt(e))
                  for _ in range(3))
    got = tra.ring_self_attention(x, wq, wk, wv, causal=True)
    _close(got, jra.ring_self_attention(x, wq, wk, wv, causal=True),
           F32_TOL)


def test_refuses_what_the_reference_refuses(P):
    """Both packages assert on S % P, h % hkv and, for the chained form,
    hkv != h."""
    rng = np.random.default_rng(17)
    odd = _randn(rng, 1, 8 * P + 1, 2, 8)
    q3 = _randn(rng, 1, 8 * P, 3, 8)
    q4 = _randn(rng, 1, 8 * P, 4, 8)
    kv = _randn(rng, 1, 8 * P, 2, 8)
    for mod in (dt, dr_tpu):
        with pytest.raises(AssertionError):
            mod.ring_attention(odd, odd, odd)
        with pytest.raises(AssertionError):
            mod.ring_attention(q3, kv, kv)
        with pytest.raises(AssertionError):
            mod.ring_attention_n(q4, kv, kv, 1)


@pytest.mark.parametrize("route", ["f32", "bf16"])
def test_ring_attention_schedules_bitwise(P, route, monkeypatch):
    """serial and pipelined run the same dataflow: the same bits, by
    argument and by DR_GPU_RING_SCHEDULE (tests/test_pipeline.py:190)."""
    rng = np.random.default_rng(7)
    if route == "f32":
        B, S, h, d = 1, 8 * P, 2, 8
        q, k, v = (torch.from_numpy(_randn(rng, B, S, h, d))
                   for _ in range(3))
    else:
        B, S, h, d = 1, 128 * P, 2, 128
        q, k, v = (torch.from_numpy(_randn(rng, B, S, h, d)).bfloat16()
                   for _ in range(3))
    outs = {s: dt.ring_attention(q, k, v, causal=True, schedule=s)
            for s in ("serial", "pipelined")}
    assert torch.equal(outs["serial"], outs["pipelined"])
    monkeypatch.setenv("DR_GPU_RING_SCHEDULE", "serial")
    assert torch.equal(dt.ring_attention(q, k, v, causal=True),
                       outs["serial"])


# ------------------------------------------------- K9's plain version

def _jax_state(BH, s, d):
    return (jnp.full((BH, s, 1), -jnp.inf, jnp.float32),
            jnp.zeros((BH, s, 1), jnp.float32),
            jnp.zeros((BH, s, d), jnp.float32))


def _torch_state(jstate):
    # JAX's carries in the port's layout: no conversion
    return tuple(torch.from_numpy(np.array(x)) for x in jstate)


def _normalized(state):
    m, l, acc = (_np(x) if not isinstance(x, np.ndarray) else x
                 for x in state)
    return acc / np.where(l > 0, l, 1.0)


def _check_state(got, want):
    gm, gl = _np(got[0]), _np(got[1])
    wm, wl = _np(want[0]), _np(want[1])
    np.testing.assert_array_equal(np.isneginf(gm), np.isneginf(wm))
    fin = np.isfinite(wm)
    np.testing.assert_allclose(gm[fin], wm[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=0)
    np.testing.assert_allclose(_normalized(got), _normalized(want),
                               **FLASH_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offs", [(0, 0), (256, 512), (512, 256),
                                  (256, 256)])
@pytest.mark.parametrize("group", [1, 2])
def test_plain_flash_update_matches_pallas_interpret(causal, offs, group):
    """One update from zero state; (256, 512) causal is a wholly future
    block (no row attends: m stays -inf, l and acc 0)."""
    rng = np.random.default_rng(30 + group)
    BH, s, d = 4, 256, 128
    q = _randn(rng, BH, s, d)
    k, v = _randn(rng, BH // group, s, d), _randn(rng, BH // group, s, d)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jstate = _jax_state(BH, s, d)
    want = jfa.flash_update(qb, kb, vb, *jstate, *offs, causal=causal,
                            bq=64, bk=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tfa.flash_update(tq, tk, tv, *_torch_state(jstate), *offs,
                           causal=causal)
    _check_state(got, want)
    if causal and offs == (256, 512):
        assert np.isneginf(_np(got[0])).all()
        assert not _np(got[1]).any() and not _np(got[2]).any()


@pytest.mark.parametrize("d", [256, 768])
def test_plain_flash_update_wide_heads_match_pallas_interpret(d):
    """Head dims past one 128-column chunk (the kernel stages Q and K a
    chunk at a time; the reference takes any d % 128 == 0)."""
    rng = np.random.default_rng(d)
    BH, s = 2, 128
    q, k, v = (_randn(rng, BH, s, d) for _ in range(3))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jstate = _jax_state(BH, s, d)
    want = jfa.flash_update(qb, kb, vb, *jstate, 0, 0, causal=True,
                            bq=64, bk=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    _check_state(tfa.flash_update(tq, tk, tv, *_torch_state(jstate), 0, 0,
                                  causal=True), want)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_math_matches_dense(causal):
    """Two chained updates against the two halves emulate two ring
    steps: the plain version against the dense oracle and against the
    chained Pallas kernel in interpret mode."""
    rng = np.random.default_rng(4)
    BH, s, d = 2, 256, 128
    q, k, v = (_randn(rng, BH, s, d) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    half = s // 2
    jstate = _jax_state(BH, s, d)
    state = _torch_state(jstate)
    for lo in (0, half):
        state = tfa.flash_update(tq, tk[:, lo:lo + half], tv[:, lo:lo + half],
                                 *state, 0, lo, causal=causal)
        jstate = jfa.flash_update(qb, kb[:, lo:lo + half],
                                  vb[:, lo:lo + half], *jstate, 0, lo,
                                  causal=causal, bq=128, bk=half,
                                  interpret=True)
    _check_state(state, jstate)
    qf, kf, vf = (_bf16_values(x) for x in (q, k, v))
    logits = np.einsum("bqd,bkd->bqk", qf, kf) / np.sqrt(d)
    if causal:
        logits = np.where(np.tril(np.ones((s, s), bool))[None], logits,
                          -np.inf)
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(_normalized(state),
                               np.einsum("bqk,bkd->bqd", p, vf),
                               **ORACLE_BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_one_streaming_kernel_matches_both_pallas_variants(causal,
                                                           monkeypatch):
    """The port's one K-tile loop is the counterpart of the resident and
    the streaming TPU kernels: it matches both, at zero and at ring
    offsets, and its 128-key tiles (the kernel's at d = 128) match 64-key
    ones."""
    rng = np.random.default_rng(21)
    BH, s, d = 4, 256, 128
    q, k, v = (_randn(rng, BH, s, d) for _ in range(3))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    jstate = _jax_state(BH, s, d)
    for offs in ((0, 0), (s, 2 * s), (2 * s, s)):
        got = tfa.flash_update(tq, tk, tv, *_torch_state(jstate), *offs,
                               causal=causal)
        for stream in ("0", "1"):
            monkeypatch.setenv("DR_TPU_FLASH_STREAM", stream)
            want = jfa.flash_update(qb, kb, vb, *jstate, *offs,
                                    causal=causal, bq=64, bk=128,
                                    interpret=True)
            _check_state(got, want)
        wide = tfa.plain_flash_update(tq, tk, tv, *_torch_state(jstate),
                                      *offs, causal=causal, block_k=64)
        _check_state(got, wide)


def test_flash_update_refuses_bad_operands():
    BH, s, d = 2, 128, 128
    q = torch.zeros((BH, s, d), dtype=torch.bfloat16)
    m, l = torch.zeros((BH, s, 1)), torch.zeros((BH, s, 1))
    acc = torch.zeros((BH, s, d))
    for bad in (dict(q=q.float()), dict(k=q[:, :, :64]),
                dict(k=torch.zeros((3, s, d), dtype=torch.bfloat16)),
                dict(m=m.double()), dict(acc=acc[:, :64])):
        args = dict(q=q, k=q, v=q, m=m, l=l, acc=acc)
        args.update(bad)
        if "k" in bad:
            args["v"] = bad["k"]
        with pytest.raises(ValueError):
            tfa.flash_update(*args.values(), 0, 0, causal=True)


def test_kernel_shape_gate():
    """The shape rule pick_blocks keeps for the kernel path, without the
    TPU's VMEM caps (one kernel streams any length)."""
    assert tfa.kernel_shape_ok(128, 8192)
    assert jfa.pick_blocks(8192, 8192, 128) is not None
    for d, skv in ((100, 8192), (128, 100), (128, 192)):
        assert not tfa.kernel_shape_ok(d, skv)
        assert jfa.pick_blocks(skv, skv, d) is None
    assert tfa.kernel_shape_ok(128, 1 << 20)
    for d in (256, 640, 768, 1024):      # no cap on d: Q/K go by chunks
        assert tfa.kernel_shape_ok(d, 384)
        assert jfa.pick_blocks(384, 384, d) is not None
        assert tra._flash_viable((1, 384, 2, d), torch.bfloat16)
    assert tra._flash_viable((1, 128, 2, 128), torch.bfloat16)
    assert not tra._flash_viable((1, 128, 2, 128), torch.float32)
    assert not tra._flash_viable((1, 96, 2, 128), torch.bfloat16)
    assert not tra._flash_viable((1, 128, 2, 64), torch.bfloat16)


def test_causal_computed_flops_matches_reference():
    for case in [(8192, 8192, 128, 2048, 1024, 0, 0),
                 (8192, 8192, 128, 1024, 2048, 0, 0),
                 (1024, 2048, 128, 256, 128, 2048, 0),
                 (1024, 2048, 128, 256, 128, 0, 2048),
                 (512, 512, 128, 512, 512, 0, 0),
                 (32768, 32768, 128, 64, 64, 0, 0)]:
        assert tfa.causal_computed_flops(*case) == \
            jfa.causal_computed_flops(*case)


# ------------------------------------------------------ the flash ring

def _jax_flash_ring(q, k, v, P, s, causal, hkv, monkeypatch, stream):
    rt = dr_tpu.parallel.runtime.runtime()
    monkeypatch.setenv("DR_TPU_FLASH_STREAM", stream)
    B, _, h, d = q.shape
    prog = jra._build_flash(rt.mesh, rt.axis, P, (B, s, h, d), causal,
                            jnp.dtype(jnp.float32), interpret=True, hkv=hkv)
    sh = NamedSharding(rt.mesh, PartitionSpec(None, rt.axis))
    return np.asarray(prog(*(jax.device_put(x, sh) for x in (q, k, v))))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,h,stream", [(128, 2, "0"), (128, 4, "0"),
                                        (256, 2, "1")])
def test_flash_ring_matches_pallas_interpret(P, causal, s, h, stream,
                                             monkeypatch):
    """The whole flash ring over 8 ranks (per-step update, K/V rotation,
    the (m, l, acc) carries, global offsets; hkv = 2, so h = 4 is GQA)
    against the JAX flash ring with its kernel interpreted (resident at
    s = 128, streaming at 256; 256 x 4 heads would double this file's
    time); and the public bf16 route."""
    rng = np.random.default_rng(11 + s + h)
    B, d, hkv = 1, 128, 2
    S = P * s
    q = _randn(rng, B, S, h, d)
    k, v = _randn(rng, B, S, hkv, d), _randn(rng, B, S, hkv, d)
    want = _jax_flash_ring(q, k, v, P, s, causal, hkv, monkeypatch, stream)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    devs = dt.devices()
    parts = [tra._shard(x, devs, s) for x in (tq, tk, tv)]
    got = torch.cat(tra._flash_ring(*parts, devs, (B, s, h, d), causal,
                                    torch.float32, hkv=hkv), dim=1)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)
    kr, vr = (np.repeat(_bf16_values(x), h // hkv, axis=2) for x in (k, v))
    np.testing.assert_allclose(
        got.numpy(), _dense_attention(_bf16_values(q), kr, vr, causal),
        **ORACLE_BF16_TOL)
    pub = dt.ring_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                            causal=causal)
    assert pub.dtype == torch.bfloat16 and pub.shape == (B, S, h, d)
    np.testing.assert_allclose(_np(pub), want, **FLASH_BF16_TOL)


def test_flash_ring_n_chains_the_output(P):
    """ring_attention_n on the flash route: v := attn(q, k, v) in bf16,
    equal to chained ring_attention calls."""
    rng = np.random.default_rng(18)
    B, S, h, d = 1, 128 * P, 2, 128
    q, k, v = (torch.from_numpy(_randn(rng, B, S, h, d)).bfloat16()
               for _ in range(3))
    once = dt.ring_attention(q, k, v, causal=True)
    twice = dt.ring_attention(q, k, once, causal=True)
    assert torch.equal(dt.ring_attention_n(q, k, v, 2, causal=True), twice)
