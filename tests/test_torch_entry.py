"""dr_tpu_torch's main-path entry points against ``__graft_entry__`` on
the CPU: ``entry()``'s step and masked sum against the JAX entry jitted
on the CPU (rows within 1e-6 relative, the sum within 1e-5 relative:
one f32 5-point step, and f32 sums of 2^16 cells in two orders), and
``dryrun`` over 8 and 3 CPU ranks running every section to its end."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dr_tpu_torch import entry as port_entry


def test_entry_matches_reference():
    jfn, jargs = graft.entry()
    tfn, targs = port_entry.entry(device="cpu")
    assert [tuple(r.shape) for r in targs[0]] == [tuple(jargs[0].shape)]
    rng = np.random.default_rng(3)
    width = jargs[0].shape[1]
    rand = (rng.standard_normal((1, width)).astype(np.float32),
            rng.standard_normal((1, width)).astype(np.float32))
    step = jax.jit(jfn)
    for ja, ta in ((jargs, targs),
                   (rand, ([torch.from_numpy(rand[0])],
                           [torch.from_numpy(rand[1])]))):
        jout, jsum = step(*ja)
        tout, tsum = tfn(*ta)
        jout = np.asarray(jout)
        np.testing.assert_allclose(tout[0].numpy(), jout, rtol=1e-6,
                                   atol=1e-6 * np.abs(jout).max())
        assert float(tsum) == pytest.approx(float(jsum), rel=1e-5,
                                            abs=1e-5 * np.abs(jout).sum())
    # the input rows stay as they were (the step works on copies)
    np.testing.assert_array_equal(targs[0][0].numpy(), np.asarray(jargs[0]))


@pytest.mark.parametrize("ranks", [8, 3])
def test_dryrun_runs_every_section(ranks):
    port_entry.dryrun(ranks, ["cpu"] * ranks)


def test_entry_points_default_to_the_card():
    """No device named: the CUDA devices, or an error, never the CPU."""
    if torch.cuda.is_available():
        fn, args = port_entry.entry()
        assert args[0][0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun(2)
