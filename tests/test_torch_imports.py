"""The port stands alone: no file of ``dr_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package or pandas, and ``init()`` never
falls back to the CPU on its own.

The import check is static (the AST of every file): a runtime
``sys.modules`` check cannot work where an interpreter imports jax at
start-up."""

import ast
import pathlib

import pytest
import torch

import dr_tpu_torch as dt

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "dr_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "dr_tpu", "pandas")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"runtime.py", "halo.py", "stencil_matmul.py", "scan_pallas.py",
            "dense_matrix.py", "stencil2d.py", "stencil2d_pallas.py",
            "mdarray.py", "sort.py", "sort_pallas.py", "segred_pallas.py",
            "order_keys.py", "pipeline.py", "flash_attention.py",
            "ring_attention.py", "relational.py", "hist_pallas.py",
            "resilience.py", "sparse_matrix.py", "gemv.py", "entry.py",
            "distributed_span.py", "unstructured_halo.py",
            "redistribute.py", "checkpoint.py", "elastic.py", "expr.py",
            "logging.py", "debug.py", "env.py", "recorder.py", "metrics.py",
            "export.py", "profiling.py", "chip_smoke.py"} <= names
    assert (REPO / "dr_tpu_torch" / "obs" / "__init__.py") in PORT_FILES


#: the names of ``dr_tpu.__all__`` the port does not have yet: the
#: host-side layers of ROADMAP.md queue 1 item 3 (plans, faults,
#: spmd_guard, tuning, elastic) and the multi-host and mesh names of
#: item 4.  Later slices shrink it.
REMAINDER = {"DeferredCount", "Plan", "PlanScalar", "deferred", "plan",
             "faults", "spmd_guard", "tuning", "elastic",
             "init_distributed", "mesh"}


def test_public_surface_remainder():
    import dr_tpu
    assert set(dr_tpu.__all__) - set(dt.__all__) == REMAINDER
    for name in dt.__all__:
        assert hasattr(dt, name), name


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_dr_tpu_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_rule_itself():
    assert _forbidden("jax.numpy") and _forbidden("dr_tpu.ops.kernels")
    assert _forbidden("dr_tpu") and not _forbidden("dr_tpu_torch.ops")
    assert not _forbidden("torch") and not _forbidden("numpy")
    assert _forbidden("pandas")


def test_init_without_devices_needs_cuda():
    """No arguments: the visible CUDA devices, or an error — never the
    CPU behind the caller's back."""
    if torch.cuda.is_available():
        rt = dt.init()
        assert all(d.type == "cuda" for d in rt.devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dt.init()
        with pytest.raises(RuntimeError):
            dt.get_duplicated_devices(2)
    assert dt.init(["cpu"]).devices == [torch.device("cpu")]


def test_cuda_tensor_takes_kernel_or_raises():
    """The routing rule: CPU tensors take the plain version, a mix of
    devices is refused (a CUDA tensor would launch the kernel)."""
    from dr_tpu_torch.ops import kernels
    assert kernels.on_cuda(torch.zeros(2)) is False
    meta = torch.zeros(2, device="meta")
    with pytest.raises(ValueError):
        kernels.on_cuda(torch.zeros(2), meta)
