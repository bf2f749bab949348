"""The port stands alone: no file of ``dr_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package or pandas, no C++ source of
its bridge names them, and ``init()`` never falls back to the CPU on its own.

The import check is static (the AST of every file): a runtime
``sys.modules`` check cannot work where an interpreter imports jax at
start-up."""

import ast
import pathlib
import re

import pytest
import torch

import dr_tpu_torch as dt

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "dr_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
#: the C++ bridge's sources (dr_tpu_torch/native)
NATIVE_FILES = sorted(p for ext in ("*.cpp", "*.hpp")
                      for p in (REPO / "dr_tpu_torch").rglob(ext))
#: what a bridge source may not name: JAX, jax.numpy, or a dr_tpu module
#: other than dr_tpu_torch
NATIVE_FORBIDDEN = re.compile(r"(?i:\bjax)|\bjnp\b|\bdr_tpu(?!_torch)\b")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "dr_tpu", "pandas")


def _walk(node, skip=()):
    """``ast.walk`` that does not enter the functions named in ``skip``
    (by prefix)."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.FunctionDef) and \
                child.name.startswith(tuple(skip)):
            continue
        yield from _walk(child, skip)


def _imports(path, skip=()):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in _walk(tree, skip):
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
            "export.py", "profiling.py", "faults.py", "spmd_guard.py",
            "sanitize.py", "pinning.py", "chip_smoke.py", "opt.py",
            "plansan.py", "interference.py", "tuning.py", "host.py"} <= names
    for rel in ("__init__.py", "__main__.py", "protocol.py", "queue.py",
                "arena.py", "resident.py", "journal.py", "client.py",
                "daemon.py", "router.py"):
        assert (REPO / "dr_tpu_torch" / "serve" / rel) in PORT_FILES, rel
    for rel in ("utils/faults.py", "utils/spmd_guard.py",
                "utils/sanitize.py", "core/pinning.py"):
        assert (REPO / "dr_tpu_torch" / rel) in PORT_FILES, rel
    assert (REPO / "dr_tpu_torch" / "obs" / "__init__.py") in PORT_FILES
    assert (REPO / "dr_tpu_torch" / "native" / "__init__.py") in PORT_FILES
    assert {p.name for p in NATIVE_FILES} == {
        "thp_bridge.hpp", "thp_bridge.cpp", "thp_expr.cpp",
        "bridge_demo.cpp", "bridge_parity.cpp"}


#: the names of ``dr_tpu.__all__`` the port does not have: ``mesh``, the
#: XLA mesh ("Not carried over" in ROADMAP.md).  ``init_distributed``,
#: the multi-process runtime, is the port's own (over
#: ``torch.distributed``).
REMAINDER = {"mesh"}


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


#: test files that are their own worker processes: only the functions
#: named ``_jax*`` (the parent's oracle) may import the JAX package
WORKER_FILES = [REPO / "tests" / "test_torch_multiprocess.py",
                REPO / "tests" / "test_torch_multiprocess_paths.py",
                REPO / "tests" / "test_torch_multiprocess_relational.py",
                REPO / "tests" / "test_torch_multiprocess_host.py"]


@pytest.mark.parametrize("path", WORKER_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_worker_files_import_no_jax(path):
    bad = [(line, mod) for line, mod in _imports(path, skip=("_jax",))
           if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)}'s worker imports {bad}"
    # and the rule sees the oracle's imports where they are
    assert any(_forbidden(mod) for _, mod in _imports(path))


@pytest.mark.parametrize("path", NATIVE_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_native_sources_name_no_jax_or_dr_tpu(path):
    text = path.read_text()
    bad = [(text.count("\n", 0, m.start()) + 1, m.group())
           for m in NATIVE_FORBIDDEN.finditer(text)]
    assert not bad, f"{path.relative_to(REPO)} names {bad}"
    if path.name == "bridge_parity.cpp":  # builds against either bridge
        assert "dr_tpu" not in text


def test_native_forbidden_rule_itself():
    for bad in ("import jax", "JAX x64", "jnp.where", "dr_tpu.utils",
                "PyImport_ImportModule(\"dr_tpu\")", "jaxlib"):
        assert NATIVE_FORBIDDEN.search(bad), bad
    for ok in ("dr_tpu_torch.utils.expr", "torch.where", "adjacent",
               "dr_tpu_torch"):
        assert not NATIVE_FORBIDDEN.search(ok), ok


def test_forbidden_rule_itself():
    assert _forbidden("jax.numpy") and _forbidden("dr_tpu.ops.kernels")
    assert _forbidden("dr_tpu") and not _forbidden("dr_tpu_torch.ops")
    assert not _forbidden("torch") and not _forbidden("numpy")
    assert _forbidden("pandas")


def test_init_without_devices_needs_cuda():
    """No arguments: the visible CUDA devices, or an error — never the
    CPU behind the caller's back.  The port's counterpart of
    ``tests/test_resilience.py::test_route_first_touch_decisions``: the
    port has no first-touch router to decide on the CPU."""
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


def test_no_degrade_route_in_the_port():
    """The JAX package's routes to the CPU or to a plain version are not
    carried over (ROADMAP.md, the no-fallback rule)."""
    from dr_tpu_torch.ops import kernels
    from dr_tpu_torch.utils import resilience
    for name in ("first_touch_or_cpu", "route_first_touch", "FirstTouch",
                 "relay_listening", "dead_relay", "degradation_story"):
        assert not hasattr(resilience, name), name
    for name in ("use_kernel", "NO_KERNEL", "Decision"):
        assert not hasattr(kernels, name), name
    # init_distributed joins the backend it is given (or torch's mapping
    # for its device) and nothing else: no second backend after a failure
    import inspect
    from dr_tpu_torch.parallel import collectives
    src = inspect.getsource(collectives.init_distributed)
    assert src.count("init_process_group(") == 1
    assert "except" not in src
    assert not (REPO / "dr_tpu_torch" / "utils" / "fallback.py").exists()
    # the serving daemon never leaves its requested route: no CPU-route
    # degrade, no re-promotion, no platform switch, no fallback warnings
    from dr_tpu_torch import serve
    for name in ("_degrade", "_promote_attempt", "_maybe_promote",
                 "_orig_platforms", "_grow_sup"):
        assert not hasattr(serve.Server, name), name
        assert not hasattr(serve.Server("/tmp/unused.sock"), name), name
    for path in sorted((REPO / "dr_tpu_torch" / "serve").glob("*.py")):
        text = path.read_text()
        for word in ("jax_platforms", "warn_fallback",
                     "first_touch_or_cpu", "route_first_touch"):
            assert word not in text, f"{path.name} mentions {word}"
