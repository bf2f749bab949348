"""Expression-DSL compiler (counterpart of ``dr_tpu/utils/expr.py``).

The reference's algorithms take arbitrary C++ callables (the stencil
lambda at ``examples/mhp/stencil-1d.cpp:16-19``, the ``transform_reduce``
multiply at ``examples/shp/dot_product.cpp:11-18``).  The native API ships
an arithmetic expression DSL in their place: the C++ side
(``native/bridge/thp_bridge.hpp`` ``thp::expr``) serializes an expression
tree over placeholders ``x0..x7`` to a canonical string, and this module
compiles that string once into a callable over tensors.  The validator is
the JAX package's, unchanged: its grammar is the bridge's contract.

Compiled ops are cached by (string, nargs), so equal expressions give the
same function object.

The grammar is validated before ``eval``: only whitelisted function
names, placeholders, numeric literals and arithmetic punctuation may
appear, so a malformed or adversarial string raises instead of reaching
the interpreter with any usable namespace.

Type promotion is torch's, which agrees with ``jnp``'s where the DSL can
reach it: a Python scalar never widens a tensor of its own kind, and a
float scalar turns an integer tensor into float32 (``x0 * 2.5`` on int32
gives float32, as in the JAX package).  The DSL's functions take Python
scalars as well as tensors, as ``jnp``'s do: a scalar argument becomes a
0-dim tensor, which promotes as a scalar does.
"""

from __future__ import annotations

import ast
import functools
import re

import torch

__all__ = ["op_from_expr", "op_from_source", "FUNCTIONS"]


def _scalars_as_tensors(fn):
    """``fn`` over tensors, with Python-scalar arguments made 0-dim
    tensors on the device of the first tensor argument."""
    @functools.wraps(fn)
    def call(*args):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        return fn(*(a if isinstance(a, torch.Tensor)
                    else torch.as_tensor(a, device=dev) for a in args))
    return call


# the callable surface the C++ DSL can name (thp::sqrt & co.)
FUNCTIONS = {name: _scalars_as_tensors(fn) for name, fn in (
    ("sqrt", torch.sqrt),
    ("exp", torch.exp),
    ("log", torch.log),
    ("tanh", torch.tanh),
    ("abs", torch.abs),
    ("minimum", torch.minimum),
    ("maximum", torch.maximum),
    ("power", torch.pow),
)}

_MAX_ARGS = 8
# validator-side arity for each whitelisted function (the structural
# AST gate rejects wrong-arity calls at the trust boundary)
_ARITY = {"sqrt": 1, "exp": 1, "log": 1, "tanh": 1, "abs": 1,
          "minimum": 2, "maximum": 2, "power": 2}
assert set(_ARITY) == set(FUNCTIONS), "every DSL function needs an arity"
_NAME = re.compile(r"[A-Za-z_][A-Za-z_0-9]*")
# everything a serialized expression may contain besides names:
# numbers (incl. scientific notation), arithmetic, parens, commas
_PUNCT = re.compile(r"^[\d\s\.\+\-\*/%\(\),eE]*$")


def _validate(expr: str, nargs: int) -> None:
    names = set(_NAME.findall(expr))
    allowed = set(FUNCTIONS) | {f"x{i}" for i in range(nargs)}
    # exponent suffixes of numeric literals ("1e-3", "2.5e2") tokenize
    # as the pseudo-names "e"/"e2" since the literal's digits precede
    # them; they can never resolve to anything (globals carry no such
    # names), so they are grammar, not identifiers
    bad = sorted(n for n in names if n not in allowed
                 and not re.fullmatch(r"[eE]\d*", n))
    if bad:
        raise ValueError(f"expr names outside the DSL surface: {bad} "
                         f"(allowed: x0..x{nargs - 1} + {sorted(FUNCTIONS)})")
    rest = _NAME.sub("", expr)
    if not _PUNCT.match(rest):
        raise ValueError(f"expr contains non-DSL characters: {expr!r}")
    if "__" in expr:
        raise ValueError("double underscore is not part of the DSL")
    # structural gate (round-5 fuzz finding: the character classes
    # alone admit "x0, x1" — a TUPLE — and similar shapes): the string
    # must parse as ONE scalar expression whose AST contains only DSL
    # nodes.  Commas are legal solely as whitelisted-call argument
    # separators, which this walk enforces for free.
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError:
        raise ValueError(f"expr does not parse as one expression: "
                         f"{expr!r}") from None
    for node in ast.walk(tree):
        if isinstance(node, (ast.Expression, ast.operator, ast.unaryop,
                             ast.expr_context)):
            continue
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div,
                          ast.Mod, ast.Pow)):
            continue
        if isinstance(node, ast.UnaryOp) and isinstance(
                node.op, (ast.UAdd, ast.USub)):
            continue
        if isinstance(node, ast.Call):
            if (not isinstance(node.func, ast.Name)
                    or node.func.id not in FUNCTIONS or node.keywords):
                raise ValueError(
                    f"expr call outside the DSL surface: {expr!r}")
            want = _ARITY[node.func.id]
            if len(node.args) != want:
                # arity belongs to the validator: a wrong-arity call
                # must fail HERE with ValueError, not as a TypeError
                # when the op first runs inside a jitted algorithm
                raise ValueError(
                    f"{node.func.id} takes {want} argument(s), got "
                    f"{len(node.args)} in {expr!r}")
            continue
        if isinstance(node, ast.Name):  # membership checked above
            continue
        if isinstance(node, ast.Constant) and isinstance(
                node.value, (int, float)):
            continue
        raise ValueError(f"expr node outside the DSL: "
                         f"{type(node).__name__} in {expr!r}")


@functools.lru_cache(maxsize=512)
def op_from_source(src: str, nargs: int):
    """Compile arbitrary Python source over tensors into an op: the
    native bridge's escape hatch for ops the arithmetic DSL cannot
    express (conditionals with ``torch.where``, comparisons, clipping,
    casts).  ``src`` must evaluate to a callable of ``nargs`` positional
    arguments, e.g. ``"lambda x0: torch.where(x0 > 0, x0, 0.01 * x0)"``;
    ``torch`` and ``np`` are in scope.

    .. warning:: unsafe by design: ``src`` is ``eval``'d with full
       builtins and no grammar check, the same trust boundary as
       ``thp::session::exec``.  It must only ever receive
       embedder-authored source, never strings from config files,
       serialized programs or any other less-trusted channel; route
       those through :func:`op_from_expr`'s validated grammar."""
    nargs = int(nargs)
    if not (1 <= nargs <= _MAX_ARGS):
        raise ValueError(f"nargs must be 1..{_MAX_ARGS}")
    import builtins
    import inspect

    import numpy as np
    fn = eval(compile(src, f"<thp-custom-op:{src[:60]}>", "eval"),
              {"__builtins__": builtins, "torch": torch, "np": np})
    if not callable(fn):
        raise TypeError(f"custom op source is not callable: {src!r}")
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        params = None  # builtins without a signature: trust nargs
    if params is not None:
        # the op is called with exactly nargs positionals: reject only
        # signatures that cannot take them
        required = sum(
            p.default is p.empty
            and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            for p in params)
        max_pos = sum(p.kind in (p.POSITIONAL_ONLY,
                                 p.POSITIONAL_OR_KEYWORD)
                      for p in params)
        var_pos = any(p.kind == p.VAR_POSITIONAL for p in params)
        if required > nargs or (not var_pos and max_pos < nargs):
            raise ValueError(
                f"custom op signature incompatible with {nargs} "
                f"positional args: {src!r}")
    try:
        fn.__name__ = f"thp_custom_{abs(hash((src, nargs))) % 10 ** 8}"
    except (AttributeError, TypeError):
        pass  # some builtins have read-only names
    return fn


@functools.lru_cache(maxsize=512)
def op_from_expr(expr: str, nargs: int):
    """Compile a DSL string into a callable of ``nargs`` positional tensor
    arguments.  Cached by (string, nargs), so equal expressions share
    one function object."""
    nargs = int(nargs)
    if not (1 <= nargs <= _MAX_ARGS):
        raise ValueError(f"nargs must be 1..{_MAX_ARGS}")
    _validate(expr, nargs)
    args = ", ".join(f"x{i}" for i in range(nargs))
    code = compile(f"lambda {args}: ({expr})", f"<thp-expr:{expr}>", "eval")
    # the lambda resolves free names from its __globals__, so FUNCTIONS
    # live there.  __import__ stays available because torch's operators
    # import lazily at call time; the validated grammar cannot name it.
    fn = eval(code, {"__builtins__": {"__import__": __import__},
                     **FUNCTIONS})  # noqa: S307
    fn.__name__ = f"thp_expr_{abs(hash((expr, nargs))) % 10 ** 8}"
    return fn
