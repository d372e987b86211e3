"""Layer-1 passes of the port's own idiom, registered beside
:mod:`.passes` (which is the reference's text).

``default-dtype-scoping`` is ``x64-scoping`` in PyTorch's terms. JAX
widens to float64 through one process-wide flag, which the reference
allows only as a ``with enable_x64():`` block; PyTorch's process-wide
switches are the default dtype and the default device. A bare
``torch.set_default_dtype(torch.float64)`` widens every later factory
call in the process — the serve decode step among them, whose budget is
zero float64 operations — and ``torch.set_default_device`` moves them.
So a flip is allowed only inside a ``@contextmanager`` helper (set on
entry, restored on exit) or as the context expression of a ``with``
(``with torch.device("cuda"):``).
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.passes import (ContractPass, FileUnit, Finding,
                                         _canonical, _dotted, _import_aliases,
                                         register_pass)

__all__ = ["DefaultDtypeScopingPass"]

_GLOBAL_FLIPS = frozenset({
    "torch.set_default_dtype",
    "torch.set_default_tensor_type",
    "torch.set_default_device",
})


def _is_contextmanager(fn: ast.AST, aliases: dict[str, str]) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        dotted = _dotted(dec)
        if dotted is not None and _canonical(dotted, aliases).endswith(
                "contextmanager"):
            return True
    return False


@register_pass
class DefaultDtypeScopingPass(ContractPass):
    """A process-wide default dtype or device flip only inside a
    ``@contextmanager`` helper or as a ``with`` context."""

    name = "default-dtype-scoping"
    description = ("torch default dtype/device flips only inside a "
                   "@contextmanager helper or a `with`")
    include = ("*",)

    def visit_file(self, unit: FileUnit) -> Iterable[Finding]:
        aliases = _import_aliases(unit.tree)
        allowed: set[int] = set()
        for node in ast.walk(unit.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    allowed.add(id(item.context_expr))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _is_contextmanager(node, aliases):
                allowed.update(id(n) for n in ast.walk(node))
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call) or id(node) in allowed:
                continue
            dotted = _dotted(node.func)
            if dotted is None:
                continue
            canon = _canonical(dotted, aliases)
            if canon in _GLOBAL_FLIPS:
                yield Finding(
                    self.name, unit.path, node.lineno,
                    f"process-wide `{dotted}()` outside a scoped helper — "
                    f"set it inside a @contextmanager that restores it",
                    ident=canon)
