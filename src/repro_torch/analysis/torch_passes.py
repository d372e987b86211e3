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

``no-span-reads`` keeps the profile record's clock out of the
determinism-critical modules. They may write a record of
:mod:`repro_torch.core.spans` (``span``, ``count``, ``record``,
``fill_stats``, which hands a block's seconds to a caller's ``stats``),
but not read one: no other name of the module, no record bound by
``with spans.record(...) as ...``, no ``last_trace``. ``no-wallclock``
sees only the clock calls written in a file, and the spans read the
clock in theirs; a time read back from a record would reach the sample
path all the same.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.passes import (ContractPass, FileUnit, Finding,
                                         _canonical, _dotted, _import_aliases,
                                         DETERMINISM_CRITICAL_MODULES,
                                         register_pass)

__all__ = ["DefaultDtypeScopingPass", "NoSpanReadsPass"]

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


_SPANS = "repro_torch.core.spans"
_SPAN_WRITERS = frozenset({"span", "count", "record", "fill_stats"})


@register_pass
class NoSpanReadsPass(ContractPass):
    """Determinism-critical modules write the profile record, never read
    it."""

    name = "no-span-reads"
    description = ("determinism-critical modules only write profile "
                   "records (spans.span/count/record/fill_stats)")
    include = DETERMINISM_CRITICAL_MODULES

    def visit_file(self, unit: FileUnit) -> Iterable[Finding]:
        aliases = _import_aliases(unit.tree)
        for node in ast.walk(unit.tree):
            if isinstance(node, ast.withitem) \
                    and node.optional_vars is not None \
                    and isinstance(node.context_expr, ast.Call):
                dotted = _dotted(node.context_expr.func)
                if dotted is not None and _canonical(
                        dotted, aliases) == f"{_SPANS}.record":
                    yield Finding(
                        self.name, unit.path, node.context_expr.lineno,
                        f"`{dotted}(...)` bound with `as`: the record's "
                        f"times are readable here", ident=f"{_SPANS}.record")
            elif isinstance(node, ast.Attribute) \
                    and node.attr == "last_trace":
                yield Finding(self.name, unit.path, node.lineno,
                              "a profiler's `last_trace` read in a "
                              "determinism-critical module",
                              ident="last_trace")
            elif isinstance(node, (ast.Attribute, ast.Name)):
                dotted = _dotted(node)
                if dotted is None:
                    continue
                canon = _canonical(dotted, aliases)
                head, _, member = canon.rpartition(".")
                if head == _SPANS and member not in _SPAN_WRITERS:
                    yield Finding(
                        self.name, unit.path, node.lineno,
                        f"`{dotted}` reads the profile record in a "
                        f"determinism-critical module", ident=canon)
