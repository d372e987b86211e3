"""Layer 1 of the contract auditor: AST passes over the repo source.

Each pass encodes one *program-structure* invariant the test suite can
only spot-check (see ``ROADMAP.md`` → "Static contracts"): deterministic
sampling means no ambient clock or unseeded RNG in the modules that feed
the sample stream; the typed spill hierarchy only helps if the seams
actually raise it; swallowed exceptions in ``core``/``serve`` turn
partial failures into silent data loss; fault-site names must stay in
lock-step with ``faults.FAULT_SITES`` or chaos configs silently detach
from the code they target; and ``enable_x64`` leaking out of scoped
``with`` blocks flips the global dtype mode for everything else.

Passes run over a list of :class:`FileUnit` (parsed once, shared by all
passes), emit :class:`Finding` rows with ``file:line``, and honour
inline suppression pragmas::

    # audit: allow(<pass-name>) <reason>

A pragma suppresses findings of that pass on the pragma's own line and
on the first code line after any contiguous run of comments that
follows it (so a multi-line justification still attaches to the code it
excuses). Pre-existing violations that are not worth a pragma are
pinned by ``baseline.json`` instead (see :mod:`repro.analysis.baseline`)
— only *new* findings fail the check.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import re
from typing import Iterable, Sequence

__all__ = [
    "Finding", "FileUnit", "ContractPass", "PASS_REGISTRY",
    "register_pass", "all_passes", "parse_unit", "run_passes",
    "DETERMINISM_CRITICAL_MODULES",
]


# -- findings -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a source location.

    ``ident`` is the *stable* part of the identity — what was violated,
    not where on the page — so baselines survive unrelated edits that
    shift line numbers. Two identical violations in one file share an
    ident; the baseline stores a count per key.
    """
    pass_name: str
    path: str          # repo-relative, e.g. "src/repro/core/exchange.py"
    line: int
    message: str
    ident: str

    @property
    def key(self) -> str:
        return f"{self.pass_name}:{self.path}:{self.ident}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}] {self.message}"


# -- file units + suppression pragmas -----------------------------------------

_PRAGMA_RE = re.compile(r"#\s*audit:\s*allow\(([A-Za-z0-9_-]+)\)")
_COMMENT_OR_BLANK_RE = re.compile(r"^\s*(#.*)?$")


def _suppressed_lines(source: str) -> dict[str, set[int]]:
    """pass-name -> set of 1-based line numbers its pragmas cover."""
    lines = source.splitlines()
    out: dict[str, set[int]] = {}
    for i, text in enumerate(lines):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        covered = out.setdefault(m.group(1), set())
        covered.add(i + 1)
        # Extend through the comment block to the first code line, so a
        # justification spanning several comment lines still lands.
        j = i + 1
        while j < len(lines) and _COMMENT_OR_BLANK_RE.match(lines[j]):
            covered.add(j + 1)
            j += 1
        if j < len(lines):
            covered.add(j + 1)
    return out


@dataclasses.dataclass
class FileUnit:
    """One parsed source file, shared by every pass."""
    path: str          # repo-relative display path
    modpath: str       # path relative to the scan root (pass includes)
    source: str
    tree: ast.AST
    suppressed: dict[str, set[int]]


def parse_unit(path: str, modpath: str, source: str) -> FileUnit:
    return FileUnit(path=path, modpath=modpath, source=source,
                    tree=ast.parse(source, filename=path),
                    suppressed=_suppressed_lines(source))


# -- shared AST helpers -------------------------------------------------------

def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _import_aliases(tree: ast.AST) -> dict[str, str]:
    """Local name -> canonical dotted origin, from top-level-ish imports.

    ``import time as t`` -> ``{"t": "time"}``; ``from datetime import
    datetime`` -> ``{"datetime": "datetime.datetime"}``. Relative
    imports are skipped (they can't be stdlib clocks/RNGs).
    """
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _canonical(dotted: str, aliases: dict[str, str]) -> str:
    head, _, rest = dotted.partition(".")
    head = aliases.get(head, head)
    if head == "numpy" or head.startswith("numpy."):
        head = "np" + head[len("numpy"):]
    return f"{head}.{rest}" if rest else head


# -- pass base + registry -----------------------------------------------------

class ContractPass:
    """One invariant. Subclasses set ``name``/``description``/``include``
    and implement :meth:`visit_file`; cross-file passes accumulate state
    there and emit from :meth:`finalize`."""

    name: str = ""
    description: str = ""
    include: tuple[str, ...] = ("*",)

    def applies_to(self, modpath: str) -> bool:
        return any(fnmatch.fnmatch(modpath, pat) for pat in self.include)

    def visit_file(self, unit: FileUnit) -> Iterable[Finding]:
        raise NotImplementedError

    def finalize(self) -> Iterable[Finding]:
        return ()


PASS_REGISTRY: dict[str, type[ContractPass]] = {}


def register_pass(cls: type[ContractPass]) -> type[ContractPass]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} has no pass name")
    if cls.name in PASS_REGISTRY:
        raise ValueError(f"duplicate pass name {cls.name!r}")
    PASS_REGISTRY[cls.name] = cls
    return cls


def all_passes() -> list[ContractPass]:
    return [cls() for cls in PASS_REGISTRY.values()]


def run_passes(units: Sequence[FileUnit],
               passes: Sequence[ContractPass] | None = None
               ) -> list[Finding]:
    """Run every pass over every applicable unit; apply suppressions."""
    if passes is None:
        passes = all_passes()
    by_path = {u.path: u for u in units}
    findings: list[Finding] = []
    for p in passes:
        raw: list[Finding] = []
        for unit in units:
            if p.applies_to(unit.modpath):
                raw.extend(p.visit_file(unit))
        raw.extend(p.finalize())
        for f in raw:
            unit = by_path.get(f.path)
            if unit is not None and f.line in unit.suppressed.get(
                    f.pass_name, ()):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.pass_name))
    return findings


# -- pass (a): no wall-clock / unseeded randomness ----------------------------

DETERMINISM_CRITICAL_MODULES = (
    "core/device_pipeline.py",
    "core/faults.py",
    "core/exchange.py",
    # Heavy-hitters eviction order and hash-range ownership must be
    # pure functions of the arrival stream: a wall-clock (or unseeded
    # random) tiebreak in the sketch would make bounded-state merges
    # and kill/restore replays diverge run-to-run.
    "core/sketch.py",
    "kernels/sample_attr/*",
    # Serving-seam replayability: deadlines, budgets, admission order
    # and snapshot/restore are all keyed on the engine step clock — a
    # wall-clock read here would break bit-exact kill/restore.
    "serve/scheduler.py",
    "serve/recovery.py",
)

_WALLCLOCK = frozenset({
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
    "time.clock_gettime", "time.clock_gettime_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

_SEEDED_NP_CTORS = frozenset({
    "default_rng", "Generator", "RandomState", "SeedSequence",
})


@register_pass
class NoWallclockPass(ContractPass):
    """Determinism-critical modules may not read the ambient clock or an
    unseeded RNG: ALEA's sample clock is counter-keyed precisely so runs
    replay bit-exactly; one ``time.time()`` in the sample path breaks
    the replay *and* the numpy reference oracle. ``time.sleep`` is fine
    (it spends wall time, it doesn't sample it)."""

    name = "no-wallclock"
    description = ("no wall-clock reads or unseeded RNG in "
                   "determinism-critical modules")
    include = DETERMINISM_CRITICAL_MODULES

    def visit_file(self, unit: FileUnit) -> Iterable[Finding]:
        aliases = _import_aliases(unit.tree)
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted is None:
                continue
            canon = _canonical(dotted, aliases)
            msg = None
            if canon in _WALLCLOCK:
                msg = f"wall-clock read `{dotted}()`"
            elif canon.startswith("random.") or canon == "random":
                msg = f"global-state stdlib RNG `{dotted}()`"
            elif canon.startswith("np.random."):
                last = canon.rsplit(".", 1)[1]
                if last not in _SEEDED_NP_CTORS:
                    msg = f"unseeded numpy RNG `{dotted}()`"
                elif not node.args:
                    msg = (f"`{dotted}()` without an explicit seed "
                           f"(entropy from the OS)")
            if msg is not None:
                yield Finding(self.name, unit.path, node.lineno,
                              msg + " in a determinism-critical module",
                              ident=canon)


# -- pass (b): typed spill errors at durable seams ----------------------------

_OS_ERROR_BUILTINS = frozenset({
    "IOError", "OSError", "EnvironmentError", "FileNotFoundError",
    "FileExistsError", "PermissionError", "IsADirectoryError",
    "NotADirectoryError", "InterruptedError", "BlockingIOError",
    "TimeoutError",
})


@register_pass
class TypedSpillErrorsPass(ContractPass):
    """The spill/ckpt seams must raise the ``SpillError`` hierarchy, not
    builtin OSError family types: tolerance code dispatches on the typed
    classes (corrupt vs torn vs stale vs missing), and a builtin raise
    is invisible to that dispatch — it reads as an environment failure
    rather than a classified artifact state."""

    name = "typed-spill-errors"
    description = "durable-seam raises use the SpillError hierarchy"
    include = ("core/exchange.py", "checkpoint/ckpt.py")

    def visit_file(self, unit: FileUnit) -> Iterable[Finding]:
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call):
                name = _dotted(exc.func)
            elif isinstance(exc, (ast.Name, ast.Attribute)):
                name = _dotted(exc)
            if name in _OS_ERROR_BUILTINS:
                yield Finding(
                    self.name, unit.path, node.lineno,
                    f"raises builtin `{name}` at a durable seam — use a "
                    f"typed SpillError subclass (faults.py)",
                    ident=name)


# -- pass (c): no silent exception swallowing ---------------------------------

_LOG_HEADS = frozenset({"print", "logging", "logger", "log", "warnings"})


def _is_silent_stmt(stmt: ast.stmt) -> bool:
    if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
        return True
    if isinstance(stmt, ast.Return):
        return stmt.value is None or isinstance(stmt.value, ast.Constant)
    if isinstance(stmt, ast.Expr):
        if isinstance(stmt.value, ast.Constant):
            return True      # stray docstring
        if isinstance(stmt.value, ast.Call):
            dotted = _dotted(stmt.value.func)
            if dotted is not None:
                return dotted.split(".")[0] in _LOG_HEADS
    return False


@register_pass
class NoSilentExceptPass(ContractPass):
    """``core``/``serve`` handlers may not swallow exceptions without
    leaving evidence (a counter, a re-raise, a recorded report). A
    quorum gather that drops a host *records* it in provenance; a bare
    ``except: pass`` makes the same loss unobservable and the coverage
    report a lie. Deliberate absence-means-empty handlers carry an
    ``# audit: allow(no-silent-except) <reason>`` pragma."""

    name = "no-silent-except"
    description = "no silent exception swallowing in core/ and serve/"
    include = ("core/*", "serve/*")

    def visit_file(self, unit: FileUnit) -> Iterable[Finding]:
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not all(_is_silent_stmt(s) for s in node.body):
                continue
            typ = ast.unparse(node.type) if node.type is not None \
                else "<bare>"
            yield Finding(
                self.name, unit.path, node.lineno,
                f"`except {typ}` swallows the error without evidence "
                f"(counter, re-raise, or provenance record)",
                ident=typ)


# -- pass (d): fault-site hygiene ---------------------------------------------

@register_pass
class FaultSiteHygienePass(ContractPass):
    """Every ``declare_site(...)`` literal must be registered in
    ``faults.FAULT_SITES`` and declared by exactly one seam; every
    registered site must actually be declared somewhere. Drift here
    decouples chaos configs from the seams they think they target."""

    name = "fault-site-hygiene"
    description = "declare_site literals registered, unique, exhaustive"
    include = ("*",)

    _REGISTRY_FILE = "core/faults.py"

    def __init__(self):
        self._registry: tuple[str, ...] | None = None
        self._registry_loc: tuple[str, int] | None = None
        self._declared: list[tuple[str, str, int]] = []   # (name, path, line)

    def visit_file(self, unit: FileUnit) -> Iterable[Finding]:
        if unit.modpath == self._REGISTRY_FILE:
            yield from self._read_registry(unit)
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted is None or dotted.split(".")[-1] != "declare_site":
                continue
            if unit.modpath == self._REGISTRY_FILE:
                continue          # the definition, not a declaration
            if not node.args or not (
                    isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                yield Finding(
                    self.name, unit.path, node.lineno,
                    "fault site name must be a string literal (chaos "
                    "configs grep for it)",
                    ident="<non-literal>")
                continue
            self._declared.append(
                (node.args[0].value, unit.path, node.lineno))

    def _read_registry(self, unit: FileUnit) -> Iterable[Finding]:
        for node in ast.walk(unit.tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            if not any(isinstance(t, ast.Name) and t.id == "FAULT_SITES"
                       for t in targets):
                continue
            if not (isinstance(value, ast.Tuple) and all(
                    isinstance(e, ast.Constant)
                    and isinstance(e.value, str) for e in value.elts)):
                yield Finding(
                    self.name, unit.path, node.lineno,
                    "FAULT_SITES must be a tuple of string literals",
                    ident="<registry-shape>")
                return
            names = tuple(e.value for e in value.elts)
            dupes = {n for n in names if names.count(n) > 1}
            for d in sorted(dupes):
                yield Finding(
                    self.name, unit.path, node.lineno,
                    f"site {d!r} registered more than once in FAULT_SITES",
                    ident=f"registry-dup:{d}")
            self._registry = names
            self._registry_loc = (unit.path, node.lineno)
            return

    def finalize(self) -> Iterable[Finding]:
        seen: dict[str, tuple[str, int]] = {}
        for name, path, line in self._declared:
            if self._registry is not None and name not in self._registry:
                yield Finding(
                    self.name, path, line,
                    f"fault site {name!r} is not in faults.FAULT_SITES",
                    ident=f"unregistered:{name}")
            if name in seen:
                p0, l0 = seen[name]
                yield Finding(
                    self.name, path, line,
                    f"fault site {name!r} already declared at {p0}:{l0}",
                    ident=f"duplicate:{name}")
            else:
                seen[name] = (path, line)
        if self._registry is not None and self._registry_loc is not None:
            declared = {n for n, _, _ in self._declared}
            path, line = self._registry_loc
            for name in self._registry:
                if name not in declared:
                    yield Finding(
                        self.name, path, line,
                        f"registered fault site {name!r} is never "
                        f"declared by any seam",
                        ident=f"undeclared:{name}")


# -- pass (e): enable_x64 scoping ---------------------------------------------

@register_pass
class X64ScopingPass(ContractPass):
    """x64 may only be entered through the scoped ``with enable_x64():``
    helper. A bare ``enable_x64()`` call (context manager constructed
    but never entered/exited) or a global
    ``jax.config.update("jax_enable_x64", ...)`` flips the process-wide
    dtype mode — re-tracing *every* cached jit and silently widening
    the serve path, whose budget is zero f64 ops."""

    name = "x64-scoping"
    description = "enable_x64 only as a `with` context; no global flag"
    include = ("*",)

    def visit_file(self, unit: FileUnit) -> Iterable[Finding]:
        aliases = _import_aliases(unit.tree)
        with_calls: set[int] = set()
        for node in ast.walk(unit.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    with_calls.add(id(item.context_expr))
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted is None:
                continue
            if dotted.split(".")[-1] == "enable_x64":
                if id(node) not in with_calls:
                    yield Finding(
                        self.name, unit.path, node.lineno,
                        "`enable_x64()` outside a `with` statement — the "
                        "scope is never entered (or never exited)",
                        ident="enable_x64-unscoped")
                continue
            canon = _canonical(dotted, aliases)
            if canon.endswith("config.update") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    node.args[0].value == "jax_enable_x64":
                yield Finding(
                    self.name, unit.path, node.lineno,
                    "global `config.update(\"jax_enable_x64\", ...)` — "
                    "use the scoped `with enable_x64():` helper",
                    ident="jax_enable_x64-global")
