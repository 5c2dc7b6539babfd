"""Shared AST plumbing for the checkers: parsed modules, function
indexes, dotted-name rendering, and the escape-hatch comment grammar.

Escape hatches are line comments of the form::

    # lint: allow-blocking(reason the analyzer cannot know)

The reason is mandatory — an empty one is itself a finding, because a
bare suppression is exactly the un-checkable prose this package exists
to replace.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow-([a-z-]+)\(([^)]*)\)")

# the port's scripts for the card, at the root of the checkout: scanned as
# its tools are (their HTTP calls, asserted series and fault specs count)
CARD_SCRIPTS = ("chip_smoke.py", "chip_phases.py")


@dataclass
class Suppression:
    code: str    # e.g. "blocking"
    reason: str
    line: int


@dataclass
class Module:
    """One parsed source file plus the lookups every checker needs."""

    path: str           # absolute
    relpath: str        # repo-relative (finding coordinates)
    source: str
    tree: ast.Module
    # line -> suppressions declared on that line
    suppressions: Dict[int, List[Suppression]] = field(default_factory=dict)
    # function/method name -> def node (methods keyed both bare and
    # "Class.method"; last definition wins, which matches runtime)
    functions: Dict[str, ast.AST] = field(default_factory=dict)

    def allows(self, code: str, line: int) -> Optional[Suppression]:
        for suppression in self.suppressions.get(line, ()):
            if suppression.code == code:
                return suppression
        return None


def parse_module(path: str, relpath: str) -> Optional[Module]:
    try:
        with open(path, "r", encoding="utf-8") as handle:
            source = handle.read()
        tree = ast.parse(source, filename=relpath)
    except (OSError, SyntaxError):
        return None
    module = Module(path=path, relpath=relpath, source=source, tree=tree)
    for i, text in enumerate(source.splitlines(), start=1):
        for match in _ALLOW_RE.finditer(text):
            module.suppressions.setdefault(i, []).append(
                Suppression(
                    code=match.group(1), reason=match.group(2).strip(),
                    line=i,
                )
            )
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module.functions[node.name] = node
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    module.functions[f"{node.name}.{item.name}"] = item
    return module


def dotted(node: ast.AST) -> str:
    """Best-effort dotted rendering of a Name/Attribute chain
    (``torch.cuda.synchronize`` / ``self._session.post``); '' when the
    expression is not a plain chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        # e.g. ``self._http().get`` — render the callee chain with ()
        inner = dotted(node.func)
        parts.append(f"{inner}()" if inner else "()")
    else:
        return ""
    return ".".join(reversed(parts))


def attr_chain_names(node: ast.AST) -> Iterator[str]:
    """Every attribute/name identifier appearing in an expression —
    how ``with self._dispatch_lock or contextlib.nullcontext():``
    still resolves to ``_dispatch_lock``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            yield sub.attr
        elif isinstance(sub, ast.Name):
            yield sub.id


def local_functions(node: ast.AST) -> Dict[str, ast.AST]:
    """Defs nested directly inside ``node``'s body (closures handed to
    Thread(target=...) and friends)."""
    out: Dict[str, ast.AST] = {}
    for sub in ast.walk(node):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[sub.name] = sub
    return out


def iter_calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def resolve_target(
    module: Module, scope: ast.AST, expr: ast.AST
) -> Tuple[str, Optional[ast.AST]]:
    """Resolve a callable expression (a ``target=`` argument, a
    submitted coroutine call) to a function node in this module when
    possible. Returns (display name, node-or-None).

    SOUND resolution only: bare names and ``self.method`` — an
    attribute on any other receiver (``session.close``,
    ``loop.run_forever``) could be anything, and guessing by suffix
    produces false positives. Innermost scope wins (closures shadow
    module-level defs)."""
    if isinstance(expr, ast.Call):  # submitted coroutine: f(...)
        expr = expr.func
    name = dotted(expr)
    if not name:
        if isinstance(expr, ast.Lambda):
            return "<lambda>", expr
        return "<expr>", None
    parts = name.split(".")
    if len(parts) > 2 or (len(parts) == 2 and parts[0] != "self"):
        return name, None
    short = parts[-1]
    node = local_functions(scope).get(short) or module.functions.get(short)
    return name, node
