"""``row_filter``: the subset of ``DataFrame.query`` that dataset configs
use, evaluated over numpy columns.

The grammar and precedence are pandas': ``&`` and ``|`` are rewritten to
``and`` and ``or`` before parsing (as ``pandas.core.computation.expr``
does), so they bind more loosely than comparisons (``a > 0 & b < 1`` is
``(a > 0) & (b < 1)``); chained comparisons (``0 < a < 2.5``) are a
conjunction; ``not`` and ``~`` negate a mask; backticks quote a column
name that is not an identifier (`` `GRA-TE-223` > 0 ``); arithmetic
(``+ - * / // % **``, unary ``-``) and number or boolean literals are
allowed. Anything else raises ``ValueError`` naming the expression: a
filter is never dropped.
"""

from __future__ import annotations

import ast
import io
import operator
import re
import tokenize
from typing import Any, Dict

import numpy as np

_BACKTICK_RE = re.compile(r"`([^`]*)`")
_COMPARE = {ast.Lt: operator.lt, ast.LtE: operator.le, ast.Gt: operator.gt,
            ast.GtE: operator.ge, ast.Eq: operator.eq, ast.NotEq: operator.ne}
_ARITH = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
          ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod,
          ast.Pow: operator.pow}


def _rewrite(expression: str, names: Dict[str, str]) -> str:
    """Backtick names → placeholders, ``&``/``|`` → ``and``/``or``."""
    def quote(match: re.Match) -> str:
        placeholder = f"__backtick_{len(names)}__"
        names[placeholder] = match.group(1)
        return placeholder

    text = _BACKTICK_RE.sub(quote, expression)
    tokens = []
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type == tokenize.OP and tok.string in ("&", "|"):
            tokens.append((tokenize.NAME, "and" if tok.string == "&" else "or"))
        else:
            tokens.append((tok.type, tok.string))
    return tokenize.untokenize(tokens).strip()


def evaluate(expression: str, columns: Dict[str, np.ndarray]) -> np.ndarray:
    """The boolean row mask of ``expression`` over ``columns`` (name →
    1-D array, all of one length)."""
    names: Dict[str, str] = {}

    def refuse(why: str) -> ValueError:
        return ValueError(f"row_filter {expression!r}: {why}")

    try:
        tree = ast.parse(_rewrite(expression, names), mode="eval")
    except (SyntaxError, tokenize.TokenError, IndentationError) as exc:
        raise refuse(f"not a query expression ({exc})") from exc

    def mask(value: Any, node: ast.AST) -> Any:
        if isinstance(value, (bool, np.bool_)) or (
                isinstance(value, np.ndarray) and value.dtype == bool):
            return value
        raise refuse(f"{ast.unparse(node)!r} is not a boolean condition")

    def visit(node: ast.AST) -> Any:
        if isinstance(node, ast.BoolOp):
            combine = np.logical_and if isinstance(node.op, ast.And) else np.logical_or
            result = mask(visit(node.values[0]), node.values[0])
            for value in node.values[1:]:
                result = combine(result, mask(visit(value), value))
            return result
        if isinstance(node, ast.Compare):
            result, left = None, visit(node.left)
            for op, comparator in zip(node.ops, node.comparators):
                if type(op) not in _COMPARE:
                    raise refuse(f"unsupported comparison {type(op).__name__}")
                right = visit(comparator)
                step = _COMPARE[type(op)](left, right)
                result = step if result is None else np.logical_and(result, step)
                left = right
            return result
        if isinstance(node, ast.UnaryOp):
            operand = visit(node.operand)
            if isinstance(node.op, (ast.Not, ast.Invert)):
                return np.logical_not(mask(operand, node.operand))
            if isinstance(node.op, ast.USub):
                return -operand
            if isinstance(node.op, ast.UAdd):
                return +operand
        if isinstance(node, ast.BinOp) and type(node.op) in _ARITH:
            return _ARITH[type(node.op)](visit(node.left), visit(node.right))
        if isinstance(node, ast.Name):
            name = names.get(node.id, node.id)
            if name not in columns:
                raise refuse(f"no column named {name!r}")
            return columns[name]
        if isinstance(node, ast.Constant) and isinstance(node.value, (bool, int, float)):
            return node.value
        raise refuse(f"unsupported syntax {ast.unparse(node)!r}")

    result = visit(tree.body)
    if not (isinstance(result, np.ndarray) and result.dtype == bool and result.ndim == 1):
        raise refuse("does not evaluate to a boolean row mask")
    return result
