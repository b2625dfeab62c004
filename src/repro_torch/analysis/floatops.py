"""parity-float: engine files must mirror the scalar loop's float-op order.

Scope is ``config.FLOAT_SCOPE_PATTERNS`` (the ``batch_*.py`` engines and
``world.py``) — the modules whose outputs are asserted bit-equal to a
scalar oracle. Two shapes are flagged:

  * unordered reductions: ``np.sum``/``np.mean``/``np.prod`` (and the
    ``.sum()``/``.mean()``/``.prod()`` methods, plus ``math.fsum``) use
    pairwise/compensated summation whose fold order differs from the
    scalar loop's sequential accumulation — use
    ``np.add.reduce``-style ordered folds instead;
  * raw-set iteration feeding accumulation: ``for x in {...}`` /
    ``set(...)`` / ``frozenset(...)`` with a ``+=`` in the body folds in
    hash order, which varies with insertion history — iterate
    ``sorted(...)`` (the clean twin) so the fold order is pinned.
"""
from __future__ import annotations

import ast
import fnmatch
import os
from typing import Dict, List

from . import config
from .astutil import ScopedVisitor, dotted, resolve
from .findings import Finding

_BAD_METHODS = frozenset({"sum", "mean", "prod"})


def _is_raw_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        if name.split(".")[-1] in {"set", "frozenset"}:
            return True
        # x.union(...), a | b on sets are out of heuristic reach; keys()
        # views of dicts are insertion-ordered and fine.
    return False


class _FloatVisitor(ScopedVisitor):
    def __init__(self, path: str, imports: Dict[str, str]) -> None:
        super().__init__()
        self.path = path
        self.imports = imports
        self.findings: List[Finding] = []

    def _emit(self, node: ast.AST, symbol: str, what: str) -> None:
        self.findings.append(
            Finding(
                path=self.path,
                line=node.lineno,
                col=node.col_offset,
                rule=config.RULE_FLOAT,
                symbol=f"{self.qualname}:{symbol}",
                message=(
                    f"{what} — violates the contract "
                    f"({config.RULE_CONTRACTS[config.RULE_FLOAT]}). "
                    f"Use {config.FLOAT_GOOD_FORMS}, or iterate sorted(...) "
                    f"for pinned fold order. Integer-only reductions may "
                    f"suppress with '# reprolint: ignore[{config.RULE_FLOAT}]'."
                ),
            )
        )

    def visit_Call(self, node: ast.Call) -> None:
        chain = dotted(node.func)
        matched_module_form = False
        if chain is not None:
            full = resolve(chain, self.imports)
            parts = full.split(".")
            if parts[0] == "numpy" and len(parts) == 2 and parts[1] in config.FLOAT_BAD_NUMPY:
                matched_module_form = True
                self._emit(
                    node,
                    f"np.{parts[1]}",
                    f"unordered reduction np.{parts[1]} (pairwise summation; "
                    f"fold order differs from the scalar loop)",
                )
            elif full == "math.fsum":
                matched_module_form = True
                self._emit(
                    node,
                    "math.fsum",
                    "math.fsum (compensated summation; not the scalar loop's fold)",
                )
        if (
            not matched_module_form
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _BAD_METHODS
        ):
            self._emit(
                node,
                f".{node.func.attr}()",
                f"unordered reduction .{node.func.attr}() on an array expression",
            )
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if _is_raw_set_expr(node.iter):
            for sub in node.body:
                for inner in ast.walk(sub):
                    if isinstance(inner, ast.AugAssign) and isinstance(
                        inner.op, (ast.Add, ast.Sub, ast.Mult)
                    ):
                        self._emit(
                            node,
                            "set-iter-accum",
                            "iteration over an unordered set feeding accumulation "
                            "(hash order varies with insertion history)",
                        )
                        self.generic_visit(node)
                        return
        self.generic_visit(node)


def in_scope(path: str) -> bool:
    base = os.path.basename(path)
    return any(fnmatch.fnmatch(base, pat) for pat in config.FLOAT_SCOPE_PATTERNS)


def check(path: str, tree: ast.Module, imports: Dict[str, str]) -> List[Finding]:
    if not in_scope(path):
        return []
    v = _FloatVisitor(path, imports)
    v.visit(tree)
    return v.findings
