"""Small shared AST helpers for the reprolint checkers."""
from __future__ import annotations

import ast
from typing import Dict, List, Optional


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as ``a.b.c`` (None for anything else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_map(tree: ast.Module) -> Dict[str, str]:
    """Local name -> canonical dotted module/object path.

    Covers ``import random``, ``import numpy as np``,
    ``from numpy import random as npr`` and
    ``from random import choice`` — enough to resolve the RNG namespaces
    this repo's rules care about.
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else alias.name.split(".")[0]
                out[local] = target
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                local = alias.asname or alias.name
                out[local] = f"{node.module}.{alias.name}"
    return out


def resolve(chain: str, imports: Dict[str, str]) -> str:
    """Rewrite the root of a dotted chain through the import map, then
    canonicalize the numpy alias (``np.random.x`` -> ``numpy.random.x``)."""
    root, _, rest = chain.partition(".")
    base = imports.get(root, root)
    full = f"{base}.{rest}" if rest else base
    if full == "np" or full.startswith("np."):
        full = "numpy" + full[2:]
    return full


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing class/function qualname."""

    def __init__(self) -> None:
        self._stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._stack) or "<module>"

    @property
    def enclosing_class(self) -> Optional[str]:
        return self._class_stack[-1] if getattr(self, "_class_stack", None) else None

    @property
    def enclosing_function(self) -> Optional[str]:
        return self._func_stack[-1] if getattr(self, "_func_stack", None) else None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        if not hasattr(self, "_class_stack"):
            self._class_stack: List[str] = []
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()
        self._stack.pop()

    def _visit_func(self, node) -> None:
        self._stack.append(node.name)
        if not hasattr(self, "_func_stack"):
            self._func_stack: List[str] = []
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()
        self._stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_func(node)


def is_frozen_dataclass(node: ast.ClassDef) -> bool:
    """True for ``@dataclass(frozen=True)`` (any dataclass alias spelling)."""
    for dec in node.decorator_list:
        if isinstance(dec, ast.Call):
            name = dotted(dec.func) or ""
            if name.split(".")[-1] == "dataclass":
                for kw in dec.keywords:
                    if (
                        kw.arg == "frozen"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                    ):
                        return True
    return False
