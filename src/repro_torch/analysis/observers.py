"""index-bypass: no untracked writes to IndexObserved row fields.

``Job``/``JobInstance`` route tracked-field assignment through
``JobStore._on_field_change`` so the mutation-time indexes stay exact.
Writing those fields via ``object.__setattr__(inst, "state", ...)`` or
``inst.__dict__["state"] = ...`` skips the observer: the row changes, the
index doesn't, and ``check_invariants``'s oracle scan fires much later —
far from the cause.

Flagged shapes (outside ``config.BYPASS_MODULE_WHITELIST`` — the mixin
itself and the store's sanctioned fused bulk writers):

  * ``object.__setattr__(x, "<tracked>", v)``;
  * ``x.__dict__["<tracked>"] = v`` (and ``.update({...})`` with tracked
    keys).

Untracked fields (``claimed_credit``, ``granted_credit``, ``_store``)
may use either form freely — only names in ``config.TRACKED_FIELDS``
carry index obligations.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from . import config
from .astutil import ScopedVisitor, dotted
from .findings import Finding


class _BypassVisitor(ScopedVisitor):
    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.findings: List[Finding] = []

    def _emit(self, node: ast.AST, field: str, what: str) -> None:
        self.findings.append(
            Finding(
                path=self.path,
                line=node.lineno,
                col=node.col_offset,
                rule=config.RULE_BYPASS,
                symbol=f"{self.qualname}:{field}",
                message=(
                    f"{what} writes tracked field '{field}' without notifying the "
                    f"store observer — violates the contract "
                    f"({config.RULE_CONTRACTS[config.RULE_BYPASS]}). "
                    f"Assign the attribute normally, or move the bulk write into "
                    f"a whitelisted store module ({list(config.BYPASS_MODULE_WHITELIST)}) "
                    f"where the index update is fused in."
                ),
            )
        )

    def visit_Call(self, node: ast.Call) -> None:
        if dotted(node.func) == "object.__setattr__" and len(node.args) >= 2:
            name = node.args[1]
            if (
                isinstance(name, ast.Constant)
                and isinstance(name.value, str)
                and name.value in config.TRACKED_FIELDS
            ):
                self._emit(node, name.value, "object.__setattr__")
        # x.__dict__.update({...})
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "update"
            and isinstance(node.func.value, ast.Attribute)
            and node.func.value.attr == "__dict__"
            and node.args
            and isinstance(node.args[0], ast.Dict)
        ):
            for k in node.args[0].keys:
                if (
                    isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and k.value in config.TRACKED_FIELDS
                ):
                    self._emit(node, k.value, "__dict__.update")
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Subscript)
                and isinstance(tgt.value, ast.Attribute)
                and tgt.value.attr == "__dict__"
                and isinstance(tgt.slice, ast.Constant)
                and isinstance(tgt.slice.value, str)
                and tgt.slice.value in config.TRACKED_FIELDS
            ):
                self._emit(node, tgt.slice.value, "__dict__[...] assignment")
        self.generic_visit(node)


def check(path: str, tree: ast.Module, imports: Dict[str, str]) -> List[Finding]:
    posix = path.replace("\\", "/")
    if any(posix.endswith(suf) for suf in config.BYPASS_MODULE_WHITELIST):
        return []
    v = _BypassVisitor(path)
    v.visit(tree)
    return v.findings
