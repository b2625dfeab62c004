"""frozen-mut: no mutation of frozen value dataclasses outside __post_init__.

Frozen classes are the union of ``config.KNOWN_FROZEN_CLASSES`` and every
``@dataclass(frozen=True)`` definition discovered in the scanned tree
(the engine passes that set in). Three shapes are flagged:

  * attribute assignment (plain or augmented) through a variable whose
    annotation names a frozen class (parameter annotations and local
    ``AnnAssign`` both count) — this would raise FrozenInstanceError at
    runtime, but the lint catches it before a rarely-run branch does;
  * ``object.__setattr__(self, ...)`` inside a frozen class's methods,
    except ``__post_init__`` (the sanctioned construction-time escape);
  * ``object.__setattr__(x, ...)`` where ``x`` is frozen-annotated.

``dataclasses.replace(spec, ...)`` is the sanctioned way to derive a
modified spec; the finding message says so.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional

from . import config
from .astutil import ScopedVisitor, dotted, is_frozen_dataclass
from .findings import Finding


def discover_frozen(tree: ast.Module) -> FrozenSet[str]:
    return frozenset(
        n.name
        for n in ast.walk(tree)
        if isinstance(n, ast.ClassDef) and is_frozen_dataclass(n)
    )


def _annotation_name(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover
        return None
    # Optional["ScenarioSpec"] / "ScenarioSpec" / ScenarioSpec
    text = text.strip("\"'")
    for wrapper in ("Optional[", "Final["):
        if text.startswith(wrapper) and text.endswith("]"):
            text = text[len(wrapper):-1].strip("\"'")
    return text.split(".")[-1] or None


class _FrozenVisitor(ScopedVisitor):
    def __init__(self, path: str, frozen: FrozenSet[str], tree: ast.Module) -> None:
        super().__init__()
        self.path = path
        self.frozen = frozen
        self.findings: List[Finding] = []
        #: per-function annotated-variable maps, keyed by id(funcnode)
        self._var_types: List[Dict[str, str]] = [{}]
        #: class defs that are frozen, by name, for the self case
        self._frozen_classes = {
            n.name
            for n in ast.walk(tree)
            if isinstance(n, ast.ClassDef)
            and (is_frozen_dataclass(n) or n.name in frozen)
        }

    # -- scope bookkeeping ------------------------------------------------

    def _visit_func(self, node) -> None:
        scope: Dict[str, str] = {}
        for arg in list(node.args.args) + list(node.args.kwonlyargs):
            t = _annotation_name(arg.annotation)
            if t in self.frozen:
                scope[arg.arg] = t
        self._var_types.append(scope)
        super()._visit_func(node)
        self._var_types.pop()

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if isinstance(node.target, ast.Name):
            t = _annotation_name(node.annotation)
            if t in self.frozen:
                self._var_types[-1][node.target.id] = t
        self.generic_visit(node)

    def _frozen_type_of(self, name: str) -> Optional[str]:
        for scope in reversed(self._var_types):
            if name in scope:
                return scope[name]
        return None

    # -- findings ---------------------------------------------------------

    def _emit(self, node: ast.AST, cls: str, attr: str, what: str) -> None:
        self.findings.append(
            Finding(
                path=self.path,
                line=node.lineno,
                col=node.col_offset,
                rule=config.RULE_FROZEN,
                symbol=f"{cls}.{attr}",
                message=(
                    f"{what} mutates frozen {cls} outside __post_init__ — "
                    f"violates the contract ({config.RULE_CONTRACTS[config.RULE_FROZEN]}). "
                    f"Derive a new spec with dataclasses.replace(...) instead; "
                    f"construction-time writes belong in __post_init__ "
                    f"(the whitelisted scope)."
                ),
            )
        )

    def _check_store(self, target: ast.AST, node: ast.AST) -> None:
        if isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name):
            t = self._frozen_type_of(target.value.id)
            if t is not None and self.enclosing_function != "__post_init__":
                self._emit(
                    node, t, target.attr,
                    f"assignment to {target.value.id}.{target.attr}",
                )

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._check_store(tgt, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store(node.target, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if (dotted(node.func) == "object.__setattr__") and node.args:
            first = node.args[0]
            attr = (
                node.args[1].value
                if len(node.args) > 1
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
                else "<dynamic>"
            )
            if isinstance(first, ast.Name):
                if first.id == "self":
                    cls = self.enclosing_class
                    if (
                        cls in self._frozen_classes
                        and self.enclosing_function != "__post_init__"
                    ):
                        self._emit(
                            node, cls or "<class>", attr,
                            "object.__setattr__(self, ...)",
                        )
                else:
                    t = self._frozen_type_of(first.id)
                    if t is not None and self.enclosing_function != "__post_init__":
                        self._emit(
                            node, t, attr,
                            f"object.__setattr__({first.id}, ...)",
                        )
        self.generic_visit(node)


def check(
    path: str,
    tree: ast.Module,
    imports: Dict[str, str],
    frozen: FrozenSet[str] = frozenset(),
) -> List[Finding]:
    all_frozen = frozenset(config.KNOWN_FROZEN_CLASSES) | frozen | discover_frozen(tree)
    v = _FrozenVisitor(path, all_frozen, tree)
    v.visit(tree)
    return v.findings
