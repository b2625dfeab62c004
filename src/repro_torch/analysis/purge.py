"""purge-complete: every per-host container has a purge-path clear.

Discovery (per class in a ``core/`` module):

  * container attributes — class-body ``AnnAssign`` whose annotation
    renders as a dict/defaultdict type, or ``self.x = {}/dict()/
    defaultdict(...)`` assignments in ``__init__``;
  * host-keyed evidence — the attribute name contains ``host``, or the
    module subscripts/``get``s/``pop``s the attribute with a key variable
    named like a host id (``config.HOST_KEY_NAMES``, or an attribute
    chain ending ``.host_id``).

Verification: some function whose name matches a purge-path fragment
(``config.PURGE_PATH_NAMES``) must reference the attribute. Referencing
is enough — deliberate retention (tombstoned ``world.index`` slots,
interned ``_host_idx`` rows) lives *inside* the purge path where the
decision is documented. Containers on per-tick ephemeral classes
(``config.PURGE_EPHEMERAL_CLASSES``) are exempt; permanent documented
exceptions (credit history kept per §7) use an inline
``# reprolint: ignore[purge-complete]`` on the declaration line.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import config
from .astutil import dotted
from .findings import Finding

_DICT_MARKERS = ("Dict[", "dict[", "defaultdict", "DefaultDict", "dict")


def _is_dict_annotation(node: ast.AST) -> bool:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse failure
        return False
    return any(text.startswith(m) or f"[{m}" in text for m in _DICT_MARKERS)


def _is_dict_value(node: ast.AST) -> bool:
    if isinstance(node, ast.Dict):
        return True
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        leaf = name.split(".")[-1]
        if leaf in {"dict", "defaultdict", "OrderedDict"}:
            return True
        # dataclasses.field(default_factory=dict/defaultdict/...)
        if leaf == "field":
            for kw in node.keywords:
                if kw.arg == "default_factory":
                    f = kw.value
                    fname = dotted(f) or ""
                    if fname.split(".")[-1] in {"dict", "defaultdict", "OrderedDict"}:
                        return True
                    if isinstance(f, ast.Lambda) and _is_dict_value(f.body):
                        return True
    return False


def _host_key_expr(node: ast.AST) -> bool:
    """Does this subscript/argument expression look like a host id?"""
    if isinstance(node, ast.Name) and node.id in config.HOST_KEY_NAMES:
        return True
    if isinstance(node, ast.Attribute) and node.attr == "host_id":
        return True
    if isinstance(node, ast.Tuple):
        return any(_host_key_expr(e) for e in node.elts)
    return False


class _ClassInfo:
    def __init__(self, name: str) -> None:
        self.name = name
        #: attr -> (lineno, col)
        self.containers: Dict[str, Tuple[int, int]] = {}
        self.host_keyed: Set[str] = set()
        #: attrs referenced from inside purge-path functions
        self.purged: Set[str] = set()
        self.has_purge_path = False


def _is_purge_name(name: str) -> bool:
    low = name.lower()
    return any(frag in low for frag in config.PURGE_PATH_NAMES)


def _collect_class(cls: ast.ClassDef, info: _ClassInfo) -> None:
    # class-body annotated containers
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            if _is_dict_annotation(stmt.annotation) or (
                stmt.value is not None and _is_dict_value(stmt.value)
            ):
                info.containers[stmt.target.id] = (stmt.lineno, stmt.col_offset)
        elif isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and stmt.value is not None and _is_dict_value(stmt.value):
                    info.containers[tgt.id] = (stmt.lineno, stmt.col_offset)

    # __init__ self.x = {} containers
    for stmt in cls.body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name in ("__init__", "__post_init__"):
            for node in ast.walk(stmt):
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign) and _is_dict_value(node.value):
                    targets = list(node.targets)
                elif isinstance(node, ast.AnnAssign) and (
                    _is_dict_annotation(node.annotation)
                    or (node.value is not None and _is_dict_value(node.value))
                ):
                    targets = [node.target]
                for tgt in targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        info.containers.setdefault(
                            tgt.attr, (node.lineno, node.col_offset)
                        )

    # evidence + purge references, scanning every method
    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        purging = _is_purge_name(stmt.name)
        if purging:
            info.has_purge_path = True
        for node in ast.walk(stmt):
            attr: Optional[str] = None
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id == "self"
            ):
                attr = node.value.attr
                if _host_key_expr(node.slice):
                    info.host_keyed.add(attr)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in {"get", "pop", "setdefault", "__contains__"}
                and isinstance(node.func.value, ast.Attribute)
                and isinstance(node.func.value.value, ast.Name)
                and node.func.value.value.id == "self"
            ):
                attr = node.func.value.attr
                if node.args and _host_key_expr(node.args[0]):
                    info.host_keyed.add(attr)
            if purging:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Attribute) and isinstance(
                        sub.value, ast.Name
                    ) and sub.value.id == "self":
                        info.purged.add(sub.attr)

    # name heuristic
    for attr in info.containers:
        if config.HOST_NAME_FRAGMENT in attr.lower():
            info.host_keyed.add(attr)


def check(path: str, tree: ast.Module, imports: Dict[str, str]) -> List[Finding]:
    posix = path.replace("\\", "/")
    parts = posix.split("/")
    if not any(d in parts for d in config.PURGE_SCOPE_DIRS):
        return []

    findings: List[Finding] = []
    # module-level purge functions also count (e.g. free functions)
    module_purgers: List[ast.FunctionDef] = [
        n
        for n in tree.body
        if isinstance(n, ast.FunctionDef) and _is_purge_name(n.name)
    ]
    module_purged: Set[str] = set()
    for fn in module_purgers:
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute):
                module_purged.add(node.attr)

    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        if cls.name in config.PURGE_EPHEMERAL_CLASSES:
            continue
        info = _ClassInfo(cls.name)
        _collect_class(cls, info)
        for attr, (line, col) in sorted(info.containers.items()):
            if attr not in info.host_keyed:
                continue
            if attr in info.purged or attr in module_purged:
                continue
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=col,
                    rule=config.RULE_PURGE,
                    symbol=f"{cls.name}.{attr}",
                    message=(
                        f"per-host container {cls.name}.{attr} has no clear in any "
                        f"purge path ({'/'.join(config.PURGE_PATH_NAMES[:3])}...) — "
                        f"violates the contract ({config.RULE_CONTRACTS[config.RULE_PURGE]}). "
                        f"Add a forget_host that pops the entry, or — for documented "
                        f"permanent retention (e.g. credit history per §7) — suppress "
                        f"with '# reprolint: ignore[{config.RULE_PURGE}]' on this line. "
                        f"Per-tick ephemeral classes belong in PURGE_EPHEMERAL_CLASSES."
                    ),
                )
            )
    return findings
