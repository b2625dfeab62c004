"""rng-discipline: no draws outside seeded entry points and draw caches.

Flags three shapes, all of which desynchronize the scalar and vector
engines' draw sequences (or make a run unreproducible outright):

  * module-level draws on the process-global stream
    (``random.random()``, ``random.shuffle(...)``, ...);
  * unseeded RNG construction (``random.Random()`` with no seed,
    ``random.SystemRandom(...)``, zero-argument ``np.random.default_rng()``);
  * legacy/hidden-state numpy RNG (``np.random.RandomState``,
    ``np.random.rand``, ``np.random.seed``, ...).

Seeded ``random.Random(seed)`` construction and the
``np.random.SeedSequence``/``default_rng(seed)``/``Generator`` family are
the sanctioned seed-entry points (``config.NP_SEED_ENTRY``); drawing from
an rng *object* (a parameter or a seeded ``self._rng``) is always fine —
the object's provenance is what the seed-entry rule pins down. Modules in
``config.RNG_MODULE_WHITELIST`` (draw-cache hosts) are exempt wholesale.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from . import config
from .astutil import ScopedVisitor, dotted, resolve
from .findings import Finding


class _RngVisitor(ScopedVisitor):
    def __init__(self, path: str, imports: Dict[str, str]) -> None:
        super().__init__()
        self.path = path
        self.imports = imports
        self.findings: List[Finding] = []

    def _emit(self, node: ast.AST, symbol: str, what: str, fix: str) -> None:
        self.findings.append(
            Finding(
                path=self.path,
                line=node.lineno,
                col=node.col_offset,
                rule=config.RULE_RNG,
                symbol=f"{self.qualname}:{symbol}",
                message=(
                    f"{what} breaks the contract ({config.RULE_CONTRACTS[config.RULE_RNG]}). "
                    f"{fix} Whitelist: seed-entry constructors "
                    f"{sorted(config.NP_SEED_ENTRY)} and seeded random.Random(seed); "
                    f"draw-cache modules: {list(config.RNG_MODULE_WHITELIST) or 'none'}."
                ),
            )
        )

    def visit_Call(self, node: ast.Call) -> None:
        chain = dotted(node.func)
        if chain is not None:
            full = resolve(chain, self.imports)
            parts = full.split(".")
            if parts[0] == "random" and len(parts) == 2:
                fn = parts[1]
                if fn in config.RNG_GLOBAL_DRAWS:
                    self._emit(
                        node,
                        f"random.{fn}",
                        f"module-level draw random.{fn}() on the global stream",
                        "Thread a seeded random.Random through the caller instead.",
                    )
                elif fn == "Random" and not node.args and not node.keywords:
                    self._emit(
                        node,
                        "random.Random()",
                        "unseeded random.Random() (seeds from OS entropy)",
                        "Pass an explicit integer seed.",
                    )
                elif fn == "SystemRandom":
                    self._emit(
                        node,
                        "random.SystemRandom",
                        "random.SystemRandom (OS entropy; never reproducible)",
                        "Use seeded random.Random(seed).",
                    )
            elif parts[:2] == ["numpy", "random"] and len(parts) == 3:
                fn = parts[2]
                if fn not in config.NP_SEED_ENTRY:
                    self._emit(
                        node,
                        f"np.random.{fn}",
                        f"legacy/hidden-state numpy RNG np.random.{fn}",
                        "Use np.random.default_rng(np.random.SeedSequence([...])) "
                        "or derive constants by hashing (no RNG namespace).",
                    )
                elif fn == "default_rng" and not node.args and not node.keywords:
                    self._emit(
                        node,
                        "np.random.default_rng()",
                        "unseeded np.random.default_rng() (seeds from OS entropy)",
                        "Pass a SeedSequence or integer seed.",
                    )
        self.generic_visit(node)


def check(path: str, tree: ast.Module, imports: Dict[str, str]) -> List[Finding]:
    posix = path.replace("\\", "/")
    if any(posix.endswith(suf) for suf in config.RNG_MODULE_WHITELIST):
        return []
    v = _RngVisitor(path, imports)
    v.visit(tree)
    return v.findings
