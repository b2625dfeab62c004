"""reprolint — the AST-based invariant checker for this repo's contracts.

Every engine here is trusted only because of a handful of hand-enforced
contracts: RNG-stream neutrality across the scalar/vector paths,
IEEE-order float-op mirroring in the batch engines, churn-purges-
everything per-host hygiene, frozen scenario specs, and observer-routed
store mutations. A violation of any of them shows up only later, as a
parity failure to be debugged; reprolint checks them mechanically,
before a failure localizes them for you.

Usage::

    from repro_torch.analysis import run_checks
    report = run_checks(["src/repro_torch"])
    assert report.ok, [f.format() for f in report.new]

or from the command line::

    python -m repro_torch.analysis src/repro_torch

The CLI reads ``reprolint_torch_baseline.json`` from the working directory
when that file exists (the port's tree is clean, so it does not);
``reprolint_baseline.json`` belongs to the JAX package's tree and is never
read unless named with ``--baseline``.

Rules (stdlib ``ast`` only — no new runtime deps):

===============  =========================================================
rule id          contract
===============  =========================================================
rng-discipline   draws only via seeded entry points / draw caches
purge-complete   per-host containers cleared on forget_host/churn paths
parity-float     batch engines fold floats in the scalar loop's order
frozen-mut       frozen specs immutable outside __post_init__
index-bypass     tracked store-row fields never written past the observer
===============  =========================================================
"""
from .config import ALL_RULES, RULE_CONTRACTS
from .engine import run_checks
from .findings import Finding, Report, dump_baseline, load_baseline

__all__ = [
    "ALL_RULES",
    "Finding",
    "Report",
    "RULE_CONTRACTS",
    "dump_baseline",
    "load_baseline",
    "run_checks",
]
