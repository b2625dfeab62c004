"""reprolint rule configuration: rule ids, whitelists, and scopes.

Every whitelist here is *policy*, not mechanism — the checkers consult
these tables so that the sanctioned escape hatches are enumerated in one
reviewable place. A finding's message names the whitelist that would have
applied, mirroring how ``run_parity`` localizes a divergence to the axis
that introduced it.
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# Rule ids (stable: baselines and suppression comments reference these)
# ---------------------------------------------------------------------------

RULE_RNG = "rng-discipline"
RULE_PURGE = "purge-complete"
RULE_FLOAT = "parity-float"
RULE_FROZEN = "frozen-mut"
RULE_BYPASS = "index-bypass"

ALL_RULES = (RULE_RNG, RULE_PURGE, RULE_FLOAT, RULE_FROZEN, RULE_BYPASS)

RULE_CONTRACTS = {
    RULE_RNG: (
        "RNG-stream neutrality: scalar and vector engines must consume "
        "identical draw sequences, so every draw goes through a seeded "
        "random.Random(seed) entry point, an ExpDrawCache-style prefetch "
        "cache, or an integer-salted scenario generator"
    ),
    RULE_PURGE: (
        "purge completeness: churn/Sybil scenarios require that every "
        "per-host keyed container is cleared by a forget_host/remove_host/"
        "purge path when the host departs"
    ),
    RULE_FLOAT: (
        "IEEE-order float-op mirroring: batch engines must fold in the "
        "scalar loop's cell order (np.add.reduce-style) — unordered "
        "reductions and raw-set iteration feeding float accumulation "
        "break bit-equality with the oracle"
    ),
    RULE_FROZEN: (
        "frozen-spec immutability: ScenarioSpec/layer dataclasses are "
        "value objects; mutation outside __post_init__ invalidates the "
        "pure (spec, seed) -> population contract"
    ),
    RULE_BYPASS: (
        "index-observer coverage: IndexObserved-tracked row fields must "
        "be written through normal attribute assignment so the store's "
        "mutation-time indexes stay honest with check_invariants"
    ),
}

# ---------------------------------------------------------------------------
# rng-discipline
# ---------------------------------------------------------------------------

#: module-level draws on the process-global stream — never reproducible
#: across engine orderings, so never allowed.
RNG_GLOBAL_DRAWS = frozenset(
    {
        "random",
        "randint",
        "randrange",
        "choice",
        "choices",
        "shuffle",
        "sample",
        "uniform",
        "triangular",
        "gauss",
        "normalvariate",
        "lognormvariate",
        "expovariate",
        "vonmisesvariate",
        "gammavariate",
        "betavariate",
        "paretovariate",
        "weibullvariate",
        "getrandbits",
        "randbytes",
        "seed",
        "setstate",
    }
)

#: numpy.random names that are seed-entry *constructors* (they build an
#: explicitly-seeded generator rather than drawing from hidden state).
#: Everything else under numpy.random — RandomState, rand, randn, seed,
#: the legacy module-level draws — is flagged.
NP_SEED_ENTRY = frozenset(
    {
        "SeedSequence",
        "default_rng",
        "Generator",
        "BitGenerator",
        "PCG64",
        "PCG64DXSM",
        "Philox",
        "MT19937",
        "SFC64",
    }
)

#: path suffixes (posix) of modules exempt from rng-discipline: the
#: sanctioned draw-cache / seed-entry modules named by the contract.
#: Empty on purpose — world.py's ExpDrawCache and scenarios.py's salted
#: generators already satisfy the rule structurally (seeded
#: random.Random(seed) construction + caller-supplied rng parameters),
#: so no module needs a blanket exemption today. Add a suffix here only
#: with a comment naming the draw-cache it hosts.
RNG_MODULE_WHITELIST: tuple = ()

# ---------------------------------------------------------------------------
# purge-complete
# ---------------------------------------------------------------------------

#: only files under these directories hold long-lived per-host server
#: state; runtime/ and models/ are per-process training code.
PURGE_SCOPE_DIRS = ("core",)

#: a container attribute counts as purged if any function/method whose
#: name matches one of these fragments references it.
PURGE_PATH_NAMES = (
    "forget_host",
    "remove_host",
    "forget_volunteer",
    "purge",
    "churn",
    "detach",
    "clear",
    "evict",
    "reset",
)

#: variable names that identify a subscript key as a host id.
HOST_KEY_NAMES = frozenset({"host_id", "hid", "hostid", "host"})

#: attribute-name fragments that mark a container as host-keyed even
#: without subscript evidence.
HOST_NAME_FRAGMENT = "host"

#: classes that are per-tick ephemerals (rebuilt from scratch every
#: engine pass): their containers die with the tick, so churn cannot
#: leak through them. Listed by class name.
PURGE_EPHEMERAL_CLASSES = frozenset(
    {
        "ValidationPlan",  # batch_validate: one transitioner tick
        "WRRResult",  # client: one WRR simulation pass
    }
)

# ---------------------------------------------------------------------------
# parity-float
# ---------------------------------------------------------------------------

#: file-name patterns (fnmatch, basename) where the engine/oracle
#: bit-equality contract applies.
FLOAT_SCOPE_PATTERNS = ("batch_*.py", "world.py")

#: unordered numpy reductions (pairwise/tree summation — order differs
#: from the scalar loop's sequential fold).
FLOAT_BAD_NUMPY = frozenset({"sum", "mean", "prod", "average", "nansum", "nanmean", "nanprod"})

#: the order-mirroring alternatives the message recommends.
FLOAT_GOOD_FORMS = "np.add.reduce / np.minimum.reduce / np.bincount-style sequential folds"

# ---------------------------------------------------------------------------
# frozen-mut
# ---------------------------------------------------------------------------

#: frozen value classes that may be defined outside the scanned path set
#: (the scanner also auto-discovers @dataclass(frozen=True) definitions
#: in the scanned files and unions them in).
KNOWN_FROZEN_CLASSES = frozenset(
    {
        "ScenarioSpec",
        "TraceReplay",
        "Outage",
        "Clique",
        "Sybil",
        "CreditFarm",
        "DefensePolicy",
        "Platform",
    }
)

# ---------------------------------------------------------------------------
# index-bypass
# ---------------------------------------------------------------------------

#: IndexObserved-tracked field names. Keep in sync with
#: ``repro_torch.core.types.Job._TRACKED | JobInstance._TRACKED``
#: (tests/test_torch_reprolint.py asserts this equality).
TRACKED_FIELDS = frozenset(
    {
        "state",
        "transition_flag",
        "assimilated",
        "files_deleted",
        "deadline",
        "host_id",
        "outcome",
        "validate_state",
    }
)

#: path suffixes (posix) sanctioned to bypass the observer:
#:   * core/types.py — the IndexObserved mixin itself (its __setattr__
#:     terminates the observer chain with object.__setattr__);
#:   * core/store.py — the store's fused bulk writers
#:     (clear_transition_flags / finish_jobs / set_validate_states) and
#:     the _store wiring in submit_job/create_instance/purge_job, which
#:     update the indexes inline and are covered by check_invariants.
BYPASS_MODULE_WHITELIST = ("core/types.py", "core/store.py")
