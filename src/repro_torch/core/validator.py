"""Replication-based result validation (§3.4).

A job's successful instances are compared pairwise with an app-supplied
comparator (bitwise by default, fuzzy-numeric for stable numeric apps). If a
strict majority of a quorum agree, one member is designated the canonical
instance. Homogeneous redundancy restricts instances of one job to a single
host equivalence class so that bitwise comparison is meaningful; homogeneous
app version does the same at app-version granularity.

This module compares plain Python and NumPy payloads. The grid trainer's
gradient payloads stay on the card and are compared by its own comparator,
``repro_torch.runtime.grid_runtime.grad_comparator``, which counts with the
``quorum_compare`` CUDA kernel (``repro_torch.kernels.quorum_compare``).
"""
from __future__ import annotations

import itertools
import struct
from dataclasses import dataclass
from hashlib import blake2b
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .types import (
    App,
    InstanceOutcome,
    InstanceState,
    JobInstance,
    ValidateState,
)

Comparator = Callable[[Any, Any], bool]


# ---------------------------------------------------------------------------
# Comparators
# ---------------------------------------------------------------------------


def bitwise_equal(a: Any, b: Any) -> bool:
    """Byte-for-byte comparison (the validator BOINC supplies for apps using
    homogeneous redundancy)."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    for xa, xb in zip(la, lb):
        if isinstance(xa, np.ndarray) or isinstance(xb, np.ndarray):
            xa, xb = np.asarray(xa), np.asarray(xb)
            if xa.shape != xb.shape or xa.dtype != xb.dtype:
                return False
            if not np.array_equal(xa.view(np.uint8) if xa.dtype.kind == "f" else xa,
                                  xb.view(np.uint8) if xb.dtype.kind == "f" else xb):
                return False
        elif xa != xb:
            return False
    return True


def fuzzy_comparator(rtol: float = 1e-5, atol: float = 1e-8,
                     max_bad_fraction: float = 0.0) -> Comparator:
    """Application-specific fuzzy validator (§3.4): values agree within
    tolerances; optionally allow a small fraction of out-of-band elements
    (useful for bf16 gradient payloads where a handful of large-magnitude
    accumulations legitimately differ)."""

    def cmp(a: Any, b: Any) -> bool:
        la, lb = _leaves(a), _leaves(b)
        if len(la) != len(lb):
            return False
        total = 0
        bad = 0
        for xa, xb in zip(la, lb):
            xa = np.asarray(xa, dtype=np.float64)
            xb = np.asarray(xb, dtype=np.float64)
            if xa.shape != xb.shape:
                return False
            ok = np.isclose(xa, xb, rtol=rtol, atol=atol)
            total += ok.size
            bad += int(ok.size - np.count_nonzero(ok))
        if total == 0:
            return True
        return (bad / total) <= max_bad_fraction

    # Digest hook for the batch validation engine. A bad-fraction allowance
    # cannot be expressed as a per-payload digest (it is a property of a
    # *pair*), so those comparators stay on the scalar path.
    if max_bad_fraction == 0.0:
        cmp.digest_batch = lambda outputs: _fuzzy_digest_batch(outputs, rtol, atol)  # type: ignore[attr-defined]
        # tolerances, exposed so the jax validation backend can route
        # homogeneous tensor payloads through the quorum_compare Pallas
        # kernel with the same (rtol, atol) contract
        cmp.fuzzy_params = (rtol, atol)  # type: ignore[attr-defined]
    return cmp


def _leaves(x: Any) -> List[Any]:
    """Flatten nested dict/list/tuple payloads to a leaf list (stable order)."""
    if isinstance(x, dict):
        out: List[Any] = []
        for k in sorted(x):
            out.extend(_leaves(x[k]))
        return out
    if isinstance(x, (list, tuple)):
        out = []
        for v in x:
            out.extend(_leaves(v))
        return out
    return [x]


# ---------------------------------------------------------------------------
# Payload digests (batch validation engine)
# ---------------------------------------------------------------------------
#
# The batch engine replaces pairwise comparator calls with equivalence
# grouping over per-instance 64-bit digests: instances of one job with equal
# digests form one group. The digest contracts are:
#
#   * bitwise (comparator None): digests are an *exact* encoding of
#     ``bitwise_equal``'s equivalence — equal payloads share a digest and
#     unequal payloads differ (up to a 2^-64 hash-collision probability for
#     composite payloads; plain-float payloads use the raw IEEE bits, with
#     -0.0 canonicalized to +0.0 and each NaN given a unique sentinel to
#     mirror Python's ``==``).
#   * fuzzy (``fuzzy_comparator`` with ``max_bad_fraction == 0``): each
#     value is quantized to a bucket of width ``atol + rtol*|x|`` (the
#     ``np.isclose`` tolerance at that magnitude). Bucketing is coarser
#     than the pairwise comparator: digest grouping agrees with greedy
#     pairwise grouping **provided** a job's outputs either agree to well
#     within tolerance (same bucket) or disagree by far more than the
#     bucket width. Replicated numeric workloads satisfy this — honest
#     replicas agree to round-off while corruption is orders of magnitude
#     outside tolerance — and the scenario suite asserts oracle agreement.
#     Payloads containing NaN match nothing (``isclose`` semantics), so
#     they get unique sentinels.
#
# Payloads the digest functions cannot encode faithfully (exotic leaf
# types, or a comparator without a ``digest_batch`` hook) raise
# ``DigestError``; the engine then falls back to the scalar ``check_set``
# for that job, so correctness never depends on digest coverage. Digests
# also assume instances of one job use a *consistent payload structure*
# (same nesting/leaf kinds) — true for any real app, where one program
# produced every replica's output.


class DigestError(Exception):
    """Payload (or comparator) not expressible as an equivalence digest."""


_F64 = struct.Struct("<d")
#: int64 value of the 0x7FF8... quiet-NaN bit pattern: the base of the
#: unique-sentinel space. Canonicalized non-NaN floats can never land here.
_NAN_SENTINEL_BASE = struct.unpack("<q", _F64.pack(float("nan")))[0]
_nan_counter = itertools.count(1)


def _float_bits(x: float) -> int:
    """Canonical IEEE-754 bits of ``x`` as a Python int (two's complement):
    -0.0 folds into +0.0 (Python ``==`` semantics); NaN callers must handle
    separately."""
    return struct.unpack("<q", _F64.pack(x + 0.0))[0]


def _nan_sentinel() -> int:
    """A digest no other payload can share: NaN compares unequal even to
    itself under both comparators, so every NaN occurrence is its own
    group."""
    return int(_NAN_SENTINEL_BASE) + next(_nan_counter)


def _hash_digest(parts: List[bytes]) -> int:
    h = blake2b(digest_size=8)
    for p in parts:
        h.update(p)
    return int.from_bytes(h.digest(), "little", signed=True)


def _numeric_bits(v: Any) -> bytes:
    """Encode a scalar numeric leaf so Python ``==`` equivalence is
    preserved across int/float/bool mixes (1 == 1.0 == True)."""
    if isinstance(v, float):
        if v != v:  # NaN
            raise _UniqueDigest()
        return b"N" + _F64.pack(v + 0.0)
    try:
        f = float(v)
    except OverflowError:
        return b"I" + str(int(v)).encode()
    if f == v:
        return b"N" + _F64.pack(f + 0.0)
    return b"I" + str(int(v)).encode()


class _UniqueDigest(Exception):
    """Internal: payload matches nothing — assign a unique sentinel."""


def _bitwise_digest_one(out: Any) -> int:
    leaves = _leaves(out)
    try:
        if len(leaves) == 1 and isinstance(leaves[0], (bool, int, float)) \
                and not isinstance(leaves[0], np.ndarray):
            enc = _numeric_bits(leaves[0])
            if enc[:1] == b"N":
                return struct.unpack("<q", enc[1:])[0]
            return _hash_digest([enc])
        parts: List[bytes] = []
        for leaf in leaves:
            if isinstance(leaf, np.ndarray) or isinstance(leaf, np.generic):
                a = np.ascontiguousarray(leaf)
                parts.append(b"A" + a.dtype.str.encode() + repr(a.shape).encode())
                parts.append(a.tobytes())
            elif isinstance(leaf, (bool, int, float)):
                parts.append(_numeric_bits(leaf))
            elif isinstance(leaf, str):
                parts.append(b"S" + leaf.encode())
            elif isinstance(leaf, bytes):
                parts.append(b"B" + leaf)
            elif leaf is None:
                parts.append(b"Z")
            else:
                raise DigestError(f"unhashable leaf type {type(leaf).__name__}")
        return _hash_digest(parts)
    except _UniqueDigest:
        return _nan_sentinel()


def _homogeneous_arrays(outputs: Sequence[Any]) -> Optional[np.ndarray]:
    """Stack payloads that are all ndarrays of one dtype and shape (the
    typical tensor-result population) into an (n, size) matrix; None when
    the population is mixed."""
    first = outputs[0]
    if not (isinstance(first, np.ndarray) and first.ndim >= 1):
        return None
    dt, shp = first.dtype, first.shape
    for o in outputs:
        if not isinstance(o, np.ndarray) or o.dtype != dt or o.shape != shp:
            return None
    return np.stack(outputs).reshape(len(outputs), -1)


def bitwise_digest_batch(outputs: Sequence[Any]) -> np.ndarray:
    """Digests for ``bitwise_equal`` equivalence. Plain-float payloads (the
    emulator's common case) vectorize to raw IEEE bits; homogeneous ndarray
    payloads hash row-wise off one stacked matrix; anything else goes
    through an 8-byte blake2b per payload."""
    if all(type(o) is float for o in outputs):
        arr = np.asarray(outputs, dtype=np.float64) + 0.0  # -0.0 -> +0.0
        bits = arr.view(np.int64).copy()
        nan = np.isnan(arr)
        if nan.any():
            bits[nan] = [_nan_sentinel() for _ in range(int(nan.sum()))]
        return bits
    mat = _homogeneous_arrays(outputs)
    if mat is not None:
        # same framing as _bitwise_digest_one's single-ndarray case
        prefix = (
            b"A" + outputs[0].dtype.str.encode() + repr(outputs[0].shape).encode()
        )
        mat = np.ascontiguousarray(mat)
        rowbytes = mat.dtype.itemsize * mat.shape[1]
        buf = mat.view(np.uint8).reshape(mat.shape[0], rowbytes)
        out = np.empty(len(outputs), dtype=np.int64)
        for i in range(len(outputs)):
            h = blake2b(prefix, digest_size=8)
            h.update(buf[i].tobytes())
            out[i] = int.from_bytes(h.digest(), "little", signed=True)
        return out
    return np.array([_bitwise_digest_one(o) for o in outputs], dtype=np.int64)


def _quantize(x: np.ndarray, rtol: float, atol: float) -> np.ndarray:
    """Bucket code per element, injective across magnitudes.

    Two regimes, matching the ``np.isclose`` tolerance ``atol + rtol*|x|``:

      * ``|x| <= atol/rtol`` (atol-dominated): linear buckets of width
        ``atol`` — code ``round(x/atol)``, bounded by ``1/rtol``;
      * larger magnitudes (rtol-dominated): buckets of *ratio* ``1+rtol``,
        i.e. width ``rtol`` in log space — code derived from
        ``round(ln|x|/rtol)``, sign-extended and offset clear of the
        linear range. (A naive ``round(x/width(x))`` saturates at
        ``1/rtol`` for large ``x`` and would merge distinct magnitudes.)

    ±inf keep their sign (``isclose`` treats equal infinities as close);
    NaN is handled by the caller. Codes stay integral below 2^53, which
    bounds the usable tolerance at roughly ``rtol >= 1e-12``.
    """
    if rtol <= 0.0:
        w = atol if atol > 0.0 else 1.0
        return np.round(x / w)
    cutoff = atol / rtol
    ax = np.abs(x)
    lin = ax <= cutoff  # x == 0 lands here (its own bucket when atol == 0)
    code = np.empty(x.shape, dtype=np.float64)
    nlog = ~lin  # ±inf and NaN land here (NaN propagates; callers sentinel it)
    if lin.any():
        code[lin] = np.round(x[lin] / atol) if atol > 0.0 else 0.0
    if nlog.any():
        # log-space buckets, shifted positive and offset past the linear
        # range: ln|x| >= ln(5e-324) > -746, so k + 746/rtol >= ~1/rtol > 0
        # and |code| >= 1024/rtol > 1/rtol + 1 > any linear code. ±inf
        # propagate through log/round/sign and keep their own buckets.
        xs = x[nlog]
        k = np.round(np.log(np.abs(xs)) / rtol) + 746.0 / rtol
        code[nlog] = np.sign(xs) * (1024.0 / rtol + k)
    return code


def _bucket_bits(q: np.ndarray) -> np.ndarray:
    """Fold float bucket indices into int64 digests: exact int64 when small,
    raw float bits for huge magnitudes (disjoint ranges)."""
    out = np.zeros(q.shape, dtype=np.int64)
    small = np.abs(q) < 2.0**62
    out[small] = q[small].astype(np.int64)
    big = ~small
    if big.any():
        out[big] = np.ascontiguousarray(q[big]).view(np.int64)
    return out


def _fuzzy_digest_one(out: Any, rtol: float, atol: float) -> int:
    leaves = _leaves(out)
    parts: List[bytes] = []
    for leaf in leaves:
        a = np.asarray(leaf, dtype=np.float64)
        if np.isnan(a).any():
            return _nan_sentinel()
        q = _quantize(a, rtol, atol)
        if len(leaves) == 1 and a.ndim == 0 and np.isfinite(a):
            return int(_bucket_bits(q.reshape(1))[0])
        parts.append(b"F" + repr(a.shape).encode())
        parts.append(np.ascontiguousarray(q).tobytes())
    return _hash_digest(parts)


_mix_cache: dict = {}


def _mix_vector(d: int) -> np.ndarray:
    """Fixed odd int64 multipliers for the row linear hash, derived by
    hashing the column index (blake2b, keyed) — deterministic constants
    with no RNG namespace involved, so the rng-discipline contract (no
    draws outside seeded entry points) holds trivially. Only pairwise
    independence-ish mixing is needed: equal bucket rows always collide,
    distinct rows collide with probability ~2^-64 for *any* fixed odd
    multipliers without structure, which keyed blake2b provides."""
    r = _mix_cache.get(d)
    if r is None:
        raw = b"".join(
            blake2b(i.to_bytes(8, "little"), digest_size=8, key=b"reprolint-mix").digest()
            for i in range(d)
        )
        r = np.frombuffer(raw, dtype="<i8").astype(np.int64) | np.int64(1)
        _mix_cache[d] = r
    return r


def _fuzzy_digest_batch(outputs: Sequence[Any], rtol: float, atol: float) -> np.ndarray:
    if all(type(o) is float for o in outputs):
        arr = np.asarray(outputs, dtype=np.float64)
        dig = _bucket_bits(_quantize(arr, rtol, atol))
        nan = np.isnan(arr)
        if nan.any():
            dig[nan] = [_nan_sentinel() for _ in range(int(nan.sum()))]
        return dig
    mat = _homogeneous_arrays(outputs)
    if mat is not None:
        return _fuzzy_digest_matrix(mat, rtol, atol)
    return np.array(
        [_fuzzy_digest_one(o, rtol, atol) for o in outputs], dtype=np.int64
    )


def _fuzzy_digest_matrix(mat: np.ndarray, rtol: float, atol: float) -> np.ndarray:
    """Fused bucket digests for a homogeneous (n, d) payload matrix.

    Relative (rtol) quantization is a mantissa truncation: keeping the top
    ``m ≈ -log2(rtol)`` mantissa bits buckets values by sign/exponent/
    leading-mantissa — relative bucket width ~2^-m, i.e. the isclose rtol
    band within a small constant factor, in one shift over the raw IEEE
    bits (no log calls, and float32 payloads never widen to float64). The
    atol-dominated band ``|x| <= atol/rtol`` is patched with linear
    ``round(x/atol)`` buckets (this also folds ±0.0 together). Rows then
    collapse through a wraparound-int64 linear hash: equal bucket rows ⇔
    equal digest; distinct rows collide with probability ~2^-64. NaN rows
    get unique sentinels (isclose: NaN matches nothing); ±inf keep their
    (signed) bit patterns and group by equal-inf layout.
    """
    n, d = mat.shape
    if mat.dtype == np.float32:
        bits = mat.view(np.int32)
        mant = 23
    elif mat.dtype == np.float64:
        bits = mat.view(np.int64)
        mant = 52
    else:
        mat = mat.astype(np.float64)
        bits = mat.view(np.int64)
        mant = 52
    keep = 52 if rtol <= 0.0 else min(52, max(1, int(round(-np.log2(max(rtol, 2.0 ** -52))))))
    shift = max(0, mant - keep)
    q = (bits >> shift).astype(np.int64, copy=False)
    # linear patch for the atol-dominated band (covers x == ±0.0)
    cutoff = (atol / rtol) if rtol > 0.0 else np.inf
    lin = np.abs(mat) <= cutoff
    if lin.any():
        idx = np.flatnonzero(lin.reshape(-1))
        vals = mat.reshape(-1)[idx]
        patch = np.round(vals / atol) if atol > 0.0 else np.zeros(len(idx))
        # offset well past the shifted-bits code range so the two bucket
        # families cannot collide (|patch| <= 1/rtol << 2^52)
        q.reshape(-1)[idx] = patch.astype(np.int64) + (np.int64(1) << 61)
    r = _mix_vector(d)
    with np.errstate(over="ignore"):
        out = q @ r
    nan_rows = np.isnan(mat).any(axis=1)
    if nan_rows.any():
        for k in np.flatnonzero(nan_rows):
            out[int(k)] = _nan_sentinel()
    return out


def digest_batch_for(comparator: Optional[Comparator]):
    """The digest hook for an app comparator, or None when only the scalar
    path can evaluate it (custom comparators without a ``digest_batch``
    attribute, fuzzy comparators with a bad-fraction allowance)."""
    if comparator is None:
        return bitwise_digest_batch
    return getattr(comparator, "digest_batch", None)


# ---------------------------------------------------------------------------
# Quorum check (§3.4, §4)
# ---------------------------------------------------------------------------


@dataclass
class ValidationResult:
    canonical: Optional[JobInstance]
    valid: List[JobInstance]
    invalid: List[JobInstance]
    inconclusive: List[JobInstance]


def effective_quorum_size(
    group: Sequence[JobInstance], clusters: Dict[int, int]
) -> int:
    """Quorum votes of a group under work-spreading (§3.4 defense layer):
    replicas from hosts of one suspicion cluster collectively count as a
    single vote, so colluders can never validate each other by themselves.
    Unclustered hosts count individually."""
    seen: set = set()
    n = 0
    for i in group:
        cl = clusters.get(i.host_id) if i.host_id is not None else None
        if cl is None:
            n += 1
        elif cl not in seen:
            seen.add(cl)
            n += 1
    return n


def check_set(
    instances: Sequence[JobInstance],
    comparator: Optional[Comparator],
    min_quorum: int,
    clusters: Optional[Dict[int, int]] = None,
) -> ValidationResult:
    """Find a canonical instance among successful instances (§4).

    Groups instances into equivalence classes under ``comparator``; if a
    class forms a strict majority of the quorum set, its first member is
    canonical; members of that class are VALID, others INVALID. With fewer
    than ``min_quorum`` successes, everything is INCONCLUSIVE.

    **Grouping-order contract** (pinned; the batch engine and its tests
    rely on it). Fuzzy comparators are tolerance relations, not true
    equivalences — non-transitive chains (a~b, b~c, a!~c) make greedy
    grouping order-dependent. The canonical order is:

      1. instances are visited in the order given (the transitioner passes
         them in creation order — the ``JobStore._by_job`` row order);
      2. each instance joins the first existing group (groups in creation
         order) whose **representative** — the group's first member — it
         matches; members beyond the representative are never consulted;
      3. the winning group is the largest, ties broken by earliest group
         creation; its representative becomes canonical.

    So in the a~b, b~c, a!~c chain visited as [a, b, c]: b joins a's group,
    c is compared against a (the representative), fails, and opens its own
    group — {a, b}, {c}.

    With ``clusters`` (the defense layer's tick-start suspicion-cluster
    snapshot, host_id -> cluster id), quorum support is counted by
    :func:`effective_quorum_size` — same-cluster replicas are one vote —
    both for the quorum gate and for ranking the winning group (effective
    size first, then raw size, then creation order). Without clusters the
    behavior is bit-identical to the original.
    """
    cmp = comparator or bitwise_equal
    succ = [i for i in instances if i.outcome == InstanceOutcome.SUCCESS]
    if len(succ) < min_quorum:
        return ValidationResult(None, [], [], list(succ))

    # Greedy equivalence grouping (comparator assumed transitive in-tolerance).
    groups: List[List[JobInstance]] = []
    for inst in succ:
        placed = False
        for g in groups:
            if cmp(g[0].output, inst.output):
                g.append(inst)
                placed = True
                break
        if not placed:
            groups.append([inst])

    if clusters:
        eff = lambda g: effective_quorum_size(g, clusters)  # noqa: E731
        groups.sort(key=lambda g: (eff(g), len(g)), reverse=True)
    else:
        eff = len
        groups.sort(key=len, reverse=True)
    best = groups[0]
    # "a quorum of consistent instances" (§3.4/§4): the largest equivalent
    # group must reach min_quorum (for the min_quorum-sized initial set this
    # is exactly the paper's strict-majority-of-these condition; for larger
    # sets it is what terminates the repeat-until-quorum loop).
    if eff(best) >= min_quorum:
        canonical = best[0]
        valid = list(best)
        invalid = [i for g in groups[1:] for i in g]
        for i in valid:
            i.validate_state = ValidateState.VALID
        for i in invalid:
            i.validate_state = ValidateState.INVALID
        return ValidationResult(canonical, valid, invalid, [])

    for i in succ:
        i.validate_state = ValidateState.INCONCLUSIVE
    return ValidationResult(None, [], [], list(succ))


def validate_against_canonical(
    instance: JobInstance,
    canonical: JobInstance,
    comparator: Optional[Comparator],
) -> bool:
    """A straggler success reported after the canonical instance exists is
    validated against it (to grant credit) (§4)."""
    cmp = comparator or bitwise_equal
    ok = bool(cmp(canonical.output, instance.output))
    instance.validate_state = ValidateState.VALID if ok else ValidateState.INVALID
    return ok
