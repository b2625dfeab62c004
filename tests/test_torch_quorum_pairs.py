"""The batched digest grouping against the per-pair greedy, on the CPU.

- ``quorum_pair_counts_ref`` (the pair-count kernel's plain version, which
  ``quorum_pair_counts`` takes for a CPU tensor) equals, pair for pair, the
  port's ``quorum_compare_ref`` count and the reference's
  ``repro.kernels.quorum_compare.ref.quorum_compare_ref`` count, with the
  earlier row as ``b``; its blocks over i and r rows give the same counts
  at any block size;
- the port's ``quorum_group_codes`` (one pair-count call and one host copy
  a panel) equals the reference's ``repro.core.jax_backend``
  ``quorum_group_codes`` (its Pallas kernel in interpret mode, one pair at
  a time) code for code, NaN sentinels compared as distinct and increasing
  in row order: on the digest matrices of ``tests/test_torch_engines.py``
  and off the digest contract (elements exactly at ``atol + rtol*|b|``, a
  pair that agrees under one row's tolerance and not the other's, chains
  that the greedy order decides, +-inf and -0.0, n = 1 and 2, d = 1, more
  rows than one panel); and it equals the per-pair loop it replaced on
  seeded hypothesis searches (``derandomize=True, database=None``).

The pair-count kernel itself is held against this plain version on the card
by ``tests/test_torch_kernels.py`` (``gpu``) and ``chip_smoke.py`` phase 26.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.jax_backend import quorum_group_codes as j_quorum_group_codes  # noqa: E402
from repro.kernels.quorum_compare.ref import quorum_compare_ref as j_quorum_compare_ref  # noqa: E402
from repro_torch.core import torch_backend  # noqa: E402
from repro_torch.core.torch_backend import quorum_group_codes  # noqa: E402
from repro_torch.kernels.quorum_compare import ops as quorum_ops  # noqa: E402
from repro_torch.kernels.quorum_compare import ref as quorum_ref  # noqa: E402
from repro_torch.kernels.quorum_compare.ref import (  # noqa: E402
    quorum_compare_ref,
    quorum_pair_counts_ref,
)
from test_torch_engines import _digest_matrix  # noqa: E402

CPU = torch.device("cpu")
F32 = np.float32


def per_pair_codes(mat, rtol, atol):
    """The grouping ``quorum_group_codes`` ran before its pair counts: each
    row against each representative in founding order, one
    ``quorum_compare`` (here its plain version) a pair."""
    rows = torch.from_numpy(mat).to(torch.float32)
    codes = np.zeros(mat.shape[0], dtype=np.int64)
    reps = []
    nan_rows = np.isnan(mat).any(axis=1)
    for i in range(mat.shape[0]):
        if nan_rows[i]:
            codes[i] = mat.shape[0] + i  # a sentinel: past every group code, in row order
            continue
        for g, r in enumerate(reps):
            if int(quorum_ops.quorum_compare(rows[i], rows[r], rtol=rtol, atol=atol)[0]) == 0:
                codes[i] = g
                break
        else:
            reps.append(i)
            codes[i] = len(reps) - 1
    return codes


def assert_same_codes(got, want, mat):
    """Equal codes on the rows without NaN; on the NaN rows, sentinels that
    no other row shares, increasing in row order, in both."""
    nan = np.isnan(mat).any(axis=1)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    for codes in (got, want):
        sentinels = codes[nan]
        assert (np.diff(sentinels) > 0).all()
        assert not set(sentinels.tolist()) & set(codes[~nan].tolist())


def assert_codes_match_reference(mat, rtol, atol):
    got = quorum_group_codes(mat, rtol, atol, CPU)
    assert got.dtype == np.int64 and got.shape == (mat.shape[0],)
    assert_same_codes(got, j_quorum_group_codes(mat, rtol, atol), mat)
    return got


# ---------------------------------------------------------------------------
# matrices off the digest contract (f32 values, held in f64 as the engine's)
# ---------------------------------------------------------------------------

RTOL, ATOL = 1e-5, 1e-8


def _tol(b, rtol=RTOL, atol=ATOL):
    return F32(atol) + F32(rtol) * np.abs(b)


def _exactly_at(b, sign):
    """b moved by +-(atol + rtol*|b|) where some f32 neighbour of b + sign*tol
    lies at exactly that f32 distance from b, else b itself."""
    tol = _tol(b)
    out = b.copy()
    start = (b + sign * tol).astype(F32)
    for cand in (start, np.nextafter(start, F32(-np.inf)), np.nextafter(start, F32(np.inf))):
        hit = (np.abs(cand - b).astype(F32) == tol) & (out == b)
        out = np.where(hit, cand, out)
    return out


def boundary_matrix():
    """Row 0 and replicas of it whose elements lie exactly at
    ``atol + rtol*|b|`` from it, above and below (they agree), or with one
    of those one f32 step further (they disagree)."""
    rng = np.random.default_rng(3)
    b = (rng.standard_normal(64) * np.logspace(-9, 3, 64)).astype(F32)
    at, below = _exactly_at(b, 1), _exactly_at(b, -1)
    moved = np.flatnonzero(at != b)
    assert moved.size >= 8 and (below != b).sum() >= 8, (moved.size, (below != b).sum())
    past = at.copy()
    past[moved[0]] = np.nextafter(at[moved[0]], F32(np.inf))
    return np.stack([b, at, past, below, past]).astype(np.float64)


def asymmetric_pair():
    """x = 0 and y a few f32 steps above atol: |x - y| <= atol + rtol*|y|
    (x agrees with y as b) but > atol + rtol*|x| (y disagrees with x as b)."""
    y = np.full(5, F32(ATOL), dtype=F32)
    for _ in range(3):
        y = np.nextafter(y, F32(np.inf))
    x = np.zeros(5, dtype=F32)
    assert (np.abs(x - y) <= _tol(y)).all() and (np.abs(x - y) > _tol(x)).all()
    return x.astype(np.float64), y.astype(np.float64)


def chain():
    """a ~ b and b ~ c, but a !~ c: which rows group depends on their order."""
    a = np.full(4, 10.0, dtype=F32)
    step = F32(0.6) * _tol(a)
    b, c = (a + step).astype(F32), (a + 2 * step).astype(F32)
    return a.astype(np.float64), b.astype(np.float64), c.astype(np.float64)


def test_the_constructed_matrices_are_what_they_claim():
    mat = boundary_matrix()
    assert per_pair_codes(mat, RTOL, ATOL).tolist() == [0, 0, 1, 0, 1]
    x, y = asymmetric_pair()
    assert per_pair_codes(np.stack([y, x]), RTOL, ATOL).tolist() == [0, 0]
    assert per_pair_codes(np.stack([x, y]), RTOL, ATOL).tolist() == [0, 1]
    a, b, c = chain()
    assert per_pair_codes(np.stack([a, b, c]), RTOL, ATOL).tolist() == [0, 0, 1]
    assert per_pair_codes(np.stack([b, a, c]), RTOL, ATOL).tolist() == [0, 0, 0]


def _off_contract_cases():
    x, y = asymmetric_pair()
    a, b, c = chain()
    inf = np.array([np.inf, 1.0, -np.inf, 0.0])
    fin = np.array([1e30, 1.0, -1e30, -0.0])
    zero = np.array([0.0, -0.0, 0.0, 5.0])
    nan = np.array([np.nan, 1.0, -np.inf, 0.0])
    return {
        "boundary": boundary_matrix(),
        "asymmetric_b_first": np.stack([y, x, y]),
        "asymmetric_a_first": np.stack([x, y, x, y]),
        "chain_abc": np.stack([a, b, c]),
        "chain_bac": np.stack([b, a, c]),
        "chain_acb": np.stack([a, c, b, c, a]),
        "inf_first": np.stack([inf, fin, inf, -inf]),
        "finite_first": np.stack([fin, inf, fin]),
        "signed_zeros_and_nan": np.stack([zero, -zero, nan, zero * 0.0, nan, -zero]),
        "one_row": np.ones((1, 7)),
        "one_nan_row": np.full((1, 3), np.nan),
        "two_rows_agree": np.stack([a, a]),
        "two_rows_differ": np.stack([a, a + 1.0]),
        "d_1": np.array([[1.0], [1.0 + 1e-6], [2.0], [np.nan], [2.0], [1.0]]),
    }


OFF_CONTRACT = _off_contract_cases()


@pytest.mark.parametrize("seed", range(12))
def test_codes_match_reference_on_digest_matrices(seed):
    mat, rtol, atol = _digest_matrix(seed)
    assert_codes_match_reference(mat, rtol, atol)


@pytest.mark.parametrize("name", sorted(OFF_CONTRACT))
def test_codes_match_reference_off_the_digest_contract(name):
    mat = OFF_CONTRACT[name]
    got = assert_codes_match_reference(mat, RTOL, ATOL)
    assert_same_codes(got, per_pair_codes(mat, RTOL, ATOL), mat)


@pytest.mark.parametrize("entries", [1, 7, 64])
def test_codes_match_reference_over_several_panels(monkeypatch, entries):
    """PANEL_ENTRIES cut down so that an n-row matrix takes panels of
    max(1, entries // n) rows: one call a panel, the reference's codes."""
    monkeypatch.setattr(torch_backend, "PANEL_ENTRIES", entries)
    mats = [_digest_matrix(5)[0], OFF_CONTRACT["chain_acb"], OFF_CONTRACT["signed_zeros_and_nan"]]
    rng = np.random.default_rng(entries)
    base = rng.integers(-2, 3, size=(4, 6)).astype(np.float64)
    mats.append(base[rng.integers(0, 4, size=40)] + rng.choice([0.0, 1e-9, 1.0], size=(40, 6)))
    calls = []
    real = quorum_ops.quorum_pair_counts

    def counting(rows, lo, hi, **kw):
        calls.append((lo, hi))
        return real(rows, lo, hi, **kw)

    monkeypatch.setattr(quorum_ops, "quorum_pair_counts", counting)
    for mat in mats:
        calls.clear()
        assert_codes_match_reference(mat, RTOL, ATOL)
        n, step = mat.shape[0], max(1, entries // mat.shape[0])
        assert calls == [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def test_codes_take_one_pair_count_call_a_panel(monkeypatch):
    calls = []
    real = quorum_ops.quorum_pair_counts

    def counting(rows, lo, hi, **kw):
        calls.append((lo, hi))
        return real(rows, lo, hi, **kw)

    monkeypatch.setattr(quorum_ops, "quorum_pair_counts", counting)
    mat, rtol, atol = _digest_matrix(1)
    quorum_group_codes(mat, rtol, atol, CPU)
    assert calls == [(0, mat.shape[0])]  # the digests' n fits one panel


# a small alphabet of values makes ties, exact equalities and +-inf common
_VALUES = [0.0, -0.0, 1.0, 1.0 + 1e-6, 1.0 + 2e-5, -1.0, 1e30, np.inf, -np.inf, np.nan]


@st.composite
def _matrices(draw, max_n=40, max_d=64):
    n = draw(st.integers(1, max_n))
    d = draw(st.integers(1, max_d))
    n_base = draw(st.integers(1, 4))
    idx = st.integers(0, len(_VALUES) - 1)
    base = np.array([[_VALUES[draw(idx)] for _ in range(d)] for _ in range(n_base)])
    picks = draw(st.lists(st.integers(0, n_base - 1), min_size=n, max_size=n))
    mat = base[picks].copy()
    for _ in range(draw(st.integers(0, 4))):  # a few single-element edits
        mat[draw(st.integers(0, n - 1)), draw(st.integers(0, d - 1))] = _VALUES[draw(idx)]
    return mat


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(mat=_matrices(), entries=st.sampled_from([1, 50, 1 << 24]))
def test_codes_equal_the_per_pair_loop(mat, entries):
    old = torch_backend.PANEL_ENTRIES
    torch_backend.PANEL_ENTRIES = entries
    try:
        got = quorum_group_codes(mat, RTOL, ATOL, CPU)
    finally:
        torch_backend.PANEL_ENTRIES = old
    assert_same_codes(got, per_pair_codes(mat, RTOL, ATOL), mat)


@settings(max_examples=10, deadline=None, derandomize=True, database=None)
@given(mat=_matrices(max_n=12, max_d=8))
def test_codes_match_reference_on_searched_matrices(mat):
    assert_codes_match_reference(mat, RTOL, ATOL)


# ---------------------------------------------------------------------------
# pair counts against both packages' per-pair plain versions
# ---------------------------------------------------------------------------


def _count_matrices():
    rng = np.random.default_rng(11)
    dense = rng.standard_normal((9, 13)).astype(F32)
    dense[4] = dense[1] + F32(1e-7)
    dense[6, ::2] = np.nan
    dense[7] = dense[2]
    dense[7, 0] = np.inf
    dense[8] = -0.0
    return {
        "dense": dense,
        "boundary": boundary_matrix().astype(F32),
        "inf_and_zeros": np.stack([OFF_CONTRACT["inf_first"][i] for i in range(4)]
                                  + [OFF_CONTRACT["signed_zeros_and_nan"][i] for i in range(6)]
                                  ).astype(F32),
        "d_1": OFF_CONTRACT["d_1"].astype(F32),
        "d_0": np.zeros((4, 0), dtype=F32),
    }


COUNT_MATRICES = _count_matrices()


@pytest.mark.parametrize("tol", [(1e-5, 1e-8), (1e-3, 1e-2), (0.5, 0.0)])
@pytest.mark.parametrize("name", sorted(COUNT_MATRICES))
def test_pair_counts_equal_both_per_pair_counts(name, tol):
    rtol, atol = tol
    mat = COUNT_MATRICES[name]
    n = mat.shape[0]
    x = torch.from_numpy(mat)
    for lo, hi in ((0, n), (1, n), (n // 2, n), (0, n - 1), (n - 1, n)):
        counts = quorum_pair_counts_ref(x, lo, hi, rtol, atol)
        assert counts.dtype == torch.int32 and counts.shape == (hi - lo, hi)
        for i in range(lo, hi):
            for r in range(hi):
                got = int(counts[i - lo, r])
                if r >= i:
                    assert got == 0
                    continue
                want = int(quorum_compare_ref(x[i], x[r], rtol, atol)[0])
                j_want = int(float(j_quorum_compare_ref(jax.numpy.asarray(mat[i]),
                                                        jax.numpy.asarray(mat[r]), rtol, atol)[0]))
                assert got == want == j_want, (name, i, r)


def test_pair_counts_b_is_the_earlier_row():
    x, y = asymmetric_pair()
    for first, second, want in ((y, x, 0), (x, y, 5)):
        rows = torch.from_numpy(np.stack([first, second]).astype(F32))
        assert int(quorum_pair_counts_ref(rows, 0, 2, RTOL, ATOL)[1, 0]) == want


@pytest.mark.parametrize("block", [1, 7, 13 * 5, 1 << 23])
def test_pair_counts_are_the_same_at_any_block(monkeypatch, block):
    x = torch.from_numpy(COUNT_MATRICES["dense"])
    want = quorum_pair_counts_ref(x, 0, 9, 1e-3, 1e-2)
    monkeypatch.setattr(quorum_ref, "_PAIR_BLOCK", block)
    torch.testing.assert_close(quorum_pair_counts_ref(x, 0, 9, 1e-3, 1e-2), want, rtol=0, atol=0)
    torch.testing.assert_close(quorum_pair_counts_ref(x, 3, 7, 1e-3, 1e-2), want[3:7, :7],
                               rtol=0, atol=0)


def test_pair_counts_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(COUNT_MATRICES["dense"]).to(torch.bfloat16)
    before, before_pairs = quorum_ops.launches, quorum_ops.launches_pairs
    got = quorum_ops.quorum_pair_counts(x, 2, 8, rtol=1e-2, atol=1e-3)
    assert quorum_ops.launches == before and quorum_ops.launches_pairs == before_pairs
    torch.testing.assert_close(got, quorum_pair_counts_ref(x, 2, 8, 1e-2, 1e-3), rtol=0, atol=0)
    assert quorum_ops.quorum_pair_counts(x, 0, 9).shape == (9, 9)
    assert quorum_ops.quorum_pair_counts(x[:1], 0, 1).shape == (1, 1)


@pytest.mark.parametrize("args", [((5,), 0, 5), ((3, 4), 2, 1), ((3, 4), 0, 4), ((3, 4), -1, 2)])
def test_pair_counts_wrapper_rejects_what_it_does_not_take(args):
    shape, lo, hi = args
    with pytest.raises(ValueError):
        quorum_ops.quorum_pair_counts(torch.zeros(shape), lo, hi)
