"""The port's SSD scan against the reference's, on the CPU.

The plain chunked version (``repro_torch.kernels.ssd_scan.ref.ssd_scan_ref``,
which the ``ssd_scan`` op takes for a CPU tensor) is held against the
reference's Pallas kernel in interpret mode and against its sequential
oracle ``ssd_ref``, at the three shapes of ``tests/test_kernels.py`` (the
padding and group cases included), in f32 to 3e-4, the reference test's
tolerance. With an initial state it is held against the reference's
``ssd_chunked``. The CUDA kernel is held against the plain version on the
card in ``tests/test_torch_kernels.py`` (``gpu`` cases).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_scan_ref  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

# (b, s, h, p, g, n, block_q) — the sweep of tests/test_kernels.py
CASES = [
    (2, 256, 4, 64, 1, 64, 128),
    (1, 200, 8, 32, 2, 32, 64),  # padding path + groups
    (1, 128, 2, 16, 1, 128, 128),
]
TOL = 3e-4


def _inputs(seed, b, s, h, p, g, n):
    """The reference test's distributions, drawn with numpy."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.logaddexp(r.standard_normal((b, s, h)), 0.0) * 0.05 + 0.001).astype(np.float32)
    A = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    Cm = (r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want, tol=TOL, msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=msg)


@pytest.mark.parametrize("b,s,h,p,g,n,bq", CASES)
def test_plain_scan_matches_pallas_and_oracle(b, s, h, p, g, n, bq):
    arrs = _inputs(7, b, s, h, p, g, n)
    y, st = ssd_scan_ref(*map(torch.from_numpy, arrs), block_q=bq)
    jy, jst = j_ssd_scan(*map(jnp.asarray, arrs), block_q=bq, interpret=True)
    oy, ost = j_ssd_ref(*map(jnp.asarray, arrs))
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n) and st.dtype == torch.float32
    _close(y, jy, msg="y vs Pallas")
    _close(st, jst, msg="state vs Pallas")
    _close(y, oy, msg="y vs ssd_ref")
    _close(st, ost, msg="state vs ssd_ref")


@pytest.mark.parametrize("b,s,h,p,g,n,bq", CASES)
def test_sequential_oracle_matches_reference(b, s, h, p, g, n, bq):
    arrs = _inputs(3, b, s, h, p, g, n)
    y, st = ssd_ref(*map(torch.from_numpy, arrs))
    oy, ost = j_ssd_ref(*map(jnp.asarray, arrs))
    _close(y, oy, tol=1e-5)
    _close(st, ost, tol=1e-5)


@pytest.mark.parametrize("b,s,h,p,g,n,bq", CASES)
def test_initial_state_matches_ssd_chunked(b, s, h, p, g, n, bq):
    arrs = _inputs(11, b, s, h, p, g, n)
    init = (np.random.default_rng(5).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    jy, jst = j_ssd_chunked(*map(jnp.asarray, arrs), bq, jnp.asarray(init))
    y, st = ssd_chunked(*map(torch.from_numpy, arrs), bq, torch.from_numpy(init))
    _close(y, jy, msg="y")
    _close(st, jst, msg="state")
    # a scan from the state of a prefix equals the scan of the whole
    x, dt, A, Bm, Cm = map(torch.from_numpy, arrs)
    k = s // 3
    y0, s0 = ssd_scan_ref(x[:, :k], dt[:, :k], A, Bm[:, :k], Cm[:, :k], block_q=bq)
    y1, s1 = ssd_scan_ref(x[:, k:], dt[:, k:], A, Bm[:, k:], Cm[:, k:], block_q=bq,
                          initial_state=s0)
    yw, sw = ssd_scan_ref(x, dt, A, Bm, Cm, block_q=bq)
    torch.testing.assert_close(torch.cat([y0, y1], dim=1), yw, atol=TOL, rtol=TOL)
    torch.testing.assert_close(s1, sw, atol=TOL, rtol=TOL)


def test_result_does_not_depend_on_the_chunk():
    # the kernel picks its own chunk (32); the plain version takes block_q
    arrs = map(torch.from_numpy, _inputs(2, 1, 200, 8, 32, 2, 32))
    x, dt, A, Bm, Cm = arrs
    y, st = ssd_scan_ref(x, dt, A, Bm, Cm, block_q=256)
    for bq in (1, 16, 32, 64, 200):
        yq, sq = ssd_scan_ref(x, dt, A, Bm, Cm, block_q=bq)
        torch.testing.assert_close(yq, y, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(sq, st, atol=1e-5, rtol=1e-5)


def test_padding_is_a_no_op():
    # positions with dt = 0 leave the state alone: the final state of a
    # sequence padded with dt = 0 (and any x, B, C) is that of the sequence
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(4, 1, 40, 4, 16, 1, 16))
    y, st = ssd_scan_ref(x, dt, A, Bm, Cm, block_q=32)
    pad = lambda t: torch.cat([t, torch.randn((1, 9) + t.shape[2:])], dim=1)  # noqa: E731
    dtp = torch.cat([dt, torch.zeros((1, 9, 4))], dim=1)
    yp, sp = ssd_scan_ref(pad(x), dtp, A, pad(Bm), pad(Cm), block_q=32)
    torch.testing.assert_close(sp, st, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(yp[:, :40], y, atol=1e-6, rtol=1e-6)


def test_bf16_inputs_give_bf16_y_and_f32_state():
    arrs = _inputs(9, 1, 64, 4, 16, 1, 16)
    x, dt, A, Bm, Cm = map(torch.from_numpy, arrs)
    y, st = ssd_ops.ssd_scan(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), block_q=32)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y32, _ = ssd_scan_ref(x.bfloat16().float(), dt, A, Bm.bfloat16().float(), Cm.bfloat16().float(),
                          block_q=32)
    torch.testing.assert_close(y.float(), y32, atol=2e-2, rtol=2e-2)


def test_op_takes_the_plain_version_on_the_cpu():
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(1, 1, 50, 4, 16, 2, 8))
    launches = ssd_ops.launches
    y, st = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, block_q=16)
    wy, wst = ssd_scan_ref(x, dt, A, Bm, Cm, block_q=16)
    assert ssd_ops.launches == launches
    assert torch.equal(y, wy) and torch.equal(st, wst)
    # the plain version is differentiable on the CPU
    xg = x.clone().requires_grad_()
    ssd_ops.ssd_scan(xg, dt, A, Bm, Cm)[0].sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


def test_op_raises_off_the_cpu(monkeypatch):
    # off the CPU no plain version runs: a meta tensor (the dry run's) gets
    # outputs of the kernel's shapes and dtypes, and neither the plain
    # version nor a kernel is called
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version or a kernel ran off the CPU")

    for name in ("ssd_scan_ref", "ssd_chunk_states_ref", "ssd_scan_bwd_ref"):
        monkeypatch.setattr(ssd_ops, name, refuse)
    monkeypatch.setattr(ssd_ops._build, "entry", refuse)
    x = torch.empty((1, 8, 2, 4), device="meta")
    y, state = ssd_ops.ssd_scan(x, torch.empty((1, 8, 2), device="meta"), torch.empty((2,), device="meta"),
                                torch.empty((1, 8, 1, 4), device="meta"),
                                torch.empty((1, 8, 1, 4), device="meta"))
    assert (y.device.type, y.shape, y.dtype) == ("meta", (1, 8, 2, 4), torch.float32)
    assert (state.device.type, state.shape, state.dtype) == ("meta", (1, 2, 4, 4), torch.float32)

