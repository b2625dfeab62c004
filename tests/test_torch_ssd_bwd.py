"""The port's plain SSD backward against autograd and the reference, on the CPU.

``ssd_scan_bwd_ref`` (``repro_torch.kernels.ssd_scan.ref``) is the chunked
backward written out stage by stage, the computation of the backward kernel
(``repro_ssd_scan_bwd`` in ``csrc/ssd_scan.cu``) and its oracle on the card.
Here, in f32, each of its six gradients (dx, ddt, dA, dB, dC and the initial
state's) is held to 3e-4 of that leaf's largest entry (the forward tests'
tolerance):

* against ``jax.vjp`` of the reference's ``ssd_chunked``
  (``repro.models.ssm``), the function the reference differentiates;
* against autograd of the port's plain forward ``ssd_scan_ref``;

at the three shapes of ``tests/test_torch_ssd.py`` and a ragged one (S = 50,
not a multiple of the chunk of 16, in two groups), each from a zero and from
a drawn initial state, with the final state's cotangent None and drawn.
Then: the result does not depend on the chunk, a None cotangent is zeros,
and the ``ssd_scan`` op on CPU tensors is autograd of the plain version (its
``ssd_scan_bwd`` the plain backward cast to the inputs' dtype), with no
launch counted. The CUDA kernel is held against ``ssd_scan_bwd_ref`` on the
card in ``tests/test_torch_kernels.py`` (``gpu`` cases).

Every input is drawn from a seeded numpy generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref  # noqa: E402

# (b, s, h, p, g, n, block_q): the CASES of tests/test_torch_ssd.py, then a
# ragged S (50 = 3 x 16 + 2) in two groups
SHAPES = [
    (2, 256, 4, 64, 1, 64, 128),
    (1, 200, 8, 32, 2, 32, 64),
    (1, 128, 2, 16, 1, 128, 128),
    (2, 50, 4, 8, 2, 6, 16),
]
TOL = 3e-4
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _inputs(seed, b, s, h, p, g, n):
    """The reference test's distributions, drawn with numpy."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.logaddexp(r.standard_normal((b, s, h)), 0.0) * 0.05 + 0.001).astype(np.float32)
    A = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    Cm = (r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _cotangents(seed, b, s, h, p, n, with_init, with_dstate):
    """dy, the final state's cotangent (None unless with_dstate) and the
    initial state (None unless with_init)."""
    r = np.random.default_rng(seed)
    dy = r.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = r.standard_normal((b, h, p, n)).astype(np.float32)
    init = (r.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    return dy, dstate if with_dstate else None, init if with_init else None


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _leaf_close(got, want, name, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=name)


CASES = [shape + (with_init, with_dstate) for shape in SHAPES
         for with_init in (False, True) for with_dstate in (False, True)]


@pytest.mark.parametrize("b,s,h,p,g,n,bq,with_init,with_dstate", CASES)
def test_plain_backward_matches_jax_vjp(b, s, h, p, g, n, bq, with_init, with_dstate):
    arrs = _inputs(13, b, s, h, p, g, n)
    dy, dstate, init = _cotangents(14, b, s, h, p, n, with_init, with_dstate)
    # the reference differentiated at its initial state, zeros where there is none
    j_init = jnp.asarray(init if with_init else np.zeros((b, h, p, n), np.float32))
    _, vjp = jax.vjp(lambda x, dt, A, Bm, Cm, st: j_ssd_chunked(x, dt, A, Bm, Cm, bq, st),
                     *map(jnp.asarray, arrs), j_init)
    want = vjp((jnp.asarray(dy), jnp.zeros((b, h, p, n), jnp.float32) if dstate is None
                else jnp.asarray(dstate)))
    got = ssd_scan_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), _t(dstate), _t(init),
                           block_q=bq)
    for name, gt, w in zip(GRADS, got, want):
        assert gt.dtype == torch.float32, name
        _leaf_close(gt, w, name)


@pytest.mark.parametrize("b,s,h,p,g,n,bq,with_init,with_dstate", CASES)
def test_plain_backward_matches_autograd(b, s, h, p, g, n, bq, with_init, with_dstate):
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(15, b, s, h, p, g, n))
    dy, dstate, init = map(_t, _cotangents(16, b, s, h, p, n, with_init, with_dstate))
    start = init if with_init else torch.zeros((b, h, p, n))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, start)]
    y, st = ssd_scan_ref(*leaves[:5], block_q=bq, initial_state=leaves[5])
    out = (y * dy).sum() + ((st * dstate).sum() if with_dstate else 0.0)
    want = torch.autograd.grad(out, leaves)
    got = ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate, init, block_q=bq)
    for name, gt, w in zip(GRADS, got, want):
        _leaf_close(gt, w, name)


def test_plain_backward_does_not_depend_on_the_chunk():
    # the kernel takes chunks of 64, the plain version block_q: only rounding differs
    arrs = map(torch.from_numpy, _inputs(21, 1, 200, 4, 16, 2, 16))
    x, dt, A, Bm, Cm = arrs
    dy, dstate, init = map(_t, _cotangents(22, 1, 200, 4, 16, 16, True, True))
    base = ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate, init, block_q=64)
    for bq in (16, 50, 256):
        got = ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate, init, block_q=bq)
        for name, gt, w in zip(GRADS, got, base):
            _leaf_close(gt, w.numpy(), f"{name} block_q={bq}", tol=1e-5)


def test_none_cotangent_and_start_are_zeros():
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(17, 1, 40, 4, 8, 2, 8))
    dy = torch.from_numpy(_cotangents(18, 1, 40, 4, 8, 8, False, False)[0])
    got = ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, block_q=16)
    zeros = torch.zeros((1, 4, 8, 8))
    again = ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, zeros, zeros, block_q=16)
    for name, gt, w in zip(GRADS, got, again):
        assert torch.equal(gt, w), name


def test_op_gradients_on_the_cpu_are_autograd_of_the_plain_version():
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(19, 1, 50, 4, 8, 2, 8))
    dy = torch.from_numpy(_cotangents(20, 1, 50, 4, 8, 8, False, False)[0])
    launches, launches_bwd = ssd_ops.launches, ssd_ops.launches_bwd
    grads = []
    for fn in (lambda *t: ssd_ops.ssd_scan(*t, block_q=16), lambda *t: ssd_scan_ref(*t, block_q=16)):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        grads.append(torch.autograd.grad(fn(*leaves)[0], leaves, dy))
    for name, got, want in zip(GRADS, *grads):
        assert torch.equal(got, want), name
    # the op's backward on CPU tensors is the plain backward
    got = ssd_ops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, block_q=16)
    for name, gt, w in zip(GRADS, got, ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, block_q=16)):
        assert torch.equal(gt, w), name
    assert (ssd_ops.launches, ssd_ops.launches_bwd) == (launches, launches_bwd)


def test_op_backward_on_the_cpu_casts_to_the_input_dtype():
    # dx, dB and dC in the inputs' dtype, the rest f32, as the kernel writes them
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(23, 1, 40, 4, 8, 2, 8))
    dy, dstate, init = map(_t, _cotangents(24, 1, 40, 4, 8, 8, True, True))
    bf = torch.bfloat16
    got = ssd_ops.ssd_scan_bwd(x.to(bf), dt, A, Bm.to(bf), Cm.to(bf), dy.to(bf), dstate, init, block_q=16)
    want = ssd_scan_bwd_ref(x.to(bf), dt, A, Bm.to(bf), Cm.to(bf), dy.to(bf), dstate, init, block_q=16)
    assert [t.dtype for t in got] == [bf, torch.float32, torch.float32, bf, bf, torch.float32]
    assert all(w.dtype == torch.float32 for w in want)
    for name, gt, w in zip(GRADS, got, want):
        assert torch.equal(gt, w.to(gt.dtype)), name
