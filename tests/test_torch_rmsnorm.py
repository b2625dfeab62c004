"""The rmsnorm kernels at every width the reference takes.

On the CPU: the backward's grid (``bwd_parts``) is a function of the shape
alone, never of the card. The plain versions at the wide shapes are held
against the reference in ``test_torch_kernels.py`` (``RMS_SHAPES``).

Cases marked ``gpu`` hold the CUDA kernels against their plain versions on
the card at the widths of ``chip_smoke.py``'s phase 2: the model widths
768-5120 and 12288, a width above what the registers hold (20000) and one
above what shared memory holds for the backward's dscale sums (60000), a
ragged width (1000, not a whole number of 16-byte vectors) and a base one
element into its buffer (both take the element-wide accesses); each call
raises its launch counter by one, and the backward gives the same bits on
every call::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_rmsnorm.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (rows, d): mamba2's model width and gated norm, zamba2's model width and
# gated norm at a 700-token prefill; phi4-mini's, pixtral's and
# command-r-plus's model widths; above the registers; above shared memory
WIDE_SHAPES = [(700, 768), (700, 1536), (700, 2048), (700, 4096), (300, 3072), (300, 5120),
               (300, 12288), (8, 20000), (2, 60000)]


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_bwd_grid_is_a_function_of_the_shape(monkeypatch):
    # the card is never asked: a replica on another card sums in the same order
    def no_card(*args, **kwargs):
        raise AssertionError("bwd_parts asked the card")

    for name in ("device_count", "get_device_properties", "get_device_capability", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    want = {(1, 1024): 1, (4, 1024): 4, (4096, 1024): 512, (65536, 128): 528, (32768, 128): 528,
            (4096, 2048): 256, (4096, 4096): 132, (300, 12288): 132, (2, 60000): 2}
    for (rows, d), parts in want.items():
        assert rms_ops.bwd_parts(rows, d) == parts == rms_ops.bwd_parts(rows, d)
    for rows in (1, 7, 300, 10 ** 6):
        for d in (1, 128, 1000, 4096, 20000, 10 ** 6):
            parts = rms_ops.bwd_parts(rows, d)
            assert 1 <= parts <= min(rows, rms_ops.BWD_MAX_PARTS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip(f"the kernels are built for sm_90a; card is {torch.cuda.get_device_name(0)}")
    return torch.device("cuda")


def _inputs(cuda, rows, d, dtype, misaligned=False):
    """x and dy of (rows, d) and an f32 scale; with ``misaligned``, x and dy
    start one element into their buffers (contiguous, not 16-byte aligned)."""
    def make(seed):
        flat = torch.from_numpy(_normal(seed, (rows * d + 1,))).to(cuda, TORCH_DT[dtype])
        return flat[1:].view(rows, d) if misaligned else flat[:-1].view(rows, d)

    return make(7), torch.from_numpy(_normal(1, (d,))).to(cuda), make(2)


CARD_CASES = ([(rows, d, False) for rows, d in WIDE_SHAPES]
              + [(700, 1000, False), (700, 1024, True), (65536, 128, True)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,misaligned", CARD_CASES)
def test_rmsnorm_on_card(cuda, rows, d, misaligned, dtype):
    x, sc, _ = _inputs(cuda, rows, d, dtype, misaligned)
    assert misaligned == (x.data_ptr() % 16 != 0)
    launches = rms_ops.launches
    out = rms_ops.rmsnorm(x, sc)
    torch.cuda.synchronize()
    assert rms_ops.launches == launches + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, sc).float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,misaligned", CARD_CASES)
def test_rmsnorm_bwd_on_card(cuda, rows, d, misaligned, dtype):
    x, sc, dy = _inputs(cuda, rows, d, dtype, misaligned)
    launches = rms_ops.launches_bwd
    dx, ds = rms_ops.rmsnorm_bwd(x, sc, dy)
    torch.cuda.synchronize()
    assert rms_ops.launches_bwd == launches + 1
    want_dx, want_ds = rmsnorm_bwd_ref(x, sc, dy)
    tol = BWD_TOL[dtype]
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=tol, rtol=tol)
    # dscale sums every row: f32 rounding grows with the row count
    torch.testing.assert_close(ds, want_ds, atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,dtype", [(4096, 1024, "bfloat16"), (65536, 128, "bfloat16"),
                                          (4096, 1024, "float32"), (300, 12288, "bfloat16"),
                                          (2, 60000, "float32"), (700, 1000, "bfloat16")])
def test_rmsnorm_bwd_is_bit_equal_across_calls(cuda, rows, d, dtype):
    # no float atomics: the grid trainer's quorum compares replicas'
    # gradients, so equal inputs must give equal bits
    x, sc, dy = _inputs(cuda, rows, d, dtype)
    first = rms_ops.rmsnorm_bwd(x, sc, dy)
    for _ in range(2):
        again = rms_ops.rmsnorm_bwd(x, sc, dy)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_rmsnorm_bwd_of_no_rows_is_zero(cuda):
    x = torch.empty((0, 1536), device=cuda, dtype=torch.bfloat16)
    dx, ds = rms_ops.rmsnorm_bwd(x, torch.ones(1536, device=cuda), x)
    assert dx.shape == (0, 1536) and torch.equal(ds, torch.zeros(1536, device=cuda))
