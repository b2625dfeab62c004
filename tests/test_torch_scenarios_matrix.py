"""The port's scenario layer against the reference's, on the CPU (part 2).

- The second half of the reference's scenario matrix by sorted name, each
  scenario through the reference's ``run_spec``, the port's NumPy
  ``run_spec`` and the port's ``run_spec(backend="torch", device="cpu")``,
  all three identical field by field (``test_torch_scenarios.py`` holds the
  first half; the matrix is split so that the halves run on two workers).
- The port's own ``run_parity`` (all four axes, the torch engines on the
  CPU) on three scenarios, its full run identical to the reference's.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_scenarios import SCENARIOS  # noqa: E402
from repro.core import scenarios as j_scen  # noqa: E402
from repro_torch.core import scenarios  # noqa: E402
from test_torch_scenarios import SECOND_HALF, assert_same, run_three, to_port  # noqa: E402


@pytest.mark.parametrize("name", SECOND_HALF)
def test_scenario_matrix_across_packages(name):
    spec, check = SCENARIOS[name]
    ref, _, _ = run_three(spec)
    check(ref)  # the reference's golden bounds, on the result all three share


@pytest.mark.parametrize("name", ["clique_small_fleet_defended", "cpu_gpu_mix", "trace_outage"])
def test_port_run_parity_all_four_axes(name):
    spec, check = SCENARIOS[name]
    full = scenarios.run_parity(to_port(spec), device="cpu")
    assert_same(full, j_scen.run_spec(spec), f"{name}: run_parity's full run vs reference")
    check(full)
