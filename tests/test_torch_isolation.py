"""The port stands alone: no module of ``repro_torch``, nor ``chip_smoke.py``,
imports JAX or the reference package, and no entry point runs on the CPU
unless asked to."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.swiglu import ops as swiglu_ops  # noqa: E402
from repro_torch.models import init_cache, init_params, model_spec, params_from_jax  # noqa: E402
from repro_torch.runtime import BatchServer  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_imports_nothing_of_jax_or_repro():
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None    # any import of jax now raises
        sys.modules["repro"] = None  # and so does any import of the reference
        sys.path[:0] = [{os.path.join(ROOT, "src")!r}, {ROOT!r}]
        import repro_torch
        names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(len(names))
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the package was walked: 54 with the training slice
    # (core, data, optim, quorum_compare, grid_runtime)
    assert int(proc.stdout.split()[-1]) >= 54


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    cfg = get_smoke_config("qwen3-0.6b")
    params = init_params(torch.Generator().manual_seed(0), model_spec(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator().manual_seed(0), model_spec(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": params["final_norm"]["scale"].numpy()}, "cuda")
    BatchServer(cfg, params, device="cpu")  # asked for: runs


def test_wrappers_take_no_plain_path_off_the_cpu():
    # only a CPU tensor takes the plain version; any other device raises
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x, torch.ones(8, device="meta"))
    with pytest.raises(ValueError):
        swiglu_ops.swiglu(x, x)
