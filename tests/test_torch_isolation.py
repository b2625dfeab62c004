"""The port stands alone: no module of ``repro_torch``, nor ``chip_smoke.py``,
imports JAX or the reference package, and no entry point runs on the CPU
unless asked to."""
import asyncio
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BatchClientEngine,
    BatchDispatchEngine,
    HostArrays,
    ProjectServer,
    ScenarioSpec,
    run_parity,
)
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.swiglu import ops as swiglu_ops  # noqa: E402
from repro_torch.models import init_cache, init_params, model_spec, params_from_jax  # noqa: E402
from repro_torch.runtime import BatchServer  # noqa: E402
from repro_torch.service import SchedulerService  # noqa: E402

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
    # every module of the package was walked: 69 with the SSM serving slice
    # (kernels.ssd_scan and its ops and ref, models.ssm, two configs), 75
    # with the MoE and MLA slice (models.moe, five configs), 78 with the
    # frontends (models.frontends, two configs), 83 with the engines
    # (data.traces, configs.boinc_sim, core.coordinator, core.scenarios,
    # core.torch_backend), 98 with the service and the lint (service: the
    # package, protocol, server, loadgen; analysis: the package, __main__,
    # astutil, config, engine, findings, floatops, frozen, observers, purge,
    # rng), 109 with the dry run (kernels._costs; distributed.sharding,
    # logical, roofline, hlo_costs, hlo_analysis; launch: the package, mesh,
    # dryrun, perf_iter, roofline_table), 111 with the sharded step
    # (kernels._sharded, distributed.dtensors)
    assert int(proc.stdout.split()[-1]) >= 111


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


def test_engines_raise_without_card():
    # the torch engine backend runs on "cuda" unless "cpu" is asked for;
    # the NumPy engines ignore the device
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the engines run on it")
    server = ProjectServer(name="p")
    for make in (lambda **kw: BatchDispatchEngine(server.store, server.feeder, backend="torch", **kw),
                 lambda **kw: BatchClientEngine(backend="torch", **kw),
                 lambda **kw: HostArrays(backend="torch", **kw),
                 lambda **kw: ProjectServer(name="q", engine_backend="torch",
                                            **{f"engine_{k}": v for k, v in kw.items()})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(device="cuda")
        make(device="cpu")  # asked for: runs
    assert BatchClientEngine(device="cuda").device is None  # NumPy: the device is ignored
    spec = ScenarioSpec(name="tiny", n_hosts=2, n_jobs=2, horizon=3600.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_parity(spec)
    full = run_parity(spec, device="cpu")
    assert full.server.engine_backend == "numpy" and full.sim.backend == "numpy"


def test_service_over_torch_engines_raises_without_card():
    # the service takes the project it is given: over the torch engines the
    # project wants the card unless "cpu" is asked for
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the engines run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerService(ProjectServer(name="s", engine_backend="torch"))
    svc = SchedulerService(ProjectServer(name="s", engine_backend="torch", engine_device="cpu"))

    async def ping():
        await svc.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)
            writer.write(b"PING 3\n")
            await writer.drain()
            line = await reader.readline()
            writer.close()
        finally:
            await svc.stop()
        return line

    assert asyncio.run(asyncio.wait_for(ping(), timeout=30)) == b"PONG 3\n"  # asked for: runs


def test_wrappers_take_no_plain_path_off_the_cpu(monkeypatch):
    # only a CPU tensor takes the plain version; a meta tensor (the dry run's)
    # gets outputs of the kernel's shapes and runs nothing, neither the plain
    # version nor a kernel
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version or a kernel ran off the CPU")

    for mod, names in ((rms_ops, ("rmsnorm_ref", "rmsnorm_bwd_ref")),
                       (swiglu_ops, ("swiglu_ref", "swiglu_bwd_ref")),
                       (ssd_ops, ("ssd_scan_ref", "ssd_chunk_states_ref", "ssd_scan_bwd_ref"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(rms_ops._build, "entry", refuse)
    x = torch.empty(2, 8, device="meta")
    out = rms_ops.rmsnorm(x, torch.ones(8, device="meta"))
    assert (out.device.type, out.shape) == ("meta", (2, 8))
    assert swiglu_ops.swiglu(x, x).shape == (2, 8)
    y, state = ssd_ops.ssd_scan(x.view(1, 2, 2, 4), x[0, :4].view(1, 2, 2), x[0, :2],
                                x.view(1, 2, 2, 4)[:, :, :1], x.view(1, 2, 2, 4)[:, :, :1])
    assert (y.device.type, y.shape, state.shape, state.dtype) == ("meta", (1, 2, 2, 4), (1, 2, 4, 4),
                                                                  torch.float32)
