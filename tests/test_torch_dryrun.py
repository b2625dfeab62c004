"""The port's dry run (``repro_torch.launch``) against the reference's
formulas: ``model_flops_for_cell`` in every (arch x shape) cell, the
roofline terms with the H100's constants in place of the TPU's, the
roofline table's layout, the dry run at full width on the meta device for
one cell of each family, and the production meshes, which it cannot run
on yet (``run_cell(..., multi_pod=True)`` and ``lower()`` past one device
raise).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import roofline as ref_roofline  # noqa: E402
from repro.launch import roofline_table as ref_table  # noqa: E402
from repro.models.config import get_shape as ref_get_shape  # noqa: E402
from repro.runtime.step_builder import model_flops_for_cell as ref_model_flops  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed.hlo_analysis import memory_analysis_dict  # noqa: E402
from repro_torch.distributed import roofline  # noqa: E402
from repro_torch.launch import roofline_table  # noqa: E402
from repro_torch.launch.dryrun import DRYRUN_MESH, run_cell  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, single_device_mesh  # noqa: E402
from repro_torch.launch.perf_iter import run_iteration  # noqa: E402
from repro_torch.models import init_cache, init_params, model_spec  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig, cell_supported, get_shape  # noqa: E402
from repro_torch.runtime import StepBundle, build_step, model_flops_for_cell  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
H100 = {"PEAK_FLOPS_BF16": roofline.PEAK_FLOPS_BF16, "HBM_BW": roofline.HBM_BW,
        "ICI_BW": roofline.ICI_BW, "DCN_BW": roofline.DCN_BW}


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch, shape):
    got = model_flops_for_cell(get_config(arch), get_shape(shape))
    assert got == ref_model_flops(ref_get_config(arch), ref_get_shape(shape))  # to the last bit


def test_h100_constants():
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.ICI_BW, roofline.DCN_BW) == (
        989.4e12, 3.35e12, 450e9, 50e9)
    assert roofline.PEAK_OPS == {"bfloat16": 989.4e12, "float32": 67e12}


TERMS = [
    dict(arch="a", shape="train_4k", mesh="1x1:data,model", chips=1, hlo_flops=7.0e15, hlo_bytes=5.4e13,
         collective_bytes=0.0, model_flops=3.75e15),
    dict(arch="b", shape="decode_32k", mesh="16x16:data,model", chips=256, hlo_flops=1.1e12,
         hlo_bytes=1.5e12, collective_bytes=3.0e11, model_flops=1.9e11),
    dict(arch="c", shape="prefill_32k", mesh="2x16x16:pod,data,model", chips=512, hlo_flops=2.6e17,
         hlo_bytes=1.1e14, collective_bytes=4.0e13, model_flops=2.2e17, pod_collective_bytes=1.0e13),
    dict(arch="d", shape="long_500k", mesh="1x1:data,model", chips=1, hlo_flops=0.0, hlo_bytes=0.0,
         collective_bytes=0.0, model_flops=0.0),
]


@pytest.mark.parametrize("fields", TERMS, ids=[t["arch"] for t in TERMS])
def test_roofline_terms_are_the_references_formulas(monkeypatch, fields):
    for name, value in H100.items():
        monkeypatch.setattr(ref_roofline, name, value)
    port, ref = roofline.RooflineTerms(**fields), ref_roofline.RooflineTerms(**fields)
    for prop in ("compute_s", "memory_s", "collective_s", "dominant", "step_time_s",
                 "useful_flops_fraction", "roofline_fraction"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.row() == ref.row() and port.render() == ref.render()


def _records():
    """Port dry-run records of three cells (two run, one skipped)."""
    return [run_cell("mamba2-130m", "long_500k", verbose=False),
            run_cell("qwen3-0.6b", "long_500k", verbose=False),
            run_cell("qwen3-0.6b", "decode_32k", verbose=False)]


def test_render_table_in_the_references_layout(monkeypatch):
    recs = _records()
    for name, value in H100.items():
        monkeypatch.setattr(ref_roofline, name, value)
    got = roofline_table.render_table(recs)
    # the port's records carry no collective bytes (one device); the
    # reference's reader takes the key
    ref_recs = [{**r, "collective_bytes": 0.0} if r["status"] == "ok" else r for r in recs]
    assert got == ref_table.render_table(ref_recs, mesh_filter="1x1")
    lines = roofline_table.render_table(recs, fits=True).splitlines()
    assert lines[0].endswith("| fits |") and lines[2].endswith("| yes |")
    assert lines[4].endswith("| no |")  # qwen3's 32k decode cache outgrows one card
    assert roofline_table.to_terms(recs[0]).render() == ref_table.to_terms(ref_recs[0]).render()


# one cell of each family at full width on the meta device
FAMILY_CELLS = [
    ("qwen3-0.6b", "decode_32k"),  # dense
    ("qwen3-0.6b", "long_500k"),  # dense: skipped
    ("llama4-scout-17b-a16e", "decode_32k"),  # moe
    ("minicpm3-4b", "decode_32k"),  # mla
    ("mamba2-130m", "long_500k"),  # ssm
    ("zamba2-1.2b", "long_500k"),  # hybrid
    ("pixtral-12b", "decode_32k"),  # vlm
    ("hubert-xlarge", "prefill_32k"),  # audio
    ("hubert-xlarge", "decode_32k"),  # audio: skipped
]


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_dry_run_cell_at_full_width(arch, shape):
    rec = run_cell(arch, shape, verbose=False)
    cfg, sh = get_config(arch), get_shape(shape)
    supported, why = cell_supported(cfg, sh)
    if not supported:
        assert rec == {"arch": arch, "shape": shape, "status": "skipped", "reason": why}
        return
    assert rec["status"] == "ok" and rec["mesh"] == "1x1:data,model" and rec["chips"] == 1
    assert rec["model_flops"] == model_flops_for_cell(cfg, sh)
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert not {"collective_bytes", "collectives", "while_trips"} & rec.keys()  # one device
    assert rec["kernels"] and all(k["calls"] > 0 and k["bound_s"] > 0 for k in rec["kernels"].values())
    mem = rec["memory_analysis"]
    assert rec["per_device_bytes"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert rec["fits"] == (rec["per_device_bytes"] <= rec["device_bytes"])
    assert rec["device_bytes"] == (roofline.HBM_BYTES if not torch.cuda.is_available()
                                   else torch.cuda.get_device_properties(0).total_memory)
    assert rec["step_time_s"] == max(rec["hlo_flops"] / roofline.PEAK_FLOPS_BF16,
                                     rec["hlo_bytes"] / roofline.HBM_BW)
    # decode: the cache is updated in place, and every layer's norms ran
    if sh.kind == "decode":
        assert mem["alias_size_in_bytes"] > 0
        assert rec["kernels"]["rmsnorm_fwd"]["calls"] >= cfg.n_layers


def test_dry_run_cli_writes_a_record(tmp_path):
    out = tmp_path / "dry.jsonl"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-130m",
                           "--shape", "decode_32k", "--json", str(out)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dry-run: 1 ok, 0 skipped, 0 failed" in proc.stdout
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["fits"] is True


def test_launch_modules_set_no_environment_variable():
    code = textwrap.dedent(
        f"""
        import os, sys
        sys.path.insert(0, {os.path.join(ROOT, "src")!r})
        before = dict(os.environ)
        import repro_torch.launch.dryrun, repro_torch.launch.perf_iter, repro_torch.launch.mesh
        import repro_torch.launch.roofline_table, repro_torch.distributed, repro_torch.runtime
        print(dict(os.environ) == before)
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "True"


def test_production_mesh_and_sharded_step_raise():
    # the production meshes and the dry run on them are Queue A 10b.2's
    for multi_pod in (False, True):
        with pytest.raises(NotImplementedError, match="10b.2"):
            make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(NotImplementedError, match="10b.2"):
        run_cell("qwen3-0.6b", "train_4k", True)  # the third parameter is multi_pod, as in the reference
    with pytest.raises(NotImplementedError, match="10b.2"):
        run_iteration("qwen3-0.6b", "train_4k", multi_pod=True, verbose=False)
    # the train step builds over a described mesh of 512 devices; lowering it is 10b.2's
    wide = type(DRYRUN_MESH)(("pod", "data", "model"), (2, 16, 16))
    bundle = build_step(get_config("qwen3-0.6b"), get_shape("train_4k"), wide)
    assert bundle.kind == "train" and bundle.rules.mesh_shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(NotImplementedError, match="10b.2"):
        bundle.lower()


def test_a_dry_run_mesh_is_lowered_not_run():
    bundle = build_step(get_config("qwen3-0.6b"), ShapeConfig("t", 16, 1, "decode"), DRYRUN_MESH)
    assert isinstance(bundle, StepBundle) and bundle.kind == "decode" and bundle.donated == (2,)
    with pytest.raises(ValueError, match="no device"):
        bundle(*bundle.in_specs)


def test_perf_iter_remat_direction():
    shape = ShapeConfig("train_2x2048", 2048, 2, "train")  # the activations outweigh AdamW here
    _, nothing, dev_n = run_iteration("qwen3-0.6b", shape, {"remat_policy": "nothing"}, verbose=False)
    _, dots, dev_d = run_iteration("qwen3-0.6b", shape, {"remat_policy": "dots"}, verbose=False)
    assert nothing.flops > dots.flops
    assert dev_n < dev_d  # per-device bytes, as the reference's: arguments + outputs - aliased + temp
    mem = memory_analysis_dict(build_step(get_config("qwen3-0.6b").scaled(remat_policy="dots"), shape,
                                          DRYRUN_MESH).lower())
    assert dev_d == (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                     - mem["alias_size_in_bytes"] + mem["temp_size_in_bytes"])


@pytest.mark.parametrize("donate", [True, False])
def test_a_step_updates_its_cache_in_place_unless_not_donated(donate):
    cfg = get_smoke_config("qwen3-0.6b")
    bundle = build_step(cfg, ShapeConfig("d", 16, 2, "decode"), single_device_mesh("cpu"), donate=donate)
    params = init_params(torch.Generator().manual_seed(0), model_spec(cfg), device="cpu")
    cache = init_cache(cfg, 2, 16, "cpu")
    logits, new_cache = bundle(params, torch.ones(2, 1, dtype=torch.int32), cache, 3)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    written = bool(cache["layers"]["k"][:, :, 3].abs().sum() > 0)
    assert written == donate and bool(new_cache["layers"]["k"][:, :, 3].abs().sum() > 0)
