"""The port's reprolint against the reference's: the exact findings on the
fixture corpus, suppressions, the baseline ratchet, the CLI
(``python -m repro_torch.analysis``), and the live gate: the port's own tree
is clean with no baseline.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import run_checks as ref_run_checks  # noqa: E402
from repro_torch.analysis import ALL_RULES, RULE_CONTRACTS, dump_baseline, load_baseline, run_checks  # noqa: E402
from repro_torch.analysis import config as rlconfig  # noqa: E402

pytestmark = pytest.mark.lint

FIXTURES = Path(__file__).parent / "analysis_fixtures"
REPO_ROOT = Path(__file__).parent.parent
PORT_SRC = REPO_ROOT / "src" / "repro_torch"
FIXTURE_FILES = sorted(str(p.relative_to(FIXTURES)) for p in FIXTURES.rglob("*.py"))


def _rows(findings):
    return [(f.rule, f.path, f.line, f.col, f.symbol, f.message) for f in findings]


def rule_symbol_set(report):
    return {(f.rule, f.symbol) for f in report.findings}


def test_rules_and_contracts_match_the_reference():
    from repro.analysis import ALL_RULES as REF_RULES, RULE_CONTRACTS as REF_CONTRACTS

    assert ALL_RULES == REF_RULES
    assert RULE_CONTRACTS == REF_CONTRACTS


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_equal_the_reference(name):
    # every *_bad.py and *_clean.py twin and core/purge_*.py: the same
    # findings, suppressions and counts, to the column and the message
    path = str(FIXTURES / name)
    got, want = run_checks([path]), ref_run_checks([path])
    assert _rows(got.findings) == _rows(want.findings)
    assert _rows(got.suppressed) == _rows(want.suppressed)
    assert got.files_scanned == want.files_scanned == 1
    if name.endswith("_bad.py"):
        assert got.findings  # the rule is not vacuous
    if name.endswith("_clean.py"):
        assert got.findings == []


def test_whole_corpus_equals_the_reference():
    got, want = run_checks([str(FIXTURES)]), ref_run_checks([str(FIXTURES)])
    assert _rows(got.findings) == _rows(want.findings)
    assert {f.rule for f in got.findings} == set(ALL_RULES)


class TestRuleScopes:
    def test_purge_out_of_scope_without_core_segment(self):
        src = (FIXTURES / "core/purge_bad.py").read_text()
        with tempfile.TemporaryDirectory() as d:
            p = Path(d) / "purge_bad.py"
            p.write_text(src)
            assert run_checks([str(p)]).findings == []

    def test_float_scope_is_engine_files_only(self):
        src = (FIXTURES / "batch_float_bad.py").read_text()
        with tempfile.TemporaryDirectory() as d:
            p = Path(d) / "layers.py"
            p.write_text(src)
            assert run_checks([str(p)]).findings == []

    def test_frozen_symbols_fire_twice(self):
        syms = [f.symbol for f in run_checks([str(FIXTURES / "frozen_bad.py")]).findings]
        assert syms.count("LocalSpec.n_hosts") == 2
        assert syms.count("ScenarioSpec.seed") == 2

    def test_tracked_fields_config_matches_the_ports_types(self):
        from repro_torch.core.types import Job, JobInstance

        assert rlconfig.TRACKED_FIELDS == frozenset(Job._TRACKED | JobInstance._TRACKED)

    def test_store_module_is_whitelisted(self):
        assert run_checks([str(PORT_SRC / "core/store.py")]).findings == []

    def test_torch_backend_is_outside_the_float_scope(self):
        import fnmatch

        assert not any(fnmatch.fnmatch("torch_backend.py", pat) for pat in rlconfig.FLOAT_SCOPE_PATTERNS)


class TestSuppression:
    def test_inline_ignores(self):
        report = run_checks([str(FIXTURES / "suppressed_ok.py")])
        assert rule_symbol_set(report) == {("rng-discipline", "unsuppressed_draw:random.random")}
        assert {f.symbol for f in report.suppressed} == {
            "fixed_table:np.random.RandomState",
            "any_rule_jitter:random.uniform",
        }


class TestBaseline:
    def test_ratchet_roundtrip(self, tmp_path):
        bad = str(FIXTURES / "rng_bad.py")
        report = run_checks([bad])
        assert len(report.new) == 5 and not report.ok

        bl = tmp_path / "baseline.json"
        dump_baseline(str(bl), report.findings)
        report2 = run_checks([bad], baseline_path=str(bl))
        assert report2.ok
        assert len(report2.baselined) == 5 and report2.new == []

        report3 = run_checks([str(FIXTURES / "rng_clean.py")], baseline_path=str(bl))
        assert report3.ok and len(report3.stale_baseline) == 5

        entries = load_baseline(str(bl))
        assert all(e[1] == "rng-discipline" for e in entries)
        report4 = run_checks([str(FIXTURES / "observer_bad.py")], baseline_path=str(bl))
        assert not report4.ok and len(report4.new) == 3

    def test_baseline_keys_ignore_line_numbers(self, tmp_path):
        src = (FIXTURES / "rng_bad.py").read_text()
        p = tmp_path / "rng_bad.py"
        p.write_text(src)
        bl = tmp_path / "baseline.json"
        dump_baseline(str(bl), run_checks([str(p)]).findings)
        p.write_text("# a new comment shifting every line\n" + src)
        report = run_checks([str(p)], baseline_path=str(bl))
        assert report.ok and len(report.baselined) == 5

    def test_baseline_file_is_the_references_format(self, tmp_path):
        from repro.analysis import dump_baseline as ref_dump

        findings = run_checks([str(FIXTURES / "rng_bad.py")]).findings
        dump_baseline(str(tmp_path / "port.json"), findings)
        ref_dump(str(tmp_path / "ref.json"), findings)
        assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()


def run_cli(*args, cwd):
    """``python -m repro_torch.analysis`` in a subprocess."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args], capture_output=True,
                          text=True, env=env, cwd=str(cwd), timeout=120)


def cli(main, *args):
    """A CLI ``main`` run in this process: (exit code, stdout)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(args))
    return rc, out.getvalue()


class TestCLI:
    def test_exit_codes_and_report(self, tmp_path):
        report_file = tmp_path / "REPROLINT_report.json"
        r = run_cli(str(FIXTURES / "rng_bad.py"), "--no-baseline", "--report", str(report_file),
                    cwd=tmp_path)
        assert r.returncode == 1
        assert "rng-discipline" in r.stdout
        data = json.loads(report_file.read_text())
        assert data["tool"] == "reprolint" and not data["ok"]
        assert len(data["new"]) == 5
        assert set(data["rules"]) == set(ALL_RULES)

        r2 = run_cli(str(FIXTURES / "rng_clean.py"), "--no-baseline", cwd=tmp_path)
        assert r2.returncode == 0

    def test_usage_errors(self, tmp_path, capsys):
        from repro_torch.analysis.__main__ import main

        assert main([str(tmp_path / "missing.py")]) == 2
        assert "reprolint: error" in capsys.readouterr().err
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code == 2

    def test_fail_on_stale_enforces_shrink(self, tmp_path):
        from repro_torch.analysis.__main__ import main

        bl = tmp_path / "baseline.json"
        dump_baseline(str(bl), run_checks([str(FIXTURES / "rng_bad.py")]).findings)
        rc, out = cli(main, str(FIXTURES / "rng_clean.py"), "--baseline", str(bl), "--fail-on-stale")
        assert rc == 1 and "stale" in out
        rc2, _ = cli(main, str(FIXTURES / "rng_clean.py"), "--baseline", str(bl))
        assert rc2 == 0  # stale alone is a warning without the flag

    def test_default_baseline_is_the_ports_own(self, tmp_path, monkeypatch):
        # a reprolint_baseline.json in the working directory (the JAX
        # package's name) that grandfathers every finding: the reference's
        # CLI reads it, the port's does not; the port reads its own name
        from repro.analysis.__main__ import main as ref_main
        from repro_torch.analysis.__main__ import DEFAULT_BASELINE, main

        assert DEFAULT_BASELINE == "reprolint_torch_baseline.json"
        monkeypatch.chdir(tmp_path)
        bad = str(FIXTURES / "rng_bad.py")
        findings = run_checks([bad]).findings
        dump_baseline("reprolint_baseline.json", findings)
        assert cli(ref_main, bad)[0] == 0
        rc, out = cli(main, bad)
        assert rc == 1 and "0 baselined" in out
        dump_baseline(DEFAULT_BASELINE, findings)
        rc2, out2 = cli(main, bad)
        assert rc2 == 0 and "5 baselined" in out2
        assert cli(main, bad, "--no-baseline")[0] == 1

    def test_repo_root_cli_ignores_the_reference_baseline(self):
        # from the repository root, where reprolint_baseline.json lives, the
        # port's CLI scans its tree with no baseline and exits 0
        before = (REPO_ROOT / "reprolint_baseline.json").read_bytes()
        r = run_cli("src/repro_torch", cwd=REPO_ROOT)
        assert r.returncode == 0, r.stdout
        assert "0 new, 0 baselined" in r.stdout and "0 stale" in r.stdout
        assert (REPO_ROOT / "reprolint_baseline.json").read_bytes() == before


class TestLiveTree:
    def test_src_repro_torch_is_clean_without_a_baseline(self):
        report = run_checks([str(PORT_SRC)], root=str(REPO_ROOT))
        assert report.ok, "\n".join(f.format() for f in report.new)
        assert report.findings == [] and report.stale_baseline == []
        # the analyzer skips its own package, whose config spells every
        # forbidden form
        files = [p for p in PORT_SRC.rglob("*.py") if "__pycache__" not in p.parts]
        assert report.files_scanned == sum(1 for p in files if p.parent.name != "analysis")

    def test_engine_modules_stay_clean(self):
        # the batch engines and their torch backend carry the bit-equality
        # staging rules; the reference's fixed modules must stay fixed
        for mod in ("core/coordinator.py", "core/validator.py", "core/credit.py",
                    "core/batch_dispatch.py", "core/batch_client.py", "core/batch_validate.py",
                    "core/world.py", "core/torch_backend.py"):
            report = run_checks([str(PORT_SRC / mod)])
            assert report.ok, "\n".join(f.format() for f in report.new)
