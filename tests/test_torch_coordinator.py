"""The port's coordinated VC model (§10.1, Science United) on the CPU: the
twin of ``tests/test_coordinator.py::TestCoordinator`` on the port's
``core.coordinator``, and the port's account-manager replies, balances and
assignments step for step equal to the reference's. (The reference file's
elastic case runs the JAX trainer and has no twin here.)"""
import pytest

pytest.importorskip("torch")

from repro.core import coordinator as j_coordinator  # noqa: E402
from repro.core import keywords as j_keywords  # noqa: E402
from repro_torch.core import AMReply, Coordinator, VettedProject  # noqa: E402
from repro_torch.core.keywords import KeywordPrefs  # noqa: E402


class TestCoordinator:
    def make(self):
        co = Coordinator()
        co.vet_project(VettedProject("einstein", keywords=("astrophysics",), share=2.0))
        co.vet_project(VettedProject("rosetta", keywords=("biomedicine",), share=1.0))
        co.vet_project(VettedProject("climate", keywords=("climate",), share=1.0))
        return co

    def test_no_keyword_never_assigned(self):
        co = self.make()
        co.register_volunteer(1, KeywordPrefs.make(no=["biomedicine"]))
        assert "rosetta" not in co.eligible_projects(1)

    def test_yes_keyword_preferred(self):
        co = self.make()
        co.register_volunteer(1, KeywordPrefs.make(yes=["physics"]))
        assert co.eligible_projects(1)[0] == "einstein"

    def test_am_rpc_attaches_and_switches(self):
        co = self.make()
        co.register_volunteer(1, KeywordPrefs())
        r1 = co.am_rpc(host_id=10, volunteer_id=1, now=100.0)
        assert isinstance(r1, AMReply)
        assert len(r1.attach) == 1
        seen = {r1.attach[0].name}
        for t in range(1, 40):
            r = co.am_rpc(10, 1, now=100.0 + t * 600.0, used_seconds=50_000.0)
            if r.attach:
                assert r.detach  # switching always detaches the old project
                seen.add(r.attach[0].name)
        assert len(seen) >= 2, "linear-bounded balances never rotated the host"
        assert all(a.total_used > 0 for a in co.allocator.accounts.values())

    def test_forget_host_purges_assignment(self):
        co = self.make()
        co.register_volunteer(1, KeywordPrefs())
        r = co.am_rpc(host_id=10, volunteer_id=1, now=0.0)
        project = r.attach[0].name
        assert 10 in co.attached_hosts(project)
        was = co.forget_host(10)
        assert was == project
        assert 10 not in co.assignments
        assert 10 not in co.attached_hosts(project)
        assert co.forget_host(10) is None
        assert co.forget_host(999) is None
        assert 1 in co.volunteer_prefs
        r2 = co.am_rpc(host_id=11, volunteer_id=1, now=0.0)
        assert r2.attach
        co.forget_volunteer(1)
        assert 1 not in co.volunteer_prefs

    def test_forget_host_rebalances_future_assignment(self):
        co = self.make()
        co.register_volunteer(1, KeywordPrefs())
        co.am_rpc(10, 1, now=0.0)
        co.am_rpc(10, 1, now=600.0, used_seconds=50_000.0)
        co.forget_host(10)
        assert co.assignments == {}
        r = co.am_rpc(20, 1, now=1200.0)
        assert r.attach and co.attached_hosts(r.attach[0].name) == [20]

    def test_guaranteed_share_before_any_volunteers(self):
        co = self.make()
        assert co.guaranteed_share("einstein") == pytest.approx(0.5)
        co.vet_project(VettedProject("new-project", keywords=("machine_learning",), share=4.0))
        assert co.guaranteed_share("new-project") == pytest.approx(0.5)

    def test_share_drives_long_term_assignment_mix(self):
        co = Coordinator()
        co.vet_project(VettedProject("big", keywords=("physics",), share=3.0))
        co.vet_project(VettedProject("small", keywords=("physics",), share=1.0))
        for v in range(20):
            co.register_volunteer(v, KeywordPrefs())
        counts = {"big": 0.0, "small": 0.0}
        now = 0.0
        for step in range(200):
            now += 600.0
            for host in range(20):
                co.am_rpc(host, host, now, used_seconds=600.0 / 20)
            for host, proj in co.assignments.items():
                counts[proj] += 1
        frac_big = counts["big"] / (counts["big"] + counts["small"])
        assert 0.55 <= frac_big <= 0.95  # ~3:1 share target, coarse check


def _drive(co_mod, kw_mod):
    """A mixed run of AM RPCs with usage, prefs, churn and a late project;
    every reply, the balances and the assignments as plain values."""
    co = co_mod.Coordinator()
    co.vet_project(co_mod.VettedProject("big", keywords=("physics",), share=3.0))
    co.vet_project(co_mod.VettedProject("small", keywords=("astrophysics",), share=1.0))
    co.vet_project(co_mod.VettedProject("bio", keywords=("biomedicine",), share=2.0))
    for v in range(12):
        prefs = (kw_mod.KeywordPrefs.make(no=["biomedicine"]) if v % 3 == 0 else
                 kw_mod.KeywordPrefs.make(yes=["physics"]) if v % 3 == 1 else kw_mod.KeywordPrefs())
        co.register_volunteer(v, prefs)
    out = []
    now = 0.0
    for step in range(60):
        now += 600.0
        if step == 20:
            co.vet_project(co_mod.VettedProject("late", keywords=("climate",), share=4.0))
        if step == 30:
            out.append(("forgot", co.forget_host(3)))
        for host in range(12):
            r = co.am_rpc(host, host, now, used_seconds=(host + 1) * 25.0)
            out.append(([(p.name, p.resource_share) for p in r.attach], list(r.detach)))
    out.append(sorted(co.assignments.items()))
    out.append(sorted((k, a.balance, a.total_used) for k, a in co.allocator.accounts.items()))
    out.append([co.guaranteed_share(p) for p in ("big", "small", "bio", "late")])
    return out


def test_coordinator_matches_reference_step_for_step():
    from repro_torch.core import coordinator, keywords

    assert _drive(coordinator, keywords) == _drive(j_coordinator, j_keywords)
