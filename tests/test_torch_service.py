"""The port's scheduler service against the reference's (§5.1): the wire
codec byte for byte, every rejection code, and the asyncio service over the
port's project on the NumPy engines and on the torch engines (on the CPU).

The same messages are built in both packages and must encode to the same
bytes; a pipelined one-connection run must give the reference service's
reply frames, byte for byte.
"""
import asyncio
import math
import random

import pytest

pytest.importorskip("torch")

import repro.core as rcore  # noqa: E402
import repro.core.scheduler as rsched  # noqa: E402
import repro.service as rsvc  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.scheduler as tsched  # noqa: E402
import repro_torch.service as tsvc  # noqa: E402

OSES = ("windows", "mac", "linux")
TIMEOUT = 60.0  # seconds; every asyncio run is bounded
BACKENDS = {
    "numpy": {},
    "torch-cpu": {"engine_backend": "torch", "engine_device": "cpu"},
}


def run_bounded(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=TIMEOUT))


# ---------------------------------------------------------------------------
# codec: the reference test's examples, built in both packages
# ---------------------------------------------------------------------------


def _examples(core, sched, svc):
    """name -> [(kind, message)] of ``tests/test_service.py``'s codec
    examples, built from one package's classes."""
    RT, RR = core.ResourceType, core.ResourceRequest
    full = core.ScheduleRequest(
        host_id=42,
        requests={RT.CPU: RR(500.0, 1, 80.5), RT.GPU: RR(1000.0, 0, 0.0)},
        completed=[
            core.CompletedResult(instance_id=9, outcome=core.InstanceOutcome.SUCCESS,
                                 runtime=123.456, peak_flop_count=1e12, exit_code=0),
            core.CompletedResult(instance_id=10, outcome=core.InstanceOutcome.CLIENT_ERROR,
                                 exit_code=-9),
        ],
        trickles=[sched.TrickleUp(instance_id=9, fraction_done=0.25)],
        sticky_files=("a b.dat", "comma,colon:.bin", "uni⊕code"),
        usable_disk=5e11,
    )
    nonfinite = core.ScheduleRequest(
        host_id=1,
        requests={RT.CPU: RR(0.1 + 0.2, 1e-308, float("inf")),
                  RT.TPU: RR(float("-inf"), float("nan"), 5e-324)},
        usable_disk=-0.0,
    )
    return {
        "ping_stats": [("request", svc.PingRequest(seq=7)), ("request", svc.StatsRequest(seq=0)),
                       ("reply", svc.PongReply(seq=7)),
                       ("reply", svc.StatsReply(seq=3, values={"a b": 1.5}))],
        "work_request_full": [("request", svc.WorkRequest(seq=3, request=full))],
        "work_reply": [("reply", svc.WorkReply(seq=11, request_delay=6.5,
                                               jobs=[svc.JobOffer(1, 2, 3, 100.25, 1e12)],
                                               delete_sticky=["old file.dat"]))],
        "error_reply": [("reply", svc.ErrorReply(seq=0, code="bad-frame", message="what is this?"))],
        "float_fidelity_nonfinite": [("request", svc.WorkRequest(seq=1, request=nonfinite))],
        "empty_work": [("request", svc.WorkRequest(seq=2, request=core.ScheduleRequest(host_id=5))),
                       ("reply", svc.WorkReply(seq=2)), ("reply", svc.StatsReply(seq=9))],
    }


def _codec(svc, kind):
    if kind == "request":
        return svc.encode_request, svc.decode_request
    return svc.encode_reply, svc.decode_reply


def _same_nan(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("name", sorted(_examples(tcore, tsched, tsvc)))
def test_codec_examples_encode_to_the_reference_bytes(name):
    port = _examples(tcore, tsched, tsvc)[name]
    ref = _examples(rcore, rsched, rsvc)[name]
    for (kind, p_msg), (_, r_msg) in zip(port, ref, strict=True):
        p_enc, p_dec = _codec(tsvc, kind)
        r_enc, r_dec = _codec(rsvc, kind)
        wire = r_enc(r_msg)
        assert p_enc(p_msg) == wire
        # the reference's frame decodes in the port and re-encodes unchanged
        back = p_dec(wire)
        assert type(back).__name__ == type(p_msg).__name__
        assert p_enc(back) == wire
        if name != "float_fidelity_nonfinite":  # nan != nan: checked field by field below
            assert back == p_msg


def test_float_fidelity_and_nonfinite():
    # repr/float is the identity on doubles, inf, -0.0 and nan included
    (_, msg), = _examples(tcore, tsched, tsvc)["float_fidelity_nonfinite"]
    back = tsvc.decode_request(tsvc.encode_request(msg)).request
    for rt, rr in msg.request.requests.items():
        got = back.requests[rt]
        for a, b in ((got.req_runtime, rr.req_runtime), (got.req_idle, rr.req_idle),
                     (got.queue_dur, rr.queue_dur)):
            assert _same_nan(a, b) and str(a) == str(b)
    assert str(back.usable_disk) == "-0.0"


# The reference test's 24 malformed frames: 18 requests, 6 replies.
MALFORMED = [
    ("request", "", "bad-frame"),
    ("request", "PING", "bad-frame"),
    ("request", "PING x", "bad-int"),
    ("request", "NOPE 1", "bad-verb"),
    ("request", "PING 1 extra", "bad-field"),
    ("request", "STATS 1 v=1", "bad-field"),
    ("request", "WORK 1 host=1", "bad-field"),
    ("request", "WORK 1 disk=0.0", "bad-field"),
    ("request", "WORK 1 host=abc disk=0.0", "bad-int"),
    ("request", "WORK 1 host=1 disk=abc", "bad-float"),
    ("request", "WORK 1 host=1 disk=0.0 host=2", "bad-field"),
    ("request", "WORK 1 host=1 disk=0.0 bogus=3", "bad-field"),
    ("request", "WORK 1 host=1 disk=0.0 cpu=1.0:2.0", "bad-field"),
    ("request", "WORK 1 host=1 disk=0.0 done=", "bad-field"),
    ("request", "WORK 1 host=1 disk=0.0 done=1:2:3", "bad-field"),
    ("request", "WORK 1 host=1 disk=0.0 done=1:weird:0.0:0.0:0", "bad-field"),
    ("request", "WORK 1 host=1 disk=0.0 trickle=1", "bad-field"),
    ("request", "W" * (tsvc.MAX_LINE + 1), "too-long"),
    ("reply", "WAT 1", "bad-verb"),
    ("reply", "JOBS 1", "bad-field"),
    ("reply", "JOBS 1 delay=x", "bad-float"),
    ("reply", "JOBS 1 delay=0.0 job=1:2:3", "bad-field"),
    ("reply", "ERR 1 code", "bad-field"),
    ("reply", "PONG 1 extra", "bad-field"),
]


@pytest.mark.parametrize("kind,line,code", MALFORMED,
                         ids=[f"{k}-{i}" for i, (k, _, _) in enumerate(MALFORMED)])
def test_rejections_give_the_reference_codes(kind, line, code):
    with pytest.raises(rsvc.ProtocolError) as want:
        _codec(rsvc, kind)[1](line)
    with pytest.raises(tsvc.ProtocolError) as got:
        _codec(tsvc, kind)[1](line)
    assert (got.value.code, got.value.message) == (want.value.code, want.value.message)
    assert got.value.code == code


def test_max_line_and_exports_match():
    assert tsvc.MAX_LINE == rsvc.MAX_LINE
    assert tsvc.__all__ == rsvc.__all__


# ---------------------------------------------------------------------------
# the asyncio service over the port's project
# ---------------------------------------------------------------------------


def _make_project(core, n_sched=4, vector=True, cache_size=48, n_jobs=200, n_hosts=64, **kw):
    """The reference test's project, from either package's classes."""
    core.reset_ids()
    server = core.ProjectServer(name="svc", cache_size=cache_size, n_scheduler_instances=n_sched,
                                vector_dispatch=vector, **kw)
    app = core.App(name="a", min_quorum=1, init_ninstances=1)
    for osn in OSES:
        app.add_version(core.AppVersion(id=core.next_id("appver"), app_name="a",
                                        platform=core.Platform(osn, "x86_64"), version_num=1,
                                        plan_class=core.default_cpu_plan_class()))
    server.add_app(app)
    for _ in range(n_jobs):
        server.submit_job(core.Job(id=core.next_id("job"), app_name="a", est_flop_count=1e12), 0.0)
    CPU = core.ResourceType.CPU
    for i in range(n_hosts):
        server.add_host(core.Host(id=i + 1, platforms=(core.Platform(OSES[i % 3], "x86_64"),),
                                  resources={CPU: core.ProcessingResource(CPU, 4, 2e10)},
                                  volunteer_id=i + 1))
    server.tick(0.0)
    return server


@pytest.fixture(params=sorted(BACKENDS))
def backend(request):
    return BACKENDS[request.param]


class TestServiceRuns:
    def test_coalesced_load(self, backend):
        server = _make_project(tcore, **backend)

        async def main():
            svc = tsvc.SchedulerService(server, coalesce=True, max_batch=256)
            await svc.start()
            try:
                report = await tsvc.run_load("127.0.0.1", svc.port, n_clients=200, n_conns=16,
                                             host_ids=list(range(1, 65)))
            finally:
                await svc.stop()
            return report, svc.stats()

        report, stats = run_bounded(main())
        assert report.replies == report.requests == 200
        assert report.errors == 0
        assert report.jobs_received > 0
        assert stats["requests"] == 200
        assert stats["max_wave"] > 1
        assert stats["waves"] < 200
        shard_reqs = [row["requests"] for row in stats["shards"]]
        assert sum(shard_reqs) == 200
        assert all(r > 0 for r in shard_reqs)

    def test_sequential_baseline_mode(self, backend):
        server = _make_project(tcore, n_sched=1, vector=False, **backend)

        async def main():
            svc = tsvc.SchedulerService(server, coalesce=False)
            await svc.start()
            try:
                return await tsvc.run_load("127.0.0.1", svc.port, n_clients=30, n_conns=4)
            finally:
                await svc.stop()

        report = run_bounded(main())
        assert report.replies == 30
        assert report.errors == 0
        assert report.jobs_received > 0

    def test_ping_stats_and_error_frames_inline(self, backend):
        server = _make_project(tcore, n_sched=1, n_jobs=10, n_hosts=4, **backend)

        async def main():
            svc = tsvc.SchedulerService(server)
            await svc.start()
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)
                writer.write(b"PING 5\n")
                writer.write(b"this is not a frame\n")  # ERR, the connection survives
                writer.write(b"STATS 6\n")
                await writer.drain()
                lines = [await reader.readline() for _ in range(3)]
                writer.close()
            finally:
                await svc.stop()
            return [tsvc.decode_reply(line.decode().rstrip("\n")) for line in lines]

        pong, err, stats = run_bounded(main())
        assert pong == tsvc.PongReply(seq=5)
        assert isinstance(err, tsvc.ErrorReply) and err.code == "bad-int"
        assert isinstance(stats, tsvc.StatsReply)
        assert stats.values["errors"] == 1.0

    def test_too_long_frame_drops_the_connection(self, backend):
        # the frame one byte over the limit: ERR too-long, then EOF, in both
        # packages' services
        async def main(core, svc_mod, kw):
            svc = svc_mod.SchedulerService(_make_project(core, n_sched=1, n_jobs=4, n_hosts=2, **kw))
            await svc.start()
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)
                writer.write(b"PING 1\n" + b"W" * (svc_mod.MAX_LINE + 1) + b"\n")
                await writer.drain()
                lines = [await reader.readline() for _ in range(3)]
                writer.close()
            finally:
                await svc.stop()
            return lines

        got = run_bounded(main(tcore, tsvc, backend))
        assert got == run_bounded(main(rcore, rsvc, {}))
        assert got[0] == b"PONG 1\n"
        assert tsvc.decode_reply(got[1].decode().rstrip("\n")).code == "too-long"
        assert got[2] == b""  # dropped

    def test_work_frame_reports_completions(self, backend):
        # a done= report flows through the scheduler: the instance leaves
        # IN_PROGRESS, the reply still offers work, and both packages agree
        async def main(core, svc_mod, kw):
            server = _make_project(core, n_sched=2, n_jobs=40, n_hosts=8, **kw)
            svc = svc_mod.SchedulerService(server)
            await svc.start()
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)

                async def ask(seq, host_id, done=""):
                    line = f"WORK {seq} host={host_id} disk=1e+15 cpu=3000.0:1.0:0.0"
                    if done:
                        line += f" done={done}"
                    writer.write((line + "\n").encode())
                    await writer.drain()
                    return (await reader.readline()).decode().rstrip("\n")

                first = await ask(1, 2)
                inst = svc_mod.decode_reply(first).jobs[0].instance_id
                second = await ask(2, 2, done=f"{inst}:success:120.0:1e+12:0")
                writer.close()
            finally:
                await svc.stop()
            i = server.store.instances[inst]
            return [first, second], (inst, i.outcome.value, i.state.value, i.is_outstanding())

        frames, (inst_id, outcome, state, outstanding) = run_bounded(main(tcore, tsvc, backend))
        assert isinstance(tsvc.decode_reply(frames[1]), tsvc.WorkReply)
        assert not outstanding and outcome == "success"
        assert (frames, (inst_id, outcome, state, outstanding)) == run_bounded(main(rcore, rsvc, {}))


# ---------------------------------------------------------------------------
# exact: one pipelined connection, byte for byte against the reference
# ---------------------------------------------------------------------------


def _work_frames(svc_mod, core, n_hosts):
    CPU = core.ResourceType.CPU
    return [svc_mod.encode_request(svc_mod.WorkRequest(
        seq=i + 1, request=core.ScheduleRequest(
            host_id=i + 1, requests={CPU: core.ResourceRequest(req_runtime=1.0 + 97.0 * (i % 3))},
            usable_disk=1e12)))
        for i in range(n_hosts)]


async def _pipelined(svc_mod, server, frames, coalesce):
    """Send every frame at once over one connection; refill_every above the
    frame count, so no feeder refill falls between waves."""
    svc = svc_mod.SchedulerService(server, coalesce=coalesce, max_batch=1024,
                                   refill_every=len(frames) + 1)
    await svc.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)
        writer.write(("\n".join(frames) + "\n").encode())
        await writer.drain()
        got = [(await reader.readline()).decode().rstrip("\n") for _ in frames]
        writer.close()
    finally:
        await svc.stop()
    return got


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesced", "per-request"])
def test_pipelined_replies_equal_the_reference_service(backend, coalesce):
    frames = _work_frames(tsvc, tcore, 64)
    assert frames == _work_frames(rsvc, rcore, 64)
    want = run_bounded(_pipelined(rsvc, _make_project(rcore), frames, coalesce))
    got = run_bounded(_pipelined(tsvc, _make_project(tcore, **backend), frames, coalesce))
    assert got == want
    # and both equal the sequential rpc calls, the rpc_batch contract
    seq = _make_project(tcore, **backend)
    sequential = [tsvc.encode_reply(tsvc.reply_to_wire(i + 1, seq.rpc(tsvc.decode_request(f).request, 0.0)))
                  for i, f in enumerate(frames)]
    assert got == sequential
    assert sum("job=" in line for line in got) > 0


def test_any_wave_cut_gives_the_sequential_replies(backend):
    # the service's waves are cut by the event loop; without a refill between
    # them, rpc_batch over any cut must equal rpc per request in order
    frames = _work_frames(tsvc, tcore, 64)
    reqs = [tsvc.decode_request(f).request for f in frames]
    seq = _make_project(tcore, **backend)
    want = [tsvc.encode_reply(tsvc.reply_to_wire(i + 1, seq.rpc(r, 0.0))) for i, r in enumerate(reqs)]
    rng = random.Random(0)
    for _ in range(3):
        server, got, i = _make_project(tcore, **backend), [], 0
        while i < len(reqs):
            k = rng.choice([1, 2, 3, 7, 20, 64])
            got += server.rpc_batch(reqs[i:i + k], 0.0)
            i += k
        assert [tsvc.encode_reply(tsvc.reply_to_wire(j + 1, r)) for j, r in enumerate(got)] == want
