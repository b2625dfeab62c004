"""Hypothesis round trips on the port's service wire codec, and across the
two packages: every encodable request and reply decodes back to an equal
dataclass in the port, and the same message built in the reference encodes
to the same bytes and decodes from the port's.

NaN is left out of the drawn floats only because ``nan != nan`` breaks
dataclass equality; ``test_torch_service.py`` carries it explicitly. Every
search is seeded and keeps no example database.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as rcore  # noqa: E402
import repro.core.scheduler as rsched  # noqa: E402
import repro.service as rsvc  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CompletedResult,
    InstanceOutcome,
    ResourceRequest,
    ResourceType,
    ScheduleRequest,
)
from repro_torch.core.scheduler import TrickleUp  # noqa: E402
from repro_torch.service import (  # noqa: E402
    ErrorReply,
    JobOffer,
    PingRequest,
    PongReply,
    StatsReply,
    StatsRequest,
    WorkReply,
    WorkRequest,
    decode_reply,
    decode_request,
    encode_reply,
    encode_request,
)

seqs = st.integers(min_value=0, max_value=2**31)
ids = st.integers(min_value=1, max_value=2**40)
exits = st.integers(min_value=-2**31, max_value=2**31)
floats = st.floats(allow_nan=False)  # inf allowed: repr round-trips it
texts = st.text(max_size=40)

resource_requests = st.builds(ResourceRequest, floats, floats, floats)

completions = st.builds(
    CompletedResult,
    instance_id=ids,
    outcome=st.sampled_from(list(InstanceOutcome)),
    runtime=floats,
    peak_flop_count=floats,
    exit_code=exits,
)

trickles = st.builds(TrickleUp, instance_id=ids, fraction_done=floats)

schedule_requests = st.builds(
    ScheduleRequest,
    host_id=ids,
    requests=st.dictionaries(st.sampled_from(list(ResourceType)), resource_requests, max_size=3),
    completed=st.lists(completions, max_size=4),
    trickles=st.lists(trickles, max_size=3),
    sticky_files=st.lists(texts, max_size=3).map(tuple),
    usable_disk=floats,
)

requests = st.one_of(
    st.builds(PingRequest, seq=seqs),
    st.builds(StatsRequest, seq=seqs),
    st.builds(WorkRequest, seq=seqs, request=schedule_requests),
)

job_offers = st.builds(
    JobOffer,
    job_id=ids,
    instance_id=ids,
    version_id=ids,
    est_runtime=floats,
    est_flops=floats,
)

replies = st.one_of(
    st.builds(PongReply, seq=seqs),
    st.builds(
        WorkReply,
        seq=seqs,
        request_delay=floats,
        jobs=st.lists(job_offers, max_size=4),
        delete_sticky=st.lists(texts, max_size=3),
    ),
    st.builds(StatsReply, seq=seqs, values=st.dictionaries(texts, floats, max_size=4)),
    st.builds(
        ErrorReply,
        seq=seqs,
        code=st.text(alphabet="abcdefghijklmnopqrstuvwxyz-", min_size=1, max_size=16),
        message=texts,
    ),
)

SEEDED = settings(max_examples=300, deadline=None, derandomize=True, database=None)


def to_reference(msg):
    """The same message built from the reference's classes, field by field."""
    name = type(msg).__name__
    if name == "WorkRequest":
        r = msg.request
        return rsvc.WorkRequest(seq=msg.seq, request=rcore.ScheduleRequest(
            host_id=r.host_id,
            requests={rcore.ResourceType(rt.value): rcore.ResourceRequest(
                rr.req_runtime, rr.req_idle, rr.queue_dur) for rt, rr in r.requests.items()},
            completed=[rcore.CompletedResult(
                instance_id=c.instance_id, outcome=rcore.InstanceOutcome(c.outcome.value),
                runtime=c.runtime, peak_flop_count=c.peak_flop_count, exit_code=c.exit_code)
                for c in r.completed],
            trickles=[rsched.TrickleUp(instance_id=t.instance_id, fraction_done=t.fraction_done)
                      for t in r.trickles],
            sticky_files=tuple(r.sticky_files),
            usable_disk=r.usable_disk,
        ))
    if name == "WorkReply":
        return rsvc.WorkReply(seq=msg.seq, request_delay=msg.request_delay,
                              jobs=[rsvc.JobOffer(j.job_id, j.instance_id, j.version_id,
                                                  j.est_runtime, j.est_flops) for j in msg.jobs],
                              delete_sticky=list(msg.delete_sticky))
    if name == "StatsReply":
        return rsvc.StatsReply(seq=msg.seq, values=dict(msg.values))
    if name == "ErrorReply":
        return rsvc.ErrorReply(seq=msg.seq, code=msg.code, message=msg.message)
    return getattr(rsvc, name)(seq=msg.seq)


@SEEDED
@given(requests)
def test_request_roundtrip(req):
    wire = encode_request(req)
    assert "\n" not in wire
    assert decode_request(wire) == req


@SEEDED
@given(replies)
def test_reply_roundtrip(rep):
    wire = encode_reply(rep)
    assert "\n" not in wire
    assert decode_reply(wire) == rep


@SEEDED
@given(requests)
def test_request_crosses_packages(req):
    ref = to_reference(req)
    wire = encode_request(req)
    assert rsvc.encode_request(ref) == wire
    assert rsvc.decode_request(wire) == ref
    assert encode_request(decode_request(rsvc.encode_request(ref))) == wire


@SEEDED
@given(replies)
def test_reply_crosses_packages(rep):
    ref = to_reference(rep)
    wire = encode_reply(rep)
    assert rsvc.encode_reply(ref) == wire
    assert rsvc.decode_reply(wire) == ref
    assert encode_reply(decode_reply(rsvc.encode_reply(ref))) == wire
