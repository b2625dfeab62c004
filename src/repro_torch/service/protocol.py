"""Newline-delimited wire protocol for the scheduler service.

One request or reply per line, UTF-8, ``\\n``-terminated, at most
``MAX_LINE`` bytes.  Every frame starts with a verb and a client-chosen
sequence number; replies echo the sequence number so clients may pipeline
requests over a shared connection.

Grammar (``<f>`` = ``repr()`` of a Python float, ``<esc>`` = percent-escaped
string with no reserved bytes, lists comma-joined, optional keys omitted
when empty)::

    request  = "PING" SP seq
             | "STATS" SP seq
             | "WORK" SP seq SP "host=" int SP "disk=" <f>
               ["cpu=" rt:idle:qd] ["gpu=" ...] ["tpu=" ...]
               ["done=" inst:outcome:rt:pfc:exit ("," ...)*]
               ["trickle=" inst:frac ("," ...)*]
               ["sticky=" <esc> ("," <esc>)*]
    reply    = "PONG" SP seq
             | "JOBS" SP seq SP "delay=" <f>
               ["job=" jid:iid:vid:est_rt:est_flops ("," ...)*]
               ["del=" <esc> ("," <esc>)*]
             | "STATS" SP seq ["v=" <esc>:<f> ("," ...)*]
             | "ERR" SP seq SP code SP <esc>

Floats travel as ``repr()`` so round-trips are bit-exact (``repr``/``float``
is the identity on finite doubles, and ``inf``/``nan`` parse back).  The
codec deliberately carries only the fields the dispatch path consumes;
``keyword_prefs``, ``anonymous_versions`` and the opaque ``output`` /
``stderr`` / trickle payloads are out of scope for the wire format and keep
their dataclass defaults on decode.

Malformed frames raise :class:`ProtocolError`; the service answers them
with an ``ERR`` frame instead of dropping the connection.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple, Union
from urllib.parse import quote, unquote

from ..core.scheduler import (
    CompletedResult,
    ResourceRequest,
    ScheduleReply,
    ScheduleRequest,
    TrickleUp,
)
from ..core.types import InstanceOutcome, ResourceType

MAX_LINE = 64 * 1024

# Fixed encode order for the per-resource work-request keys.
_RESOURCE_KEYS: Tuple[ResourceType, ...] = (
    ResourceType.CPU,
    ResourceType.GPU,
    ResourceType.TPU,
)


class ProtocolError(Exception):
    """A frame the codec refuses; ``code`` is a short machine token."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


# ---------------------------------------------------------------------------
# Wire dataclasses
# ---------------------------------------------------------------------------


@dataclass
class PingRequest:
    seq: int


@dataclass
class StatsRequest:
    seq: int


@dataclass
class WorkRequest:
    seq: int
    request: ScheduleRequest


@dataclass
class PongReply:
    seq: int


@dataclass
class JobOffer:
    """One dispatched job as seen on the wire.  Replies cannot reconstruct
    the server-side ``Job``/``JobInstance`` objects, so the service flattens
    each ``DispatchedJob`` to the identifiers and estimates a client needs."""

    job_id: int
    instance_id: int
    version_id: int
    est_runtime: float
    est_flops: float


@dataclass
class WorkReply:
    seq: int
    request_delay: float = 0.0
    jobs: List[JobOffer] = field(default_factory=list)
    delete_sticky: List[str] = field(default_factory=list)


@dataclass
class StatsReply:
    seq: int
    values: Dict[str, float] = field(default_factory=dict)


@dataclass
class ErrorReply:
    seq: int
    code: str
    message: str


Request = Union[PingRequest, StatsRequest, WorkRequest]
Reply = Union[PongReply, WorkReply, StatsReply, ErrorReply]


def reply_to_wire(seq: int, reply: ScheduleReply) -> WorkReply:
    """Flatten a scheduler :class:`ScheduleReply` into its wire form."""
    return WorkReply(
        seq=seq,
        request_delay=reply.request_delay,
        jobs=[
            JobOffer(
                job_id=d.job.id,
                instance_id=d.instance.id,
                version_id=d.version.id,
                est_runtime=d.est_runtime,
                est_flops=d.est_flops,
            )
            for d in reply.jobs
        ],
        delete_sticky=list(reply.delete_sticky),
    )


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _ffmt(x: float) -> str:
    return repr(float(x))


def _esc(s: str) -> str:
    return quote(s, safe="")


def encode_request(req: Request) -> str:
    if isinstance(req, PingRequest):
        return f"PING {req.seq}"
    if isinstance(req, StatsRequest):
        return f"STATS {req.seq}"
    if isinstance(req, WorkRequest):
        r = req.request
        parts = [f"WORK {req.seq}", f"host={r.host_id}", f"disk={_ffmt(r.usable_disk)}"]
        for rt in _RESOURCE_KEYS:
            rr = r.requests.get(rt)
            if rr is not None:
                parts.append(
                    f"{rt.value}={_ffmt(rr.req_runtime)}:{_ffmt(rr.req_idle)}"
                    f":{_ffmt(rr.queue_dur)}"
                )
        if r.completed:
            parts.append(
                "done="
                + ",".join(
                    f"{c.instance_id}:{c.outcome.value}:{_ffmt(c.runtime)}"
                    f":{_ffmt(c.peak_flop_count)}:{c.exit_code}"
                    for c in r.completed
                )
            )
        if r.trickles:
            parts.append(
                "trickle="
                + ",".join(
                    f"{t.instance_id}:{_ffmt(t.fraction_done)}" for t in r.trickles
                )
            )
        if r.sticky_files:
            parts.append("sticky=" + ",".join(_esc(s) for s in r.sticky_files))
        return " ".join(parts)
    raise ProtocolError("bad-verb", f"cannot encode {type(req).__name__}")


def encode_reply(rep: Reply) -> str:
    if isinstance(rep, PongReply):
        return f"PONG {rep.seq}"
    if isinstance(rep, WorkReply):
        parts = [f"JOBS {rep.seq}", f"delay={_ffmt(rep.request_delay)}"]
        if rep.jobs:
            parts.append(
                "job="
                + ",".join(
                    f"{j.job_id}:{j.instance_id}:{j.version_id}"
                    f":{_ffmt(j.est_runtime)}:{_ffmt(j.est_flops)}"
                    for j in rep.jobs
                )
            )
        if rep.delete_sticky:
            parts.append("del=" + ",".join(_esc(s) for s in rep.delete_sticky))
        return " ".join(parts)
    if isinstance(rep, StatsReply):
        line = f"STATS {rep.seq}"
        if rep.values:
            line += " v=" + ",".join(
                f"{_esc(k)}:{_ffmt(v)}" for k, v in rep.values.items()
            )
        return line
    if isinstance(rep, ErrorReply):
        return f"ERR {rep.seq} {rep.code} {_esc(rep.message)}"
    raise ProtocolError("bad-verb", f"cannot encode {type(rep).__name__}")


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _parse_int(tok: str, what: str) -> int:
    try:
        return int(tok)
    except ValueError:
        raise ProtocolError("bad-int", f"{what}: {tok!r}") from None


def _parse_float(tok: str, what: str) -> float:
    try:
        return float(tok)
    except ValueError:
        raise ProtocolError("bad-float", f"{what}: {tok!r}") from None


def _split_frame(line: str) -> Tuple[str, int, List[str]]:
    if len(line) > MAX_LINE:
        raise ProtocolError("too-long", f"frame of {len(line)} bytes")
    toks = line.split(" ")
    if len(toks) < 2 or not toks[0]:
        raise ProtocolError("bad-frame", f"short frame: {line!r}")
    return toks[0], _parse_int(toks[1], "seq"), toks[2:]


def _kv_fields(toks: List[str], allowed: Tuple[str, ...]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for tok in toks:
        key, sep, val = tok.partition("=")
        if not sep or key not in allowed:
            raise ProtocolError("bad-field", f"unexpected token {tok!r}")
        if key in out:
            raise ProtocolError("bad-field", f"duplicate key {key!r}")
        out[key] = val
    return out


def _parse_list(val: str, what: str) -> List[str]:
    # "k=" is a one-element list holding the empty string (encoders omit
    # the key for genuinely empty lists), so splitting is lossless; items
    # that need structure get rejected downstream by _parse_cols
    return val.split(",")


def _parse_cols(item: str, n: int, what: str) -> List[str]:
    cols = item.split(":")
    if len(cols) != n:
        raise ProtocolError("bad-field", f"{what} wants {n} columns: {item!r}")
    return cols


def decode_request(line: str) -> Request:
    verb, seq, toks = _split_frame(line)
    if verb == "PING":
        if toks:
            raise ProtocolError("bad-field", f"PING takes no fields: {toks!r}")
        return PingRequest(seq=seq)
    if verb == "STATS":
        if toks:
            raise ProtocolError("bad-field", f"STATS takes no fields: {toks!r}")
        return StatsRequest(seq=seq)
    if verb != "WORK":
        raise ProtocolError("bad-verb", f"unknown request verb {verb!r}")
    allowed = ("host", "disk") + tuple(rt.value for rt in _RESOURCE_KEYS) + (
        "done",
        "trickle",
        "sticky",
    )
    kv = _kv_fields(toks, allowed)
    if "host" not in kv or "disk" not in kv:
        raise ProtocolError("bad-field", "WORK requires host= and disk=")
    req = ScheduleRequest(
        host_id=_parse_int(kv["host"], "host"),
        usable_disk=_parse_float(kv["disk"], "disk"),
    )
    for rt in _RESOURCE_KEYS:
        if rt.value in kv:
            cols = _parse_cols(kv[rt.value], 3, rt.value)
            req.requests[rt] = ResourceRequest(
                req_runtime=_parse_float(cols[0], f"{rt.value} rt"),
                req_idle=_parse_float(cols[1], f"{rt.value} idle"),
                queue_dur=_parse_float(cols[2], f"{rt.value} qd"),
            )
    for item in _parse_list(kv["done"], "done") if "done" in kv else []:
        cols = _parse_cols(item, 5, "done")
        try:
            outcome = InstanceOutcome(cols[1])
        except ValueError:
            raise ProtocolError("bad-field", f"unknown outcome {cols[1]!r}") from None
        req.completed.append(
            CompletedResult(
                instance_id=_parse_int(cols[0], "done inst"),
                outcome=outcome,
                runtime=_parse_float(cols[2], "done rt"),
                peak_flop_count=_parse_float(cols[3], "done pfc"),
                exit_code=_parse_int(cols[4], "done exit"),
            )
        )
    for item in _parse_list(kv["trickle"], "trickle") if "trickle" in kv else []:
        cols = _parse_cols(item, 2, "trickle")
        req.trickles.append(
            TrickleUp(
                instance_id=_parse_int(cols[0], "trickle inst"),
                fraction_done=_parse_float(cols[1], "trickle frac"),
            )
        )
    if "sticky" in kv:
        req.sticky_files = tuple(
            unquote(s) for s in _parse_list(kv["sticky"], "sticky")
        )
    return WorkRequest(seq=seq, request=req)


def decode_reply(line: str) -> Reply:
    verb, seq, toks = _split_frame(line)
    if verb == "PONG":
        if toks:
            raise ProtocolError("bad-field", f"PONG takes no fields: {toks!r}")
        return PongReply(seq=seq)
    if verb == "ERR":
        if len(toks) != 2:
            raise ProtocolError("bad-field", f"ERR wants code + message: {toks!r}")
        return ErrorReply(seq=seq, code=toks[0], message=unquote(toks[1]))
    if verb == "STATS":
        kv = _kv_fields(toks, ("v",))
        rep = StatsReply(seq=seq)
        for item in _parse_list(kv["v"], "v") if "v" in kv else []:
            key, sep, val = item.rpartition(":")
            if not sep:
                raise ProtocolError("bad-field", f"v wants key:value: {item!r}")
            rep.values[unquote(key)] = _parse_float(val, "stat value")
        return rep
    if verb != "JOBS":
        raise ProtocolError("bad-verb", f"unknown reply verb {verb!r}")
    kv = _kv_fields(toks, ("delay", "job", "del"))
    if "delay" not in kv:
        raise ProtocolError("bad-field", "JOBS requires delay=")
    rep = WorkReply(seq=seq, request_delay=_parse_float(kv["delay"], "delay"))
    for item in _parse_list(kv["job"], "job") if "job" in kv else []:
        cols = _parse_cols(item, 5, "job")
        rep.jobs.append(
            JobOffer(
                job_id=_parse_int(cols[0], "job id"),
                instance_id=_parse_int(cols[1], "instance id"),
                version_id=_parse_int(cols[2], "version id"),
                est_runtime=_parse_float(cols[3], "est_runtime"),
                est_flops=_parse_float(cols[4], "est_flops"),
            )
        )
    if "del" in kv:
        rep.delete_sticky = [unquote(s) for s in _parse_list(kv["del"], "del")]
    return rep
