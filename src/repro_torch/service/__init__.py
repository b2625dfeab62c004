"""Asyncio service surface for the project server (§5.1).

The port's twin of ``repro.service``: the same wire bytes for the same
messages, over ``repro_torch.core.ProjectServer`` on either engine backend
(the service takes the project it is given and chooses no device).

The core engines are synchronous and virtual-time; this package puts a
network front on them without perturbing their determinism:

  protocol — newline-delimited wire codec (requests, replies, error frames)
  server   — asyncio TCP service coalescing concurrent RPCs into per-shard
             ``rpc_batch`` waves
  loadgen  — async load generator (10k–100k simulated clients) recording
             RPC/s and tail latency
"""
from .loadgen import LoadReport, run_load
from .protocol import (
    MAX_LINE,
    ErrorReply,
    JobOffer,
    PingRequest,
    PongReply,
    ProtocolError,
    StatsReply,
    StatsRequest,
    WorkReply,
    WorkRequest,
    decode_reply,
    decode_request,
    encode_reply,
    encode_request,
    reply_to_wire,
)
from .server import SchedulerService

__all__ = [
    "ErrorReply",
    "JobOffer",
    "LoadReport",
    "MAX_LINE",
    "PingRequest",
    "PongReply",
    "ProtocolError",
    "SchedulerService",
    "StatsReply",
    "StatsRequest",
    "WorkReply",
    "WorkRequest",
    "decode_reply",
    "decode_request",
    "encode_reply",
    "encode_request",
    "reply_to_wire",
    "run_load",
]
