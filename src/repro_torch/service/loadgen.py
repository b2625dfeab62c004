"""Async load generator for the scheduler service.

Simulates *n_clients* volunteer hosts multiplexed over a small pool of TCP
connections (real volunteer fleets are many hosts behind few concurrent
sockets, and an OS fd table does not enjoy 100k sockets either).  Each
connection owns a reader task that resolves pipelined replies back to the
awaiting client coroutine by sequence number.

Deterministic on purpose: hosts issue identical WORK requests (host id
aside), there is no randomness, and latency measurement is the only use of
the wall clock.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..core.scheduler import ResourceRequest, ScheduleRequest
from ..core.types import ResourceType
from .protocol import (
    ErrorReply,
    WorkReply,
    WorkRequest,
    decode_reply,
    encode_request,
)


@dataclass
class LoadReport:
    n_clients: int
    requests: int
    replies: int
    errors: int
    jobs_received: int
    wall_s: float
    rpcs_per_s: float
    p50_ms: float
    p95_ms: float
    p99_ms: float


@dataclass
class _Conn:
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    pending: Dict[int, asyncio.Future] = field(default_factory=dict)
    task: Optional[asyncio.Task] = None


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


async def _reader_loop(conn: _Conn) -> None:
    try:
        while True:
            raw = await conn.reader.readline()
            if not raw:
                break
            rep = decode_reply(raw.decode().rstrip("\r\n"))
            fut = conn.pending.pop(rep.seq, None)
            if fut is not None and not fut.done():
                fut.set_result(rep)
    except (ConnectionError, asyncio.CancelledError):
        pass


async def run_load(
    host: str,
    port: int,
    *,
    n_clients: int,
    requests_per_client: int = 1,
    n_conns: int = 64,
    req_runtime: float = 1.0,
    usable_disk: float = 1e12,
    host_ids: Optional[Sequence[int]] = None,
) -> LoadReport:
    """Drive the service with ``n_clients`` concurrent hosts and report
    throughput plus tail latency."""
    n_conns = max(1, min(n_conns, n_clients))
    conns: List[_Conn] = []
    for _ in range(n_conns):
        r, w = await asyncio.open_connection(host, port)
        conn = _Conn(reader=r, writer=w)
        conn.task = asyncio.create_task(_reader_loop(conn))
        conns.append(conn)

    seq_counter = 0
    latencies: List[float] = []
    counts = {"requests": 0, "replies": 0, "errors": 0, "jobs": 0}
    loop = asyncio.get_event_loop()

    async def client(i: int) -> None:
        nonlocal seq_counter
        hid = host_ids[i % len(host_ids)] if host_ids else i + 1
        conn = conns[i % n_conns]
        for _ in range(requests_per_client):
            seq_counter += 1
            seq = seq_counter
            sched = ScheduleRequest(
                host_id=hid,
                requests={
                    ResourceType.CPU: ResourceRequest(req_runtime=req_runtime)
                },
                usable_disk=usable_disk,
            )
            line = encode_request(WorkRequest(seq=seq, request=sched))
            fut = loop.create_future()
            conn.pending[seq] = fut
            counts["requests"] += 1
            t0 = time.perf_counter()
            conn.writer.write((line + "\n").encode())
            await conn.writer.drain()
            rep = await fut
            latencies.append(time.perf_counter() - t0)
            if isinstance(rep, WorkReply):
                counts["replies"] += 1
                counts["jobs"] += len(rep.jobs)
            elif isinstance(rep, ErrorReply):
                counts["errors"] += 1

    t_start = time.perf_counter()
    await asyncio.gather(*(client(i) for i in range(n_clients)))
    wall = time.perf_counter() - t_start

    for conn in conns:
        if conn.task is not None:
            conn.task.cancel()
        try:
            conn.writer.close()
        except Exception:
            pass

    latencies.sort()
    return LoadReport(
        n_clients=n_clients,
        requests=counts["requests"],
        replies=counts["replies"],
        errors=counts["errors"],
        jobs_received=counts["jobs"],
        wall_s=wall,
        rpcs_per_s=(counts["replies"] + counts["errors"]) / wall if wall > 0 else 0.0,
        p50_ms=_percentile(latencies, 0.50) * 1e3,
        p95_ms=_percentile(latencies, 0.95) * 1e3,
        p99_ms=_percentile(latencies, 0.99) * 1e3,
    )
