"""Asyncio scheduler service: a TCP front for :class:`ProjectServer`.

Connections speak the newline protocol from :mod:`.protocol`.  ``PING`` and
``STATS`` are answered inline; ``WORK`` frames are queued and a single
dispatcher task drains the queue in *waves* — every wave is handed to the
project as one ``rpc_batch`` call, so concurrent clients are coalesced into
the vectorized per-shard dispatch pass instead of paying one scalar cache
scan each (§5.1).  With ``coalesce=False`` the dispatcher degrades to
per-request ``rpc`` calls; that mode is the sequential baseline the RPC
bench measures against.

The core stays synchronous and deterministic: all scheduler state is
touched only from the dispatcher task, and "now" comes from an injected
``clock`` callable (virtual time by default) rather than the wall clock.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..core.server import ProjectServer
from .protocol import (
    MAX_LINE,
    ErrorReply,
    PingRequest,
    PongReply,
    ProtocolError,
    StatsReply,
    StatsRequest,
    WorkRequest,
    decode_request,
    encode_reply,
    reply_to_wire,
)


@dataclass
class _Pending:
    seq: int
    request: object  # ScheduleRequest
    writer: asyncio.StreamWriter


class SchedulerService:
    """Serve a :class:`ProjectServer` over TCP, coalescing RPC waves."""

    def __init__(
        self,
        project: ProjectServer,
        *,
        coalesce: bool = True,
        max_batch: int = 1024,
        refill_every: int = 512,
        clock: Optional[Callable[[], float]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self.project = project
        self.coalesce = coalesce
        self.max_batch = max_batch
        self.refill_every = refill_every
        self.clock = clock or (lambda: 0.0)
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._dispatcher: Optional[asyncio.Task] = None
        self._queue: Optional[asyncio.Queue] = None
        self._since_refill = 0
        self._stats = {
            "waves": 0,
            "requests": 0,
            "dispatched": 0,
            "errors": 0,
            "max_wave": 0,
        }

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        # The queue must be created inside the running loop (pre-3.10
        # asyncio primitives bind their loop at construction time).
        self._queue = asyncio.Queue()
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port, limit=MAX_LINE
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._dispatcher = asyncio.create_task(self._dispatch_loop())

    async def stop(self) -> None:
        if self._dispatcher is not None:
            self._dispatcher.cancel()
            try:
                await self._dispatcher
            except asyncio.CancelledError:
                pass
            self._dispatcher = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def stats(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self._stats)
        if self.project.shard_map is not None:
            out["shards"] = self.project.shard_map.utilization()
        return out

    # -- connection handling ------------------------------------------------

    def _send(self, writer: asyncio.StreamWriter, reply) -> None:
        if not writer.is_closing():
            writer.write((encode_reply(reply) + "\n").encode())

    def _flat_stats(self) -> Dict[str, float]:
        vals = {k: float(v) for k, v in self._stats.items()}
        if self.project.shard_map is not None:
            for row in self.project.shard_map.utilization():
                s = row["shard"]
                for k, v in row.items():
                    if k != "shard":
                        vals[f"shard{s}.{k}"] = float(v)
        return vals

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    raw = await reader.readline()
                except (asyncio.LimitOverrunError, ValueError):
                    # Over-long frame: the stream offset is lost, so reply
                    # and drop the connection rather than resynchronize.
                    self._stats["errors"] += 1
                    self._send(writer, ErrorReply(0, "too-long", "frame too long"))
                    await writer.drain()
                    break
                if not raw:
                    break
                line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
                try:
                    req = decode_request(line)
                except ProtocolError as e:
                    self._stats["errors"] += 1
                    self._send(writer, ErrorReply(0, e.code, e.message))
                    await writer.drain()
                    continue
                if isinstance(req, PingRequest):
                    self._send(writer, PongReply(req.seq))
                    await writer.drain()
                elif isinstance(req, StatsRequest):
                    self._send(writer, StatsReply(req.seq, self._flat_stats()))
                    await writer.drain()
                else:
                    assert isinstance(req, WorkRequest)
                    await self._queue.put(_Pending(req.seq, req.request, writer))
        except ConnectionError:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # -- dispatcher ---------------------------------------------------------

    async def _dispatch_loop(self) -> None:
        assert self._queue is not None
        while True:
            wave: List[_Pending] = [await self._queue.get()]
            while len(wave) < self.max_batch:
                try:
                    wave.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            now = self.clock()
            requests = [p.request for p in wave]
            if self.coalesce and len(requests) > 1:
                replies = self.project.rpc_batch(requests, now)
            else:
                replies = [self.project.rpc(r, now) for r in requests]
            dispatched = 0
            writers = {}
            for p, rep in zip(wave, replies):
                dispatched += len(rep.jobs)
                self._send(p.writer, reply_to_wire(p.seq, rep))
                writers[id(p.writer)] = p.writer
            for w in writers.values():
                try:
                    await w.drain()
                except ConnectionError:
                    pass
            self._stats["waves"] += 1
            self._stats["requests"] += len(wave)
            self._stats["dispatched"] += dispatched
            self._stats["max_wave"] = max(self._stats["max_wave"], len(wave))
            self._since_refill += len(wave)
            if self._since_refill >= self.refill_every:
                self._since_refill = 0
                self.project.feeder.fill()
