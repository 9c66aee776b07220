"""The HTTP front-end proper: the scheduler pump thread + asyncio endpoints.

Threading model
---------------
The :class:`repro_torch.serving.scheduler.Scheduler` is single-threaded
(host bookkeeping + device dispatch), so exactly ONE dedicated thread —
the :class:`SchedulerPump` — owns it and makes every device call: the
kernels' first-use build, each CUDA-graph capture of the engine's step
entries and every replay. The pump makes the engine's device current on
its own thread before anything else (the current CUDA device is per
thread). The asyncio event loop never touches scheduler state directly
and never a tensor: a streamed :class:`~repro_torch.serving.api.StepResult`
and a :class:`~repro_torch.serving.api.FinishedRequest` carry Python ints,
so the loop makes no CUDA call (one made during a capture would break it).

  loop → pump   a thread-safe submission queue carries
                ``(GenerateRequest, Future)`` pairs; the pump calls
                ``sched.submit`` and resolves the future with the
                admission verdict (``False`` = load-shed → HTTP 429)
  pump → loop   ``on_token`` callbacks and per-request done events fire
                on the pump thread and are marshalled into per-request
                ``asyncio.Queue`` channels via
                ``loop.call_soon_threadsafe``
  loop → pump   a client disconnect calls ``CancelToken.cancel()`` — a
                plain flag read by the scheduler's terminal sweep, safe
                from any thread

The pump loop is the same admit/step cycle ``run_to_completion`` drives,
plus inbox draining; when the scheduler is idle it blocks on the inbox
(bounded poll) instead of spinning.

Request lifecycle over the wire: JSON body → frozen
:class:`~repro_torch.serving.api.SamplingParams` / ``GenerateRequest``;
``stream: true`` answers ``text/event-stream`` and emits one SSE frame per
token plus a final ``data: [DONE]``; a deadline expiring mid-stream emits
an ``event: error`` frame carrying 504 semantics (the status line is long
gone); overload answers 429 with ``Retry-After`` before any lane is
touched. The transport adds no sampling state: tokens over HTTP are those
of the same request served straight through the scheduler, and the routes,
bodies and frames are ``repro.serving.frontend.server``'s.
"""

from __future__ import annotations

import asyncio
import itertools
import queue
import threading
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.serving import metrics as _metrics
from repro_torch.serving.api import (CancelToken, GenerateRequest,
                                     SamplingParams)
from repro_torch.serving.frontend import http as _http
from repro_torch.serving.frontend.http import (BadRequest, error_body,
                                               send_json, send_text,
                                               sse_event, sse_head)

#: finish reasons that mean the request ran to a natural end
NATURAL = ("eos", "stop", "length")
_STOP = object()          # inbox sentinel waking the pump to exit


class SchedulerPump(threading.Thread):
    """The one thread that owns the scheduler and makes its device calls.

    ``submit()`` (any thread) enqueues a request and returns a
    :class:`concurrent.futures.Future` resolving to the admission
    verdict; an optional ``done_cb`` fires (on the pump thread) with the
    :class:`~repro_torch.serving.api.FinishedRequest` when the request
    retires by ANY path — natural finish, shed, deadline, cancel or fault —
    by watching the scheduler's results watermark, so no retirement path
    needs its own notification plumbing. An exception on the pump is kept
    in ``error``, fails every pending future and ends the thread.
    """

    def __init__(self, sched, *, idle_poll_s: float = 0.02):
        super().__init__(name="scheduler-pump", daemon=True)
        self.sched = sched
        self.idle_poll_s = idle_poll_s
        self.inbox: queue.Queue = queue.Queue()
        self.error: BaseException | None = None
        # the card the engine's tensors live on, named on the caller's
        # thread (a device without an index means that thread's current)
        dev = sched.engine.device
        self._cuda_index = (None if dev.type != "cuda" else dev.index
                            if dev.index is not None
                            else torch.cuda.current_device())
        self._stopping = threading.Event()
        self._done_cbs: dict = {}
        self._results_seen = 0

    def submit(self, req: GenerateRequest, done_cb=None) -> Future:
        fut: Future = Future()
        self.inbox.put((req, fut, done_cb))
        return fut

    def stop(self) -> None:
        self._stopping.set()
        self.inbox.put(_STOP)

    # ---------------- pump loop (the only scheduler toucher) ----------

    def run(self) -> None:
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while not self._stopping.is_set():
                moved = self._drain_inbox(block=not self.sched.has_work())
                self.sched.admit()
                if self.sched.has_work():
                    self.sched.step()
                self._dispatch_done()
                if not moved and not self.sched.has_work() \
                        and self._stopping.is_set():
                    break
        except BaseException as e:                     # noqa: BLE001
            # a poisoned scheduler must fail the pending futures loudly,
            # not hang every in-flight HTTP request
            self.error = e
            while True:
                try:
                    item = self.inbox.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP:
                    item[1].set_exception(e)
            raise

    def _drain_inbox(self, *, block: bool) -> bool:
        moved = False
        timeout = self.idle_poll_s if block else None
        while True:
            try:
                item = (self.inbox.get(timeout=timeout) if block
                        else self.inbox.get_nowait())
            except queue.Empty:
                return moved
            block = False
            if item is _STOP:
                return moved
            req, fut, done_cb = item
            if done_cb is not None:
                self._done_cbs[req.rid] = done_cb
            try:
                accepted = self.sched.submit(req)
            except BaseException as e:                 # noqa: BLE001
                self._done_cbs.pop(req.rid, None)
                fut.set_exception(e)
                continue
            fut.set_result(accepted)
            moved = True

    def _dispatch_done(self) -> None:
        results = self.sched.results
        while self._results_seen < len(results):
            res = results[self._results_seen]
            self._results_seen += 1
            cb = self._done_cbs.pop(res.rid, None)
            if cb is not None:
                cb(res)


class HttpFrontend:
    """Asyncio HTTP server bridging sockets to the scheduler pump."""

    def __init__(self, sched, *, model_name: str | None = None,
                 registry=None, default_max_tokens: int = 16):
        self.sched = sched
        self.model = model_name or getattr(sched.cfg, "name", "repro")
        self.registry = registry if registry is not None else sched.metrics
        self.default_max_tokens = default_max_tokens
        self.pump = SchedulerPump(sched)
        self._m = _metrics.http_instruments(self.registry)
        self._rids = itertools.count(1)
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._closing: asyncio.Event | None = None
        self.port: int | None = None

    # ---------------- lifecycle ----------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind and start serving; returns the bound port (``port=0``
        picks a free one — how tests and the benchmark run)."""
        self._loop = asyncio.get_running_loop()
        self._closing = asyncio.Event()
        self.pump.start()
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def serve_forever(self) -> None:
        await self._closing.wait()
        await self.stop()

    def close(self) -> None:
        """Thread-safe shutdown request (unblocks ``serve_forever``)."""
        if self._loop is not None and self._closing is not None:
            self._loop.call_soon_threadsafe(self._closing.set)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self.pump.is_alive():
            self.pump.stop()
            await asyncio.to_thread(self.pump.join, 10.0)

    # ---------------- connection handling ----------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._m.in_flight.inc()
        route, code = "unknown", 500
        try:
            try:
                req = await _http.read_request(reader)
            except BadRequest as e:
                route, code = "malformed", 400
                await send_json(writer, 400,
                                error_body(400, "bad_request", str(e)))
                return
            if req is None:
                route, code = "empty", 0
                return
            route = req.path
            code = await self._route(req, reader, writer)
        except (ConnectionError, asyncio.CancelledError):
            code = 0                  # client went away; nothing to send
        finally:
            self._m.in_flight.dec()
            self._m.requests.labels(route=route, code=code).inc()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, asyncio.CancelledError):
                pass

    async def _route(self, req, reader, writer) -> int:
        if req.path == "/healthz" and req.method == "GET":
            healthy = self.pump.is_alive() and self.pump.error is None
            await send_json(writer, 200 if healthy else 500, {
                "status": "ok" if healthy else "error",
                "model": self.model,
                "active_lanes": self.sched.n_active,
                "prefilling": self.sched.n_prefilling,
                "queue_depth": len(self.sched.queue),
            })
            return 200 if healthy else 500
        if req.path == "/metrics" and req.method == "GET":
            await send_text(writer, 200, self.registry.render(),
                            ctype="text/plain; version=0.0.4; "
                                  "charset=utf-8")
            return 200
        if req.path == "/v1/models" and req.method == "GET":
            await send_json(writer, 200, {
                "object": "list",
                "data": [{"id": self.model, "object": "model",
                          "owned_by": "repro",
                          "family": getattr(self.sched.cfg, "family",
                                            "unknown")}],
            })
            return 200
        if req.path == "/v1/completions":
            if req.method != "POST":
                await send_json(writer, 405, error_body(
                    405, "method_not_allowed", "use POST"))
                return 405
            return await self._completions(req, reader, writer)
        await send_json(writer, 404, error_body(
            404, "not_found", f"no route {req.path}"))
        return 404

    # ---------------- POST /v1/completions ----------------

    def _parse_completion(self, body: dict) -> dict:
        """JSON body → validated GenerateRequest fields. The wire
        contract speaks token ids (the repo has no tokenizer): ``prompt``
        is a list of ints in [0, vocab)."""
        if not isinstance(body, dict):
            raise BadRequest("body must be a JSON object")
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt or \
                not all(isinstance(t, int) and not isinstance(t, bool)
                        for t in prompt):
            raise BadRequest("prompt must be a non-empty list of token ids")
        vocab = int(getattr(self.sched.cfg, "vocab", 0))
        if vocab and not all(0 <= t < vocab for t in prompt):
            raise BadRequest(f"prompt token out of range [0, {vocab})")
        max_tokens = body.get("max_tokens", self.default_max_tokens)
        if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) \
                or max_tokens < 1:
            raise BadRequest("max_tokens must be an int >= 1")
        cap = self.sched.capacity
        if cap and len(prompt) + max_tokens > cap:
            raise BadRequest(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                f"exceeds the pool capacity ({cap})")
        try:
            sp = SamplingParams(
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                seed=int(body.get("seed", 0)),
                gamma=int(body.get("gamma", 0)))
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad sampling params: {e}") from e
        if sp.temperature < 0 or sp.top_k < 0 or not 0 < sp.top_p <= 1 \
                or sp.gamma < 0:
            raise BadRequest("sampling params out of range")
        stop = body.get("stop", ())
        if stop and (not isinstance(stop, list)
                     or not all(isinstance(s, list)
                                and all(isinstance(t, int) for t in s)
                                for s in stop)):
            raise BadRequest("stop must be a list of token-id lists")
        eos_id = body.get("eos_id")
        if eos_id is not None and (not isinstance(eos_id, int)
                                   or isinstance(eos_id, bool)):
            raise BadRequest("eos_id must be an int")
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is not None and (
                not isinstance(deadline_ms, (int, float))
                or isinstance(deadline_ms, bool) or deadline_ms <= 0):
            raise BadRequest("deadline_ms must be a positive number")
        return {"prompt": prompt, "max_tokens": max_tokens, "sampling": sp,
                "stop": tuple(tuple(s) for s in stop), "eos_id": eos_id,
                "deadline_ms": deadline_ms,
                "stream": bool(body.get("stream", False))}

    async def _completions(self, req, reader, writer) -> int:
        try:
            spec = self._parse_completion(req.json())
        except BadRequest as e:
            await send_json(writer, 400,
                            error_body(400, "bad_request", str(e)))
            return 400

        rid = next(self._rids)
        chan: asyncio.Queue = asyncio.Queue()
        loop = self._loop
        cancel = CancelToken()
        on_token = None
        if spec["stream"]:
            def on_token(sr):
                loop.call_soon_threadsafe(chan.put_nowait, ("token", sr))

        def on_done(res):
            loop.call_soon_threadsafe(chan.put_nowait, ("done", res))

        greq = GenerateRequest(
            rid=rid, prompt=np.asarray(spec["prompt"], np.int32),
            max_new_tokens=spec["max_tokens"], eos_id=spec["eos_id"],
            sampling=spec["sampling"], stop=spec["stop"],
            on_token=on_token, cancel=cancel,
            deadline_ms=spec["deadline_ms"])
        fut = self.pump.submit(greq, on_done)
        try:
            accepted = await asyncio.wrap_future(fut)
        except ValueError as e:
            await send_json(writer, 400,
                            error_body(400, "bad_request", str(e)))
            return 400
        if not accepted:
            # admission control end to end: a bounded queue answers an
            # immediate 429, never a hang; Retry-After is advisory
            await send_json(writer, 429, error_body(
                429, "overloaded", "queue is full, retry later"),
                extra=("Retry-After: 1",))
            return 429

        # client-disconnect watch: the request body is fully consumed,
        # so ANY further read completing means EOF/reset → cancel the
        # lane (its slot frees on the scheduler's next terminal sweep)
        watcher = asyncio.create_task(
            self._watch_disconnect(reader, cancel))
        try:
            if spec["stream"]:
                return await self._stream(writer, rid, chan, cancel)
            return await self._unary(writer, rid, chan)
        finally:
            watcher.cancel()

    async def _watch_disconnect(self, reader, cancel: CancelToken) -> None:
        try:
            await reader.read(1)
        except (ConnectionError, asyncio.CancelledError):
            pass
        else:
            self._m.disconnects.inc()
        cancel.cancel()

    def _chunk(self, rid: int, sr) -> dict:
        return {"id": f"cmpl-{rid}",
                "object": "text_completion.chunk",
                "model": self.model,
                "choices": [{"index": 0, "token": sr.token,
                             "token_index": sr.index,
                             "finish_reason": sr.finish_reason or None}]}

    async def _stream(self, writer, rid, chan, cancel) -> int:
        """SSE streaming: headers go out with (not before) the first
        event, so a request retired before any token still gets a real
        status line (504 deadline / 500 fault) instead of an empty
        200 stream."""
        kind, payload = await chan.get()
        if kind == "done" and payload.finish_reason not in NATURAL:
            reason = payload.finish_reason
            if reason == "deadline":
                await send_json(writer, 504, error_body(
                    504, "deadline_expired",
                    "deadline_ms elapsed before the first token"))
                return 504
            if reason == "cancelled":
                return 0
            await send_json(writer, 500, error_body(
                500, "generation_fault", f"request retired: {reason}"))
            return 500
        writer.write(sse_head())
        try:
            while True:
                if kind == "token":
                    writer.write(sse_event(self._chunk(rid, payload)))
                    await writer.drain()
                    if payload.finished:
                        break
                elif kind == "done":
                    reason = payload.finish_reason
                    if reason in NATURAL:
                        break        # final token frame already sent
                    if reason == "cancelled":
                        return 0     # client is gone; nothing to say
                    # mid-stream retirement (deadline/fault): the status
                    # line was 200 long ago — signal in-band per the SSE
                    # contract, then end the stream cleanly
                    code = 504 if reason == "deadline" else 500
                    writer.write(sse_event(
                        error_body(code, reason, f"request retired "
                                   f"mid-stream: {reason}"),
                        event="error"))
                    await writer.drain()
                    break
                kind, payload = await chan.get()
            writer.write(sse_event("[DONE]"))
            await writer.drain()
        except ConnectionError:
            cancel.cancel()
            self._m.disconnects.inc()
            return 0
        return 200

    async def _unary(self, writer, rid, chan) -> int:
        while True:
            kind, res = await chan.get()
            if kind == "done":
                break
        reason = res.finish_reason
        if reason in NATURAL:
            await send_json(writer, 200, {
                "id": f"cmpl-{rid}", "object": "text_completion",
                "model": self.model,
                "choices": [{"index": 0, "tokens": list(res.tokens),
                             "finish_reason": reason}],
                "usage": {"prompt_tokens": res.prompt_len,
                          "completion_tokens": len(res.tokens),
                          "cached_prompt_tokens": res.cached_len}})
            return 200
        if reason == "cancelled":
            return 0
        code = 504 if reason == "deadline" else 500
        await send_json(writer, code, error_body(
            code, reason, f"request retired: {reason}"))
        return code


# ---------------------------------------------------------------------------
# Thread-hosted server (tests, the smoke test)
# ---------------------------------------------------------------------------

class ThreadedServer:
    """Handle on a frontend running in its own event-loop thread."""

    def __init__(self, frontend: HttpFrontend, thread: threading.Thread):
        self.frontend = frontend
        self.thread = thread

    @property
    def port(self) -> int:
        return self.frontend.port

    def close(self) -> None:
        self.frontend.close()
        self.thread.join(timeout=15.0)


def serve_threaded(sched, *, host: str = "127.0.0.1", port: int = 0,
                   **kw) -> ThreadedServer:
    """Start an :class:`HttpFrontend` on a daemon thread; returns once
    the socket is bound (``.port`` is live). The caller's thread stays
    free — how the tests and ``chip_smoke.py`` drive a real loopback
    server."""
    frontend = HttpFrontend(sched, **kw)
    started = threading.Event()
    failure: list = []

    def main() -> None:
        async def body():
            try:
                await frontend.start(host, port)
            except BaseException as e:                 # noqa: BLE001
                failure.append(e)
                raise
            finally:
                started.set()
            await frontend.serve_forever()
        asyncio.run(body())

    thread = threading.Thread(target=main, name="http-frontend",
                              daemon=True)
    thread.start()
    started.wait(timeout=30.0)
    if failure:
        raise failure[0]
    assert frontend.port is not None, "frontend failed to bind"
    return ThreadedServer(frontend, thread)
