"""The port's production HTTP serving front-end.

An asyncio HTTP/1.1 server — stdlib only, no new dependency — that
exposes the typed serving API (:mod:`repro_torch.serving.api`) over the
wire:

  ``POST /v1/completions``  OpenAI-style completion; ``"stream": true``
                            streams tokens as Server-Sent Events
  ``GET /v1/models``        the served model
  ``GET /healthz``          liveness + lane/queue occupancy
  ``GET /metrics``          Prometheus text
                            (:mod:`repro_torch.serving.metrics`)

The scheduler is pumped from a dedicated thread
(:class:`~repro_torch.serving.frontend.server.SchedulerPump`), which makes
every device call; the asyncio loop and the pump communicate through a
thread-safe submission queue and ``loop.call_soon_threadsafe`` token
delivery — the JSON body maps onto a frozen
:class:`~repro_torch.serving.api.GenerateRequest`, ``on_token`` becomes
SSE chunks, and a client disconnect becomes
:meth:`~repro_torch.serving.api.CancelToken.cancel`.
"""

from repro_torch.serving.frontend.http import Request, read_request, sse_event
from repro_torch.serving.frontend.server import (HttpFrontend, SchedulerPump,
                                                 serve_threaded)

__all__ = ["HttpFrontend", "SchedulerPump", "serve_threaded",
           "Request", "read_request", "sse_event"]
