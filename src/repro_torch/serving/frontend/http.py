"""Minimal HTTP/1.1 + SSE plumbing over asyncio streams (stdlib only).

Just enough protocol for the serving endpoints: request-line + headers +
``Content-Length`` body parsing, JSON and Server-Sent-Event response
writers, one request per connection (every response carries
``Connection: close`` — curl and the tests open a connection per request,
and closing is what delimits an SSE stream with no ``Content-Length``).
The wire format is ``repro.serving.frontend.http``'s, byte for byte.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field

#: request body cap — a completions body is a token list, not a payload
MAX_BODY_BYTES = 8 * 1024 * 1024
MAX_HEADER_LINE = 64 * 1024

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 408: "Request Timeout",
           413: "Payload Too Large", 429: "Too Many Requests",
           500: "Internal Server Error", 504: "Gateway Timeout"}


class BadRequest(Exception):
    """Malformed HTTP or JSON — answered with a 400 and a close."""


@dataclass
class Request:
    method: str
    path: str
    headers: dict = field(default_factory=dict)
    body: bytes = b""

    def json(self):
        try:
            return json.loads(self.body.decode("utf-8") or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            raise BadRequest(f"body is not valid JSON: {e}") from e


async def read_request(reader: asyncio.StreamReader) -> Request | None:
    """Parse one request off the stream; ``None`` on a clean EOF (the
    client connected and went away without sending anything)."""
    try:
        line = await reader.readline()
    except (ConnectionError, asyncio.LimitOverrunError):
        return None
    if not line:
        return None
    if len(line) > MAX_HEADER_LINE:
        raise BadRequest("request line too long")
    parts = line.decode("latin-1").strip().split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise BadRequest(f"malformed request line {line!r}")
    method, path, _version = parts
    headers: dict[str, str] = {}
    while True:
        hline = await reader.readline()
        if hline in (b"\r\n", b"\n", b""):
            break
        if len(hline) > MAX_HEADER_LINE:
            raise BadRequest("header line too long")
        name, sep, value = hline.decode("latin-1").partition(":")
        if not sep:
            raise BadRequest(f"malformed header {hline!r}")
        headers[name.strip().lower()] = value.strip()
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError as e:
            raise BadRequest("bad Content-Length") from e
        if n < 0 or n > MAX_BODY_BYTES:
            raise BadRequest(f"Content-Length {n} out of bounds")
        if n:
            try:
                body = await reader.readexactly(n)
            except asyncio.IncompleteReadError as e:
                raise BadRequest("body shorter than Content-Length") from e
    return Request(method=method, path=path.split("?", 1)[0],
                   headers=headers, body=body)


def response_head(code: int, ctype: str, *, length: int | None = None,
                  extra: tuple = ()) -> bytes:
    lines = [f"HTTP/1.1 {code} {REASONS.get(code, 'Unknown')}",
             f"Content-Type: {ctype}",
             "Connection: close"]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    lines.extend(extra)
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def send_json(writer: asyncio.StreamWriter, code: int, obj,
                    *, extra: tuple = ()) -> None:
    body = (json.dumps(obj) + "\n").encode("utf-8")
    writer.write(response_head(code, "application/json", length=len(body),
                               extra=extra) + body)
    await writer.drain()


async def send_text(writer: asyncio.StreamWriter, code: int, text: str,
                    ctype: str = "text/plain; charset=utf-8") -> None:
    body = text.encode("utf-8")
    writer.write(response_head(code, ctype, length=len(body)) + body)
    await writer.drain()


def sse_head() -> bytes:
    """SSE response head: no Content-Length — the close delimits."""
    return response_head(200, "text/event-stream",
                         extra=("Cache-Control: no-cache",))


def sse_event(data, event: str | None = None) -> bytes:
    """One SSE frame: optional ``event:`` line + ``data:`` payload.
    ``data`` is JSON-encoded unless it is already a string (the
    ``[DONE]`` sentinel)."""
    payload = data if isinstance(data, str) else json.dumps(data)
    head = f"event: {event}\n" if event else ""
    return (head + f"data: {payload}\n\n").encode("utf-8")


def error_body(code: int, kind: str, message: str) -> dict:
    """OpenAI-style error envelope."""
    return {"error": {"type": kind, "code": code, "message": message}}
