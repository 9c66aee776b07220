"""The port's HTTP serving front-end (``repro_torch.serving.frontend``)
over real loopback sockets, on ``bitnet-3b-reduced`` with the reference's
converted weights, on the CPU (``device="cpu"``): the cases of
``tests/test_http_frontend.py`` against the port's ``serve_threaded``.

  * greedy and seeded-sampled SSE streams, a unary completion and four
    concurrent streams equal the reference's ``lockstep_generate``
    bitwise; the transport adds nothing to sampling;
  * a mid-stream disconnect cancels the lane and frees its slot (the next
    request on it streams its lockstep tokens), overload answers 429 with
    ``Retry-After``, an expired deadline 504, an invalid body 400 before
    the scheduler sees it;
  * ``/healthz``, ``/v1/models`` and ``/metrics`` (the scheduler's and the
    HTTP series);
  * the same request bodies sent to the reference's server and to the
    port's give the same status lines, headers, JSON bodies and SSE
    frames, ``id`` masked, and the same counters on ``/metrics``;
  * ``repro_torch.launch.server`` builds the scheduler it serves, raises
    without a card unless ``--device cpu``, does not take ``--shape-log``,
    and with ``--no-chunked`` prefills whole prompts.
"""
import json
import re
import socket
import threading
import time
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving.api import PooledEngine as JEngine
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.frontend import serve_threaded as jserve_threaded
from repro.serving.metrics import MetricsRegistry as JRegistry
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import server as launch_server
from repro_torch.serving.api import PooledEngine
from repro_torch.serving.frontend import serve_threaded
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("bitnet-3b-reduced")


@pytest.fixture(scope="module")
def stack():
    """(reference weights, the port's engine, the reference's engine),
    both LOP, as the reference's test serves."""
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    tqp = from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")
    return (jqp, PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu"),
            JEngine(JCFG, jqp, max_len=MAX_LEN))


def _ref(stack, prompt, n, sampling=None):
    """The reference's lockstep tokens, as Python ints."""
    jqp, _, jengine = stack
    return [int(t) for t in jlockstep(JCFG, jqp, prompt, n, max_len=MAX_LEN,
                                      sampling=sampling, engine=jengine)]


class _SlowDecode:
    """Engine proxy that stretches every decode step — makes the
    disconnect and overload races deterministic."""

    def __init__(self, inner, delay_s=0.02):
        self._inner = inner
        self._delay = delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def decode_step(self, *a, **kw):
        time.sleep(self._delay)
        return self._inner.decode_step(*a, **kw)


@contextmanager
def _server(engine, *, n_slots=2, **sched_kw):
    reg = MetricsRegistry()
    sched = Scheduler(engine, n_slots=n_slots, metrics=reg, **sched_kw)
    srv = serve_threaded(sched, model_name="bitnet-test", registry=reg)
    try:
        yield srv, sched, reg
    finally:
        srv.close()
    assert not srv.thread.is_alive() and srv.frontend.pump.error is None


@contextmanager
def _ref_server(stack, *, n_slots=2):
    jqp, _, jengine = stack
    reg = JRegistry()
    sched = JScheduler(JCFG, jqp, n_slots=n_slots, max_len=MAX_LEN,
                       engine=jengine, metrics=reg)
    srv = jserve_threaded(sched, model_name="bitnet-test", registry=reg)
    try:
        yield srv, sched, reg
    finally:
        srv.close()


def _prompt(n=9, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab, (n,)).astype(np.int32)


def _raw(port, payload: bytes, timeout=120) -> bytes:
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.sendall(payload)
    raw = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        raw += chunk
    s.close()
    return raw


def _split(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
    return status, headers, body


def _request(body, *, path="/v1/completions", method="POST") -> bytes:
    payload = json.dumps(body).encode() if body is not None else b""
    return (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)


def _post(port, body, *, path="/v1/completions", method="POST"):
    """One request, response fully read. → (status, headers, body)."""
    return _split(_raw(port, _request(body, path=path, method=method)))


def _sse_tokens(body: bytes):
    """An SSE byte stream → (tokens, saw_done, error_frames)."""
    tokens, done, errors = [], False, []
    for frame in body.decode().split("\n\n"):
        is_error = any(line.strip() == "event: error"
                       for line in frame.split("\n"))
        for line in frame.split("\n"):
            if not line.startswith("data: "):
                continue
            data = line[6:]
            if data == "[DONE]":
                done = True
            elif is_error:
                errors.append(json.loads(data))
            else:
                tokens.append(json.loads(data)["choices"][0]["token"])
    return tokens, done, errors


def _ids(p):
    return [int(t) for t in p]


# ---------------------------------------------------------------------------
# token exactness over the wire, against the reference's lockstep
# ---------------------------------------------------------------------------

def test_greedy_stream_matches_reference_lockstep(stack):
    p = _prompt()
    with _server(stack[1]) as (srv, _, _):
        status, headers, body = _post(srv.port, {
            "prompt": _ids(p), "max_tokens": 6, "stream": True})
    assert status == 200
    assert headers["Content-Type"] == "text/event-stream"
    tokens, done, errors = _sse_tokens(body)
    assert done and not errors
    assert tokens == _ref(stack, p, 6)


def test_sampled_seeded_stream_matches_reference_lockstep(stack):
    p = _prompt(n=12, seed=7)
    with _server(stack[1]) as (srv, _, _):
        status, _, body = _post(srv.port, {
            "prompt": _ids(p), "max_tokens": 6, "stream": True,
            "temperature": 0.9, "top_k": 8, "seed": 13})
    assert status == 200
    tokens, done, _ = _sse_tokens(body)
    assert done
    assert tokens == _ref(stack, p, 6, JSamplingParams(temperature=0.9,
                                                       top_k=8, seed=13))


def test_unary_completion_matches_reference_with_usage(stack):
    p = _prompt(n=10, seed=5)
    with _server(stack[1]) as (srv, _, _):
        status, _, body = _post(srv.port, {"prompt": _ids(p),
                                           "max_tokens": 5})
    assert status == 200
    obj = json.loads(body)
    assert obj["choices"][0]["tokens"] == _ref(stack, p, 5)
    assert obj["choices"][0]["finish_reason"] == "length"
    assert obj["usage"] == {"prompt_tokens": 10, "completion_tokens": 5,
                            "cached_prompt_tokens": 0}


def test_concurrent_streams_each_match_reference(stack):
    prompts = [_prompt(n=n, seed=s)
               for n, s in ((9, 1), (14, 2), (11, 3), (8, 4))]
    outs = [{} for _ in prompts]

    def go(i):
        status, _, body = _post(srv.port, {
            "prompt": _ids(prompts[i]), "max_tokens": 5, "stream": True})
        outs[i].update(status=status, body=body)

    with _server(stack[1]) as (srv, _, _):
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    for p, out in zip(prompts, outs):
        assert out["status"] == 200
        tokens, done, _ = _sse_tokens(out["body"])
        assert done
        assert tokens == _ref(stack, p, 5)


# ---------------------------------------------------------------------------
# disconnect -> cancel, overload -> 429, deadline -> 504, invalid -> 400
# ---------------------------------------------------------------------------

def test_mid_stream_disconnect_cancels_lane_and_frees_slot(stack):
    slow = _SlowDecode(stack[1], delay_s=0.02)
    p = _prompt()
    with _server(slow, n_slots=1) as (srv, sched, reg):
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=120)
        s.sendall(_request({"prompt": _ids(p), "max_tokens": 50,
                            "stream": True}))
        got = b""
        while got.count(b"\n\n") < 2:          # ~2 tokens of a 50-token run
            got += s.recv(4096)
        s.close()                              # client walks away

        deadline = time.monotonic() + 30
        while sched.has_work() or not sched.results:
            assert time.monotonic() < deadline, "lane never retired"
            time.sleep(0.02)
        res = sched.results[-1]
        assert res.finish_reason == "cancelled"
        assert len(res.tokens) < 50            # cut off mid-stream
        assert sched.n_active == 0             # lane retired...
        assert list(sched._free) == [0]        # ...and the slot is back
        assert reg.value("repro_requests_total",
                         {"outcome": "cancelled"}) == 1
        # the freed lane serves the next request token-exactly
        q = _prompt(n=11, seed=8)
        status, _, body = _post(srv.port, {"prompt": _ids(q),
                                           "max_tokens": 4, "stream": True})
    assert status == 200
    assert _sse_tokens(body)[0] == _ref(stack, q, 4)


def test_overload_returns_429_with_retry_after(stack):
    slow = _SlowDecode(stack[1], delay_s=0.02)
    outs = {}

    def go(name, n_tokens):
        outs[name] = _post(srv.port, {
            "prompt": _ids(_prompt(seed=ord(name[0]))),
            "max_tokens": n_tokens, "stream": True})

    with _server(slow, n_slots=1, max_queue=1) as (srv, sched, reg):
        a = threading.Thread(target=go, args=("a", 30))
        a.start()
        deadline = time.monotonic() + 30
        while not sched.n_active:              # a holds the only lane
            assert time.monotonic() < deadline
            time.sleep(0.01)
        b = threading.Thread(target=go, args=("b", 3))
        b.start()
        deadline = time.monotonic() + 30
        while not len(sched.queue):            # b parked in the queue
            assert time.monotonic() < deadline
            time.sleep(0.005)
        status, headers, body = _post(srv.port, {
            "prompt": _ids(_prompt(seed=9)), "max_tokens": 3})
        a.join(timeout=300)
        b.join(timeout=300)
        assert not a.is_alive() and not b.is_alive()
    assert status == 429
    assert headers.get("Retry-After") == "1"
    assert json.loads(body)["error"]["code"] == 429
    assert reg.value("repro_requests_shed_total") == 1
    assert outs["a"][0] == 200 and outs["b"][0] == 200
    assert reg.value("repro_http_requests_total",
                     {"route": "/v1/completions", "code": 429}) == 1


def test_expired_deadline_is_504_not_a_hang(stack):
    p = _prompt()
    with _server(stack[1]) as (srv, _, reg):
        status, _, body = _post(srv.port, {
            "prompt": _ids(p), "max_tokens": 5, "deadline_ms": 0.001,
            "stream": True})
        assert status == 504
        assert json.loads(body)["error"]["type"] == "deadline_expired"
        status2, _, _ = _post(srv.port, {
            "prompt": _ids(p), "max_tokens": 5, "deadline_ms": 0.001})
        assert status2 == 504
    assert reg.value("repro_deadline_expired_total") == 2


INVALID = [
    {"prompt": "text"},                          # not token ids
    {"prompt": []},                              # empty
    {"prompt": [1, 2], "max_tokens": 0},         # no budget
    {"prompt": [1, 2], "max_tokens": MAX_LEN + 60},   # > capacity
    {"prompt": [int(CFG.vocab) + 5]},            # out of vocab
    {"prompt": [1, 2], "temperature": -1.0},
    {"prompt": [1, 2], "deadline_ms": -5},
    {"prompt": [1, 2], "gamma": -1},
    {"prompt": [1, 2], "stop": [1, 2]},          # not a list of lists
    {"prompt": [1, 2], "eos_id": True},
    [1, 2],                                      # not an object
]


def test_validation_rejects_before_touching_the_scheduler(stack):
    with _server(stack[1]) as (srv, sched, _):
        for body in INVALID:
            status, _, raw = _post(srv.port, body)
            assert status == 400, body
            assert "error" in json.loads(raw), body
        status, _, _ = _split(_raw(srv.port, b"GARBAGE\r\n\r\n"))
        assert status == 400
        assert not sched.results and not sched.queue   # nothing submitted
        status, _, _ = _post(srv.port, None, path="/nope", method="GET")
        assert status == 404
        status, _, _ = _post(srv.port, None, method="GET")
        assert status == 405


def test_healthz_and_models(stack):
    with _server(stack[1]) as (srv, _, _):
        status, _, body = _post(srv.port, None, path="/healthz",
                                method="GET")
        assert status == 200
        health = json.loads(body)
        assert health["status"] == "ok" and health["active_lanes"] == 0
        status, _, body = _post(srv.port, None, path="/v1/models",
                                method="GET")
        assert status == 200
        models = json.loads(body)
        assert models["data"][0]["id"] == "bitnet-test"
        assert models["data"][0]["family"] == "dense"


def test_metrics_endpoint_exports_stage_histograms_and_counters(stack):
    p = _prompt()
    with _server(stack[1]) as (srv, _, _):
        _post(srv.port, {"prompt": _ids(p), "max_tokens": 4})
        status, headers, body = _post(srv.port, None, path="/metrics",
                                      method="GET")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
    text = body.decode()
    for stage in ("queue", "prefill", "decode"):
        assert f'repro_request_stage_seconds_bucket{{stage="{stage}"' \
            in text
    assert 'repro_requests_total{outcome="length"} 1' in text
    assert "repro_tokens_generated_total 4" in text
    assert 'repro_prefill_tokens_total{source="computed"} 9' in text
    assert "repro_request_ttft_seconds_count 1" in text
    assert "repro_decode_step_seconds_count 3" in text
    assert 'repro_http_requests_total{route="/v1/completions",' \
        'code="200"} 1' in text


# ---------------------------------------------------------------------------
# the reference's server and the port's: the same bytes on the wire
# ---------------------------------------------------------------------------

def _payloads():
    """Request bytes, in order; both servers get the same sequence."""
    bodies = [
        _request({"prompt": _ids(_prompt()), "max_tokens": 6,
                  "stream": True}),
        _request({"prompt": _ids(_prompt(n=12, seed=7)), "max_tokens": 6,
                  "stream": True, "temperature": 0.9, "top_k": 8,
                  "seed": 13}),
        _request({"prompt": _ids(_prompt(n=10, seed=5)), "max_tokens": 5}),
        _request({"prompt": _ids(_prompt(n=40, seed=6)), "max_tokens": 4,
                  "temperature": 0.7, "top_p": 0.9, "seed": 2}),
        _request({"prompt": _ids(_prompt()), "max_tokens": 5,
                  "deadline_ms": 0.001, "stream": True}),
        _request({"prompt": _ids(_prompt()), "max_tokens": 5,
                  "deadline_ms": 0.001}),
        _request(None, path="/v1/models", method="GET"),
        _request(None, path="/healthz", method="GET"),
        _request(None, path="/nope", method="GET"),
        _request(None, method="GET"),
        b"GARBAGE\r\n\r\n",
    ]
    return bodies + [_request(body) for body in INVALID]


_ID = re.compile(rb'"id": "cmpl-\d+"')
_COUNTERS = ("repro_requests_total", "repro_tokens_generated_total",
             "repro_prefill_tokens_total", "repro_http_requests_total",
             "repro_requests_shed_total", "repro_deadline_expired_total",
             "repro_queue_depth", "repro_active_lanes",
             "repro_http_client_disconnects_total")


def _exchange(srv):
    out = []
    for payload in _payloads():
        status, headers, body = _split(_raw(srv.port, payload))
        headers.pop("Content-Length", None)    # moves with the id's digits
        out.append((status, headers, _ID.sub(b'"id": "cmpl-N"', body)))
    status, _, text = _split(_raw(srv.port, _request(
        None, path="/metrics", method="GET")))
    counters = [line for line in text.decode().splitlines()
                if line.split("{")[0].split(" ")[0] in _COUNTERS]
    return out, counters


def test_reference_and_port_servers_send_the_same_payloads(stack):
    with _ref_server(stack) as (jsrv, _, _):
        want, want_counters = _exchange(jsrv)
    with _server(stack[1]) as (srv, _, _):
        got, got_counters = _exchange(srv)
    assert [w[0] for w in want] == [200, 200, 200, 200, 504, 504, 200, 200,
                                    404, 405, 400] + [400] * len(INVALID)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert got_counters == want_counters
    assert any(line.startswith("repro_tokens_generated_total 21")
               for line in got_counters)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_builds_on_cpu_and_raises_without_a_card(monkeypatch,
                                                          tmp_path):
    args = launch_server.parse_args(["--reduced", "--device", "cpu",
                                     "--max-len", "63", "--slots", "2",
                                     "--no-lop", "--max-queue", "5"])
    sched = launch_server.build_scheduler(args)
    assert sched.engine.device.type == "cpu"
    assert sched.n_slots == 2 and sched.max_queue == 5
    assert sched.capacity == 64 and not sched.engine.use_lop
    assert sched.metrics is launch_server.REGISTRY
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_server.build_scheduler(launch_server.parse_args(
            ["--reduced"]))
    # --shape-log arms the tile autotuner's shape log, as the reference's
    from repro_torch.kernels import autotune
    log = tmp_path / "shapes.json"
    args = launch_server.parse_args(["--reduced", "--device", "cpu",
                                     "--max-len", "63", "--shape-log",
                                     str(log)])
    monkeypatch.undo()
    try:
        launch_server.build_scheduler(args)
        assert autotune.shape_log_path() == log
    finally:
        autotune.stop_shape_log()


def test_launcher_no_chunked_prefills_whole(stack):
    """``--no-chunked``: every prompt prefills whole at its exact length
    (no prefix store), with the reference's tokens."""
    from repro_torch.serving.api import GenerateRequest

    args = launch_server.parse_args(["--reduced", "--device", "cpu",
                                     "--max-len", "63", "--no-chunked"])
    built = launch_server.build_scheduler(args)
    assert not built.chunked and built.prefix_store is None
    sched = Scheduler(stack[1], n_slots=2, chunked=False)
    assert sched.prefix_store is None
    p = _prompt(n=40, seed=6)
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=4))
    (res,) = sched.run_to_completion()
    assert res.tokens == _ref(stack, p, 4)
    assert sched.prefill_tokens_computed == 40
