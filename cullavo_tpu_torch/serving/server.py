"""HTTP front end of the continuous-batching engine (counterpart of
``cullavo_tpu/serving/server.py``).

``EngineRunner``
    One scheduler thread owns every engine call (the engine is
    single-threaded: every launch comes from that thread, on the default
    stream); HTTP handler threads ``submit`` requests under a lock, which
    the scheduler hands to a waiting client between two steps (a plain lock
    would go back to the scheduler every time, and requests would wait until
    the engine idles).  The thread loops admit -> decode quantum -> harvest
    while work exists and parks on an event when idle.  Completion is signalled per request, so
    any number of callers can block on their own results while the pool
    keeps every slot busy.  If an engine step raises, the runner keeps the
    exception and wakes every waiter: ``result`` raises ``SchedulerFailed``
    (from it), a stream gets the ``SchedulerFailed`` in place of its end
    marker, ``submit`` refuses new work, ``failed`` is set, and the thread
    re-raises (its traceback is printed).  The JAX runner's thread dies
    silently and leaves every client waiting for its timeout.

``ServingHTTPServer`` (stdlib ``ThreadingHTTPServer``)
    * ``POST /generate``  body: {"id"?: int, "prompt": str | "input_ids":
      [int, ...], "image"?: path | [3, H, W] list, "max_new_tokens"?: int,
      "adapter_id"?: int, "stream"?: bool} -> {"id", "tokens", "text"}.
      Blocks until the request completes; with ``stream`` the reply is
      chunked JSONL, one {"token": t} line per token as its quantum ends,
      then a {"done": true, "id", "tokens", "text"} line.  Missing ids are
      assigned by the server.
    * ``GET /healthz`` -> 200 {"ok": true}; 503 once the scheduler failed.
    * ``GET /stats``   -> rolling TTFT / E2E percentiles and the scheduler
      counters.

Invalid requests (bad JSON, bad shapes, duplicate ids, over-long prompts,
an ``adapter_id`` the engine does not serve) get 400 with the message; a
request that outlives ``timeout_s`` gets 504 (its slot still completes and
is freed); a request that was waiting when the scheduler failed gets 500
with the error, and a request after that 503.
"""
from __future__ import annotations

import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from cullavo_tpu_torch.serving.engine import Request, ServingEngine
from cullavo_tpu_torch.serving.io import request_from_row

__all__ = ["EngineRunner", "SchedulerFailed", "ServingHTTPServer", "make_server"]

STATS_WINDOW = 2048      # requests in the rolling TTFT / E2E windows of ``stats``
IDLE_POLL_S = 0.05       # an idle scheduler's longest park, so that ``stop`` is prompt


class SchedulerFailed(RuntimeError):
    """The scheduler thread stopped on an error (the ``__cause__``)."""


class _ClientTurn:
    """``with runner._client():`` the engine lock, taken ahead of the
    scheduler's next step (it waits while ``_waiting`` is above 0)."""

    def __init__(self, runner):
        self.runner = runner

    def __enter__(self):
        r = self.runner
        with r._gate:
            r._waiting += 1
        r._lock.acquire()
        with r._gate:
            r._waiting -= 1
            r._gate.notify_all()

    def __exit__(self, *exc):
        self.runner._lock.release()


class EngineRunner:
    """Owns a ``ServingEngine`` behind a scheduler thread.

    Every engine access happens under ``_lock``: ``submit`` (any thread)
    enqueues into the engine and registers a completion event; the scheduler
    thread steps the engine while it has work and harvests finished results
    out of ``engine.results`` (so that the engine's dicts stay bounded in a
    long-running server).  ``stats`` reads a rolling window of per-request
    latencies instead of the engine's unbounded ``times``."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self._lock = threading.Lock()
        self._gate = threading.Condition()  # guards _waiting: clients queued for _lock
        self._waiting = 0
        self._wake = threading.Event()
        self._stop = False
        self._error: Optional[BaseException] = None
        self._events: dict = {}          # req_id -> threading.Event
        self._done: dict = {}            # req_id -> [tokens]
        self._streams: dict = {}         # req_id -> queue.Queue (streaming)
        self._sent: dict = {}            # req_id -> tokens already streamed
        self._ttft = collections.deque(maxlen=STATS_WINDOW)
        self._e2e = collections.deque(maxlen=STATS_WINDOW)
        self._counters = {"submitted": 0, "completed": 0}
        self._started = time.time()
        self._thread = threading.Thread(target=self._loop, name="cullavo-serve-scheduler",
                                        daemon=True)
        self._thread.start()

    @property
    def failed(self) -> bool:
        return self._error is not None

    def failure(self) -> SchedulerFailed:
        """A fresh ``SchedulerFailed`` caused by the scheduler's error."""
        err = SchedulerFailed(f"the scheduler thread failed: {self._error!r}")
        err.__cause__ = self._error
        return err

    # -- client side ---------------------------------------------------------
    def _client(self) -> _ClientTurn:
        return _ClientTurn(self)

    def _register(self, req: Request, table: dict, value):
        with self._client():
            if self._error is not None:
                raise self.failure()
            self.engine.submit(req)      # may raise; nothing registered yet
            table[req.req_id] = value
            if table is self._streams:
                self._sent[req.req_id] = 0
            self._counters["submitted"] += 1
        self._wake.set()
        return value

    def submit(self, req: Request) -> threading.Event:
        """Validate and enqueue; returns the completion event.  Raises
        ``ValueError`` (duplicate id, prompt too long, budget over max_len,
        adapter out of range) at once, as the engine validates at submit
        time, and ``SchedulerFailed`` once the scheduler has failed."""
        return self._register(req, self._events, threading.Event())

    def result(self, req_id, timeout: Optional[float] = None) -> list:
        ev = self._events.get(req_id)
        if ev is None:
            raise KeyError(f"unknown or already-collected req_id {req_id}")
        ev.wait(timeout)
        with self._client():
            # deregistered, so that a late completion is dropped, not kept
            self._events.pop(req_id, None)
            if req_id in self._done:     # also when it finished between wait and lock
                return self._done.pop(req_id)
            if self._error is not None:
                raise self.failure()
        raise TimeoutError(f"request {req_id} not done in {timeout}s")

    def generate(self, req: Request, timeout: Optional[float] = None) -> list:
        self.submit(req)
        return self.result(req.req_id, timeout)

    def submit_stream(self, req: Request) -> queue.Queue:
        """Streaming submit: returns a Queue yielding tokens as quanta
        complete, then ``None`` as the end-of-stream marker (a
        ``SchedulerFailed`` instead if the scheduler fails first)."""
        return self._register(req, self._streams, queue.Queue())

    def stats(self) -> dict:
        def pct(xs):
            xs = list(xs)
            return ({"p50": round(float(np.percentile(xs, 50)), 4),
                     "p95": round(float(np.percentile(xs, 95)), 4),
                     "n": len(xs)} if xs else {"n": 0})

        with self._client():
            eng = self.engine
            return {"ok": self._error is None,
                    "uptime_s": round(time.time() - self._started, 1),
                    "submitted": self._counters["submitted"],
                    "completed": self._counters["completed"],
                    "pending": len(eng.pending),
                    "active_slots": len(eng.active),
                    "free_slots": len(eng.free),
                    "num_slots": eng.num_slots,
                    "scheduler": dict(eng.counters),
                    "quantum": eng.quantum,
                    "buckets": list(eng.buckets),
                    "ttft_s": pct(self._ttft),
                    "e2e_s": pct(self._e2e)}

    def stop(self, join: bool = True):
        self._stop = True
        self._wake.set()
        if join:
            self._thread.join(timeout=10)

    # -- scheduler thread ----------------------------------------------------
    def _loop(self):
        try:
            while not self._stop:
                with self._gate:            # clients waiting for the lock go first
                    self._gate.wait_for(lambda: self._waiting == 0)
                with self._lock:
                    busy = bool(self.engine.pending or self.engine.active)
                    if busy:
                        # grad mode is per thread: the engine's own tensor
                        # work runs without autograd here too
                        with torch.no_grad():
                            self.engine.step()
                        self._push_partial_locked()
                        self._harvest_locked()
                if not busy:
                    # park until a submit wakes us (bounded, so stop() is prompt)
                    self._wake.wait(IDLE_POLL_S)
                    self._wake.clear()
        except BaseException as exc:
            with self._lock:
                self._error = exc
                for ev in self._events.values():
                    ev.set()
                failure = self.failure()
                for q in self._streams.values():
                    q.put(failure)
                self._streams.clear()
            raise

    def _push_partial_locked(self):
        """Feed streaming queues the tokens decoded so far (in-flight rows)."""
        if not self._streams:
            return
        for req, out in self.engine.active.values():
            q = self._streams.get(req.req_id)
            if q is None:
                continue
            sent = self._sent[req.req_id]
            for t in out[sent:]:
                q.put(t)
            self._sent[req.req_id] = len(out)

    def _harvest_locked(self):
        eng = self.engine
        for rid in list(eng.results):
            toks = eng.results.pop(rid)
            t = eng.times.pop(rid, {})
            if "first_token" in t:
                self._ttft.append(t["first_token"] - t["submit"])
            if "done" in t:
                self._e2e.append(t["done"] - t["submit"])
            self._counters["completed"] += 1
            q = self._streams.pop(rid, None)
            if q is not None:
                for tok in toks[self._sent.pop(rid, 0):]:
                    q.put(tok)
                q.put(None)              # end of stream
                continue
            ev = self._events.get(rid)
            if ev is not None:
                self._done[rid] = toks
                ev.set()
            # else: a submit nobody waits for (timed out): the tokens are dropped


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the runner and the model context."""
    daemon_threads = True

    def __init__(self, addr, runner: EngineRunner, model_cfg, tokenizer, *,
                 eos_token_id: int, timeout_s: float = 300.0):
        super().__init__(addr, _Handler)
        self.runner = runner
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.eos_token_id = eos_token_id
        self.timeout_s = timeout_s
        self._next_id = 1 << 32          # automatic ids above any sane client id
        self._id_lock = threading.Lock()

    def assign_id(self) -> int:
        with self._id_lock:
            self._next_id += 1
            return self._next_id


class _Handler(BaseHTTPRequestHandler):
    server: ServingHTTPServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):      # quiet
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        runner = self.server.runner
        if self.path == "/healthz":
            if runner.failed:
                self._reply(503, {"ok": False, "error": str(runner.failure())})
            else:
                self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, runner.stats())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/generate":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        runner = self.server.runner
        try:
            n = int(self.headers.get("Content-Length", 0))
            row = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad JSON body: {e}"})
            return
        if "id" not in row:
            row = dict(row, id=self.server.assign_id())
        stream = bool(row.pop("stream", False))
        try:
            req = request_from_row(row, self.server.model_cfg, self.server.tokenizer)
            q = runner.submit_stream(req) if stream else runner.submit(req)
        except (ValueError, KeyError) as e:
            self._reply(400, {"error": str(e)})
            return
        except SchedulerFailed as e:
            self._reply(503, {"error": str(e)})
            return
        if stream:
            self._stream_reply(row["id"], q)
            return
        try:
            toks = runner.result(req.req_id, timeout=self.server.timeout_s)
        except TimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        except SchedulerFailed as e:
            self._reply(500, {"error": str(e)})
            return
        self._reply(200, {"id": row["id"], "tokens": toks, "text": self._decode(toks)})

    def _decode(self, toks):
        if self.server.tokenizer is None:
            return None
        eos = self.server.eos_token_id
        return self.server.tokenizer.decode(toks[:-1] if toks and toks[-1] == eos else toks)

    def _stream_reply(self, req_id, q):
        """Chunked JSONL: one {"token": t} line per decoded token as its
        quantum completes, then a {"done": true, ...} summary line (an
        {"error": ...} line on a timeout or a scheduler failure)."""
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        toks, deadline = [], time.time() + self.server.timeout_s
        while True:
            try:
                t = q.get(timeout=max(0.0, deadline - time.time()))
            except queue.Empty:
                chunk({"error": f"timeout after {self.server.timeout_s}s", "id": req_id,
                       "tokens": toks})
                break
            if isinstance(t, SchedulerFailed):
                chunk({"error": str(t), "id": req_id, "tokens": toks})
                break
            if t is None:
                chunk({"done": True, "id": req_id, "tokens": toks, "text": self._decode(toks)})
                break
            toks.append(t)
            chunk({"token": t})
        self.wfile.write(b"0\r\n\r\n")


def make_server(engine: ServingEngine, model_cfg, tokenizer, *, host: str = "127.0.0.1",
                port: int = 0, timeout_s: float = 300.0) -> ServingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` binds an
    ephemeral port (``server.server_address[1]``).  ``serve_forever()``
    runs it; ``shutdown()``, ``runner.stop()`` and ``server_close()`` tear it
    down."""
    runner = EngineRunner(engine)
    return ServingHTTPServer((host, port), runner, model_cfg, tokenizer,
                             eos_token_id=engine.gen.eos_token_id, timeout_s=timeout_s)
