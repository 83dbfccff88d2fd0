"""The torch port's HTTP front end (``serving/server.py``) on the CPU at the
tiny config in f32: a transport over ``ServingEngine``.  Concurrent blocking
and streamed ``POST /generate`` requests, each picking one of two adapter
sets, give the tokens of the offline engine and of JAX's engine; invalid
requests get 400, unknown paths 404, a request past its deadline 504; a
failed scheduler gives 500 to its waiters and 503 to new work and to
``/healthz`` (the JAX runner's thread dies silently and leaves every client
waiting); ``entry.serve`` with ``SERVE.PORT`` serves until shut down or
interrupted.
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import lora as j_lora
from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.serving import Request as JRequest
from cullavo_tpu.serving import ServingEngine as JEngine
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint import store as t_store
from cullavo_tpu_torch.checkpoint.from_jax import llava_params_to_numpy, lora_to_numpy
from cullavo_tpu_torch.models.llava import lora as t_lora
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.serving import Request as TRequest
from cullavo_tpu_torch.serving import ServingEngine as TEngine
from cullavo_tpu_torch.serving import make_server
from cullavo_tpu_torch.serving.server import ServingHTTPServer

VOCAB, SCALING = 128, 0.25
GEN = tm.GenerationConfig(eos_token_id=-1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sets(tp, cfg, n=2):
    """n LLM adapter sets with a random B (PEFT's zero B would be a no-op)."""
    out = []
    for k in range(n):
        lo = t_lora.init_lora_params(tp, cfg, t_lora.LoraConfig(r=4, alpha=1.0),
                                     torch.Generator().manual_seed(10 + k))["language_model"]
        g = torch.Generator().manual_seed(100 + k)
        for ab in lo.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g) * 0.05
        out.append(lo)
    return out


def _engine_kw(cfg):
    n_img = cfg.num_image_tokens
    buckets = (1 + n_img + 8, 1 + n_img + 16)
    return dict(num_slots=3, max_len=buckets[-1] + 12, prompt_buckets=buckets, prefill_chunk=2,
                quantum=3)


@pytest.fixture(scope="module")
def model():
    cfg = t_tiny(VOCAB)
    tp = tm.init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sets = _sets(tp, cfg)
    return cfg, tp, {"language_model": t_lora.stack_adapter_sets(sets)}, sets


def _serve(engine, cfg, timeout_s=120.0):
    server = make_server(engine, cfg, tokenizer=None, timeout_s=timeout_s)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _close(server):
    server.shutdown()
    server.runner.stop()
    server.server_close()


@pytest.fixture(scope="module")
def served(model):
    cfg, tp, stack, _ = model
    eng = TEngine(tp, cfg, GEN, compute_dtype=torch.float32, lora=stack, lora_scaling=SCALING,
                  **_engine_kw(cfg))
    server = _serve(eng, cfg)
    yield server
    _close(server)


def _request(port, method, path, payload=None, timeout=120):
    """(status, body): a dict, or for a chunked JSONL stream the list of its
    lines."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, None if payload is None else (
        payload if isinstance(payload, bytes) else json.dumps(payload)),
        {"Content-Type": "application/json"})
    r = conn.getresponse()
    body = r.read().decode()
    conn.close()
    if r.getheader("Content-Type") == "application/jsonl":
        return r.status, [json.loads(line) for line in body.splitlines()]
    return r.status, json.loads(body)


def _row(cfg, rng, req_id, text_len, max_new, adapter_id=0):
    n_img = cfg.num_image_tokens
    ids = rng.integers(3, VOCAB - 2, size=(1 + n_img + text_len,)).astype(np.int32)
    ids[1:1 + n_img] = cfg.image_token_id
    pix = rng.normal(size=(3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32)
    row = {"input_ids": ids.tolist(), "image": pix.tolist(), "max_new_tokens": max_new,
           "adapter_id": adapter_id}
    return row if req_id is None else {"id": req_id, **row}


def _as_request(row, cls):
    return cls(req_id=row["id"], input_ids=np.asarray(row["input_ids"], np.int32),
               pixel_values=np.asarray(row["image"], np.float32),
               max_new_tokens=row["max_new_tokens"], adapter_id=row["adapter_id"])


def test_http_concurrent_blocking_and_streamed_match_offline(model, served):
    """Six concurrent clients on a 3-slot pool, half streamed, adapters 0 and
    1: every response equals the offline port engine's and JAX's engine's
    tokens; a stream's token lines equal its final line; /stats counts them
    and ends with an idle pool."""
    cfg, tp, stack, sets = model
    port = served.server_address[1]
    rng = np.random.default_rng(0)
    rows = [_row(cfg, rng, 100 + i, tl, mn, i % 2)
            for i, (tl, mn) in enumerate(zip([3, 8, 14, 5, 15, 2], [6, 10, 4, 12, 7, 1]))]
    results = {}

    def client(i, row):
        results[row["id"]] = _request(port, "POST", "/generate", {**row, "stream": i % 2 == 1})

    threads = [threading.Thread(target=client, args=(i, r)) for i, r in enumerate(rows)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)

    offline = TEngine(tp, cfg, GEN, compute_dtype=torch.float32, lora=stack,
                      lora_scaling=SCALING, **_engine_kw(cfg))
    jp = jax.tree.map(jnp.asarray, llava_params_to_numpy(tp))
    jstack = {"language_model": j_lora.stack_adapter_sets(
        [jax.tree.map(jnp.asarray, lora_to_numpy(s)) for s in sets])}
    jeng = JEngine(jp, j_tiny(VOCAB), jm.GenerationConfig(eos_token_id=-1),
                   compute_dtype=jnp.float32, lora=jstack, lora_scaling=SCALING,
                   **_engine_kw(cfg))
    for row in rows:
        offline.submit(_as_request(row, TRequest))
        jeng.submit(_as_request(row, JRequest))
    want, jwant = offline.run(), jeng.run()
    assert want == jwant
    for i, row in enumerate(rows):
        status, body = results[row["id"]]
        assert status == 200, body
        if i % 2:
            assert body[-1]["done"] is True and body[-1]["id"] == row["id"]
            assert [line["token"] for line in body[:-1]] == body[-1]["tokens"]
            body = body[-1]
        assert body["id"] == row["id"] and body["tokens"] == want[row["id"]], row["id"]
    status, stats = _request(port, "GET", "/stats")
    assert status == 200 and stats["ok"] and stats["completed"] >= 6
    assert stats["active_slots"] == 0 and stats["free_slots"] == stats["num_slots"] == 3
    assert stats["e2e_s"]["n"] >= 6 and stats["ttft_s"]["p95"] >= stats["ttft_s"]["p50"]


def test_http_healthz_ids_and_errors(model, served):
    cfg = model[0]
    port = served.server_address[1]
    assert _request(port, "GET", "/healthz") == (200, {"ok": True})
    rng = np.random.default_rng(7)
    status, body = _request(port, "POST", "/generate", _row(cfg, rng, None, 4, 3))
    assert status == 200 and body["id"] > (1 << 32) and len(body["tokens"]) == 3
    assert body["text"] is None                          # no tokenizer configured
    cases = [(_row(cfg, rng, 900, 40, 4), "bucket"),      # prompt past the largest bucket
             ({"max_new_tokens": 4}, "input_ids"),
             ({**_row(cfg, rng, 901, 4, 3), "image": [[[0.0]]]}, "shape"),
             (_row(cfg, rng, 902, 4, 3, adapter_id=2), "adapter_id 2 out of range"),
             (b"{not json", "bad JSON")]
    for payload, word in cases:
        status, body = _request(port, "POST", "/generate", payload)
        assert status == 400 and word in body["error"], (status, body)
    # an id already answered and collected is fresh again (a duplicate in
    # flight: test_http_deadline_gives_504_and_the_slot_still_completes)
    again = _row(cfg, rng, 4242, 4, 6)
    first = _request(port, "POST", "/generate", {**again, "stream": True})[1]
    status, body = _request(port, "POST", "/generate", again)
    assert status == 200 and body["tokens"] == first[-1]["tokens"]
    assert _request(port, "GET", "/nope")[0] == _request(port, "POST", "/nope", {})[0] == 404


def _slow(engine, seconds):
    step = engine.step

    def slow_step():
        time.sleep(seconds)
        step()

    engine.step = slow_step
    return engine


def test_http_deadline_gives_504_and_the_slot_still_completes(model):
    """A blocking request past ``timeout_s`` gets 504 and a stream its
    timeout line; the request stays in flight (a duplicate of its id is
    refused), then completes and frees its slot, its tokens dropped."""
    cfg, tp, _, _ = model
    eng = _slow(TEngine(tp, cfg, GEN, compute_dtype=torch.float32, **_engine_kw(cfg)), 0.2)
    server = _serve(eng, cfg, timeout_s=0.05)
    port = server.server_address[1]
    rng = np.random.default_rng(3)
    # 12 tokens: the admitting step and three more quanta of 3
    status, body = _request(port, "POST", "/generate", _row(cfg, rng, 1, 4, 12))
    assert status == 504 and "not done" in body["error"]
    row = _row(cfg, rng, 2, 4, 12)
    status, lines = _request(port, "POST", "/generate", {**row, "stream": True})
    assert status == 200 and "timeout" in lines[-1]["error"] and lines[-1]["id"] == 2
    # still in flight (each step sleeps 0.2 s): its id is a duplicate
    status, body = _request(port, "POST", "/generate", row)
    assert status == 400 and "duplicate req_id 2" in body["error"]
    for _ in range(100):
        stats = _request(port, "GET", "/stats")[1]
        if stats["completed"] == 2:
            break
        time.sleep(0.1)
    assert stats["completed"] == 2 and stats["free_slots"] == 3
    assert not server.runner._done and not server.runner._events
    _close(server)


def test_scheduler_failure_gives_500_then_503(model, monkeypatch):
    """An engine whose step raises: the waiting client gets 500 with the
    error long before its 120 s deadline, a stream its error line, later
    work and /healthz 503; the scheduler thread re-raises the error
    (threading.excepthook)."""
    cfg, tp, _, _ = model
    eng = TEngine(tp, cfg, GEN, compute_dtype=torch.float32, **_engine_kw(cfg))
    step, calls = eng.step, []

    def failing_step():
        calls.append(1)
        if len(calls) == 1:          # the first step admits what is pending
            step()
        elif server.runner._counters["submitted"] < 2:
            time.sleep(0.01)         # hold what is in flight until both are waiting
        else:
            raise RuntimeError("device lost")

    eng.step = failing_step
    hooked = []
    monkeypatch.setattr(threading, "excepthook", hooked.append)
    server = _serve(eng, cfg)
    port = server.server_address[1]
    rng = np.random.default_rng(4)
    out = {}
    streamer = threading.Thread(target=lambda: out.setdefault("stream", _request(
        port, "POST", "/generate", {**_row(cfg, rng, 1, 4, 12), "stream": True})))
    t0 = time.perf_counter()
    streamer.start()
    status, body = _request(port, "POST", "/generate", _row(cfg, rng, 2, 5, 12))
    assert status == 500 and "device lost" in body["error"]
    assert time.perf_counter() - t0 < 5.0
    streamer.join(10)
    status, lines = out["stream"]
    assert status == 200 and "device lost" in lines[-1]["error"]
    status, body = _request(port, "GET", "/healthz")
    assert status == 503 and "device lost" in body["error"]
    status, body = _request(port, "POST", "/generate", _row(cfg, rng, 3, 4, 2))
    assert status == 503 and "device lost" in body["error"]
    assert _request(port, "GET", "/stats")[1]["ok"] is False
    assert [type(h.exc_value) for h in hooked] == [RuntimeError]
    assert str(hooked[0].exc_value) == "device lost"
    _close(server)


def test_entry_serve_http_until_shut_down_or_interrupted(model, tmp_path, monkeypatch, capsys):
    """``entry.serve`` with SERVE.PORT on the smoke model, two adapter
    directories and DO_SAMPLE: it prints where it serves, answers a request
    per adapter, and returns the closed server after a shutdown or a
    KeyboardInterrupt (the scheduler stopped)."""
    mcfg = t_entry.smoke_llava_config()
    tp = tm.init_llava_params(mcfg, torch.Generator().manual_seed(1), "cpu")
    dirs = [t_store.save_adapters(str(tmp_path / f"set{k}"), {"language_model": s},
                                  {"r": 4, "alpha": 1.0}) for k, s in enumerate(_sets(tp, mcfg))]
    cfg = {"NAME": "serve", "MODEL": {"LLM": {"LOAD_PATH": None, "BITS": 4}},
           "SERVE": {"PORT": 0, "SLOTS": 4, "QUANTUM": 4, "PREFILL_CHUNK": 4, "KV_QUANT": "int8",
                     "SPEC_K": 4, "DO_SAMPLE": True, "DTYPE": "float32", "ADAPTERS": dirs,
                     "MAX_NEW_TOKENS_MAX": 8}}
    made = []

    def capture(*a, **kw):
        made.append(make_server(*a, **kw))
        return made[-1]

    monkeypatch.setattr(t_entry, "make_server", capture)
    done = {}
    runner = threading.Thread(target=lambda: done.setdefault("server", t_entry.serve(
        cfg, device="cpu")))
    runner.start()
    for _ in range(600):
        if made:
            break
        time.sleep(0.05)
    server = made[0]
    port = server.server_address[1]
    assert server.runner.engine._num_adapters == 2 and server.runner.engine.spec_k is None
    n_img = mcfg.num_image_tokens
    for k in range(2):
        row = {"id": k, "input_ids": [1, mcfg.image_token_id] + [40 + k] * 5,
               "image": np.zeros((3, 28, 28)).tolist(), "max_new_tokens": 8, "adapter_id": k}
        status, body = _request(port, "POST", "/generate", row)
        assert status == 200 and len(body["tokens"]) <= 8 and isinstance(body["text"], str)
    server.shutdown()
    runner.join(30)
    assert done["server"] is server and not server.runner._thread.is_alive()
    err = capsys.readouterr().err
    bucket = -(-(1 + n_img + 72) // 64) * 64
    assert f"[entry] serving on http://127.0.0.1:{port} (buckets=[{bucket}], " \
           f"max_len={bucket + 8})" in err
    with pytest.raises(OSError):
        http.client.HTTPConnection("127.0.0.1", port, timeout=5).request("GET", "/healthz")

    def interrupted(self, poll_interval=0.5):
        raise KeyboardInterrupt

    monkeypatch.setattr(ServingHTTPServer, "serve_forever", interrupted)
    server = t_entry.serve(cfg, device="cpu")
    assert server is made[1] and not server.runner._thread.is_alive()


class _SleepingEngine:
    """The runner's view of an engine whose every request takes ``steps``
    steps of ``seconds`` each (sleeping, so the check needs no CPU)."""

    def __init__(self, steps=10, seconds=0.1):
        self.pending, self.active, self.results, self.times = [], {}, {}, {}
        self.steps, self.seconds, self.n_steps = steps, seconds, 0

    def submit(self, req):
        self.pending.append(req.req_id)

    def step(self):
        time.sleep(self.seconds)
        self.n_steps += 1
        for rid in self.pending:
            self.active[rid] = self.steps
        self.pending = []
        for rid in list(self.active):
            self.active[rid] -= 1
            if not self.active[rid]:
                del self.active[rid]
                self.results[rid] = [1]


def test_runner_hands_the_lock_to_a_client_between_steps():
    """Submits while the engine decodes a 20-step request each wait for at
    most the step in progress (one more if the client thread is preempted
    just as it queues): the runner hands its lock to a waiting client
    between steps.  (JAX's runner takes its plain lock back after every
    step, so such a submit waits until the engine idles, or until the
    threads' timing happens to let it in.)"""
    from cullavo_tpu_torch.serving.server import EngineRunner

    eng = _SleepingEngine(steps=20)
    runner = EngineRunner(eng)
    runner.submit(TRequest(req_id=1, input_ids=np.ones(2, np.int32)))
    waited = []
    for rid in (2, 3, 4):
        time.sleep(0.25)
        n0 = eng.n_steps
        runner.submit(TRequest(req_id=rid, input_ids=np.ones(2, np.int32)))
        waited.append(eng.n_steps - n0)
    assert [runner.result(rid, timeout=30) for rid in (1, 2, 3, 4)] == [[1]] * 4
    runner.stop()
    assert max(waited) <= 2, waited


def test_retired_slots_idle_as_done_in_a_long_lived_engine(model):
    """A slot retired by its budget stops decoding.  Two short requests
    retire beside a long one, then twelve more requests follow one at a
    time into the third slot: through every later quantum (speculative
    windows) the two idle rows stay done and their lookup histories keep
    their length (left decoding, they would outgrow the history table and
    the cache, and the draft's gather would index past it)."""
    cfg, tp, _, _ = model
    eng = TEngine(tp, cfg, GEN, compute_dtype=torch.float32, spec_k=3, **_engine_kw(cfg))
    rng = np.random.default_rng(8)
    first = [_row(cfg, rng, i, 4, budget) for i, budget in enumerate((2, 2, 20))]
    for row in first:
        eng.submit(_as_request(row, TRequest))
    eng.run()
    idle = [s for s in range(3) if s != eng.free[-1]]
    assert len(idle) == 2 and bool(eng.pool["done"][idle].all())
    hist_len = eng.hist["hist_len"][idle].clone()
    for i in range(12):
        eng.submit(_as_request(_row(cfg, rng, 10 + i, 4, 20), TRequest))
        eng.run()
    assert all(len(eng.results[10 + i]) == 20 for i in range(12))
    assert bool(eng.pool["done"][idle].all())
    assert torch.equal(eng.hist["hist_len"][idle], hist_len)
