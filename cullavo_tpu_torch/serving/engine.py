"""Continuous-batching serving engine for the LLaVA family (counterpart of
``cullavo_tpu/serving/engine.py``).

  * requests arrive at any time (``submit``) with their own prompt length,
    image and token budget;
  * prompts are padded to a small set of BUCKET lengths and prefilled in
    right-sized chunks (``generate_prefill``);
  * each prefilled request is written into a free row of a persistent
    decode POOL (``write_slot``, in place) whose rows advance independently:
    per-row write positions, positions and done flags (``decode_quantum`` and
    ``llama_forward``'s per-row scatter path);
  * decode runs in QUANTA of ``quantum`` tokens over the whole pool, plain or
    with prompt-lookup speculative windows (``decode_quantum_spec``); between
    quanta the host harvests finished rows (EOS or budget) and admits queued
    requests into the freed slots;
  * requests sharing a prompt head (a system prompt, or the whole image run
    of several questions about one image) prefill only their suffix from a
    stored 1-row KV prefix (``generate_prefill_prefix``);
  * unmerged runtime LoRA adapters over the (quantized) base: one set for
    every request, or a multi stack (``lora.stack_adapter_sets``) of which
    each request picks one by ``adapter_id`` (prefixes are keyed by it too);
  * greedy or sampled decoding: one ``torch.Generator`` on the engine's
    device, seeded from ``seed``, gives each admission group's first tokens
    one [chunk rows, V] draw and each quantum ``quantum`` draws of
    [num_slots, V] (the JAX engine's key splits, in the same order).

Iteration-level scheduling is the throughput lever at 7B decode: the
per-step weight stream does not depend on the batch, so keeping every pool
row busy amortizes it.  Host reads: the first tokens of a group at
admission, one boolean per speculative window, and the tokens of a quantum
at its harvest.

The scheduler, its counters and its token streams are the JAX engine's.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from cullavo_tpu_torch.models.llava.config import LlavaConfig
from cullavo_tpu_torch.models.llava.llama import round_cache_len
from cullavo_tpu_torch.models.llava.modeling import (GenerationConfig, _cast_params,
                                                     _sample_token,
                                                     alloc_decode_state, decode_quantum,
                                                     decode_quantum_spec,
                                                     extract_prefix_state, generate_prefill,
                                                     generate_prefill_prefix, write_slot)
from cullavo_tpu_torch.ops.wwin_decode import MAX_W as WWIN_MAX_W


@dataclasses.dataclass
class Request:
    """One generation request.  ``input_ids`` must already contain the
    expanded image-token run when ``pixel_values`` is given
    (``modeling.expand_image_token``)."""
    req_id: int
    input_ids: np.ndarray                       # [T] int32
    pixel_values: Optional[np.ndarray] = None   # [3, H, W] float32
    max_new_tokens: int = 16
    adapter_id: int = 0                         # row of the engine's stacked adapters
                                                # (0 when none)
    extra_hist: Optional[np.ndarray] = None     # [E] int32 extra lookup corpus for
                                                # spec_k engines (retrieved text, prior
                                                # turns), prepended to the prompt in
                                                # the n-gram table


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _lcp(a: np.ndarray, b: np.ndarray, n: int) -> int:
    """Length of the common prefix of ``a[:n]`` and ``b[:n]``."""
    eq = a[:n] == b[:n]
    return int(n if eq.all() else np.argmin(eq))


class ServingEngine:
    """Continuous-batching engine over a fixed slot pool.

    Parameters
    ----------
    params, cfg : the LLaVA params/config (quantized bases welcome); the
        engine runs on the device the parameters lie on.
    gen : generation configuration (shared across requests; ``max_new_tokens``
        is ignored: each request carries its own budget).
    num_slots : decode pool rows (the decode batch).
    max_len : pool cache length; every admitted request needs
        ``bucket(T) + max_new_tokens <= max_len``.
    prompt_buckets : ascending prompt pad lengths.
    prefill_chunk : most rows per prefill call (a smaller group runs the
        smallest power of two that holds it, padded with inert rows).
    quantum : decode steps between scheduler interventions.  Smaller =
        faster slot turnaround, more host round-trips.
    seed : the sampler's generator seed (sampled ``gen`` only).
    lora, lora_scaling : runtime adapters (``{"language_model": ...,
        "vision_tower": ...}``, cast once to ``compute_dtype`` as the JAX
        functions cast them per call); a multi stack of LLM adapters serves
        ``Request.adapter_id``.
    """

    def __init__(self, params, cfg: LlavaConfig, gen: GenerationConfig, *,
                 num_slots: int = 8, max_len: int, prompt_buckets=(128, 256),
                 prefill_chunk: int = 2, quantum: int = 8,
                 kv_quant: Optional[str] = None,
                 compute_dtype=torch.bfloat16, seed: int = 0,
                 lora: Optional[dict] = None, lora_scaling: float = 0.0,
                 spec_k: Optional[int] = None,
                 prefix_cache: bool = True, prefix_min: int = 32,
                 suffix_buckets=(32, 64, 128),
                 max_prefixes: Optional[int] = None,
                 admit_groups: Optional[int] = 1):
        self.params = params
        self.cfg = cfg
        self.gen = gen
        self.device = params["language_model"]["embed_tokens"].device
        self.lora = _cast_params(lora, compute_dtype) if lora else None
        self.lora_scaling = float(lora_scaling)
        self._num_adapters = 1
        stacks = [t["a"] for t in ((self.lora or {}).get("language_model") or {}).values()]
        if stacks and stacks[0].dim() == 4:         # a multi stack: [L, K, D, r]
            self._num_adapters = int(stacks[0].shape[1])
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.buckets = tuple(sorted(int(b) for b in prompt_buckets))
        self.prefill_chunk = int(prefill_chunk)
        self.quantum = int(quantum)
        # speculative decode (prompt-lookup windows inside each quantum,
        # decode_quantum_spec): greedy, token-exact vs plain quanta up to f32
        # near-tie argmax.  The per-slot lookup corpus lives in self.hist (on
        # the device), filled at admission with the prompt + first token
        self.spec_k = int(spec_k) if spec_k else None
        if self.spec_k is not None and gen.do_sample:
            # spec is greedy-only; serve.yaml ships SPEC_K 4 by default, so a
            # config that merely flips DO_SAMPLE must not fail here
            print("[engine] do_sample=True disables speculative decoding (spec_k is "
                  "greedy-only); continuing with plain quanta", file=sys.stderr)
            self.spec_k = None
        if self.spec_k is not None:
            # the cache length both packages' speculative callers round to
            # (capacity only grows; extra slots stay masked)
            self.max_len = round_cache_len(self.max_len + self.spec_k)
        self.hist: Optional[dict] = None
        self.kv_quant = kv_quant
        self.compute_dtype = compute_dtype
        # prefix-KV cache.  Registry keys: (image fingerprint | None,
        # adapter_id), LRU-bounded; each entry costs one pool row of device
        # memory (counted in the fit below)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_min = int(prefix_min)       # min shared head worth reusing
        self.suffix_buckets = tuple(sorted(int(b) for b in suffix_buckets))
        # the registry must cover the distinct keys a full admission drain
        # registers before their repeats re-plan (one full group can register
        # prefill_chunk NEW images)
        self.max_prefixes = (int(max_prefixes) if max_prefixes is not None
                             else max(4, self.num_slots // 2))
        self._prefix_reg: collections.OrderedDict = collections.OrderedDict()
        self._req_keys: dict = {}               # req_id -> registry key
        # scheduler counters.  ``suffix_wide_windows``: suffix prefills wider
        # than the window the decode-attention kernels take, which run the
        # plain attention (llama_forward)
        self.counters = {"prefix_hits": 0, "prefix_misses": 0,
                         "prefix_tokens_saved": 0, "prefill_rows": 0,
                         "prefill_pad_rows": 0, "suffix_wide_windows": 0}
        # admission pacing: at most this many prefill groups per step() while
        # decode rows are ACTIVE (bounds how long in-flight rows stall behind
        # prefills); an idle engine always drains its queue.  None = drain
        # every step
        self.admit_groups = admit_groups if admit_groups is None else int(admit_groups)
        self._fit_slots_to_memory()
        self._rng = torch.Generator(device=self.device).manual_seed(int(seed))

        self.pool: Optional[dict] = None
        self.free: list = list(range(self.num_slots))
        self.pending: collections.deque = collections.deque()
        self.active: dict = {}                  # slot -> [request, emitted-token list]
        self.results: dict = {}
        # req_id -> {"submit"/"first_token"/"done": perf_counter seconds};
        # latency() reads it: TTFT is first_token - submit, E2E done - submit
        # (done is seen at a quantum's harvest, so it falls on quantum ends)
        self.times: dict = {}
        self._pix_shape = (3, cfg.vision.image_size, cfg.vision.image_size)

    # -- memory fit ---------------------------------------------------------
    def _pool_bytes_per_slot(self) -> int:
        """Device bytes one decode-pool row costs at the (possibly
        spec-rounded) cache length: k and v, plus the int8 mode's bf16 scale
        planes ([L, S, B, KV]).  The unquantized cache stores
        ``compute_dtype`` elements."""
        t = self.cfg.text
        kv_elems = 2 * t.num_hidden_layers * self.max_len * t.num_key_value_heads * t.head_dim
        if self.kv_quant == "int8":
            scale_elems = 2 * t.num_hidden_layers * self.max_len * t.num_key_value_heads
            return kv_elems + scale_elems * 2
        return kv_elems * torch.empty((), dtype=self.compute_dtype).element_size()

    def _fit_slots_to_memory(self) -> None:
        """Derate ``num_slots`` (with a warning) when the decode pool cannot
        fit next to the weights in device memory.  Budget: the
        ``CULLAVO_SERVE_HBM_GB`` override, else the card's total memory
        (``torch.cuda.mem_get_info``); with neither (CPU tensors) nothing
        changes.  An engine whose pool cannot fit even one slot fails fast
        with the numbers."""
        env = os.environ.get("CULLAVO_SERVE_HBM_GB")
        if env:
            budget = float(env) * 1e9
        elif self.device.type == "cuda":
            budget = float(torch.cuda.mem_get_info(self.device)[1])
        else:
            return
        weights = sum(t.numel() * t.element_size()
                      for tree in (self.params, self.lora or {}) for t in _tree_leaves(tree))
        avail = budget * 0.92 - weights          # 8% workspace margin
        per_slot = self._pool_bytes_per_slot()
        if self.prefix_cache:
            # each registry entry holds one pool-row-sized 1-row cache
            avail -= self.max_prefixes * per_slot
        fit = int(avail // per_slot)
        if fit < 1:
            raise ValueError(
                f"decode pool cannot fit: one slot needs {per_slot / 1e9:.2f} GB at "
                f"max_len={self.max_len} kv_quant={self.kv_quant} but only "
                f"{max(avail, 0) / 1e9:.2f} GB remain of the {budget / 1e9:.1f} GB budget "
                f"after {weights / 1e9:.2f} GB of weights (set KV_QUANT: int8, shorten "
                f"MAX_LEN, or raise CULLAVO_SERVE_HBM_GB if the device is larger)")
        if fit < self.num_slots:
            print(f"[engine] derating SLOTS {self.num_slots} -> {fit}: pool needs "
                  f"{self.num_slots * per_slot / 1e9:.2f} GB (kv_quant={self.kv_quant}, "
                  f"max_len={self.max_len}{', spec-rounded' if self.spec_k else ''}) but "
                  f"only {avail / 1e9:.2f} GB fit next to {weights / 1e9:.2f} GB of weights "
                  f"in the {budget / 1e9:.1f} GB budget", file=sys.stderr)
            self.num_slots = fit    # the constructor builds self.free next

    # -- submission ---------------------------------------------------------
    def submit(self, req: Request) -> int:
        T = int(len(req.input_ids))
        b = self._bucket(T)
        if b + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.req_id}: bucket({T})={b} + max_new_tokens="
                f"{req.max_new_tokens} exceeds max_len={self.max_len}")
        if not (0 <= req.adapter_id < self._num_adapters):
            raise ValueError(
                f"request {req.req_id}: adapter_id {req.adapter_id} out of range "
                f"(engine serves {self._num_adapters} adapter(s))")
        # results are keyed by req_id: a duplicate would silently overwrite
        # another request's stream
        if (req.req_id in self.results
                or any(r.req_id == req.req_id for r in self.pending)
                or any(st[0].req_id == req.req_id for st in self.active.values())):
            raise ValueError(f"duplicate req_id {req.req_id}")
        self.times[req.req_id] = {"submit": time.perf_counter()}
        self.pending.append(req)
        return req.req_id

    def _bucket(self, T: int) -> int:
        for b in self.buckets:
            if T <= b:
                return b
        raise ValueError(f"prompt length {T} exceeds the largest bucket {self.buckets[-1]}")

    # -- prefix registry ----------------------------------------------------
    def _req_key(self, req: Request):
        """Registry key: (image fingerprint | None, adapter_id).  Cached per
        req_id (the pixel hash reads ~1.3 MB)."""
        k = self._req_keys.get(req.req_id)
        if k is None:
            fp = None
            if req.pixel_values is not None:
                fp = hashlib.md5(np.ascontiguousarray(req.pixel_values)).hexdigest()
            k = (fp, int(req.adapter_id))
            self._req_keys[req.req_id] = k
        return k

    def _split(self, stored: np.ndarray, req: Request):
        """``(P, W_b)`` if ``req`` can reuse the first P tokens of a prompt
        ``stored`` and prefill the rest as a W_b-bucket suffix (layout
        [0, P + W_b)), else None."""
        ids = np.asarray(req.input_ids)
        lcp = _lcp(stored, ids, min(len(stored), len(ids), len(ids) - 1))  # >= 1-token suffix
        # the reuse point must NOT split an image-token run: the suffix
        # forward ranks its image slots from 0 (merge_image_features), so a
        # cut inside the run would hand the trailing image tokens the WRONG
        # features.  A cut at either end of the run is exact
        img = np.nonzero(ids == self.cfg.image_token_id)[0]
        run = (int(img[0]), int(img[-1]) + 1) if img.size else None

        def settle(p):
            # out of the run, then down to a 32-multiple so that requests
            # with other question/budget lengths share one (P, wb) group
            # (identical prefix tokens make any P <= LCP token-exact)
            if run and run[0] < p < run[1]:
                p = run[0]
            return (p // 32) * 32 if p >= 64 else p

        for wb in self.suffix_buckets:
            # the reuse point may sit BELOW the LCP: the layout [0, P + wb)
            # plus the decode budget must fit the pool cache
            p = settle(min(lcp, self.max_len - wb - req.max_new_tokens))
            # rounding down can land inside the run again: settle once more
            # (the run's start, or the 32-multiple below it, is outside)
            p = settle(p)
            if p >= self.prefix_min and len(ids) - p <= wb:
                return int(p), wb
        return None

    def _plan(self, req: Request):
        """Prefill plan for a request: ``("full", bucket)`` or
        ``("prefix", key, P, W_b)``."""
        if self.prefix_cache:
            key = self._req_key(req)
            entry = self._prefix_reg.get(key)
            if entry is not None:
                split = self._split(entry["ids"], req)
                if split is not None:
                    self._prefix_reg.move_to_end(key)       # LRU touch
                    return ("prefix", key) + split
        return ("full", self._bucket(len(req.input_ids)))

    def _maybe_register(self, group, chunk):
        """Store new prefixes out of a finished prefill chunk: each row's
        cache IS the full KV of its prompt, so one row copy
        (extract_prefix_state) seeds the registry for later requests sharing
        that image/prompt head."""
        if not self.prefix_cache:
            return
        for i, r in enumerate(group):
            key = self._req_key(r)
            if key in self._prefix_reg or len(r.input_ids) < self.prefix_min + 1:
                continue
            self._prefix_reg[key] = {"ids": np.asarray(r.input_ids, np.int32),
                                     "state": extract_prefix_state(chunk, i)}
            while len(self._prefix_reg) > self.max_prefixes:
                self._prefix_reg.popitem(last=False)

    @staticmethod
    def _pow2_rows(n: int, cap: int) -> int:
        """Smallest power-of-two chunk that fits the group (<= cap): single
        arrivals in open-loop serving prefill 1 row instead of padding to
        the full chunk."""
        b = 1
        while b < n:
            b *= 2
        return min(b, cap)

    # -- admission ----------------------------------------------------------
    def _admit(self, max_groups: Optional[int] = None):
        """Prefill queued requests (grouped by prefill plan, right-sized
        chunk rows) and write them into free slots.  ``max_groups`` bounds
        the prefill calls of this pass (admission pacing, ``admit_groups``)."""
        n_groups = 0
        while self.pending and self.free and (max_groups is None or n_groups < max_groups):
            self._admit_one_group()
            n_groups += 1

    def _take_group(self):
        """Up to prefill_chunk pending requests sharing the first pending
        request's plan, bounded by the free slots; the others keep their
        arrival order."""
        lead = self._plan(self.pending[0])
        group, rest = [], collections.deque()
        group_key_reqs: dict = {}
        while self.pending and len(group) < min(self.prefill_chunk, len(self.free)):
            r = self.pending.popleft()
            if self._plan(r) != lead:
                rest.append(r)
                continue
            if lead[0] == "full" and self.prefix_cache:
                # defer same-key requests out of a full-prefill group: this
                # chunk REGISTERS its keys, so the deferred ones re-plan as
                # prefix hits next group instead of paying a second full
                # prefill.  Only when deferral BUYS a hit: the request must
                # be able to reuse the earlier one's prompt (a shared head
                # and a rest that fits a suffix bucket)
                key = self._req_key(r)
                earlier = group_key_reqs.get(key)
                if earlier is None:
                    group_key_reqs[key] = r
                elif (len(earlier.input_ids) >= self.prefix_min + 1
                      and self._split(np.asarray(earlier.input_ids), r) is not None):
                    rest.append(r)
                    continue
            group.append(r)
        while rest:
            self.pending.appendleft(rest.pop())
        return lead, group

    def _to_dev(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _admit_one_group(self):
        lead, group = self._take_group()
        chunk_b = self._pow2_rows(len(group), self.prefill_chunk)
        self.counters["prefill_rows"] += chunk_b
        self.counters["prefill_pad_rows"] += chunk_b - len(group)
        aids = np.zeros((chunk_b,), np.int32)          # pad rows: adapter 0
        for i, r in enumerate(group):
            aids[i] = r.adapter_id
        adapters = dict(lora=self.lora, lora_scaling=self.lora_scaling,
                        adapter_ids=self._to_dev(aids))

        if lead[0] == "prefix":
            _, key, P, wb = lead
            self.counters["prefix_hits"] += len(group)
            self.counters["prefix_tokens_saved"] += P * len(group)
            if wb > WWIN_MAX_W:
                self.counters["suffix_wide_windows"] += 1
            sfx = np.zeros((chunk_b, wb), np.int32)
            smask = np.zeros((chunk_b, wb), np.int32)
            for i, r in enumerate(group):
                row = np.asarray(r.input_ids, np.int32)[P:]
                sfx[i, :len(row)] = row
                smask[i, :len(row)] = 1
            for i in range(len(group), chunk_b):
                smask[i, 0] = 1          # inert pad rows (see the full path)
            # the suffix carries the image run only when the shared head ends
            # before it (text-shared-prefix corpora); same-image reuse has
            # the whole run inside the prefix
            pix = None
            if any((np.asarray(r.input_ids)[P:] == self.cfg.image_token_id).any()
                   for r in group if r.pixel_values is not None):
                pix = np.zeros((chunk_b,) + self._pix_shape, np.float32)
                for i, r in enumerate(group):
                    if r.pixel_values is not None:
                        pix[i] = r.pixel_values
            chunk = generate_prefill_prefix(
                self.params, self.cfg, self._prefix_reg[key]["state"], self._to_dev(sfx),
                None if pix is None else self._to_dev(pix), self._to_dev(smask), P,
                compute_dtype=self.compute_dtype, **adapters)
        else:
            bucket = lead[1]
            if self.prefix_cache:
                self.counters["prefix_misses"] += len(group)
            ids = np.zeros((chunk_b, bucket), np.int32)
            mask = np.zeros((chunk_b, bucket), np.int32)
            any_pix = any(r.pixel_values is not None for r in group)
            pix = np.zeros((chunk_b,) + self._pix_shape, np.float32) if any_pix else None
            for i, r in enumerate(group):
                T = len(r.input_ids)
                ids[i, :T] = np.asarray(r.input_ids, np.int32)
                mask[i, :T] = 1
                if r.pixel_values is not None:
                    pix[i] = r.pixel_values
            # inert pad rows (group < chunk): an all-pad mask would make the
            # last index negative in generate_prefill; give them 1 valid token
            for i in range(len(group), chunk_b):
                mask[i, 0] = 1
            chunk = generate_prefill(
                self.params, self.cfg, self._to_dev(ids),
                None if pix is None else self._to_dev(pix), self._to_dev(mask),
                self.max_len, compute_dtype=self.compute_dtype, kv_quant=self.kv_quant,
                **adapters)
        self._maybe_register(group, chunk)
        first = _sample_token(chunk["logits"], self.gen, self._rng).cpu().numpy()
        t_first = time.perf_counter()

        if self.pool is None:
            self.pool = alloc_decode_state(chunk, self.num_slots)
            for name, dtype in (("write_idx", torch.int32), ("cur_tok", torch.int32)):
                self.pool[name] = torch.zeros((self.num_slots,), dtype=dtype, device=self.device)
            # idle rows decode as done (emit eos, write nothing useful)
            self.pool["done"] = torch.ones((self.num_slots,), dtype=torch.bool,
                                           device=self.device)
        if self.spec_k is not None and self.hist is None:
            cap = self.max_len + self.quantum + self.spec_k
            self.hist = {"hist": torch.zeros((self.num_slots, cap), dtype=torch.int32,
                                             device=self.device),
                         "hist_len": torch.zeros((self.num_slots,), dtype=torch.int32,
                                                 device=self.device)}

        # slot -1 = not admitted (pad rows, finished at admission)
        slots_vec = np.full((chunk_b,), -1, np.int32)
        for i, r in enumerate(group):
            tok = int(first[i])
            out = [tok]
            self.times[r.req_id]["first_token"] = t_first
            if tok == self.gen.eos_token_id or r.max_new_tokens <= 1:
                # finished at admission: never occupies a slot
                self.results[r.req_id] = out
                self.times[r.req_id]["done"] = t_first
                self._req_keys.pop(r.req_id, None)
                continue
            slot = self.free.pop()
            slots_vec[i] = slot
            self.active[slot] = [r, out]
        if not (slots_vec >= 0).any():
            return
        for i in np.nonzero(slots_vec >= 0)[0]:
            # done0=False: eos-at-admission rows never reach a slot
            self.pool = write_slot(self.pool, chunk, int(i), int(slots_vec[i]),
                                   int(first[i]), False)
        if self.spec_k is not None:
            cap = self.hist["hist"].shape[1]
            for i, r in enumerate(group):
                slot = int(slots_vec[i])
                if slot < 0:
                    continue
                # lookup corpus = valid prompt tokens + the first sampled
                # token (current token LAST, the _ngram_draft contract);
                # extra_hist (e.g. retrieved text) goes in front
                pre = (np.asarray(r.extra_hist, np.int32) if r.extra_hist is not None
                       else np.zeros((0,), np.int32))
                T = len(r.input_ids)
                row = np.zeros((cap,), np.int32)
                row[:len(pre)] = pre
                row[len(pre):len(pre) + T] = np.asarray(r.input_ids, np.int32)
                row[len(pre) + T] = int(first[i])
                self.hist["hist"][slot] = self._to_dev(row)
                self.hist["hist_len"][slot] = len(pre) + T + 1

    # -- scheduling ---------------------------------------------------------
    def step(self):
        """One scheduler iteration: admit into free slots, then decode one
        quantum over the pool and harvest finished rows.  While rows are
        actively decoding, at most ``admit_groups`` prefill calls run per
        step (each prefill stalls every in-flight row for its duration); an
        idle engine drains its whole queue before the first quantum."""
        self._admit(None if not self.active else self.admit_groups)
        if not self.active:
            return
        if self.spec_k is not None:
            toks, n_emit, self.pool, self.hist = decode_quantum_spec(
                self.params, self.cfg, self.pool, self.hist, self.gen, self.quantum,
                self.spec_k, compute_dtype=self.compute_dtype, lora=self.lora,
                lora_scaling=self.lora_scaling)
            toks = toks.cpu().numpy()               # [num_slots, quantum]
            n_emit = n_emit.cpu().numpy()
        else:
            toks, self.pool = decode_quantum(self.params, self.cfg, self.pool, self.gen,
                                             self.quantum, rng=self._rng,
                                             compute_dtype=self.compute_dtype, lora=self.lora,
                                             lora_scaling=self.lora_scaling)
            toks = toks.cpu().numpy()               # [num_slots, quantum]
            n_emit = np.full((toks.shape[0],), toks.shape[1], np.int64)
        retired = []
        for slot in list(self.active):
            req, out = self.active[slot]
            for t in toks[slot][:n_emit[slot]]:
                t = int(t)
                out.append(t)
                if t == self.gen.eos_token_id or len(out) >= req.max_new_tokens:
                    break
            if (out and out[-1] == self.gen.eos_token_id) or len(out) >= req.max_new_tokens:
                self.results[req.req_id] = out[:req.max_new_tokens]
                self.times[req.req_id]["done"] = time.perf_counter()
                self._req_keys.pop(req.req_id, None)
                del self.active[slot]
                self.free.append(slot)
                retired.append(slot)
        if retired:
            # a row retired by its budget is not done on the device: it would
            # go on decoding in every later quantum until its slot is reused,
            # past its cache and its lookup history (the JAX engine lets it
            # run, where an out-of-range gather does not fail).  Idle rows
            # decode as done
            self.pool["done"][self._to_dev(retired, torch.int64)] = True

    def run(self) -> dict:
        """Drive until every submitted request has a result; returns
        {req_id: [token, ...]}."""
        while self.pending or self.active:
            self.step()
        return self.results

    def latency(self) -> dict:
        """Per-request latency over completed requests:
        {"ttft": {"p50": ..., "p95": ...}, "e2e": {...}} in seconds."""
        ttft = [t["first_token"] - t["submit"] for t in self.times.values()
                if "first_token" in t]
        e2e = [t["done"] - t["submit"] for t in self.times.values() if "done" in t]

        def pct(xs):
            return {"p50": round(float(np.percentile(xs, 50)), 4),
                    "p95": round(float(np.percentile(xs, 95)), 4)} if xs else {}

        return {"ttft": pct(ttft), "e2e": pct(e2e)}
