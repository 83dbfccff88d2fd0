"""Beam search with the semantics of transformers' ``BeamSearchScorer``
(counterpart of ``cullavo_tpu/models/beam.py``): the reference decodes its
BLIP-2 answers with ``num_beams=5, length_penalty=-1``.

  * candidate scores are summed log-probs; the top ``2 * num_beams`` per
    batch row are considered each step, in rank order;
  * an eos candidate of rank < num_beams becomes a finished hypothesis
    scored ``sum_logprobs / generated_len ** length_penalty`` (the eos
    counts toward the length but is not stored);
  * non-eos candidates fill the next ``num_beams`` beams in rank order;
  * a row is done (early_stopping=False) when it holds ``num_beams``
    hypotheses and the worst is >= the best attainable
    ``best_sum_logprobs / generated_len ** length_penalty``;
  * at the end, still-open beams join the pool, the best hypothesis is
    emitted, and eos is appended where there is room.

Like the JAX ``lax.scan`` it runs ``max_new_tokens`` steps whatever the
done flags say (a done row is frozen), and skips the model step after the
last one.  Ties in the top-k selections go to the lower index, as
``jax.lax.top_k`` breaks them: a stable descending sort, not ``torch.topk``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

NEG_INF = -1.0e9


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries per row, ties to the
    lower index (``jax.lax.top_k``'s order, which ``torch.topk`` does not
    promise)."""
    idx = torch.argsort(x, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(x, 1, idx), idx


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [B, N, ...] gathered along axis 1 at idx [B, M]."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


def beam_search(step_fn: Callable[[torch.Tensor, Any, int], tuple],
                reorder_fn: Callable[[Any, torch.Tensor], Any],
                init_logits: torch.Tensor, init_state: Any, batch: int, num_beams: int,
                max_new_tokens: int, eos_token_id: int, pad_token_id: int = 0,
                length_penalty: float = 1.0) -> torch.Tensor:
    """Generated tokens [B, max_new_tokens] of the best hypothesis
    (eos-terminated, pad-filled), HF ``generate(num_beams=...)`` minus the
    prompt / decoder-start prefix.

    ``init_logits`` [B * nb, V] are the logits of the first generated token
    (rows b * nb + j are batch row b's beams).  ``step_fn(tokens [B * nb],
    state, step_idx) -> (logits, state)`` feeds the tokens chosen at step t
    with ``step_idx = t + 1``; ``reorder_fn(state, flat_parent [B * nb])``
    gathers every state row to its beam parent first."""
    B, nb, T = batch, num_beams, max_new_tokens
    dev = init_logits.device
    V = init_logits.shape[-1]
    k2 = 2 * nb
    f32 = torch.float32

    beam_scores = torch.full((B, nb), NEG_INF, dtype=f32, device=dev)
    beam_scores[:, 0] = 0.0
    seq = torch.full((B, nb, T), pad_token_id, dtype=torch.int32, device=dev)
    hyp_score = torch.full((B, nb), -torch.inf, dtype=f32, device=dev)
    hyp_seq = torch.full((B, nb, T), pad_token_id, dtype=torch.int32, device=dev)
    hyp_len = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    rank = torch.arange(k2, device=dev)[None, :]
    beam_ids = torch.arange(nb, device=dev)[None, :]
    logits, state = init_logits, init_state

    for t in range(T):
        logp = torch.log_softmax(logits.to(f32), dim=-1)
        cand = (beam_scores.reshape(B * nb, 1) + logp).reshape(B, nb * V)
        vals, idx = top_k(cand, k2)                           # [B, 2nb], rank order
        tok = (idx % V).to(torch.int32)
        parent = idx // V
        is_eos = tok == eos_token_id

        # finished hypotheses: eos candidates of rank < nb
        pen = torch.tensor(t + 1, dtype=f32, device=dev) ** length_penalty
        eligible = is_eos & (rank < nb) & ~done[:, None]
        cand_norm = torch.where(eligible, vals / pen, torch.full_like(vals, -torch.inf))
        all_scores = torch.cat([hyp_score, cand_norm], dim=1)
        all_seq = torch.cat([hyp_seq, _take_rows(seq, parent)], dim=1)
        all_len = torch.cat([hyp_len, torch.full((B, k2), t, dtype=torch.int32, device=dev)],
                            dim=1)
        hyp_score, top_i = top_k(all_scores, nb)
        hyp_seq = _take_rows(all_seq, top_i)
        hyp_len = torch.gather(all_len, 1, top_i)

        # beam continuation: the first nb non-eos candidates in rank order
        order = torch.argsort(rank + is_eos.to(rank.dtype) * (4 * nb), dim=1, stable=True)[:, :nb]
        new_scores = torch.gather(vals, 1, order)
        new_tok = torch.gather(tok, 1, order)
        new_parent = torch.gather(parent, 1, order)
        frozen = done[:, None]
        new_scores = torch.where(frozen, beam_scores, new_scores)
        new_parent = torch.where(frozen, beam_ids, new_parent)
        new_tok = torch.where(frozen, torch.full_like(new_tok, pad_token_id), new_tok)
        seq = _take_rows(seq, new_parent)
        seq[:, :, t] = torch.where(frozen, seq[:, :, t], new_tok)

        # done test (HF is_done, early_stopping=False)
        full = hyp_score[:, -1] > -torch.inf
        done = done | (full & (hyp_score[:, -1] >= vals[:, 0] / pen))
        beam_scores = new_scores.to(f32)

        if t + 1 < T:      # the last step's logits would never be read
            flat_parent = (torch.arange(B, device=dev)[:, None] * nb + new_parent).reshape(-1)
            logits, state = step_fn(new_tok.reshape(-1), reorder_fn(state, flat_parent), t + 1)

    # finalize: open beams join the pool of rows that are not done
    pen = torch.tensor(T, dtype=f32, device=dev) ** length_penalty
    open_norm = torch.where(done[:, None], torch.full_like(beam_scores, -torch.inf),
                            beam_scores / pen)
    all_scores = torch.cat([hyp_score, open_norm], dim=1)
    all_seq = torch.cat([hyp_seq, seq], dim=1)
    all_len = torch.cat([hyp_len, torch.full((B, nb), T, dtype=torch.int32, device=dev)], dim=1)
    best = torch.argmax(all_scores, dim=1)
    out = _take_rows(all_seq, best[:, None])[:, 0]
    out_len = torch.gather(all_len, 1, best[:, None])
    # append eos where there is room (HF: decoded[..., sent_length] = eos)
    pos = torch.arange(T, device=dev)[None, :]
    out = torch.where(pos == out_len, torch.full_like(out, eos_token_id), out)
    return torch.where(pos > out_len, torch.full_like(out, pad_token_id), out)
