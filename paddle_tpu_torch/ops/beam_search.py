"""Beam search: the eager decoder and the static `beam_search` /
`beam_search_decode` ops.

Counterpart of paddle_tpu/ops/beam_search.py. Beams are fixed [B, K]
tensors; a finished beam is frozen (its only continuation is EOS at log
probability 0, every other token at NEG_INF), scores are accumulated log
probabilities, and the eager decoder's final scores take GNMT's length
penalty ((5 + len) / 6) ** alpha.

The flat top-K over a row's K·V candidates breaks ties toward the lower
flat index, as `lax.top_k` does: frozen beams put every non-EOS
candidate at the same `pre + NEG_INF`, so exact ties are common. It is a
stable descending sort (`torch.topk` promises no order among equal
values on CUDA; `ops.math.top_k_lowest_index`, also the `top_k` op's).
Scores are float32, or float64 when the inputs are.
"""
import time

import torch

from paddle_tpu_torch.core.dtypes import at_least_f32_dtype
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.math import top_k_lowest_index

__all__ = ["NEG_INF", "beam_search", "tile_beam", "host_reads",
           "reset_host_reads"]

NEG_INF = -1e9

#: the eager decoder's reads of `all(finished)` on the host and the
#: seconds the host waited in them
host_reads = {"beam_search": 0, "wait_s": 0.0}


def reset_host_reads():
    for k in host_reads:
        host_reads[k] = type(host_reads[k])(0)


def _all_finished(fin):
    host_reads["beam_search"] += 1
    t0 = time.perf_counter()
    value = bool(fin.all())
    host_reads["wait_s"] += time.perf_counter() - t0
    return value


def _prune_step(pre_logp, fin, logits, beam_size, eos_id):
    """One pruning step shared by the eager decoder and the static op:
    freeze finished beams, accumulate log-probs, flat top-K over K*V.
    Returns (new tokens [B, K] int32, top log-probs [B, K], source beams
    [B, K] int32)."""
    b, v = logits.shape[0], logits.shape[-1]
    dt = at_least_f32_dtype(pre_logp, logits)
    step_logp = torch.log_softmax(logits.to(dt), dim=-1)
    eos_row = torch.full((v,), NEG_INF, dtype=dt, device=logits.device)
    # a fill, not an assignment of a Python float (a copy from the host,
    # which a CUDA graph capture refuses)
    eos_row.narrow(0, eos_id, 1).fill_(0.0)
    step_logp = torch.where(fin[..., None], eos_row, step_logp)
    cand = pre_logp.to(dt)[..., None] + step_logp                # [B, K, V]
    top_logp, top_idx = top_k_lowest_index(cand.reshape(b, beam_size * v),
                                           beam_size)
    return ((top_idx % v).to(torch.int32), top_logp,
            torch.div(top_idx, v, rounding_mode="floor").to(torch.int32))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def beam_search(step_fn, init_state, batch_size, beam_size, vocab_size,
                bos_id, eos_id, max_len, length_penalty=0.6, device=None):
    """Decode with beam search on the device of `init_state`'s tensors
    (or `device`; None with no tensor in the state means CUDA).

    step_fn(tokens [B*K] int32, state) -> (logits [B*K, V], new_state):
    one decoder step; every leaf of `state` (dicts, lists, tuples of
    tensors) has leading dim B*K (tile encoder outputs with `tile_beam`).
    The loop stops at max_len or once every beam has finished (one host
    read an iteration). Returns (sequences [B, K, max_len] int32,
    scores [B, K]) best beam first."""
    from paddle_tpu_torch.core.places import resolve_device
    leaves = []
    _tree_map(leaves.append, init_state)
    dev = (leaves[0].device if leaves and isinstance(leaves[0], torch.Tensor)
           else resolve_device(device))
    B, K = batch_size, beam_size
    tokens = torch.full((B, K), bos_id, dtype=torch.int32, device=dev)
    logp = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    logp[:, 0] = 0.0                  # only beam 0 is live at t = 0
    fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
    seqs = torch.full((B, K, max_len), eos_id, dtype=torch.int32, device=dev)
    state = init_state
    offsets = torch.arange(B, device=dev)[:, None] * K
    t = 0
    while t < max_len and not _all_finished(fin):
        logits, new_state = step_fn(tokens.reshape(B * K), state)
        tokens, logp, src = _prune_step(logp, fin, logits.reshape(B, K, -1),
                                        K, eos_id)
        src = src.to(torch.int64)
        seqs = torch.take_along_dim(seqs, src[..., None], dim=1)
        seqs[:, :, t] = tokens
        fin = torch.take_along_dim(fin, src, dim=1) | (tokens == eos_id)
        flat = (src + offsets).reshape(-1)
        state = _tree_map(lambda x: x.index_select(0, flat), new_state)
        t += 1
    has_eos = (seqs == eos_id)
    lengths = torch.where(has_eos.any(-1),
                          torch.argmax(has_eos.to(torch.int32), dim=-1) + 1,
                          torch.full_like(seqs[..., 0], max_len,
                                          dtype=torch.int64))
    scores = logp / ((5.0 + lengths.to(logp.dtype)) / 6.0) ** length_penalty
    order = torch.argsort(-scores, dim=-1, stable=True)
    return (torch.take_along_dim(seqs, order[..., None], dim=1),
            torch.take_along_dim(scores, order, dim=1))


def tile_beam(x, beam_size):
    """[B, ...] → [B*K, ...]: each row repeated for the beam dimension."""
    return torch.repeat_interleave(x, beam_size, dim=0)


@register_op("beam_search", inputs=["PreIds", "PreScores", "Scores"],
             outputs=["SelectedIds", "SelectedScores", "ParentIdx"])
def _beam_search_step(ctx, pre_ids, pre_scores, scores):
    """beam_search_op.cc on fixed [B, K] beams: Scores is the decoder's
    raw [B, K, V] logits (log-softmaxed and accumulated here); a beam
    whose last id is end_id is finished."""
    fin = pre_ids.to(torch.int32) == ctx.attr("end_id")
    return _prune_step(pre_scores, fin, scores, ctx.attr("beam_size"),
                       ctx.attr("end_id"))


@register_op("beam_search_decode", inputs=["Ids", "Parents", "FinalScores"],
             outputs=["SentenceIds", "SentenceScores"])
def _beam_search_decode(ctx, ids, parents, final_scores):
    """beam_search_decode_op.cc: backtrace the stacked [T, B, K] per-step
    ids and parents into [B, K, T] hypotheses, end_id after the first
    end_id. attr length_penalty (0: off) divides the scores by
    ((5 + len) / 6) ** alpha, len counted to the first end_id."""
    end_id = ctx.attr("end_id")
    t, b, k = ids.shape
    beam = torch.arange(k, device=ids.device)[None, :].expand(b, k)
    toks = [None] * t
    for s in range(t - 1, -1, -1):
        toks[s] = torch.gather(ids[s].to(torch.int32), 1, beam)
        beam = torch.gather(parents[s].to(torch.int64), 1, beam)
    seq = torch.stack(toks, dim=-1)                               # [B, K, T]
    is_end = (seq == end_id).to(torch.int32)
    prev_end = torch.cumsum(is_end, dim=-1) - is_end > 0
    seq = torch.where(prev_end, torch.full_like(seq, end_id), seq)
    alpha = ctx.attr("length_penalty", 0.0)
    if alpha:
        ends = seq == end_id
        lengths = torch.where(ends.any(-1),
                              torch.argmax(ends.to(torch.int32), dim=-1) + 1,
                              torch.full_like(seq[..., 0], t,
                                              dtype=torch.int64))
        final_scores = final_scores / (
            (5.0 + lengths.to(final_scores.dtype)) / 6.0) ** alpha
    return seq, final_scores
