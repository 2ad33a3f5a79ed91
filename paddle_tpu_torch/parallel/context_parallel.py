"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

Counterpart of paddle_tpu/parallel/context_parallel.py. The JAX functions
run inside `shard_map` over a mesh axis that shards the sequence; here
each rank calls them on its own sequence shard [B, T_local, N, D], with
the bound mesh's `axis_name` dim (parallel/env.py) over the ranks that
hold the shards in sequence order:

* **ring attention** (`ring_attention`, `ring_flash_attention`): K, V
  and the key bias rotate around the ring with `ops.collective.permute`
  (its gradient is the reverse rotation) while each rank keeps its Q
  shard; partial results merge by the online-softmax rule, so the full
  T×T score matrix never exists. `ring_flash_attention` computes each
  chunk with the flash kernel (`flash_attention_lse`, K1/K4f forward,
  K2/K3/K4b backward with the lse cotangent folded into delta) and
  merges by log-sum-exp in float32. Under causal masking each chunk is
  the diagonal (causal within it), wholly past (full attention) or
  wholly future (skipped): the rank's own index picks the branch in
  Python, as `lax.cond` does in the JAX package, with no host read.
* **Ulysses** (`ulysses_attention`): two all-to-alls re-shard
  [B, T/P, N, D] → [B, T, N/P, D], attention runs on the full sequence
  over a head shard (`attention_fn`; `flash_attention_fn` is the flash
  kernel), and the result shards back. Needs N % P == 0.

Both take the additive key bias [B, 1, 1, T_local] or [B, T_local] of
the local keys and support causal masking with global offsets. The
clamps for fully masked rows are the reference's (:240-247).
`shard_map_attention` dispatches on `impl` over a rank's shards, and
`shard_sequence` cuts a global [B, T, ...] array into this rank's shard
(batch over an optional `batch_axis`, sequence over `axis`).
"""
import math

import torch

from paddle_tpu_torch.ops.collective import all_gather, all_to_all, permute
from paddle_tpu_torch.parallel.env import axis_info, bind_mesh

__all__ = ["ring_attention", "ring_flash_attention", "ulysses_attention",
           "flash_attention_fn", "shard_map_attention", "shard_sequence"]

NEG_INF = -1e30


def _partial_attention(q, k, v, bias, causal, q_off, k_off, sm_scale):
    """One ring step: unnormalised attention of local q against one k/v
    chunk; (acc [B,T,N,D] f32, row max, row sum [B,T,N,1])."""
    logits = torch.einsum("btnd,bsnd->bnts", q.float(), k.float()) \
        * sm_scale
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        rows = q_off + torch.arange(tq, device=q.device)[:, None]
        cols = k_off + torch.arange(tk, device=q.device)[None, :]
        logits = torch.where(cols <= rows, logits,
                             torch.full_like(logits, NEG_INF))
    m = torch.amax(logits, dim=-1, keepdim=True)
    # a fully masked row: exp(NEG_INF - NEG_INF) = 1 would fabricate mass
    m = torch.clamp(m, min=-1e28)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bnts,bsnd->btnd", p.to(v.dtype).float(), v.float())
    return acc, m.permute(0, 2, 1, 3), l.permute(0, 2, 1, 3)


def _merge(acc1, m1, l1, acc2, m2, l2):
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return acc1 * c1 + acc2 * c2, m, l1 * c1 + l2 * c2


def _ring_setup(q, mask, axis_name):
    ax = axis_info(axis_name)
    b, t_local = q.shape[0], q.shape[1]
    bias = None
    if mask is not None:
        bias = mask.float().reshape(b, t_local)
    p_size = 1 if ax is None else ax.size
    my_idx = 0 if ax is None else ax.rank
    return ax, p_size, my_idx, bias


def ring_attention(q, k, v, mask=None, causal=False, axis_name="sp",
                   sm_scale=None):
    """Ring attention over the ranks of `axis_name`. q, k, v:
    [B, T_local, N, D]; mask: additive key bias of the local key chunk.
    Returns [B, T_local, N, D] in q's dtype."""
    ax, p_size, my_idx, bias = _ring_setup(q, mask, axis_name)
    b, t_local, n, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q_off = my_idx * t_local
    acc = torch.zeros((b, t_local, n, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, t_local, n, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, t_local, n, 1), dtype=torch.float32,
                    device=q.device)
    k_c, v_c, b_c = k, v, bias
    for s in range(p_size):
        src = (my_idx - s) % p_size
        pa, pm, pl = _partial_attention(q, k_c, v_c, b_c, causal, q_off,
                                        src * t_local, sm_scale)
        acc, m, l = _merge(acc, m, l, pa, pm, pl)
        if s + 1 < p_size:
            k_c = permute(k_c, ax, 1)
            v_c = permute(v_c, ax, 1)
            b_c = permute(b_c, ax, 1) if b_c is not None else None
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype)


def ulysses_attention(q, k, v, mask=None, causal=False, axis_name="sp",
                      sm_scale=None, attention_fn=None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism: re-shard
    seq→heads, full-sequence attention on N/P heads, re-shard back.
    attention_fn(q, k, v, mask, causal, sm_scale) defaults to the plain
    reference; pass `flash_attention_fn` for the flash kernel."""
    ax = axis_info(axis_name)
    p_size = 1 if ax is None else ax.size
    b, t_local, n, d = q.shape
    assert n % p_size == 0, (
        f"ulysses needs heads({n}) % axis({p_size}) == 0")

    def seq_to_heads(x):
        return all_to_all(x, ax, split_dim=2, concat_dim=1) if ax else x

    def heads_to_seq(x):
        return all_to_all(x, ax, split_dim=1, concat_dim=2) if ax else x

    qf, kf, vf = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    bias_f = None
    if mask is not None:
        bias = mask.float().reshape(b, t_local)
        bias_f = all_gather(bias, ax, 1) if ax else bias
    if attention_fn is None:
        from paddle_tpu_torch.ops.kernels.flash_attention import \
            attention_reference

        def attention_fn(q, k, v, mask, causal, sm_scale):
            return attention_reference(q, k, v, mask=mask, causal=causal,
                                       sm_scale=sm_scale)

    out = attention_fn(qf, kf, vf, bias_f, causal, sm_scale)
    return heads_to_seq(out)


class _Tie(torch.autograd.Function):
    """Identity on `out` that makes `others` part of its graph (zero
    gradients), so a rank whose output ignores a received chunk still
    runs that chunk's rotations in its backward."""

    @staticmethod
    def forward(ctx, out, *others):
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in others]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=dev)
                            for s, d, dev in ctx.shapes)


def ring_flash_attention(q, k, v, mask=None, causal=False, axis_name="sp",
                         sm_scale=None, block_q=None, block_k=None):
    """Ring attention with the flash kernel as the chunk attention: each
    ring step runs `flash_attention_lse` on the local q against one k/v
    chunk and the partials merge by their log-sum-exp, so a rank's
    memory stays O(T_local · D). Same calling convention as
    ring_attention; no dropout."""
    from paddle_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_lse

    ax, p_size, my_idx, bias = _ring_setup(q, mask, axis_name)
    b, t_local, n, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    def chunk(k_c, v_c, b_c, use_causal):
        o, lse = flash_attention_lse(q, k_c, v_c, mask=b_c,
                                     causal=use_causal, sm_scale=sm_scale,
                                     block_q=block_q, block_k=block_k)
        return o.float(), lse.float()

    o_acc = torch.zeros((b, t_local, n, d), dtype=torch.float32,
                        device=q.device)
    lse_acc = torch.full((b, t_local, n, 1), NEG_INF, dtype=torch.float32,
                         device=q.device)
    k_c, v_c, b_c = k, v, bias
    for s in range(p_size):
        src = (my_idx - s) % p_size
        if not causal:
            o_s, lse_s = chunk(k_c, v_c, b_c, False)
        elif s == 0:
            o_s, lse_s = chunk(k_c, v_c, b_c, True)     # the diagonal
        elif src < my_idx:
            o_s, lse_s = chunk(k_c, v_c, b_c, False)    # wholly past
        else:                                           # wholly future
            # no contribution, but the chunk stays in the graph: its
            # rotations' backward are collectives every rank must join
            o_s = lse_s = None
            o_acc = _Tie.apply(o_acc, *[t for t in (k_c, v_c, b_c)
                                        if t is not None])
        if o_s is not None:
            lse_new = torch.logaddexp(lse_acc, lse_s)
            # all-masked rows keep lse ~ NEG_INF: exp(x - x) must not
            # fabricate weight there
            lse_new_safe = torch.clamp(lse_new, min=-1e28)
            o_acc = (o_acc * torch.exp(torch.clamp(lse_acc, min=-1e29)
                                       - lse_new_safe)
                     + o_s * torch.exp(torch.clamp(lse_s, min=-1e29)
                                       - lse_new_safe))
            lse_acc = lse_new
        if s + 1 < p_size:
            k_c = permute(k_c, ax, 1)
            v_c = permute(v_c, ax, 1)
            if b_c is not None:
                b_c = permute(b_c, ax, 1)
    return o_acc.to(q.dtype)


def flash_attention_fn(q, k, v, mask, causal, sm_scale):
    """Ulysses `attention_fn` on the flash kernel: full-sequence
    attention over the rank's head shard, never materialising T×T."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention
    return flash_attention(q, k, v, mask=mask, causal=causal,
                           sm_scale=sm_scale)


_IMPLS = {"ring": (ring_attention, {}),
          "ring_flash": (ring_flash_attention, {}),
          "ulysses": (ulysses_attention, {}),
          "ulysses_flash": (ulysses_attention,
                            {"attention_fn": flash_attention_fn})}


def shard_sequence(x, mesh, axis="sp", batch_axis=None, seq_dim=1):
    """This rank's shard of a global [B, T, ...] array: the sequence
    (dim `seq_dim`) split over `axis`, the batch over `batch_axis`."""
    def cut(t, ax_name, dim):
        n = mesh.axis_size(ax_name)
        if n == 1:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, mesh.coord(ax_name) * size, size)
    out = cut(x, axis, seq_dim)
    if batch_axis:
        out = cut(out, batch_axis, 0)
    return out


def shard_map_attention(mesh, q, k, v, mask=None, causal=False, axis="sp",
                        impl="ring", batch_axis=None):
    """Run `impl` ("ring", "ring_flash", "ulysses", "ulysses_flash") on
    this rank's shards under `mesh`: q/k/v [B_local, T_local, N, D]
    (`shard_sequence` of the global arrays; the batch split over
    `batch_axis` when given), mask [B_local, 1, 1, T_local]. Returns
    this rank's output shard."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    fn, kw = _IMPLS[impl]
    with bind_mesh(mesh):
        return fn(q, k, v, mask=mask, causal=causal, axis_name=axis, **kw)
