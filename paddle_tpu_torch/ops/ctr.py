"""CTR and ranking-pipeline ops.

Counterpart of paddle_tpu/ops/ctr.py, all four of its op types:

* cvm — operators/cvm_op.h CvmComputeKernel: with use_cvm the first two
  slots become log(show + 1) and log(click + 1) - log(show + 1) and the
  width is kept; without it the two slots are dropped. Its gradient is
  the reference's hand-written one, not the forward's derivative: dX's
  first two columns copy the CVM input, the rest copies dY
  (`_CvmGrad`, a torch.autograd.Function, as the JAX package's
  custom_vjp).
* data_norm — operators/data_norm_op.cc: means = BatchSum / BatchSize,
  scales = sqrt(BatchSize / BatchSquareSum), Y = (X - means) scales. The
  "gradients" of the three statistics are the batch's own contribution
  (N, sum x, sum (x - mean)^2 + N eps; data_norm_op.cc:366-369), which
  the optimizer folds into the running statistics (`_DataNormGrad`).
* positive_negative_pair — operators/positive_negative_pair_op.h: every
  same-query pair with different labels adds (w_i + w_j) / 2 to the
  neutral count on a score tie, to the positive one when the score order
  follows the label order, else to the negative one; an O(N^2) masked
  reduction.
* filter_by_instag — operators/filter_by_instag_op.h under static
  shapes: the surviving rows keep their positions, filtered rows are
  zeroed, LossWeight marks the survivors.
"""
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op


# ------------------------------------------------------------------ cvm
class _CvmGrad(torch.autograd.Function):
    """cvm with the reference's gradient: dX = [CVM[:, :2], dY[:, 2:]]
    (use_cvm) or [CVM[:, :2], dY] (without); CVM gets none."""

    @staticmethod
    def forward(ctx, x, cvm, use_cvm):
        ctx.save_for_backward(cvm)
        ctx.use_cvm = use_cvm
        if not use_cvm:
            return x[:, 2:].clone()
        y0 = torch.log(x[:, :1] + 1.0)
        y1 = torch.log(x[:, 1:2] + 1.0) - y0
        return torch.cat([y0, y1, x[:, 2:]], dim=1)

    @staticmethod
    def backward(ctx, dy):
        cvm, = ctx.saved_tensors
        rest = dy[:, 2:] if ctx.use_cvm else dy
        return torch.cat([cvm[:, :2].to(dy.dtype), rest], dim=1), None, None


@register_op("cvm", inputs=["X", "CVM"], outputs=["Y"])
def _cvm(ctx, x, cvm):
    enforce(x.shape[1] >= 2, "cvm input needs >= 2 slots, got %d",
            x.shape[1])
    return _CvmGrad.apply(x, cvm, bool(ctx.attr("use_cvm", True)))


# -------------------------------------------------------------- data_norm
class _DataNormGrad(torch.autograd.Function):
    """data_norm with the reference's statistic "gradients": dX =
    dY scales; BatchSize, BatchSum and BatchSquareSum get N, sum x and
    sum (x - means)^2 + N eps (the cotangents of Means and Scales are
    not read, as in the JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, x, bsize, bsum, bsquare, epsilon):
        means = bsum / bsize
        scales = torch.sqrt(bsize / bsquare)
        ctx.save_for_backward(x, means, scales)
        ctx.epsilon = epsilon
        return (x - means[None, :]) * scales[None, :], means, scales

    @staticmethod
    def backward(ctx, dy, dmeans, dscales):
        x, means, scales = ctx.saved_tensors
        n = x.shape[0]
        d_bsquare = (torch.sum(torch.square(x - means[None, :]), dim=0)
                     + n * ctx.epsilon)
        return (dy * scales[None, :], torch.full_like(means, float(n)),
                torch.sum(x, dim=0), d_bsquare, None)


@register_op("data_norm",
             inputs=["X", "BatchSize", "BatchSum", "BatchSquareSum"],
             outputs=["Y", "Means", "Scales"])
def _data_norm(ctx, x, bsize, bsum, bsquare):
    return _DataNormGrad.apply(x, bsize, bsum, bsquare,
                               ctx.attr("epsilon", 1e-4))


# -------------------------------------------- positive / negative pairs
@register_op("positive_negative_pair",
             inputs=["Score", "Label", "QueryID", "Weight?",
                     "AccumulatePositivePair?", "AccumulateNegativePair?",
                     "AccumulateNeutralPair?"],
             outputs=["PositivePair", "NegativePair", "NeutralPair"])
def _positive_negative_pair(ctx, score, label, query, weight,
                            acc_pos, acc_neg, acc_neu):
    s = score[:, ctx.attr("column", 0)] if score.dim() > 1 else score
    lab = label.reshape(-1).to(torch.float32)
    q = query.reshape(-1)
    wgt = (torch.ones_like(s) if weight is None
           else weight.reshape(-1).to(s.dtype))
    n = s.shape[0]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=s.device), diagonal=1)
    pair = (q[:, None] == q[None, :]) & upper & (lab[:, None] != lab[None, :])
    w = 0.5 * (wgt[:, None] + wgt[None, :])
    ds = s[:, None] - s[None, :]
    dl = lab[:, None] - lab[None, :]
    tie = ds == 0
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    pos = torch.sum(torch.where(pair & ~tie & (ds * dl > 0), w, zero))
    neg = torch.sum(torch.where(pair & ~tie & (ds * dl < 0), w, zero))
    neu = torch.sum(torch.where(pair & tie, w, zero))
    if acc_pos is not None:
        pos = pos + acc_pos.reshape(())
        neg = neg + acc_neg.reshape(())
        neu = neu + acc_neu.reshape(())
    return tuple(v.reshape(1).to(score.dtype) for v in (pos, neg, neu))


# ---------------------------------------------------- filter_by_instag
@register_op("filter_by_instag", inputs=["Ins", "Ins_tag", "Filter_tag"],
             outputs=["Out", "LossWeight", "IndexMap"])
def _filter_by_instag(ctx, ins, ins_tag, filter_tag):
    """ins_tag [N, K] tag ids a row (0 pads); filter_tag [M]. A row
    survives when any of its tags is in the filter set: it keeps its
    position, the others are zeroed, LossWeight [N, 1] is 1 on the
    survivors, IndexMap [N, 1] int32 each row's own index."""
    n = ins.shape[0]
    tags = ins_tag.reshape(n, -1)
    hit = ((tags[:, :, None] == filter_tag.reshape(-1)[None, None, :])
           & (tags[:, :, None] != 0))
    keep = hit.any(dim=2).any(dim=1)
    flat = ins.reshape(n, -1)
    out = torch.where(keep[:, None], flat, torch.zeros_like(flat))
    idx = torch.arange(n, dtype=torch.int32, device=ins.device)[:, None]
    return (out.reshape(ins.shape), keep.to(torch.float32)[:, None], idx)
