"""Neural-net ops: conv, pool, norms, embedding, dropout, losses,
resampling.

Counterpart of paddle_tpu/ops/nn.py: every op type of it.
`sync_batch_norm` all-reduces its moments over the bound mesh's dp
ranks (ops/collective.py), where the JAX package's alias of batch_norm
gets the global moments from GSPMD. NCHW activations and OIHW filters (IOHW for
`conv2d_transpose`, Fluid's convention, which is also PyTorch's).
`conv2d` goes to `F.conv2d` (cuDNN on the card; a float32 conv there
runs in TF32 unless the caller turns `torch.backends.cudnn.allow_tf32`
off — the port sets no global flag). Pooling pads explicitly so that
`ceil_mode` and `exclusive` follow the JAX package's arithmetic rather
than PyTorch's own ceil rule.

Where the two libraries differ the op keeps the JAX package's result:

* `dropout` defaults to Fluid's `downgrade_in_infer` (training x·mask
  with no rescale, test mode x·(1-p)); its mask comes from the op's
  `torch.Generator` (`OpContext.rng`), so masks differ from the JAX
  package's and between the CPU and the card.
* `lookup_table` zeroes the output rows of `padding_idx` (and so their
  gradient), where `F.embedding(padding_idx=)` returns the row and
  only masks its gradient. Its gradient is autograd's scatter-add, whose
  summation order on the card varies from run to run.
* `interpolate` / `trilinear_interp` are `jax.image.resize`: half-pixel
  centres, nearest by floor((i + 0.5) * in / out), and the linear kernel
  widened by in / out when it downsamples (antialiasing), its weights
  renormalized per output sample — not `F.interpolate`'s defaults.
* The index ops do not clamp: an out-of-range id raises on the CPU and
  trips a device assert on the card (ROADMAP Queue 3).
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.collective import \
    _host_reason as collective_host_reason
from paddle_tpu_torch.ops.math import abs_, clip

#: conv2d's `fuse_activation` attr (inference/optimize.py fuse_conv_act)
CONV_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": lambda t: clip(t, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


@register_op("conv2d", inputs=["Input", "Filter", "Bias?"],
             outputs=["Output"])
def _conv2d(ctx, x, w, bias):
    """conv_op.cc: NCHW input, OIHW filter, groups and dilation; then the
    bias and the fused activation, each as its own pass (the JAX order)."""
    return _conv2d_groups(ctx, x, w, bias, ctx.attr("groups", 1))


@register_op("depthwise_conv2d", inputs=["Input", "Filter", "Bias?"],
             outputs=["Output"])
def _depthwise_conv2d(ctx, x, w, bias):
    return _conv2d_groups(ctx, x, w, bias, int(x.shape[1]))


def _conv2d_groups(ctx, x, w, bias, groups):
    out = F.conv2d(x, w, stride=_pair(ctx.attr("strides", [1, 1])),
                   padding=_pair(ctx.attr("paddings", [0, 0])),
                   dilation=_pair(ctx.attr("dilations", [1, 1])),
                   groups=groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    fact = ctx.attr("fuse_activation", "")
    if fact:
        out = CONV_ACTIVATIONS[fact](out)
    return out


def _ceil_extra(dim, k, s, p):
    """pool_op.cc ceil_mode: extra high-side padding so the last partial
    window is kept."""
    out = -(-(dim + 2 * p - k) // s) + 1
    return max((out - 1) * s + k - (dim + 2 * p), 0)


@register_op("pool2d", inputs=["X"], outputs=["Out"])
def _pool2d(ctx, x):
    """pool_op.cc: max / avg pooling, global_pooling, adaptive (divisible
    sizes), ceil_mode, and the exclusive average (padding not counted)."""
    ptype = ctx.attr("pooling_type", "max")
    ksize = _pair(ctx.attr("ksize", [2, 2]))
    strides = _pair(ctx.attr("strides", ksize))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    h, w = int(x.shape[2]), int(x.shape[3])
    if ctx.attr("global_pooling", False):
        ksize, strides, pads = (h, w), (1, 1), (0, 0)
    if ctx.attr("adaptive", False):
        oh, ow = ksize
        enforce(h % oh == 0 and w % ow == 0,
                "adaptive pool needs divisible sizes (got %s -> %s)",
                (h, w), (oh, ow))
        ksize = (h // oh, w // ow)
        strides, pads = ksize, (0, 0)
    extra = (0, 0)
    if ctx.attr("ceil_mode", False):
        extra = (_ceil_extra(h, ksize[0], strides[0], pads[0]),
                 _ceil_extra(w, ksize[1], strides[1], pads[1]))
    padding = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    padded = any(padding)
    if ptype == "max":
        if padded:
            x = F.pad(x, padding, value=float("-inf"))
        return F.max_pool2d(x, ksize, strides)
    xp = F.pad(x, padding) if padded else x
    s = F.avg_pool2d(xp, ksize, strides, divisor_override=1)   # window sums
    if ctx.attr("exclusive", True) and padded:
        ones = F.pad(torch.ones_like(x), padding)
        cnt = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
        return s / cnt
    return s / (ksize[0] * ksize[1])


@register_op("batch_norm",
             inputs=["X", "Scale", "Bias", "Mean", "Variance"],
             outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"])
def _batch_norm(ctx, x, scale, bias, mean, var):
    """batch_norm_op.cc. Training normalizes with the batch statistics and
    returns the updated running mean/variance (MeanOut/VarianceOut name
    the inputs); inference (is_test, use_global_stats, or not training)
    normalizes with the running statistics. Arithmetic in float32 (in
    float64 for a float64 x)."""
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    use_global = (ctx.attr("is_test", False)
                  or ctx.attr("use_global_stats", False) or not ctx.training)
    axes = tuple(i for i in range(x.dim()) if i != 1)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    xf = at_least_f32(x)
    if use_global:
        m, v = mean, var
        new_mean, new_var = mean, var
    else:
        m = xf.mean(dim=axes)
        v = xf.var(dim=axes, unbiased=False)
        new_mean = momentum * mean + (1 - momentum) * m.to(mean.dtype)
        new_var = momentum * var + (1 - momentum) * v.to(var.dtype)
    inv = torch.rsqrt(at_least_f32(v) + eps)
    y = (xf - m.reshape(bshape)) * inv.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return y.to(x.dtype), new_mean, new_var, at_least_f32(m), inv


def _global_moments(xf, axes, axis_name):
    """Mean and biased variance of xf over `axes` and over the ranks of
    the mesh axis `axis_name`, from each rank's own two-pass moments and
    its share w of the global count: m = sum(w m_r), v = sum(w (v_r +
    (m_r - m)^2)). One rank (w = 1) gives batch_norm's moments bit for
    bit. Gradients flow through the all-reduces."""
    from paddle_tpu_torch.ops.collective import all_reduce
    count = 1
    for a in axes:
        count *= xf.shape[a]
    n = torch.full((), float(count), dtype=xf.dtype, device=xf.device)
    w = n / all_reduce(n, axis_name)
    m_r = xf.mean(dim=axes)
    v_r = xf.var(dim=axes, unbiased=False)
    m = all_reduce(w * m_r, axis_name)
    v = all_reduce(w * (v_r + (m_r - m) ** 2), axis_name)
    return m, v


@register_op("sync_batch_norm",
             inputs=["X", "Scale", "Bias", "Mean", "Variance"],
             outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"],
             host=collective_host_reason)
def _sync_batch_norm(ctx, x, scale, bias, mean, var):
    """sync_batch_norm_op.cu: batch_norm whose training moments are over
    the global batch, the ranks of the bound mesh's dp axis (attr
    `axis_name`, default "dp") together: what the JAX package's alias of
    batch_norm computes under GSPMD. Without that axis bound it is
    batch_norm."""
    from paddle_tpu_torch.parallel.env import axis_info
    axis_name = ctx.attr("axis_name", "dp")
    use_global = (ctx.attr("is_test", False)
                  or ctx.attr("use_global_stats", False) or not ctx.training)
    if use_global or axis_info(axis_name) is None:
        return _batch_norm(ctx, x, scale, bias, mean, var)
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    axes = tuple(i for i in range(x.dim()) if i != 1)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    xf = at_least_f32(x)
    m, v = _global_moments(xf, axes, axis_name)
    new_mean = momentum * mean + (1 - momentum) * m.detach().to(mean.dtype)
    new_var = momentum * var + (1 - momentum) * v.detach().to(var.dtype)
    inv = torch.rsqrt(at_least_f32(v) + eps)
    y = (xf - m.reshape(bshape)) * inv.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return y.to(x.dtype), new_mean, new_var, at_least_f32(m), inv


@register_op("softmax_with_cross_entropy", inputs=["Logits", "Label"],
             outputs=["Softmax", "Loss"])
def _softmax_with_cross_entropy(ctx, logits, label):
    """softmax_with_cross_entropy_op.cc: log-softmax, then the picked
    log-probability (hard labels, ignore_index) or the soft-label sum."""
    axis = ctx.attr("axis", -1)
    axis = axis if axis >= 0 else logits.dim() + axis
    logp = torch.log_softmax(logits, dim=axis)
    sm = torch.exp(logp)
    if ctx.attr("soft_label", False):
        return sm, -(label * logp).sum(dim=axis, keepdim=True)
    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.to(torch.int64)
    ignore = ctx.attr("ignore_index", -100)
    keep = lbl != ignore
    idx = torch.where(keep, lbl, torch.zeros_like(lbl)).unsqueeze(axis)
    picked = torch.gather(logp, axis, idx)
    loss = torch.where(keep.unsqueeze(axis), -picked,
                       torch.zeros_like(picked))
    return sm, loss


@register_op("square_error_cost", inputs=["X", "Y"], outputs=["Out"])
def _square_error_cost(ctx, x, y):
    return torch.square(x - y)


def stable_sigmoid_ce(logit, target):
    """max(x, 0) - x t + log1p(exp(-|x|)): the numerically stable sigmoid
    cross-entropy. At x = 0 exactly (a logit a batch norm over one value
    makes) its gradient is the JAX package's, -t: jnp.maximum's
    derivative there is 1/2 and jnp.abs's is 1."""
    zero = torch.zeros((), dtype=logit.dtype, device=logit.device)
    return (torch.maximum(logit, zero) - logit * target
            + torch.log1p(torch.exp(-torch.where(logit >= 0, logit,
                                                 -logit))))


@register_op("conv2d_transpose", inputs=["Input", "Filter", "Bias?"],
             outputs=["Output"])
def _conv2d_transpose(ctx, x, w, bias):
    """conv_transpose_op.cc: IOHW filter; output size (H - 1) stride -
    2 pad + (k - 1) dilation + 1, the gradient of conv2d."""
    out = F.conv_transpose2d(x, w, stride=_pair(ctx.attr("strides", [1, 1])),
                             padding=_pair(ctx.attr("paddings", [0, 0])),
                             dilation=_pair(ctx.attr("dilations", [1, 1])))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _triple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v, v)


@register_op("conv3d", inputs=["Input", "Filter", "Bias?"],
             outputs=["Output"])
def _conv3d(ctx, x, w, bias):
    """conv3d_op.cc: NCDHW input, OIDHW filter."""
    out = F.conv3d(x, w, stride=_triple(ctx.attr("strides", [1, 1, 1])),
                   padding=_triple(ctx.attr("paddings", [0, 0, 0])),
                   dilation=_triple(ctx.attr("dilations", [1, 1, 1])),
                   groups=ctx.attr("groups", 1))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out


@register_op("pool3d", inputs=["X"], outputs=["Out"])
def _pool3d(ctx, x):
    """pool3d_op: max / avg pooling over NCDHW."""
    ksize = _triple(ctx.attr("ksize", [2, 2, 2]))
    strides = _triple(ctx.attr("strides", ksize))
    pads = _triple(ctx.attr("paddings", [0, 0, 0]))
    if ctx.attr("global_pooling", False):
        ksize = tuple(int(d) for d in x.shape[2:])
        strides, pads = (1, 1, 1), (0, 0, 0)
    padding = (pads[2], pads[2], pads[1], pads[1], pads[0], pads[0])
    if ctx.attr("pooling_type", "max") == "max":
        if any(pads):
            x = F.pad(x, padding, value=float("-inf"))
        return F.max_pool3d(x, ksize, strides)
    xp = F.pad(x, padding) if any(pads) else x
    s = F.avg_pool3d(xp, ksize, strides, divisor_override=1)
    if ctx.attr("exclusive", True) and any(pads):
        cnt = F.avg_pool3d(F.pad(torch.ones_like(x), padding), ksize,
                           strides, divisor_override=1)
        return s / cnt
    return s / (ksize[0] * ksize[1] * ksize[2])


def _squeeze_stats(m, v):
    return torch.squeeze(m), torch.squeeze(v)


@register_op("layer_norm", inputs=["X", "Scale?", "Bias?"],
             outputs=["Y", "Mean", "Variance"])
def _layer_norm(ctx, x, scale, bias):
    """layer_norm_op.cc: normalize over dims [begin_norm_axis:];
    statistics in float32 (float64 for a float64 x)."""
    eps = ctx.attr("epsilon", 1e-5)
    ax = ctx.attr("begin_norm_axis", 1)
    axes = tuple(range(ax, x.dim()))
    xf = at_least_f32(x)
    m = xf.mean(dim=axes, keepdim=True)
    v = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    wshape = (1,) * ax + tuple(x.shape[ax:])
    if scale is not None:
        y = y * scale.reshape(wshape).to(y.dtype)
    if bias is not None:
        y = y + bias.reshape(wshape).to(y.dtype)
    return (y.to(x.dtype),) + _squeeze_stats(m, v)


@register_op("group_norm", inputs=["X", "Scale?", "Bias?"],
             outputs=["Y", "Mean", "Variance"])
def _group_norm(ctx, x, scale, bias):
    """group_norm_op.cc (NCHW)."""
    eps = ctx.attr("epsilon", 1e-5)
    g = ctx.attr("groups")
    n, c = int(x.shape[0]), int(x.shape[1])
    xg = at_least_f32(x.reshape((n, g, c // g) + tuple(x.shape[2:])))
    axes = tuple(range(2, xg.dim()))
    m = xg.mean(dim=axes, keepdim=True)
    v = xg.var(dim=axes, unbiased=False, keepdim=True)
    y = ((xg - m) * torch.rsqrt(v + eps)).reshape(tuple(x.shape))
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return (y.to(x.dtype),) + _squeeze_stats(m, v)


@register_op("instance_norm", inputs=["X", "Scale?", "Bias?"],
             outputs=["Y", "SavedMean", "SavedVariance"])
def _instance_norm(ctx, x, scale, bias):
    eps = ctx.attr("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    xf = at_least_f32(x)
    m = xf.mean(dim=axes, keepdim=True)
    v = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    bshape = (1, int(x.shape[1])) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return (y.to(x.dtype),) + _squeeze_stats(m, v)


@register_op("dropout", inputs=["X"], outputs=["Out", "Mask"])
def _dropout(ctx, x):
    """dropout_op.cc: `downgrade_in_infer` (the default: training x·mask,
    test x·(1-p)) or `upscale_in_train` (training x·mask/(1-p), test x).
    The mask is a Bernoulli(1-p) draw from the op's generator; the
    gradient is mask·dout (/(1-p) for upscale_in_train)."""
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False) or not ctx.training:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return out, torch.ones_like(x)
    if p == 0.0:
        return x, torch.ones_like(x)
    keep = 1.0 - p
    mask = (torch.rand(tuple(x.shape), generator=ctx.rng(),
                       device=x.device) < keep).to(x.dtype)
    if impl == "upscale_in_train":
        return x * mask / keep, mask
    return x * mask, mask


def _lookup(w, ids, pad):
    """Rows of w at ids; the rows of `pad` (>= 0) are zeros."""
    ids = ids.long()
    out = F.embedding(ids, w)
    if pad is not None and pad >= 0:
        out = torch.where((ids == pad).unsqueeze(-1),
                          torch.zeros_like(out), out)
    return out


@register_op("lookup_table", inputs=["W", "Ids"], outputs=["Out"])
def _lookup_table(ctx, w, ids):
    """lookup_table_op.cc: a trailing 1-dim of ids is squeezed (LoD
    parity); the gradient is dense, autograd's scatter-add."""
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(tuple(ids.shape[:-1]))
    return _lookup(w, ids, ctx.attr("padding_idx", -1))


@register_op("lookup_table_v2", inputs=["W", "Ids"], outputs=["Out"])
def _lookup_table_v2(ctx, w, ids):
    return _lookup(w, ids, ctx.attr("padding_idx", -1))


@register_op("cross_entropy", inputs=["X", "Label"], outputs=["Y"])
def _cross_entropy(ctx, x, label):
    """cross_entropy_op.cc: x is a distribution (after softmax); hard
    labels [N, 1] or soft labels [N, D]; -log(p + 1e-8)."""
    eps = 1e-8
    if ctx.attr("soft_label", False):
        return -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    lbl = label.reshape(tuple(label.shape[:-1])) \
        if label.shape[-1] == 1 else label
    lbl = lbl.long()
    ignore = lbl == ctx.attr("ignore_index", -100)
    idx = torch.where(ignore, torch.zeros_like(lbl), lbl).unsqueeze(-1)
    loss = -torch.log(torch.gather(x, -1, idx) + eps)
    return torch.where(ignore.unsqueeze(-1), torch.zeros_like(loss), loss)


@register_op("sigmoid_cross_entropy_with_logits", inputs=["X", "Label"],
             outputs=["Out"])
def _sigmoid_ce(ctx, x, label):
    loss = stable_sigmoid_ce(x, label)
    ignore = ctx.attr("ignore_index", -100)
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if ctx.attr("normalize", False):
        norm = torch.clamp((label != ignore).to(loss.dtype).sum(), min=1.0)
        loss = loss / norm
    return loss


@register_op("smooth_l1_loss", inputs=["X", "Y"], outputs=["Diff", "Out"])
def _smooth_l1(ctx, x, y):
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    ad = torch.abs(d)
    out = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    return d, out.sum(dim=tuple(range(1, x.dim()))).reshape(-1, 1)


@register_op("huber_loss", inputs=["X", "Y"], outputs=["Residual", "Out"])
def _huber(ctx, x, y):
    delta = ctx.attr("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    return r, torch.where(ar <= delta, 0.5 * r * r,
                          delta * (ar - 0.5 * delta))


@register_op("kldiv_loss", inputs=["X", "Target"], outputs=["Loss"])
def _kldiv(ctx, x, t):
    loss = t * (torch.log(torch.clamp(t, min=1e-10)) - x)
    red = ctx.attr("reduction", "mean")
    if red == "mean":
        return loss.mean()
    if red == "sum":
        return loss.sum()
    if red == "batchmean":
        return loss.sum() / int(x.shape[0])
    return loss


@register_op("l1_norm", inputs=["X"], outputs=["Out"])
def _l1_norm(ctx, x):
    return abs_(x).sum()


@register_op("mse_loss", inputs=["X", "Y"], outputs=["Out"])
def _mse(ctx, x, y):
    return torch.square(x - y).mean()


def _linear_weights(n_in, n_out, device):
    """jax.image's weight matrix [n_in, n_out] for the linear (triangle)
    kernel: half-pixel centres, the kernel widened by n_in / n_out when
    it downsamples, columns renormalized, samples outside the input
    zeroed (jax/_src/image/scale.py compute_weight_mat), in float32."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    w = torch.clamp(1 - torch.abs(sample[None, :] - pos[:, None])
                    / kernel_scale, min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x, out_sizes, method):
    """jax.image.resize over the trailing spatial dims of x."""
    first = x.dim() - len(out_sizes)
    dims = [first + i for i, n in enumerate(out_sizes)
            if int(x.shape[first + i]) != int(n)]
    if method == "nearest":
        for d in dims:
            m, n = int(x.shape[d]), int(out_sizes[d - first])
            idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            x = torch.index_select(x, d, idx)
        return x
    for d in dims:     # one contraction a dim, as the einsum's factors
        w = _linear_weights(int(x.shape[d]), int(out_sizes[d - first]),
                            x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w,
                                          dims=1), -1, d)
    return x


@register_op("interpolate", inputs=["X"], outputs=["Out"])
def _interpolate(ctx, x):
    """interpolate_op.cc: nearest / bilinear NCHW resize, with
    jax.image.resize's semantics (module docstring)."""
    method = ctx.attr("interp_method", "nearest")
    return _resize(x, (ctx.attr("out_h"), ctx.attr("out_w")),
                   "nearest" if method == "nearest" else "linear")


@register_op("trilinear_interp", inputs=["X"], outputs=["Out"])
def _trilinear_interp(ctx, x):
    """trilinear_interp_op.cc: NCDHW trilinear resize."""
    return _resize(x, (ctx.attr("out_d"), ctx.attr("out_h"),
                       ctx.attr("out_w")), "linear")


@register_op("prelu", inputs=["X", "Alpha"], outputs=["Out"])
def _prelu(ctx, x, alpha):
    if ctx.attr("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x > 0, x, alpha * x)


@register_op("temporal_shift", inputs=["X"], outputs=["Out"])
def _temporal_shift(ctx, x):
    """temporal_shift_op.cc (video models)."""
    seg = ctx.attr("seg_num")
    ratio = ctx.attr("shift_ratio", 0.25)
    nt, c, h, w = (int(d) for d in x.shape)
    xr = x.reshape(nt // seg, seg, c, h, w)
    c1 = int(c * ratio)
    fwd = F.pad(xr[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    bwd = F.pad(xr[:, :-1, c1:2 * c1], (0, 0, 0, 0, 0, 0, 1, 0))
    rest = xr[:, :, 2 * c1:]
    return torch.cat([fwd, bwd, rest], dim=2).reshape(nt, c, h, w)


@register_op("grid_sampler", inputs=["X", "Grid"], outputs=["Output"])
def _grid_sampler(ctx, x, grid):
    """grid_sampler_op.cc: bilinear sampling at normalized grid coords,
    corner-aligned, samples clamped to the border (the JAX package's
    arithmetic)."""
    n, c, h, w = (int(d) for d in x.shape)
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    x1, y1 = x0 + 1, y0 + 1
    wx = (gx - x0).unsqueeze(-1)
    wy = (gy - y0).unsqueeze(-1)
    batch = torch.arange(n, device=x.device).reshape(n, 1, 1)
    xt = x.permute(0, 2, 3, 1)      # (n, h, w, c)

    def sample(xi, yi):
        return xt[batch, torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]

    out = (sample(x0, y0) * (1 - wx) * (1 - wy) + sample(x1, y0) * wx
           * (1 - wy) + sample(x0, y1) * (1 - wx) * wy
           + sample(x1, y1) * wx * wy)
    return out.permute(0, 3, 1, 2)


@register_op("pixel_shuffle", inputs=["X"], outputs=["Out"])
def _pixel_shuffle(ctx, x):
    r = ctx.attr("upscale_factor")
    n, c, h, w = (int(d) for d in x.shape)
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


@register_op("label_smooth", inputs=["X", "PriorDist?"], outputs=["Out"])
def _label_smooth(ctx, x, prior):
    eps = ctx.attr("epsilon", 0.1)
    if prior is not None:
        return (1 - eps) * x + eps * prior
    return (1 - eps) * x + eps / int(x.shape[-1])


@register_op("row_conv", inputs=["X", "Filter"], outputs=["Out"])
def _row_conv(ctx, x, w):
    """row_conv_op.cc (lookahead convolution, Deep Speech 2):
    out[b, t] = sum_k x[b, t+k] w[k]; x [B, T, D], w [context+1, D]."""
    out = torch.zeros_like(x)
    for j in range(int(w.shape[0])):
        shifted = F.pad(x[:, j:], (0, 0, 0, j))
        out = out + shifted * w[j].reshape(1, 1, -1)
    return out


@register_op("affine_channel", inputs=["X", "Scale", "Bias"],
             outputs=["Out"])
def _affine_channel(ctx, x, scale, bias):
    """affine_channel_op.cc: per-channel scale + shift (frozen BN)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + bias.reshape(shape)
