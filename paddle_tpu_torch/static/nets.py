"""Composite network helpers.

Counterpart of paddle_tpu/static/nets.py (the reference's fluid/nets.py):
`simple_img_conv_pool`, `img_conv_group` (the VGG block), `glu` and
`scaled_dot_product_attention`, compositions over the layer library that
build the same op sequences as the JAX package, and the text CNN block
`sequence_conv_pool` over padded sequences.
"""
from paddle_tpu_torch.static import common as _c
from paddle_tpu_torch.static import nn as _nn

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    conv_out = _nn.conv2d(input, num_filters=num_filters,
                          filter_size=filter_size, stride=conv_stride,
                          padding=conv_padding, dilation=conv_dilation,
                          groups=conv_groups, param_attr=param_attr,
                          bias_attr=bias_attr, act=act)
    return _nn.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                      pool_stride=pool_stride, pool_padding=pool_padding,
                      global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act="relu",
                   param_attr=None, conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0, pool_stride=1,
                   pool_type="max", use_cudnn=True):
    """A VGG block: convs (each with batch norm + act and a dropout of
    its rate when conv_with_batchnorm), then one pool."""
    tmp = input
    if not isinstance(conv_num_filter, (list, tuple)):
        conv_num_filter = [conv_num_filter]

    def per(arg, i):
        return arg[i] if isinstance(arg, (list, tuple)) else arg

    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm else conv_act
        tmp = _nn.conv2d(tmp, num_filters=nf,
                         filter_size=per(conv_filter_size, i),
                         padding=per(conv_padding, i),
                         param_attr=per(param_attr, i), act=local_act)
        if conv_with_batchnorm:
            tmp = _nn.batch_norm(tmp, act=conv_act)
            rate = per(conv_batchnorm_drop_rate, i)
            if rate:
                tmp = _nn.dropout(tmp, dropout_prob=rate)
    return _nn.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                      pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, lengths=None,
                       param_attr=None, act="sigmoid", pool_type="max",
                       bias_attr=None):
    """Text-CNN block over padded sequences [B, T, D] (+ lengths, which
    also mask the pooling): sequence_conv, then sequence_pool."""
    conv = _c.sequence_conv(input, num_filters=num_filters,
                            filter_size=filter_size, lengths=lengths,
                            param_attr=param_attr, bias_attr=bias_attr,
                            act=act)
    return _c.sequence_pool(conv, pool_type=pool_type, lengths=lengths)


def glu(input, dim=-1):
    """Gated linear unit: split in half on `dim`, a * sigmoid(b)."""
    a, b = _c.split(input, 2, dim=dim)
    return _c.elementwise_mul(a, _c.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head attention over [B, T, D] q / k / v with the op library
    (reshape, transpose, scale, matmul, softmax [, dropout])."""
    d = queries.shape[-1]
    head_dim = d // num_heads

    def split_heads(x):     # [B, T, D] -> [B, H, T, Dh]
        r = _c.reshape(x, [x.shape[0] or -1, x.shape[1], num_heads,
                           head_dim])
        return _c.transpose(r, [0, 2, 1, 3])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    scaled = _c.scale(q, scale=float(head_dim) ** -0.5)
    weights = _c.softmax(_c.matmul(scaled, k, transpose_y=True))
    if dropout_rate:
        weights = _nn.dropout(weights, dropout_prob=dropout_rate)
    ctx = _c.transpose(_c.matmul(weights, v), [0, 2, 1, 3])
    return _c.reshape(ctx, [ctx.shape[0] or -1, ctx.shape[1], d])
