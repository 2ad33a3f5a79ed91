"""ResNet as a static program (BASELINE.md config 2).

Counterpart of paddle_tpu/models/resnet.py's `build_static` and
`flops_per_image` (He et al. 2015, Table 1): bottleneck blocks of
conv → batch_norm (→ relu), NCHW, the fluid layer-stack style. The eager
`ResNet` layer of the JAX package is a later slice.
"""

__all__ = ["CFG", "build_static", "flops_per_image"]

#: blocks per stage by depth (He et al. 2015, Table 1)
CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def build_static(img, label, depth=50, num_classes=1000, width=64,
                 blocks=None):
    """Static-graph ResNet → (logits, avg_loss, acc). `blocks` / `width`
    shrink the net for tests (e.g. blocks=(1, 1, 1, 1), width=8)."""
    from paddle_tpu_torch import static

    blocks = blocks or CFG[depth]

    def conv_bn(x, ch, filt, stride=1, padding=0, act=None):
        c = static.conv2d(x, ch, filt, stride=stride, padding=padding,
                          bias_attr=False)
        return static.batch_norm(c, act=act)

    def bottleneck(x, ch, stride, downsample):
        h = conv_bn(x, ch, 1, act="relu")
        h = conv_bn(h, ch, 3, stride=stride, padding=1, act="relu")
        h = conv_bn(h, ch * 4, 1)
        sc = conv_bn(x, ch * 4, 1, stride=stride) if downsample else x
        return static.relu(h + sc)

    h = conv_bn(img, width, 7, stride=2, padding=3, act="relu")
    h = static.pool2d(h, 3, "max", pool_stride=2, pool_padding=1)
    ch = width
    for si, n in enumerate(blocks):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            h = bottleneck(h, ch, stride, downsample=(bi == 0))
        ch *= 2
    pooled = static.reduce_mean(h, dim=[2, 3])
    logits = static.fc(pooled, num_classes)
    loss = static.mean(static.softmax_with_cross_entropy(logits, label))
    acc = static.accuracy(static.softmax(logits), label)
    return logits, loss, acc


def flops_per_image(depth=50, image_size=224):
    """Approximate forward FLOPs (for MFU accounting): ResNet-50 at 224
    is about 4.1e9 multiply-adds, times 2."""
    if depth == 50 and image_size == 224:
        return 2 * 4.1e9
    scale = (image_size / 224) ** 2
    return 2 * 4.1e9 * scale
