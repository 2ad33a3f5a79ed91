"""ResNet (BASELINE.md config 2), eager and static.

Counterpart of paddle_tpu/models/resnet.py (He et al. 2015, Table 1):
bottleneck blocks of conv -> batch_norm (-> relu). The eager `ResNet`
takes `data_format` "NCHW" (Fluid's default) or "NHWC" (channels-last,
filters stored HWIO); `width` and `blocks` shrink it for tests.
`build_static` is the same network as a static program (NCHW), and
`flops_per_image` its forward cost.
"""

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F

__all__ = ["CFG", "BottleneckBlock", "ResNet", "resnet50", "build_static",
           "flops_per_image"]

#: blocks per stage by depth (He et al. 2015, Table 1)
CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, in_ch, ch, stride=1, downsample=False,
                 data_format="NCHW", device=None):
        super().__init__(device=device)
        df, dev = data_format, device
        self.conv1 = nn.Conv2D(in_ch, ch, 1, bias_attr=False, data_format=df,
                               device=dev)
        self.bn1 = nn.BatchNorm(ch, act="relu", data_format=df, device=dev)
        self.conv2 = nn.Conv2D(ch, ch, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=df, device=dev)
        self.bn2 = nn.BatchNorm(ch, act="relu", data_format=df, device=dev)
        self.conv3 = nn.Conv2D(ch, ch * 4, 1, bias_attr=False,
                               data_format=df, device=dev)
        self.bn3 = nn.BatchNorm(ch * 4, data_format=df, device=dev)
        self.has_down = downsample
        if downsample:
            self.down_conv = nn.Conv2D(in_ch, ch * 4, 1, stride=stride,
                                       bias_attr=False, data_format=df,
                                       device=dev)
            self.down_bn = nn.BatchNorm(ch * 4, data_format=df, device=dev)

    def forward(self, x):
        h = self.bn1(self.conv1(x))
        h = self.bn2(self.conv2(h))
        h = self.bn3(self.conv3(h))
        sc = self.down_bn(self.down_conv(x)) if self.has_down else x
        return F.relu(h + sc)


class ResNet(nn.Layer):
    CFG = CFG

    def __init__(self, depth=50, num_classes=1000, width=64, blocks=None,
                 data_format="NCHW", device=None):
        super().__init__(device=device)
        blocks = blocks or CFG[depth]
        df, dev = data_format, device
        self.data_format = df
        self.stem = nn.Conv2D(3, width, 7, stride=2, padding=3,
                              bias_attr=False, data_format=df, device=dev)
        self.stem_bn = nn.BatchNorm(width, act="relu", data_format=df,
                                    device=dev)
        self.stem_pool = nn.Pool2D(3, "max", pool_stride=2, pool_padding=1,
                                   data_format=df)
        self.stages = nn.LayerList()
        in_ch = ch = width
        for si, n in enumerate(blocks):
            stage = nn.LayerList()
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                stage.append(BottleneckBlock(in_ch, ch, stride, bi == 0,
                                             data_format=df, device=dev))
                in_ch = ch * 4
            self.stages.append(stage)
            ch *= 2
        self.fc = nn.Linear(in_ch, num_classes, device=dev)

    def forward(self, x):
        h = self.stem_pool(self.stem_bn(self.stem(x)))
        for stage in self.stages:
            for block in stage:
                h = block(h)
        # global average pool over the spatial dims
        h = h.mean(dim=(1, 2) if self.data_format == "NHWC" else (2, 3))
        return self.fc(h)


def resnet50(num_classes=1000, data_format="NCHW", device=None):
    return ResNet(50, num_classes, data_format=data_format, device=device)


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
