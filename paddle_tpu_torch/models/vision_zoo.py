"""Image-classification zoo beyond ResNet: VGG-BN, MobileNet v1 and
SE-ResNeXt, eager.

Counterpart of paddle_tpu/models/vision_zoo.py (the reference's book
vgg16_bn_drop, tests/book/test_image_classification.py:33-55, and the
fluid models repo's MobileNet depthwise-separable blocks and SE-ResNeXt
squeeze-excitation cardinality blocks), NCHW, with its layer names.
"""

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F

__all__ = ["VGG", "vgg16", "DepthwiseSeparable", "MobileNetV1", "SEBlock",
           "SEResNeXtBlock", "SEResNeXt"]


class VGG(nn.Layer):
    """Configurable VGG-BN: blocks of (conv 3x3 -> BN relu) then a 2x2
    max pool; dropout, fc 512 -> BN relu, dropout, fc 512 relu, fc."""

    CFG = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2), 16: (2, 2, 3, 3, 3),
           19: (2, 2, 4, 4, 4)}

    def __init__(self, depth=16, num_classes=1000, in_ch=3, image_size=224,
                 dropout=0.5, device=None):
        super().__init__(device=device)
        dev = device
        self.blocks = nn.LayerList()
        c = in_ch
        for g, ch in zip(self.CFG[depth], (64, 128, 256, 512, 512)):
            block = nn.LayerList()
            for _ in range(g):
                block.append(nn.Conv2D(c, ch, 3, padding=1, bias_attr=False,
                                       device=dev))
                block.append(nn.BatchNorm(ch, act="relu", device=dev))
                c = ch
            block.append(nn.Pool2D(2, "max", pool_stride=2))
            self.blocks.append(block)
        feat = image_size // 32
        self.drop = nn.Dropout(dropout)
        self.fc1 = nn.Linear(512 * feat * feat, 512, act="relu", device=dev)
        self.bn1 = nn.BatchNorm(512, act="relu", device=dev)
        self.drop2 = nn.Dropout(dropout)
        self.fc2 = nn.Linear(512, 512, act="relu", device=dev)
        self.fc3 = nn.Linear(512, num_classes, device=dev)

    def forward(self, x, generator=None):
        """`generator`: a torch.Generator on x's device for the two
        dropouts (needed in training with dropout > 0)."""
        h = x
        for block in self.blocks:
            for layer in block:
                h = layer(h)
        h = h.reshape(h.shape[0], -1)
        h = self.bn1(self.fc1(self.drop(h, generator)))
        h = self.fc2(self.drop2(h, generator))
        return self.fc3(h)


def vgg16(num_classes=1000, **kw):
    return VGG(16, num_classes, **kw)


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, device=None):
        super().__init__(device=device)
        self.dw = nn.Conv2D(in_ch, in_ch, 3, stride=stride, padding=1,
                            groups=in_ch, bias_attr=False, device=device)
        self.dw_bn = nn.BatchNorm(in_ch, act="relu", device=device)
        self.pw = nn.Conv2D(in_ch, out_ch, 1, bias_attr=False, device=device)
        self.pw_bn = nn.BatchNorm(out_ch, act="relu", device=device)

    def forward(self, x):
        return self.pw_bn(self.pw(self.dw_bn(self.dw(x))))


class MobileNetV1(nn.Layer):
    #: (out_ch, stride) per depthwise-separable block at scale 1.0
    CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]

    def __init__(self, num_classes=1000, scale=1.0, in_ch=3, device=None):
        super().__init__(device=device)
        c = max(int(32 * scale), 8)
        self.stem = nn.Conv2D(in_ch, c, 3, stride=2, padding=1,
                              bias_attr=False, device=device)
        self.stem_bn = nn.BatchNorm(c, act="relu", device=device)
        self.blocks = nn.LayerList()
        for out, stride in self.CFG:
            o = max(int(out * scale), 8)
            self.blocks.append(DepthwiseSeparable(c, o, stride, device))
            c = o
        self.fc = nn.Linear(c, num_classes, device=device)

    def forward(self, x):
        h = self.stem_bn(self.stem(x))
        for b in self.blocks:
            h = b(h)
        return self.fc(h.mean(dim=(2, 3)))


class SEBlock(nn.Layer):
    """Squeeze-and-excitation: global average pool -> fc relu -> fc
    sigmoid -> channel gates."""

    def __init__(self, ch, reduction=16, device=None):
        super().__init__(device=device)
        mid = max(ch // reduction, 4)
        self.fc1 = nn.Linear(ch, mid, act="relu", device=device)
        self.fc2 = nn.Linear(mid, ch, act="sigmoid", device=device)

    def forward(self, x):
        g = self.fc2(self.fc1(x.mean(dim=(2, 3))))
        return x * g[:, :, None, None]


class SEResNeXtBlock(nn.Layer):
    def __init__(self, in_ch, ch, stride, cardinality, downsample,
                 reduction=16, device=None):
        super().__init__(device=device)
        dev = device
        width = ch * 2          # ResNeXt 64x4d-style widening
        self.conv1 = nn.Conv2D(in_ch, width, 1, bias_attr=False, device=dev)
        self.bn1 = nn.BatchNorm(width, act="relu", device=dev)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride, padding=1,
                               groups=cardinality, bias_attr=False,
                               device=dev)
        self.bn2 = nn.BatchNorm(width, act="relu", device=dev)
        self.conv3 = nn.Conv2D(width, ch * 4, 1, bias_attr=False, device=dev)
        self.bn3 = nn.BatchNorm(ch * 4, device=dev)
        self.se = SEBlock(ch * 4, reduction, device=dev)
        self.has_down = downsample
        if downsample:
            self.down_conv = nn.Conv2D(in_ch, ch * 4, 1, stride=stride,
                                       bias_attr=False, device=dev)
            self.down_bn = nn.BatchNorm(ch * 4, device=dev)

    def forward(self, x):
        h = self.bn1(self.conv1(x))
        h = self.bn2(self.conv2(h))
        h = self.se(self.bn3(self.conv3(h)))
        sc = self.down_bn(self.down_conv(x)) if self.has_down else x
        return F.relu(h + sc)


class SEResNeXt(nn.Layer):
    CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

    def __init__(self, depth=50, num_classes=1000, cardinality=32, width=64,
                 in_ch=3, device=None):
        super().__init__(device=device)
        dev = device
        self.stem = nn.Conv2D(in_ch, width, 7, stride=2, padding=3,
                              bias_attr=False, device=dev)
        self.stem_bn = nn.BatchNorm(width, act="relu", device=dev)
        self.stem_pool = nn.Pool2D(3, "max", pool_stride=2, pool_padding=1)
        self.stages = nn.LayerList()
        in_c = ch = width
        for si, n in enumerate(self.CFG[depth]):
            stage = nn.LayerList()
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                stage.append(SEResNeXtBlock(in_c, ch, stride, cardinality,
                                            bi == 0, device=dev))
                in_c = ch * 4
            self.stages.append(stage)
            ch *= 2
        self.fc = nn.Linear(in_c, num_classes, device=dev)

    def forward(self, x):
        h = self.stem_pool(self.stem_bn(self.stem(x)))
        for stage in self.stages:
            for block in stage:
                h = block(h)
        return self.fc(h.mean(dim=(2, 3)))
