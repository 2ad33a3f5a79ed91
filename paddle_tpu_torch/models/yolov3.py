"""YOLOv3 detection family.

Counterpart of paddle_tpu/models/yolov3.py: the DarkNet-53-style
backbone (ConvBN + DarkBlock stages), three FPN-style heads coarse to
fine with a nearest x2 upsample between them, the fused `yolov3_loss`
op for training and `yolo_box` + `multiclass_nms` for inference, all
through the port's op registry and all static-shape (no host read).
Parameters carry the JAX model's flat names (`stages.i2.i1.a.conv.weight`),
so `weights.layer_state_from_jax` carries a JAX YOLOv3 across.

`scale` shrinks the channel plan (1 is the paper's DarkNet-53; tests use
tiny scales). The batch norms' leaky ReLU has the JAX package's slope,
0.01 (DarkNet itself uses 0.1).
"""
from dataclasses import dataclass

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.core.registry import OpContext, get_op

__all__ = ["YoloConfig", "ConvBN", "DarkBlock", "YOLOv3"]


@dataclass
class YoloConfig:
    num_classes: int = 80
    anchors: tuple = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                      116, 90, 156, 198, 373, 326)
    anchor_masks: tuple = ((6, 7, 8), (3, 4, 5), (0, 1, 2))
    ignore_thresh: float = 0.7
    downsamples: tuple = (32, 16, 8)
    scale: float = 1.0
    stage_blocks: tuple = (1, 2, 8, 8, 4)

    @staticmethod
    def tiny():
        return YoloConfig(num_classes=4, scale=0.0625,
                          stage_blocks=(1, 1, 1, 1, 1))


class ConvBN(nn.Layer):
    def __init__(self, cin, cout, k, stride=1, device=None):
        super().__init__(device=device)
        self.conv = nn.Conv2D(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, bias_attr=False,
                              device=device)
        self.bn = nn.BatchNorm(cout, act="leaky_relu", device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class DarkBlock(nn.Layer):
    """DarkNet residual: 1x1 squeeze + 3x3 expand + skip."""

    def __init__(self, ch, device=None):
        super().__init__(device=device)
        self.a = ConvBN(ch, ch // 2, 1, device=device)
        self.b = ConvBN(ch // 2, ch, 3, device=device)

    def forward(self, x):
        return x + self.b(self.a(x))


class YOLOv3(nn.Layer):
    def __init__(self, cfg=None, device=None):
        super().__init__(device=device)
        cfg = cfg or YoloConfig()
        self.cfg = cfg
        w = max(int(64 * cfg.scale), 8)
        self.stem = ConvBN(3, w // 2, 3, device=device)
        self.stages = nn.LayerList()
        chans = []
        cin = w // 2
        for si, nblocks in enumerate(cfg.stage_blocks):
            cout = min(w * (2 ** si), int(1024 * cfg.scale) or 8)
            stage = nn.LayerList()
            stage.append(ConvBN(cin, cout, 3, stride=2, device=device))
            for _ in range(nblocks):
                stage.append(DarkBlock(cout, device=device))
            self.stages.append(stage)
            chans.append(cout)
            cin = cout
        # FPN-style heads on the last three stages, coarse -> fine
        self.heads = nn.LayerList()
        self.routes = nn.LayerList()
        out_per_anchor = 5 + cfg.num_classes
        prev = 0
        for hi, mask in enumerate(cfg.anchor_masks):
            cin_h = chans[-1 - hi] + prev
            mid = max(cin_h // 2, 8)
            self.routes.append(ConvBN(cin_h, mid, 1, device=device))
            self.heads.append(nn.Conv2D(mid, len(mask) * out_per_anchor, 1,
                                        device=device))
            prev = mid

    def backbone(self, x):
        h = self.stem(x)
        feats = []
        for stage in self.stages:
            for blk in stage:
                h = blk(h)
            feats.append(h)
        return feats[-3:]  # strides 8, 16, 32

    def forward(self, x):
        """The three raw head tensors, coarse to fine."""
        c3, c4, c5 = self.backbone(x)
        outs = []
        route = None
        for hi, feat in enumerate([c5, c4, c3]):
            if route is not None:
                up = route.repeat_interleave(2, dim=2).repeat_interleave(
                    2, dim=3)                       # nearest x2
                feat = torch.cat([feat, up], 1)
            route = self.routes[hi](feat)
            outs.append(self.heads[hi](route))
        return outs

    def _run_op(self, name, args, attrs):
        impl = get_op(name)
        ctx = OpContext(attrs, None, self.training, 0, args[0].device)
        return impl.fn(ctx, *args)

    def loss(self, x, gt_box, gt_label, gt_score=None):
        """Mean yolov3_loss over the three scales."""
        cfg = self.cfg
        total = 0.0
        heads = self.forward(x)
        for hi, out in enumerate(heads):
            loss, _, _ = self._run_op(
                "yolov3_loss", (out, gt_box, gt_label, gt_score),
                {"anchors": list(cfg.anchors),
                 "anchor_mask": list(cfg.anchor_masks[hi]),
                 "class_num": cfg.num_classes,
                 "ignore_thresh": cfg.ignore_thresh,
                 "downsample_ratio": cfg.downsamples[hi],
                 "use_label_smooth": True})
            total = total + loss.mean()
        return total / len(heads)

    def predict(self, x, im_size, score_threshold=0.05, nms_top_k=64,
                keep_top_k=100, nms_threshold=0.45):
        """Decode + NMS → [N, keep_top_k, 6] (class, score, box)."""
        cfg = self.cfg
        boxes, scores = [], []
        for hi, out in enumerate(self.forward(x)):
            b, s = self._run_op(
                "yolo_box", (out, im_size),
                {"anchors": [cfg.anchors[2 * a + d]
                             for a in cfg.anchor_masks[hi] for d in (0, 1)],
                 "class_num": cfg.num_classes, "conf_thresh": 0.005,
                 "downsample_ratio": cfg.downsamples[hi]})
            boxes.append(b)
            scores.append(s)
        return self._run_op(
            "multiclass_nms", (torch.cat(boxes, 1),
                               torch.cat(scores, 1).permute(0, 2, 1)),
            {"score_threshold": score_threshold, "nms_top_k": nms_top_k,
             "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
             "background_label": -1})
