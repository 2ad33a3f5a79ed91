"""LeNet-5 for MNIST (BASELINE.md config 1), eager and static.

Counterpart of paddle_tpu/models/lenet.py (the reference's book
test_recognize_digits.py conv_net): the eager `LeNet` layer and
`build_static`, the same network as a static program.
"""
from paddle_tpu_torch import nn

__all__ = ["LeNet", "build_static"]


class LeNet(nn.Layer):
    """conv 5x5 (6, pad 2) -> max pool 2 -> conv 5x5 (16) -> max pool 2
    -> fc 120 -> fc 84 -> fc num_classes, relu between; NCHW [N, 1, 28,
    28] in."""

    def __init__(self, num_classes=10, device=None):
        super().__init__(device=device)
        self.conv1 = nn.Conv2D(1, 6, 5, padding=2, act="relu", device=device)
        self.pool1 = nn.Pool2D(2, "max")
        self.conv2 = nn.Conv2D(6, 16, 5, act="relu", device=device)
        self.pool2 = nn.Pool2D(2, "max")
        self.fc1 = nn.Linear(16 * 5 * 5, 120, act="relu", device=device)
        self.fc2 = nn.Linear(120, 84, act="relu", device=device)
        self.fc3 = nn.Linear(84, num_classes, device=device)

    def forward(self, x):
        h = self.pool1(self.conv1(x))
        h = self.pool2(self.conv2(h))
        h = h.reshape(h.shape[0], -1)
        return self.fc3(self.fc2(self.fc1(h)))


def build_static(img, label):
    """Static-graph LeNet (fluid.layers style) -> (logits, avg_loss, acc)."""
    from paddle_tpu_torch import static

    c1 = static.conv2d(img, 6, 5, padding=2, act="relu")
    p1 = static.pool2d(c1, 2, "max")
    c2 = static.conv2d(p1, 16, 5, act="relu")
    p2 = static.pool2d(c2, 2, "max")
    f1 = static.fc(p2, 120, act="relu")
    f2 = static.fc(f1, 84, act="relu")
    logits = static.fc(f2, 10)
    loss = static.mean(static.softmax_with_cross_entropy(logits, label))
    acc = static.accuracy(static.softmax(logits), label)
    return logits, loss, acc
