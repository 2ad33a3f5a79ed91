"""LeNet-5 for MNIST as a static program (BASELINE.md config 1).

Counterpart of paddle_tpu/models/lenet.py's `build_static` (the
reference's book test_recognize_digits.py conv_net). The eager `LeNet`
layer comes with the layer zoo (ROADMAP Queue 1 items 2 + 5).
"""

__all__ = ["build_static"]


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
