"""Fluid's CRNN-CTC text recogniser, as a static program.

PaddlePaddle/models PaddleCV/ocr_recognition/crnn_ctc_model.py (with
data_reader.py's input size and class count), built from the port's
static builders as that file builds it from fluid.layers:

* four conv_bn_pool groups of two 3 x 3 convs (padding 1, batch norm
  with ReLU) of 16 / 32 / 64 / 128 filters, a 2 x 2 max pool (stride 2,
  ceil mode) after the first three: a 1 x 48 x 512 grey image becomes
  128 x 6 x 64;
* im2sequence with filter [6, 1]: 64 steps of 768, reshaped to
  [B, 64, 768] (the dense form of the reference's LoD sequence);
* two fc projections to 3 x 200, a forward and a reverse dynamic_gru of
  200 with a relu candidate, an fc over both to 95 + 1 classes. Fluid's
  fc over the list [forward, reverse] sums one product a list entry;
  here the two are concatenated on the features and go through one fc,
  the same function (its weight is the two stacked);
* warpctc(blank=95, norm_by_times=True) summed, ctc_greedy_decoder
  (blank=95) and edit_distance against the labels (the EditDistance
  evaluator's op; normalized, as its default);
* the model's parameter attributes (Normal initializers of scale
  0.0005 / 0.01 / 0.02 / 0, L2Decay(4e-4), the GRU biases at learning
  rate 2) and Momentum(lr 1e-3, 0.9) without a global regularizer.

Labels are dense [B, max_label_len] int32 with lengths [B, 1] int64 (the
reference's LoD), padded with 0 past each length. The batch is static:
im2sequence folds it into the step dim, and the reshape back to
[B, T, 768] needs it at build time.

`crnn_ctc_programs(cfg, batch, api)` builds the training, test and startup
programs with the builders of `api` (the port's by default): any module
set with the same builder signatures builds the same program, which is
how the tests build the JAX package's twin.
"""
from collections import namedtuple
from types import SimpleNamespace

import numpy as np

__all__ = ["CRNNConfig", "port_api", "crnn_ctc_programs", "synthetic_batch"]

_FIELDS = ("image_shape", "groups", "rnn_hidden", "num_classes",
           "max_label_len", "l2", "lr", "momentum")


class CRNNConfig(namedtuple("CRNNConfig", _FIELDS)):
    """crnn_ctc_model.py's widths (the default) or a tiny one for the
    CPU tests."""

    def __new__(cls, image_shape=(1, 48, 512),
                groups=((16, 16), (32, 32), (64, 64), (128, 128)),
                rnn_hidden=200, num_classes=95, max_label_len=24, l2=4e-4,
                lr=1e-3, momentum=0.9):
        return super().__new__(cls, tuple(image_shape),
                               tuple(tuple(g) for g in groups), rnn_hidden,
                               num_classes, max_label_len, l2, lr, momentum)

    @classmethod
    def tiny(cls):
        return cls(image_shape=(1, 16, 64),
                   groups=((4, 4), (4, 4), (8, 8), (8, 8)), rnn_hidden=8,
                   num_classes=5, max_label_len=3)

    @property
    def steps(self):
        """The sequence length: the image width after three pools."""
        return -(-self.image_shape[2] // 8)

    @property
    def feature_height(self):
        return -(-self.image_shape[1] // 8)


def port_api():
    """The port's builders, optimizer, regularizer and attributes."""
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.utils.initializer import Normal
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    from paddle_tpu_torch.utils.regularizer import L2Decay
    return SimpleNamespace(static=static, optimizer=optimizer, ir=ir,
                           ParamAttr=ParamAttr, Normal=Normal,
                           L2Decay=L2Decay)


def _encoder(api, cfg, images):
    """crnn_ctc_model.py encoder_net: the logits [B, T, classes + 1]."""
    s, attr, normal = api.static, api.ParamAttr, api.Normal
    reg = api.L2Decay(cfg.l2)
    b = attr(regularizer=reg, initializer=normal(0.0, 0.0))
    w0 = attr(regularizer=reg, initializer=normal(0.0, 0.0005))
    w1 = attr(regularizer=reg, initializer=normal(0.0, 0.01))
    x = images
    for gi, filters in enumerate(cfg.groups):
        for ch in filters:
            x = s.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                         param_attr=w0 if gi == 0 else w1, act=None)
            x = s.batch_norm(x, act="relu", param_attr=w1, bias_attr=b)
        if gi < len(cfg.groups) - 1:
            x = s.pool2d(x, pool_size=2, pool_type="max", pool_stride=2,
                         ceil_mode=True)
    ch = cfg.groups[-1][-1]
    seq = s.im2sequence(x, filter_size=[cfg.feature_height, 1],
                        stride=[1, 1])
    seq = s.reshape(seq, [images.shape[0], cfg.steps,
                          ch * cfg.feature_height])
    para = attr(regularizer=reg, initializer=normal(0.0, 0.02))
    gru_bias = attr(regularizer=reg, initializer=normal(0.0, 0.02),
                    learning_rate=2.0)
    no_lr_bias = attr(regularizer=reg, initializer=normal(0.0, 0.02))
    h = cfg.rnn_hidden
    fc_1 = s.fc(seq, 3 * h, num_flatten_dims=2, param_attr=para,
                bias_attr=no_lr_bias)
    fc_2 = s.fc(seq, 3 * h, num_flatten_dims=2, param_attr=para,
                bias_attr=no_lr_bias)
    fwd = s.dynamic_gru(fc_1, h, param_attr=para, bias_attr=gru_bias,
                        candidate_activation="relu")
    bwd = s.dynamic_gru(fc_2, h, is_reverse=True, param_attr=para,
                        bias_attr=gru_bias, candidate_activation="relu")
    return s.fc(s.concat([fwd, bwd], axis=2), cfg.num_classes + 1,
                num_flatten_dims=2,
                param_attr=attr(regularizer=reg,
                                initializer=normal(0.0, 0.02)),
                bias_attr=attr(regularizer=reg,
                               initializer=normal(0.0, 0.0)))


def crnn_ctc_programs(cfg=None, batch=32, api=None, seed=0):
    """(main, test, startup, names): the training program (loss, its
    backward and Momentum), its test clone taken before the optimizer,
    and the startup program; `names` maps "pixel", "label",
    "label_length", "logits", "loss", "decoded", "decoded_length",
    "distance" and "seq_num" to var names."""
    cfg = cfg or CRNNConfig()
    api = api or port_api()
    s = api.static
    main, startup = api.ir.Program(), api.ir.Program()
    main.random_seed = startup.random_seed = seed
    with api.ir.program_guard(main, startup):
        images = s.data("pixel", [batch] + list(cfg.image_shape), "float32",
                        append_batch_size=False)
        label = s.data("label", [batch, cfg.max_label_len], "int32",
                       append_batch_size=False)
        label_len = s.data("label_length", [batch, 1], "int64",
                           append_batch_size=False)
        logits = _encoder(api, cfg, images)
        cost = s.warpctc(logits, label, blank=cfg.num_classes,
                         norm_by_times=True, label_length=label_len)
        loss = s.reduce_sum(cost)
        decoded, dec_len = s.ctc_greedy_decoder(logits, blank=cfg.num_classes)
        dist, seq_num = s.edit_distance(
            decoded, s.cast(label, "int64"), input_length=dec_len,
            label_length=label_len)
        test = main.clone(for_test=True)
        api.optimizer.Momentum(learning_rate=cfg.lr,
                               momentum=cfg.momentum).minimize(loss)
    names = dict(pixel=images.name, label=label.name,
                 label_length=label_len.name, logits=logits.name,
                 loss=loss.name, decoded=decoded.name,
                 decoded_length=dec_len.name, distance=dist.name,
                 seq_num=seq_num.name)
    return main, test, startup, names


def synthetic_batch(cfg, batch, seed):
    """A seeded batch: images uniform in [0, 1), label sequences of
    length 1..max_label_len over the cfg.num_classes classes (no blank),
    zero past each length. {feed name: numpy array}."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, cfg.max_label_len + 1, size=(batch, 1))
    label = rng.randint(0, cfg.num_classes,
                        size=(batch, cfg.max_label_len)).astype(np.int32)
    label[np.arange(cfg.max_label_len)[None, :] >= lengths] = 0
    return {"pixel": rng.rand(batch, *cfg.image_shape).astype(np.float32),
            "label": label, "label_length": lengths.astype(np.int64)}
