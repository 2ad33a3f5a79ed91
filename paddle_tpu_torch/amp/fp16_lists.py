"""Per-op mixed-precision classification lists.

Counterpart of paddle_tpu/amp/fp16_lists.py (the reference's
contrib/mixed_precision/fp16_lists.py): every op is white (compute in
low precision: the matmuls and convolutions the tensor cores take),
black (numerically sensitive: keep float32) or gray (follow its
inputs). The low-precision dtype defaults to bfloat16, which needs no
loss scaling; float16 keeps the reference's dynamic loss scaling.
"""

# matmuls and convolutions (reference fp16_lists.py white_list)
WHITE_LIST = {
    "conv2d", "depthwise_conv2d", "conv2d_transpose",
    "matmul", "matmul_v2", "mul",
}

# numerically sensitive ops (reference fp16_lists.py black_list)
BLACK_LIST = {
    "exp", "log", "square", "squared_l2_norm", "frobenius_norm", "l1_norm",
    "mean", "sum", "reduce_sum", "reduce_mean",
    "softmax", "log_softmax", "sequence_softmax",
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "kldiv_loss", "huber_loss",
    "mse_loss", "smooth_l1_loss", "square_error_cost",
    "batch_norm", "sync_batch_norm", "layer_norm", "instance_norm",
    "group_norm", "auc", "accuracy", "precision_recall",
    "isfinite", "cumsum",
}

# everything else is gray: it runs in the precision its inputs arrive in


class AutoMixedPrecisionLists:
    """White / black / gray op sets with user overrides."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        self.black_varnames = set(custom_black_varnames or ())
        for op in custom_white_list or ():
            self.black_list.discard(op)
            self.white_list.add(op)
        for op in custom_black_list or ():
            if op in (custom_white_list or ()):
                raise ValueError(f"op {op!r} in both custom white and black "
                                 "lists")
            self.white_list.discard(op)
            self.black_list.add(op)

    def classify(self, op):
        """'white' | 'black' | 'gray' for an OpDesc."""
        if self.black_varnames and any(
                n in self.black_varnames
                for n in op.input_names() + op.output_names()):
            return "black"
        if op.type in self.white_list:
            return "white"
        if op.type in self.black_list:
            return "black"
        return "gray"
