"""Structured and sampled loss layers.

Counterpart of paddle_tpu/static/losses.py (fluid.layers.linear_chain_crf,
crf_decoding, warpctc, nce, hsigmoid, sampled_softmax_with_cross_entropy)
over ops/loss.py, with the JAX package's parameters and attrs.
"""
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.static.helper import LayerHelper

__all__ = ["linear_chain_crf", "crf_decoding", "warpctc", "nce", "hsigmoid",
           "sampled_softmax_with_cross_entropy"]


def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF negative log-likelihood [B, 1]. Creates (or shares, by
    param_attr name) the [num_tags+2, num_tags] transition parameter —
    row 0 start weights, row 1 end weights (linear_chain_crf_op.h)."""
    helper = LayerHelper("linear_chain_crf")
    d = input.shape[-1]
    transition = helper.create_parameter(param_attr, [d + 2, d], input.dtype)
    ll = helper.create_tmp(dtype=input.dtype)
    alpha = helper.create_tmp(dtype=input.dtype)
    ins = {"Emission": input, "Transition": transition, "Label": label}
    if length is not None:
        ins["Length"] = length
    helper.append_op("linear_chain_crf", ins,
                     {"LogLikelihood": ll, "Alpha": alpha}, {})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode [B, T] via the transition parameter named by
    param_attr (shared with linear_chain_crf)."""
    helper = LayerHelper("crf_decoding")
    d = input.shape[-1]
    transition = helper.create_parameter(param_attr, [d + 2, d], input.dtype)
    out = helper.create_tmp(dtype="int32", stop_gradient=True)
    ins = {"Emission": input, "Transition": transition}
    if label is not None:
        ins["Label"] = label
    if length is not None:
        ins["Length"] = length
    helper.append_op("crf_decoding", ins, {"ViterbiPath": out}, {})
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss [B, 1] on dense [B, T, C] raw logits + [B, Lmax] labels."""
    helper = LayerHelper("warpctc")
    loss = helper.create_tmp(dtype=input.dtype)
    ins = {"Logits": input, "Label": label}
    if input_length is not None:
        ins["LogitsLength"] = input_length
    if label_length is not None:
        ins["LabelLength"] = label_length
    helper.append_op("warpctc", ins, {"Loss": loss},
                     {"blank": blank, "norm_by_times": norm_by_times})
    return loss


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """NCE loss [B, 1] (nn.py:7553). custom_dist is accepted for signature
    parity; sampled-softmax distributions beyond uniform/log_uniform route
    through attr custom_neg_classes when provided as a list of ints."""
    helper = LayerHelper("nce")
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_total_classes, d],
                                input.dtype)
    b = helper.create_parameter(bias_attr, [num_total_classes], input.dtype,
                                is_bias=True)
    cost = helper.create_tmp(dtype=input.dtype)
    sample_logits = helper.create_tmp(dtype=input.dtype)
    sample_labels = helper.create_tmp(dtype="int32", stop_gradient=True)
    ins = {"Input": input, "Label": label, "Weight": w}
    if b is not None:
        ins["Bias"] = b
    if sample_weight is not None:
        ins["SampleWeight"] = sample_weight
    attrs = {"num_total_classes": num_total_classes,
             "num_neg_samples": num_neg_samples or 10,
             "sampler": sampler}
    if isinstance(custom_dist, (list, tuple)) and custom_dist and \
            isinstance(custom_dist[0], int):
        attrs["custom_neg_classes"] = list(custom_dist)
    helper.append_op("nce", ins,
                     {"Cost": cost, "SampleLogits": sample_logits,
                      "SampleLabels": sample_labels}, attrs)
    return cost


def hsigmoid(input, label, num_classes=None, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid loss [B, 1] (nn.py:7782)."""
    helper = LayerHelper("hsigmoid")
    d = input.shape[-1]
    if is_custom:
        enforce(path_table is not None and path_code is not None,
                "custom hsigmoid requires path_table and path_code")
        num_w = num_classes  # custom trees pass the node count here
    else:
        enforce(num_classes is not None and num_classes > 1,
                "hsigmoid needs num_classes > 1")
        num_w = num_classes - 1
    w = helper.create_parameter(param_attr, [num_w, d], input.dtype)
    b = helper.create_parameter(bias_attr, [num_w], input.dtype, is_bias=True)
    out = helper.create_tmp(dtype=input.dtype)
    pre = helper.create_tmp(dtype=input.dtype)
    ins = {"X": input, "Label": label, "W": w}
    if b is not None:
        ins["Bias"] = b
    if path_table is not None:
        ins["PathTable"] = path_table
    if path_code is not None:
        ins["PathCode"] = path_code
    helper.append_op("hsigmoid", ins, {"Out": out, "PreOut": pre},
                     {"num_classes": num_classes or 2})
    return out


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """layers/nn.py sampled_softmax_with_cross_entropy (sample_logits +
    softmax CE on the sampled columns)."""
    helper = LayerHelper("sampled_softmax_with_cross_entropy")
    ins = {"Logits": logits, "Label": label}
    if use_customized_samples:
        ins["CustomizedSamples"] = customized_samples
        if customized_probabilities is not None:
            ins["CustomizedProbabilities"] = customized_probabilities
    loss, _ = helper.append_simple(
        ins, {"num_samples": num_samples,
              "remove_accidental_hits": remove_accidental_hits,
              "seed": seed},
        n_out=2, out_slots=["Loss", "Samples"])
    return loss
