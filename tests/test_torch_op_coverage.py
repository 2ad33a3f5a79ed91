"""The op-coverage ratchet: the port's registered op types against the
JAX package's, on the CPU.

* Every op type the port registers is one of the reference's, with the
  same input and output slots (names, order, optional and variadic).
* The reference op types the port still lacks equal MISSING, by the
  module that registers them in the JAX package. Porting an op means
  taking it off this list (ROADMAP Queue 1 item 7 carries the same
  list); an op that leaves the port, or a new reference op, fails here.
* Every op type of paddle_tpu/ops/{tensor,math,nn,random,optimizer_ops,
  metrics,sequence,rnn,control_flow,beam_search,loss,detection,
  detection_train,vision}.py is ported but `sync_batch_norm` (the
  collectives, Queue 1 item 15), and of ops/text the one the eager
  extension layers run (`tree_conv`), and amp's two loss-scaling ops:
  249 of the reference's 338 op types.
"""
import importlib

import pytest

from paddle_tpu.core import registry as jregistry
from paddle_tpu_torch.core import registry as tregistry

MISSING = {
    "ops.collective": ["c_allgather", "c_allreduce_max", "c_allreduce_min",
        "c_allreduce_prod", "c_allreduce_sum", "c_alltoall", "c_broadcast",
        "c_comm_init", "c_gen_unique_id", "c_permute", "c_reducescatter",
        "c_sync_calc_stream", "c_sync_comm_stream"],
    "ops.ctr": ["cvm", "data_norm", "filter_by_instag",
        "positive_negative_pair"],
    "ops.fused": ["attention_lstm", "fused_elemwise_activation",
        "fused_embedding_fc_lstm", "fused_embedding_seq_pool",
        "fused_fc_elementwise_layernorm", "fusion_gru", "fusion_lstm",
        "fusion_repeated_fc_relu", "fusion_seqconv_eltadd_relu",
        "fusion_seqpool_concat", "fusion_seqpool_cvm_concat",
        "fusion_squared_mat_sub", "fusion_transpose_flatten_concat",
        "switch_moe"],
    "ops.misc": ["add_position_encoding", "bilinear_tensor_product",
        "bpr_loss", "brelu", "clip_by_norm", "conv3d_transpose", "cos_sim",
        "crop_tensor", "ctc_greedy_decoder", "dice_loss", "edit_distance",
        "fsp", "gather_tree", "gaussian_random_batch_size_like",
        "hard_shrink", "has_inf", "has_nan", "hash", "is_empty",
        "l2_normalize", "log_loss", "lrn", "margin_rank_loss", "maxout",
        "mean_iou", "multiplex", "npair_loss", "pad_constant_like",
        "random_crop", "rank_loss", "reverse", "scatter_nd", "scatter_nd_add",
        "selu", "sequence_enumerate", "sequence_reshape", "sequence_scatter",
        "shard_index", "shuffle_channel", "size", "soft_relu", "softshrink",
        "space_to_depth", "stanh", "teacher_student_sigmoid_loss",
        "thresholded_relu", "unfold", "uniform_random_batch_size_like",
        "unique", "unique_with_counts"],
    "ops.nn": ["sync_batch_norm"],
    "ops.text": ["chunk_eval", "conv_shift", "match_matrix_tensor",
        "pyramid_hash", "similarity_focus", "var_conv_2d"],
    "parallel.moe": ["moe_switch"],
}

#: the JAX package's op modules that this port covers in full
FULL_FAMILIES = ("tensor", "math", "nn", "random", "optimizer_ops",
                 "metrics", "sequence", "rnn", "control_flow", "beam_search",
                 "loss", "detection", "detection_train", "vision")


def _slots(impl):
    return ([(s.name, s.optional, s.variadic) for s in impl.in_slots],
            [(s.name, s.optional, s.variadic) for s in impl.out_slots])


@pytest.mark.parametrize("op_type", tregistry.registered_ops())
def test_port_op_is_a_reference_op_with_its_slots(op_type):
    assert jregistry.has_op(op_type), op_type
    assert _slots(tregistry.get_op(op_type)) == \
        _slots(jregistry.get_op(op_type))


def test_missing_reference_ops_equal_the_list():
    assert len(tregistry.registered_ops()) == 249
    assert len(jregistry.registered_ops()) == 338
    missing = set(jregistry.registered_ops()) - set(
        tregistry.registered_ops())
    listed = {op for ops in MISSING.values() for op in ops}
    assert sum(len(v) for v in MISSING.values()) == len(listed)
    assert missing == listed, (sorted(missing - listed),
                               sorted(listed - missing))
    for module, ops in MISSING.items():
        for op in ops:
            assert jregistry.get_op(op).fn.__module__ == \
                "paddle_tpu." + module, op


@pytest.mark.parametrize("family", FULL_FAMILIES)
def test_family_is_ported(family):
    importlib.import_module(f"paddle_tpu.ops.{family}")
    ops = {op for op in jregistry.registered_ops()
           if jregistry.get_op(op).fn.__module__ == f"paddle_tpu.ops.{family}"}
    assert ops
    left = ops - set(tregistry.registered_ops())
    assert left == ({"sync_batch_norm"} if family == "nn" else set())
