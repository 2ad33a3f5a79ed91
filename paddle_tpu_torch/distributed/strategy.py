"""DistributedStrategy — one config object for how a program scales.

Counterpart of paddle_tpu/distributed/strategy.py (the reference's
DistributedStrategy, fleet collective __init__.py:94, and the
BuildStrategy knobs it forwards). The central field is the mesh layout
(ranks along the dp / tp / pp / sp axes), which `CollectiveOptimizer`
records in program.meta; the reference's knobs about all-reduce fusion,
hierarchical rings and communicator counts are accepted for source
compatibility and have no effect.
"""


class DistributedStrategy:
    def __init__(self):
        # mesh layout: axis name -> size; None/empty means pure DP over all
        # visible devices
        self.mesh_axes = None            # e.g. {"dp": 4, "tp": 2}
        # precision
        self.use_amp = False             # wrap optimizer in amp.decorate
        self.amp_dtype = "bfloat16"
        self.amp_loss_scaling = None     # None -> dtype-appropriate default
        # memory
        self.recompute = False           # wrap in RecomputeOptimizer
        self.recompute_checkpoints = None
        # gradient transforms (reference: DGCMomentum, LocalSGD transpiler)
        self.use_dgc = False
        self.dgc_rampup_begin_step = 0
        self.use_local_sgd = False
        self.local_sgd_steps = 1
        # gradient accumulation (multi_batch_merge_pass parity)
        self.gradient_merge_steps = 1
        # pipeline parallelism (parallel.pipeline's schedules):
        # schedule in {"gpipe", "1f1b", "interleaved"}; None leaves the
        # program's recorded plan untouched. virtual_stages only applies
        # to "interleaved" (v model chunks per device, Megatron-style).
        self.pipeline_schedule = None
        self.pipeline_num_microbatches = 1
        self.pipeline_virtual_stages = 1
        # accepted-and-ignored reference knobs
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.fuse_all_reduce_ops = True
        self.exec_strategy = None
        self.build_strategy = None

    def __repr__(self):
        def interesting(v):
            if v is True:
                return True   # enabled flags must show (True == 1 pitfall)
            if v is None or v is False:
                return False
            return not (isinstance(v, int) and v == 1)

        on = {k: v for k, v in vars(self).items()
              if interesting(v) and k != "mesh_axes"}
        return f"DistributedStrategy(mesh={self.mesh_axes}, {on})"
