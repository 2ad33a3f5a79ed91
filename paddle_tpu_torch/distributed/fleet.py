"""Fleet — the distributed-training API.

Counterpart of paddle_tpu/distributed/fleet.py (the reference's
fleet_base.py:38 Fleet and collective/__init__.py:41, :142
CollectiveOptimizer).

* Collective mode: `fleet.init()` starts a `torch.distributed` process
  group from the launcher's environment (PADDLE_TRAINER_ID,
  PADDLE_TRAINERS_NUM, and MASTER_ADDR / MASTER_PORT, the store's
  address) — the JAX package's `jax.distributed.initialize`; after it
  `parallel.make_mesh()` and `CompiledProgram.with_data_parallel` run
  over that group. `barrier_worker()` is a process-group barrier.
* The backend follows the layout (`choose_backend`, the one place it is
  decided): gloo on the CPU, and on the card when the node's ranks
  outnumber its cards (NCCL refuses two ranks on one device); NCCL when
  each rank has a card of its own.
* `fleet.distributed_optimizer` wraps the optimizer in
  `CollectiveOptimizer`: recompute, AMP and gradient merge (the
  reference's multi_batch_merge_pass) as program transforms.
* Parameter-server mode (`init_worker`, `run_server`, `stop_worker`)
  delegates to `paddle_tpu_torch.ps`.
"""
import os
import warnings

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.distributed.role_maker import (PaddleCloudRoleMaker,
                                                     RoleMakerBase)
from paddle_tpu_torch.distributed.strategy import DistributedStrategy
from paddle_tpu_torch.optimizer import Optimizer, _persistable_var

__all__ = ["Fleet", "CollectiveOptimizer", "choose_backend", "fleet"]


def choose_backend(device, ranks_on_node, cards_on_node):
    """The process group's backend for this layout: "gloo" for the CPU or
    when the node's ranks share its cards (NCCL refuses two ranks on one
    device), "nccl" when each rank has a card of its own."""
    if device.type != "cuda" or ranks_on_node > cards_on_node:
        return "gloo"
    return "nccl"


class Fleet:
    """fleet_base.py:38 parity (collective mode; the PS-mode hooks
    delegate to paddle_tpu_torch.ps)."""

    def __init__(self):
        self._role_maker = None
        self._is_initialized = False
        self._strategy = None
        self.device = None
        self.backend = None

    # -- lifecycle ------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, device=None):
        """`device`: where this worker computes (None means the card and
        raises without one); a worker of a launched multi-process job
        joins the process group here."""
        if role_maker is None:
            role_maker = PaddleCloudRoleMaker(is_collective=is_collective)
        enforce(isinstance(role_maker, RoleMakerBase),
                "role_maker must be a RoleMakerBase, got %s", type(role_maker))
        if not role_maker._generated:
            role_maker.generate_role()
        self._role_maker = role_maker
        # a role maker made for parameter-server mode keeps the worker
        # out of the process group (the reference reads only `init`'s
        # own is_collective)
        collective = is_collective and getattr(role_maker, "_is_collective",
                                               True)
        if collective and role_maker.is_worker() \
                and role_maker.worker_num() > 1:
            self._init_process_group(device)
        self._is_initialized = True
        return self

    def _init_process_group(self, device):
        """The reference generates an NCCL unique id over RPC
        (c_gen_nccl_id); torch.distributed meets at a TCP store whose
        address the launcher exports as MASTER_ADDR / MASTER_PORT."""
        import torch
        from paddle_tpu_torch.core.places import resolve_device
        dev = resolve_device(device)
        rm = self._role_maker
        me = os.environ.get("PADDLE_CURRENT_ENDPOINT",
                            rm.get_trainer_endpoints()[rm.worker_index()])
        host = me.rsplit(":", 1)[0]
        ranks_on_node = sum(1 for ep in rm.get_trainer_endpoints()
                            if ep.rsplit(":", 1)[0] == host)
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            local = int(os.environ.get("FLAGS_selected_gpus", "0"))
            dev = torch.device("cuda", local % cards)
            torch.cuda.set_device(dev)
        else:
            cards = 0
        self.device = dev
        self.backend = choose_backend(dev, ranks_on_node, cards)
        self._join_group(self.backend)

    def _join_group(self, backend):
        """The workers' process group at the launcher's store."""
        import torch.distributed as dist
        if dist.is_initialized():
            return
        rm = self._role_maker
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        enforce(addr is not None and port is not None,
                "fleet.init(is_collective=True) needs MASTER_ADDR and "
                "MASTER_PORT, the process group's store, as "
                "`python -m paddle_tpu_torch.distributed.launch` exports "
                "them")
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                world_size=rm.worker_num(),
                                rank=rm.worker_index())

    # -- identity -------------------------------------------------------
    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def server_num(self):
        return self._role_maker.server_num()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    # -- synchronization ------------------------------------------------
    def barrier_worker(self):
        """A barrier of the workers' process group (the reference's MPI
        barrier). In parameter-server mode the workers meet in a gloo
        group at the launcher's store, made on the first barrier."""
        import torch.distributed as dist
        if self._role_maker.worker_num() > 1:
            self._join_group("gloo")
            dist.barrier()

    # -- parameter-server mode ------------------------------------------
    def _ps(self):
        from paddle_tpu_torch import ps
        return ps

    def init_worker(self):
        if self.server_num():
            self._ps().connect_workers(self.server_endpoints())

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        enforce(self.is_server(), "run_server on a non-server role")
        self._ps().serve(self._role_maker)

    def stop_worker(self):
        """Every worker calls it once its last RPC is done: the workers
        meet at `barrier_worker`, then the first stops the servers and the
        others close their connections (Paddle's fleet.stop_worker). A
        stop sent while another worker's reply is still in flight would
        cut that reply off (the server shuts every connection down)."""
        if not self.server_num():
            return
        self.barrier_worker()
        ps = self._ps()
        if self.is_first_worker():
            ps.shutdown_workers(self.server_endpoints())
        else:
            ps.client().close()

    # -- training -------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        enforce(self._is_initialized, "call fleet.init() first")
        self._strategy = strategy or DistributedStrategy()
        return CollectiveOptimizer(optimizer, self._strategy)

    # -- io (first worker only, fleet_base save_* parity) ---------------
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None):
        if self.is_first_worker():
            from paddle_tpu_torch.static import io
            io.save_inference_model(dirname, feeded_var_names, target_vars,
                                    executor, main_program)
        self.barrier_worker()

    def save_persistables(self, executor, dirname, main_program=None):
        if self.is_first_worker():
            from paddle_tpu_torch.static import io
            io.save_persistables(executor, dirname, main_program)
        self.barrier_worker()


class CollectiveOptimizer(Optimizer):
    """collective/__init__.py:142 parity: the DistributedOptimizer of the
    collective (all-reduce) mode. The reference's transpiler inserts
    c_allreduce ops after the backward (transpiler/collective.py:178);
    here `CompiledProgram.with_data_parallel` all-reduces the gradients
    in its op hook, so this wrapper's job is the strategy's transforms:
    recompute -> AMP -> gradient merge -> the inner optimizer."""

    def __init__(self, optimizer, strategy=None):
        super().__init__(learning_rate=optimizer._lr)
        self._inner = optimizer
        self._strategy = strategy or DistributedStrategy()
        self._opt = None  # the strategy-wrapped chain, built once: backward
        #                   and apply_gradients MUST share it (AMP keeps its
        #                   loss-scaling state on the wrapper)

    def _wrapped(self):
        if self._opt is not None:
            return self._opt
        # amp first (it extends backward/apply_gradients), recompute
        # outermost (it only threads checkpoints into backward)
        opt = self._inner
        if self._strategy.use_amp:
            from paddle_tpu_torch import amp
            opt = amp.decorate(
                opt, dest_dtype=self._strategy.amp_dtype,
                init_loss_scaling=self._strategy.amp_loss_scaling)
        if self._strategy.recompute:
            from paddle_tpu_torch.optimizer.meta import RecomputeOptimizer
            opt = RecomputeOptimizer(opt)
            if self._strategy.recompute_checkpoints:
                opt._set_checkpoints(
                    list(self._strategy.recompute_checkpoints))
        self._opt = opt
        return opt

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        st = self._strategy
        if st.use_dgc or st.use_local_sgd:
            warnings.warn("DGC/LocalSGD strategies run in the eager "
                          "gradient hooks (parallel.grad_hooks) — ignored "
                          "in CollectiveOptimizer.minimize")
        opt = self._wrapped()
        program = loss.block.program

        if st.gradient_merge_steps > 1:
            pg = opt.backward(loss, startup_program=startup_program,
                              parameter_list=parameter_list,
                              no_grad_set=no_grad_set)
            amp_opt = self._find_amp(opt)
            pg, restore_lr = self._apply_gradient_merge(
                pg, program, startup_program, st.gradient_merge_steps,
                amp_opt=amp_opt)
            # when AMP loss scaling is active the merge pass already
            # unscaled + finite-checked each microbatch grad, so apply via
            # the optimizer UNDER the AMP wrapper (a second unscale would
            # divide the merged grads by the scale again)
            if amp_opt is not None and amp_opt._use_scaling:
                apply_opt = amp_opt._optimizer
            else:
                apply_opt = opt
            try:
                opt_ops = apply_opt.apply_gradients(
                    pg, program=program, startup_program=startup_program)
            finally:
                restore_lr()
            result = opt_ops, pg
        else:
            result = opt.minimize(loss, startup_program=startup_program,
                                  parameter_list=parameter_list,
                                  no_grad_set=no_grad_set)

        if st.mesh_axes:
            program.meta["mesh_axes"] = dict(st.mesh_axes)
        program.meta["distributed_strategy"] = repr(st)
        return result

    def backward(self, *a, **kw):
        return self._wrapped().backward(*a, **kw)

    def apply_gradients(self, *a, **kw):
        # must be the SAME wrapped chain backward() used, so AMP's
        # unscale/finite-check runs and sees its loss-scaling vars
        return self._wrapped().apply_gradients(*a, **kw)

    @staticmethod
    def _find_amp(opt):
        """Walk the strategy-wrapper chain for the AMP node, if any."""
        from paddle_tpu_torch.amp.decorator import OptimizerWithMixedPrecision
        node = opt
        while node is not None:
            if isinstance(node, OptimizerWithMixedPrecision):
                return node
            node = getattr(node, "_optimizer", getattr(node, "inner", None))
        return None

    def _apply_gradient_merge(self, params_grads, program, startup, k,
                              amp_opt=None):
        """multi_batch_merge_pass parity via select ops: accumulate grads
        for k steps; on the k-th, feed the averaged accumulator to the
        optimizer. Off steps feed zero grads AND a zeroed learning rate, so
        parameters cannot move even when regularization/weight-decay ops add
        decay terms to the gated grad. (Adaptive-moment decay on off steps
        remains — the same looseness the reference's batch-merge tests
        accept.)

        With AMP loss scaling, each microbatch grad is unscaled and
        finite-checked BEFORE entering the accumulator (an overflowing
        microbatch contributes zero and steps the dynamic-scale counters),
        so the accumulator never mixes gradients scaled by different
        factors and overflow feedback reaches update_loss_scaling every
        microbatch, not once per merge window.

        Returns (new_params_grads, restore_lr_fn); the caller must invoke
        restore_lr_fn after apply_gradients so the user's optimizer object
        is not left pointing at this program's gated-LR variable."""
        import paddle_tpu_torch.core.ir as ir
        from paddle_tpu_torch.core.ir import OpRole, unique_name
        startup = startup or ir.default_startup_program()
        block = program.global_block()
        step = _persistable_var(program, startup, unique_name("gm_step"),
                                [1], "int32", 0)
        new_pg = []
        with program.op_role_guard(OpRole.BACKWARD):
            block.append_op("increment", {"X": [step.name]},
                            {"Out": [step.name]}, {"step": 1})
            boundary = block.create_var(name=unique_name("gm_boundary"),
                                        dtype="bool", stop_gradient=True)
            kvar = block.create_var(name=unique_name("gm_k"), dtype="int32",
                                    stop_gradient=True)
            block.append_op("fill_constant", {}, {"Out": [kvar.name]},
                            {"shape": [1], "value": k, "dtype": "int32"})
            modv = block.create_var(name=unique_name("gm_mod"), dtype="int32",
                                    stop_gradient=True)
            block.append_op("elementwise_mod", {"X": [step.name],
                                                "Y": [kvar.name]},
                            {"Out": [modv.name]}, {"axis": -1})
            zero = block.create_var(name=unique_name("gm_zero"), dtype="int32",
                                    stop_gradient=True)
            block.append_op("fill_constant", {}, {"Out": [zero.name]},
                            {"shape": [1], "value": 0, "dtype": "int32"})
            block.append_op("equal", {"X": [modv.name], "Y": [zero.name]},
                            {"Out": [boundary.name]})
            maskf = block.create_var(name=unique_name("gm_mask"),
                                     dtype="float32", stop_gradient=True)
            block.append_op("cast", {"X": [boundary.name]},
                            {"Out": [maskf.name]},
                            {"in_dtype": "bool", "out_dtype": "float32"})

            keepf = None
            if amp_opt is not None and amp_opt._use_scaling:
                scale_name = amp_opt._loss_scaling_name
                grad_names = [g.name for _, g in params_grads]
                found_inf = block.create_var(
                    name=unique_name("gm_found_inf"), dtype="bool", shape=[1],
                    stop_gradient=True)
                block.append_op("check_finite_and_unscale",
                                {"X": grad_names, "Scale": [scale_name]},
                                {"Out": grad_names,
                                 "FoundInfinite": [found_inf.name]})
                if amp_opt._use_dynamic_loss_scaling:
                    good = _persistable_var(program, startup,
                                            unique_name("gm_good_steps"),
                                            [1], "int32", 0)
                    bad = _persistable_var(program, startup,
                                           unique_name("gm_bad_steps"),
                                           [1], "int32", 0)
                    block.append_op(
                        "update_loss_scaling",
                        {"FoundInfinite": [found_inf.name],
                         "PrevLossScaling": [scale_name],
                         "InGoodSteps": [good.name], "InBadSteps": [bad.name]},
                        {"LossScaling": [scale_name],
                         "OutGoodSteps": [good.name],
                         "OutBadSteps": [bad.name]},
                        {"incr_every_n_steps": amp_opt._incr_every_n_steps,
                         "decr_every_n_nan_or_inf":
                             amp_opt._decr_every_n_nan_or_inf,
                         "incr_ratio": amp_opt._incr_ratio,
                         "decr_ratio": amp_opt._decr_ratio})
                # keepf = 1 - found_inf: drop an overflowed microbatch from
                # the accumulator instead of poisoning the window
                inff = block.create_var(name=unique_name("gm_inf_f"),
                                        dtype="float32", stop_gradient=True)
                block.append_op("cast", {"X": [found_inf.name]},
                                {"Out": [inff.name]},
                                {"in_dtype": "bool", "out_dtype": "float32"})
                keepv = block.create_var(name=unique_name("gm_keep_mb"),
                                         dtype="float32", stop_gradient=True)
                block.append_op("scale", {"X": [inff.name]},
                                {"Out": [keepv.name]},
                                {"scale": -1.0, "bias": 1.0})
                keepf = keepv

            for p, g in params_grads:
                acc = _persistable_var(program, startup,
                                       f"{p.name}@GRAD_MERGE", p.shape,
                                       "float32", 0.0)
                # acc += g   (masked by the microbatch finite check if AMP)
                add_name = g.name
                if keepf is not None:
                    kept = block.create_var(
                        name=unique_name(f"{g.name}_kept"),
                        dtype="float32", stop_gradient=True)
                    block.append_op("elementwise_mul",
                                    {"X": [g.name], "Y": [keepf.name]},
                                    {"Out": [kept.name]}, {"axis": -1})
                    add_name = kept.name
                block.append_op("elementwise_add",
                                {"X": [acc.name], "Y": [add_name]},
                                {"Out": [acc.name]}, {"axis": -1})
                # gated = acc/k * mask  (mean over merged microbatches)
                gated = block.create_var(name=unique_name(f"{g.name}_merged"),
                                         dtype="float32", stop_gradient=True)
                block.append_op("scale", {"X": [acc.name]},
                                {"Out": [gated.name]}, {"scale": 1.0 / k})
                block.append_op("elementwise_mul",
                                {"X": [gated.name], "Y": [maskf.name]},
                                {"Out": [gated.name]}, {"axis": -1})
                # acc *= (1 - mask): reset on boundary
                keep = block.create_var(name=unique_name("gm_keep"),
                                        dtype="float32", stop_gradient=True)
                block.append_op("scale", {"X": [maskf.name]},
                                {"Out": [keep.name]},
                                {"scale": -1.0, "bias": 1.0})
                block.append_op("elementwise_mul",
                                {"X": [acc.name], "Y": [keep.name]},
                                {"Out": [acc.name]}, {"axis": -1})
                new_pg.append((p, block.var(gated.name)))

            # gate the LEARNING RATE by the boundary mask so off-step
            # updates are exact no-ops even with weight decay in the grads
            innermost = self._inner
            while True:
                nxt = getattr(innermost, "_optimizer",
                              getattr(innermost, "inner", None))
                if nxt is None:
                    break
                innermost = nxt
            from paddle_tpu_torch.core.ir import Variable
            orig_lr = innermost._lr
            if isinstance(innermost._lr, Variable):
                base_lr_name = innermost._lr.name
            else:
                base = block.create_var(name=unique_name("gm_base_lr"),
                                        dtype="float32", stop_gradient=True)
                block.append_op("fill_constant", {}, {"Out": [base.name]},
                                {"shape": [1], "value": float(innermost._lr),
                                 "dtype": "float32"})
                base_lr_name = base.name
            gated_lr = block.create_var(name=unique_name("gm_lr"),
                                        dtype="float32", stop_gradient=True)
            block.append_op("elementwise_mul",
                            {"X": [base_lr_name], "Y": [maskf.name]},
                            {"Out": [gated_lr.name]}, {"axis": -1})
            innermost._lr = block.var(gated_lr.name)

        def restore_lr():
            innermost._lr = orig_lr

        return new_pg, restore_lr


fleet = Fleet()
