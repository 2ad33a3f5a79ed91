"""fluid.trainer_desc: the trainer configs.

Counterpart of paddle_tpu/trainer_desc.py (the reference's
trainer_desc.py:20: config objects serialized to TrainerDesc protos for
the C++ trainer stack). Here `Executor.train_from_dataset` and the
pipeline executor take the same knobs directly; these classes carry
them (and print them for debugging), so trainer_factory-style code ports
unchanged."""


class TrainerDesc:
    def __init__(self):
        self.proto_desc = {
            "class_name": type(self).__name__,
            "thread_num": 1,
            "debug": False,
            "fetch_vars": [],
            "fetch_period": 100,
        }
        self._program = None
        self._device_worker = None

    # reference setter surface (trainer_desc.py:40-120)
    def _set_thread(self, num):
        self.proto_desc["thread_num"] = int(num)

    def _set_debug(self, debug):
        self.proto_desc["debug"] = bool(debug)

    def _set_fetch_var_and_info(self, fetch_vars, fetch_info, period):
        self.proto_desc["fetch_vars"] = [
            v.name if hasattr(v, "name") else str(v) for v in fetch_vars]
        self.proto_desc["fetch_info"] = list(fetch_info)
        self.proto_desc["fetch_period"] = int(period)

    def _set_program(self, program):
        self._program = program

    def _set_device_worker(self, device_worker):
        self._device_worker = device_worker

    def _desc(self):
        return dict(self.proto_desc)

    def __str__(self):
        return str(self._desc())


class MultiTrainer(TrainerDesc):
    """trainer_desc.py:128 — the default multi-thread hogwild trainer."""


class DistMultiTrainer(TrainerDesc):
    """trainer_desc.py:149 — PS-mode trainer (async communicator)."""


class PipelineTrainer(TrainerDesc):
    """trainer_desc.py:168 — the section-pipelined trainer; it runs as
    parallel.PipelineCompiledProgram."""
