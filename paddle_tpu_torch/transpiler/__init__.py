"""fluid.transpiler: the distribute transpiler's surface.

Counterpart of paddle_tpu/transpiler/__init__.py (the reference's
python/paddle/fluid/transpiler/__init__.py: DistributeTranspiler and its
config, distribute_transpiler.py:230, the memory-optimization passes and
the PS dispatchers, ps_dispatcher.py).

The reference rewrites programs: it splits vars across pservers, splices
send / recv ops and generates a program per server endpoint. Here
nothing is rewritten: dense training runs through CompiledProgram's data
parallelism, and the sparse path talks to the C++ parameter server
(`paddle_tpu_torch.ps`) through the fleet. The transpiler therefore
(a) does the role and table bookkeeping (endpoint dispatch, which
server holds which table), (b) returns the trainer program unchanged,
and (c) returns pserver "programs" carrying the server's config in
`meta` for a `fleet.run_server()` launcher.
"""
import warnings

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import Program, default_main_program


class HashName:
    """ps_dispatcher.py HashName: deterministic name-hash dispatch."""

    def __init__(self, pserver_endpoints):
        self.pserver_endpoints = list(pserver_endpoints)

    def dispatch(self, varlist):
        out = []
        for v in varlist:
            name = v if isinstance(v, str) else v.name
            idx = hash(name) % len(self.pserver_endpoints)
            out.append(self.pserver_endpoints[idx])
        return out

    def reset(self):
        pass


class RoundRobin:
    """ps_dispatcher.py RoundRobin."""

    def __init__(self, pserver_endpoints):
        self.pserver_endpoints = list(pserver_endpoints)
        self._i = 0

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self.pserver_endpoints[self._i])
            self._i = (self._i + 1) % len(self.pserver_endpoints)
        return out

    def reset(self):
        self._i = 0


class DistributeTranspilerConfig:
    """distribute_transpiler.py:131 parity (split_method and sync_mode
    steer the bookkeeping; the slicing knobs are accepted for source
    compatibility — tables shard by id modulo server, ps.cc ServerFor)."""

    slice_var_up = True
    split_method = RoundRobin
    min_block_size = 8192
    enable_dc_asgd = False
    sync_mode = True
    runtime_split_send_recv = False
    geo_sgd_mode = False
    geo_sgd_need_push_nums = 100


class DistributeTranspiler:
    """distribute_transpiler.py:230 source-compat front-end.

    transpile() records the cluster layout and assigns each sparse/dense
    table to a pserver endpoint with config.split_method;
    get_trainer_program() is the unchanged main program (the executor +
    fleet runtime own the PS RPCs); get_pserver_program(ep) returns a
    Program whose meta carries everything a server launcher needs."""

    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._transpiled = False

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=True, startup_program=None,
                  current_endpoint="127.0.0.1:6174"):
        enforce(trainer_id >= 0, "trainer_id must be >= 0, got %s",
                trainer_id)
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.program = program or default_main_program()
        self.pserver_endpoints = (pservers.split(",")
                                  if isinstance(pservers, str) else
                                  list(pservers))
        self.current_endpoint = current_endpoint
        # assign each parameter to a pserver (the reference slices vars;
        # here whole tables dispatch — ids shard server-side)
        dispatcher = self.config.split_method(self.pserver_endpoints)
        params = [v.name for v in self.program.all_parameters()]
        self.param_to_endpoint = dict(zip(params,
                                          dispatcher.dispatch(params)))
        self._transpiled = True

    def get_trainer_program(self, wait_port=True):
        enforce(self._transpiled, "call transpile() first")
        self.program.meta["ps_endpoints"] = self.pserver_endpoints
        self.program.meta["trainer_id"] = self.trainer_id
        self.program.meta["sync_mode"] = self.sync_mode
        return self.program

    def get_pserver_program(self, endpoint):
        enforce(self._transpiled, "call transpile() first")
        enforce(endpoint in self.pserver_endpoints,
                "endpoint %s not in pserver list %s", endpoint,
                self.pserver_endpoints)
        prog = Program()
        prog.meta["role"] = "pserver"
        prog.meta["endpoint"] = endpoint
        prog.meta["trainers"] = self.trainer_num
        prog.meta["tables"] = [p for p, ep in self.param_to_endpoint.items()
                               if ep == endpoint]
        return prog

    def get_pserver_programs(self, endpoint):
        prog = self.get_pserver_program(endpoint)
        return prog, self.get_startup_program(endpoint, prog)

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        prog = Program()
        prog.meta["role"] = "pserver_startup"
        if endpoint is not None:
            prog.meta["endpoint"] = endpoint
        return prog


_warned = set()


def memory_optimize(input_program=None, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """memory_optimization_transpiler.py memory_optimize: torch's caching
    allocator frees each tensor when its last use ends, so this pass is a
    documented no-op (the reference itself deprecated it in favour of
    build strategies)."""
    if "memory_optimize" not in _warned:
        _warned.add("memory_optimize")
        warnings.warn("memory_optimize is a no-op: torch's caching "
                      "allocator reuses buffers by liveness", stacklevel=2)
    return input_program


def release_memory(input_program=None, skip_opt_set=None):
    if "release_memory" not in _warned:
        _warned.add("release_memory")
        warnings.warn("release_memory is a no-op: torch frees buffers by "
                      "liveness; see BuildStrategy.memory_optimize",
                      stacklevel=2)
    return input_program
