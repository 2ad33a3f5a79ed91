"""Cluster role discovery.

Counterpart of paddle_tpu/distributed/role_maker.py (the reference's
python/paddle/fluid/incubate/fleet/base/role_maker.py): who this process
is in the cluster (worker or server, rank, world size, endpoints), from
the environment the launcher exports (launch.py `start_procs`) or given
explicitly. The reference's MPI role makers map to the environment here:
`torch.distributed` starts from a store address, not from MPI.
"""
import os


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    """role_maker.py:30 parity."""

    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints = ["127.0.0.1:6170"]
        self._server_endpoints = []
        self._generated = False

    def generate_role(self):
        self._generated = True

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id if self.is_worker() else -1

    def server_index(self):
        return self._current_id if self.is_server() else -1

    def worker_num(self):
        return len(self._worker_endpoints)

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)


class UserDefinedRoleMaker(RoleMakerBase):
    """role_maker.py:428 parity: explicit role/rank/endpoints."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=None,
                 worker_endpoints=None, server_endpoints=None):
        super().__init__()
        self._current_id = int(current_id)
        self._role = role
        if worker_endpoints is None:
            n = worker_num or 1
            worker_endpoints = [f"127.0.0.1:{6170 + i}" for i in range(n)]
        self._worker_endpoints = list(worker_endpoints)
        self._server_endpoints = list(server_endpoints or [])


class PaddleCloudRoleMaker(RoleMakerBase):
    """role_maker.py:328 parity: discover the role from the environment
    variables the launcher exports (PADDLE_TRAINER_ID,
    PADDLE_TRAINER_ENDPOINTS, PADDLE_CURRENT_ENDPOINT, TRAINING_ROLE,
    PADDLE_PSERVERS_IP_PORT_LIST)."""

    def __init__(self, is_collective=True):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        env = os.environ
        training_role = env.get("TRAINING_ROLE", "TRAINER").upper()
        eps = env.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else ["127.0.0.1:6170"]
        ps = env.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = ps.split(",") if ps else []
        if training_role == "PSERVER":
            self._role = Role.SERVER
            port = env.get("PADDLE_PORT", "")
            ip = env.get("POD_IP", "127.0.0.1")
            me = f"{ip}:{port}"
            self._current_id = (self._server_endpoints.index(me)
                                if me in self._server_endpoints else 0)
        else:
            self._role = Role.WORKER
            self._current_id = int(env.get("PADDLE_TRAINER_ID", "0"))
        self._generated = True
        return self
