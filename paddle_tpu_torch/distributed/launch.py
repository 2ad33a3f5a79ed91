"""Multi-process training launcher.

Counterpart of paddle_tpu/distributed/launch.py (the reference's
python/paddle/distributed/launch.py, start_procs :147): one training
process per worker with the PADDLE_* environment contract,

    PADDLE_TRAINER_ID         rank of this worker
    PADDLE_TRAINERS_NUM       world size
    PADDLE_CURRENT_ENDPOINT   this worker's ip:port
    PADDLE_TRAINER_ENDPOINTS  comma-separated all endpoints
    FLAGS_selected_gpus       this worker's card on the node

plus MASTER_ADDR / MASTER_PORT, the address of the TCP store
`torch.distributed` meets at, which `fleet.init()` reads (the JAX
package exports a JAX coordinator address instead). Its port is
`--master_port`, by default the one below `--started_port`.

Elastic mode (`--elastic`): the launcher is a `reliability.Supervisor`:
a crashed worker restarts with the same rank and environment up to
`--max_restarts` times within a `--restart_window`-second window and
resumes from its latest valid checkpoint, SIGTERM drains, and the
supervision report is written as JSON (`--report`). Without it the
launch fails fast: a worker's nonzero exit terminates the others and is
the launcher's exit code.

Usage:
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
        train.py ...
    python -m paddle_tpu_torch.distributed.launch --elastic \\
        --max_restarts=3 --report=supervise.json train.py ...
"""
import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["get_cluster_env", "start_procs", "start_elastic", "main"]


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch distributed launcher")
    p.add_argument("--cluster_node_ips", default="127.0.0.1",
                   help="comma-separated ips of all nodes")
    p.add_argument("--node_ip", default="127.0.0.1",
                   help="ip of this node")
    p.add_argument("--started_port", type=int, default=6170,
                   help="first worker port on this node")
    p.add_argument("--master_port", type=int, default=None,
                   help="port of the torch.distributed store on the first "
                        "node (default: --started_port - 1)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes per node")
    p.add_argument("--log_dir", default=None,
                   help="directory for per-worker logs (workerlog.N); "
                        "default: inherit stdout/stderr")
    p.add_argument("--elastic", action="store_true",
                   help="supervise workers: restart crashes with the "
                        "same rank/env (resume via checkpoints) instead "
                        "of failing the whole job")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="[elastic] restart budget per worker within "
                        "--restart_window")
    p.add_argument("--restart_window", type=float, default=60.0,
                   help="[elastic] sliding window (seconds) the restart "
                        "budget applies to")
    p.add_argument("--drain_timeout", type=float, default=10.0,
                   help="[elastic] seconds to wait for SIGTERMed workers "
                        "before SIGKILL during a drain")
    p.add_argument("--report", default=None,
                   help="[elastic] write the supervision report JSON to "
                        "this path")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def get_cluster_env(args):
    """The per-rank environment dicts of this node."""
    node_ips = args.cluster_node_ips.split(",")
    node_id = node_ips.index(args.node_ip)
    nproc = args.nproc_per_node
    all_eps = [f"{ip}:{args.started_port + i}"
               for ip in node_ips for i in range(nproc)]
    master_port = (args.master_port if args.master_port is not None
                   else args.started_port - 1)
    envs = []
    for i in range(nproc):
        rank = node_id * nproc + i
        envs.append({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(len(all_eps)),
            "PADDLE_CURRENT_ENDPOINT":
                f"{args.node_ip}:{args.started_port + i}",
            "PADDLE_TRAINER_ENDPOINTS": ",".join(all_eps),
            "MASTER_ADDR": node_ips[0],
            "MASTER_PORT": str(master_port),
            "FLAGS_selected_gpus": str(i),
        })
    return envs


def _cmd(args):
    return [sys.executable, "-u", args.training_script] \
        + args.training_script_args


def start_elastic(args):
    """Supervised launch: a reliability.Supervisor over one WorkerSpec a
    rank (the same environment contract as start_procs)."""
    from paddle_tpu_torch.reliability.supervisor import (Supervisor,
                                                         WorkerSpec)
    specs = []
    for env in get_cluster_env(args):
        log_path = None
        if args.log_dir:
            log_path = os.path.join(
                args.log_dir, f"workerlog.{env['PADDLE_TRAINER_ID']}")
        specs.append(WorkerSpec(rank=int(env["PADDLE_TRAINER_ID"]),
                                cmd=_cmd(args), env=env, log_path=log_path))
    sup = Supervisor(specs, max_restarts=args.max_restarts,
                     restart_window=args.restart_window,
                     drain_timeout=args.drain_timeout,
                     report_path=args.report)
    return sup.run()["exit_code"]


def start_procs(args):
    """launch.py:147 parity: start every worker, fail fast."""
    if getattr(args, "elastic", False):
        return start_elastic(args)
    procs, log_fds = [], []
    for env in get_cluster_env(args):
        cur = dict(os.environ)
        cur.update(env)
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            fd = open(os.path.join(
                args.log_dir, f"workerlog.{env['PADDLE_TRAINER_ID']}"), "w")
            log_fds.append(fd)
            procs.append(subprocess.Popen(_cmd(args), env=cur, stdout=fd,
                                          stderr=subprocess.STDOUT))
        else:
            procs.append(subprocess.Popen(_cmd(args), env=cur))
    code = 0
    try:
        alive = dict(enumerate(procs))
        while alive and code == 0:
            for rank, pr in list(alive.items()):
                ret = pr.poll()
                if ret is None:
                    continue
                del alive[rank]
                if ret != 0:
                    sys.stderr.write(f"worker {rank} exited with code "
                                     f"{ret}; terminating the others\n")
                    code = ret
            time.sleep(0.1)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 10
        for pr in procs:
            try:
                pr.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()
        for fd in log_fds:
            fd.close()
    return code


def main(argv=None):
    sys.exit(start_procs(_parse_args(argv)))


if __name__ == "__main__":
    main()
