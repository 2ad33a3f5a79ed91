"""The port's distributed package (role makers, strategy, fleet, the
launcher, CollectiveOptimizer, the transpiler) against the JAX
package's, on the CPU.

* Role makers read the launcher's environment as the reference's do; the
  launcher exports the same PADDLE_* contract, with MASTER_ADDR /
  MASTER_PORT (torch.distributed's store) in place of the JAX
  coordinator address; it fails fast on a worker's nonzero exit, and
  `--elastic` restarts a crashed worker that resumes bit-equal.
* The backend follows the layout (`choose_backend`).
* CollectiveOptimizer's gradient merge, alone and with float16 AMP
  loss scaling, builds the JAX package's program op for op and trains
  as it does from its state; PipelineOptimizer without a cut_list
  merges its microbatches through it.
* On launched processes (free ports): the collective fleet trains
  chip_smoke phase 39(c)'s CTR program through CompiledProgram over the
  gloo group fleet.init starts, each rank within 1e-5 of one process;
  the parameter-server fleet (a pserver process, two launched trainers)
  trains phase 39(b)'s DeepFM, and no child loads jax or paddle_tpu.
* The transpiler's bookkeeping and the lookup-table finders equal the
  reference's; the incubate aliases resolve.
"""
import importlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu.distributed import role_maker as jrm

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.distributed import role_maker as trm
from paddle_tpu_torch.weights import scope_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
#: the module (the package's `fleet` is the Fleet instance)
tfleet_mod = importlib.import_module("paddle_tpu_torch.distributed.fleet")


def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


# ------------------------------------------------------------ role makers
ENVS = {
    "trainer": {"TRAINING_ROLE": "TRAINER", "PADDLE_TRAINER_ID": "1",
                "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6170,10.0.0.2:6170",
                "PADDLE_PSERVERS_IP_PORT_LIST": "10.0.0.9:7000"},
    "pserver": {"TRAINING_ROLE": "PSERVER", "PADDLE_PORT": "7001",
                "POD_IP": "10.0.0.9",
                "PADDLE_PSERVERS_IP_PORT_LIST":
                    "10.0.0.9:7000,10.0.0.9:7001",
                "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6170"},
    "empty": {},
}


def _identity(rm):
    return (rm.is_worker(), rm.is_server(), rm.is_first_worker(),
            rm.worker_index(), rm.server_index(), rm.worker_num(),
            rm.server_num(), rm.get_trainer_endpoints(),
            rm.get_pserver_endpoints())


@pytest.mark.parametrize("env", sorted(ENVS))
def test_role_makers_read_the_environment_as_the_reference(monkeypatch,
                                                           env):
    for k in ("TRAINING_ROLE", "PADDLE_TRAINER_ID", "PADDLE_PORT", "POD_IP",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_PSERVERS_IP_PORT_LIST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    got = trm.PaddleCloudRoleMaker().generate_role()
    want = jrm.PaddleCloudRoleMaker().generate_role()
    assert _identity(got) == _identity(want)
    u = dict(current_id=1, role=trm.Role.SERVER, worker_num=3,
             server_endpoints=["a:1", "b:2"])
    assert _identity(trm.UserDefinedRoleMaker(**u)) == _identity(
        jrm.UserDefinedRoleMaker(**u))


def test_strategy_and_incubate_aliases():
    from paddle_tpu.distributed import DistributedStrategy as JS
    from paddle_tpu_torch.distributed import DistributedStrategy as TS
    from paddle_tpu_torch.incubate.fleet.base import role_maker
    from paddle_tpu_torch.incubate.fleet.collective import (
        CollectiveOptimizer, fleet)
    from paddle_tpu_torch.incubate.fleet.parameter_server import (
        fleet as ps_fleet)
    assert sorted(vars(TS())) == sorted(vars(JS()))
    s, j = TS(), JS()
    for obj in (s, j):
        obj.use_amp, obj.gradient_merge_steps = True, 4
    assert repr(s) == repr(j)
    assert fleet is ps_fleet is tfleet_mod.fleet
    assert CollectiveOptimizer is tfleet_mod.CollectiveOptimizer
    assert role_maker.PaddleCloudRoleMaker is trm.PaddleCloudRoleMaker


# ------------------------------------------------------------- launcher
def test_cluster_env_is_the_references_with_the_store_address():
    argv = ["--cluster_node_ips=10.0.0.1,10.0.0.2", "--node_ip=10.0.0.2",
            "--started_port=7100", "--nproc_per_node=3", "train.py"]
    got = tlaunch.get_cluster_env(tlaunch._parse_args(argv))
    want = jlaunch.get_cluster_env(jlaunch._parse_args(argv))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        w = dict(w)
        assert w.pop("JAX_COORDINATOR_ADDRESS") == "10.0.0.1:7099"
        assert w.pop("FLAGS_selected_tpus") == str(i)
        assert g.pop("MASTER_ADDR") == "10.0.0.1"
        assert g.pop("MASTER_PORT") == "7099"
        assert g.pop("FLAGS_selected_gpus") == str(i)
        assert g == w
    got = tlaunch.get_cluster_env(tlaunch._parse_args(
        ["--master_port=5555", "train.py"]))
    assert got[0]["MASTER_PORT"] == "5555"


def _launch(tmp_path, script, *extra, nproc=2, env=None, timeout=240):
    started, master = _free_ports(2)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={nproc}", f"--started_port={started}",
         f"--master_port={master}", f"--log_dir={tmp_path}/logs",
         *extra, str(script)], cwd=REPO, capture_output=True, text=True,
        timeout=timeout, env=dict(os.environ, PYTHONPATH=str(REPO),
                                  **(env or {})))


def test_launch_spawns_with_the_contract_and_fails_fast(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent("""
        import json, os, sys, time
        keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "MASTER_PORT",
                "PADDLE_CURRENT_ENDPOINT", "FLAGS_selected_gpus")
        print("ENV " + json.dumps({k: os.environ[k] for k in keys}),
              flush=True)
        if os.environ["PADDLE_TRAINER_ID"] == "1":
            sys.exit(3)
        time.sleep(60)
    """))
    t = __import__("time").monotonic()
    r = _launch(tmp_path, script)
    assert r.returncode == 3, r.stderr
    assert __import__("time").monotonic() - t < 30     # rank 0 was killed
    assert "worker 1 exited with code 3" in r.stderr
    envs = {}
    for rank in range(2):
        text = (tmp_path / "logs" / f"workerlog.{rank}").read_text()
        envs[rank] = json.loads(text.split("ENV ", 1)[1].splitlines()[0])
    assert envs[0]["PADDLE_TRAINERS_NUM"] == envs[1]["PADDLE_TRAINERS_NUM"] \
        == "2"
    assert [envs[r]["FLAGS_selected_gpus"] for r in (0, 1)] == ["0", "1"]
    assert envs[0]["MASTER_PORT"] == envs[1]["MASTER_PORT"]


def test_elastic_launch_restarts_a_crashed_worker_that_resumes(tmp_path):
    import test_torch_reliability as R
    _, (_, want, _) = R._ttrain(str(tmp_path / "plain"), 12)
    script = tmp_path / "worker.py"
    script.write_text(R._WORKER)
    out = str(tmp_path / "final.npz")
    report = tmp_path / "report.json"
    started, master = _free_ports(2)
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--elastic", "--max_restarts=2", f"--started_port={started}",
         f"--master_port={master}", f"--report={report}",
         f"--log_dir={tmp_path}/logs", str(script), str(tmp_path / "ckpt"),
         out, str(REPO)], cwd=REPO, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, PYTHONPATH=str(REPO),
                              PT_FLAGS_fault_plan="train.step:8:crash"))
    rep = json.loads(report.read_text())
    assert r.returncode == 0, (r.stderr[-2000:], rep)
    w = rep["workers"]["0"]
    assert w["exit_codes"] == [17, 0] and w["restarts"] == 1
    log = (tmp_path / "logs" / "workerlog.0").read_text()
    lines = [json.loads(ln[len("WORKER "):]) for ln in log.splitlines()
             if ln.startswith("WORKER ")]
    assert lines == [{"resumed_from": 8, "jax": False}]
    with np.load(out) as z:
        for k in want:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"),
    ("cuda", 1, 8, "nccl"), ("cuda", 8, 4, "gloo")])
def test_backend_follows_the_layout(case):
    import torch
    dev, ranks, cards, want = case
    assert tfleet_mod.choose_backend(torch.device(dev), ranks, cards) == want


def test_fleet_init_of_one_worker_starts_no_group():
    import torch.distributed as dist
    f = tfleet_mod.Fleet().init(trm.UserDefinedRoleMaker(worker_num=1))
    assert f.worker_num() == 1 and not dist.is_initialized()
    f.barrier_worker()
    ps_role = trm.UserDefinedRoleMaker(worker_num=2, server_endpoints=["x:1"])
    ps_role._is_collective = False
    g = tfleet_mod.Fleet().init(ps_role)     # parameter-server mode
    assert g.backend is None and not dist.is_initialized()


def test_collective_init_without_the_store_address_raises(monkeypatch):
    """Only the launcher decides the store's address: a collective worker
    started without MASTER_ADDR / MASTER_PORT raises, naming it."""
    import torch.distributed as dist
    from paddle_tpu_torch.core.enforce import EnforceError
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")
    role = trm.UserDefinedRoleMaker(
        current_id=0, worker_num=2,
        worker_endpoints=["127.0.0.1:6170", "127.0.0.1:6171"])
    with pytest.raises(EnforceError, match="distributed.launch"):
        tfleet_mod.Fleet().init(role, device="cpu")
    assert not dist.is_initialized()


# ------------------------------------------------ CollectiveOptimizer
def _fc(S, ir, opt):
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = 2
    with ir.program_guard(main, startup):
        x = S.data("x", [-1, 8], append_batch_size=False)
        y = S.data("y", [-1, 1], append_batch_size=False)
        h = S.fc(x, 16, act="relu")
        loss = S.mean(S.square_error_cost(S.fc(h, 1), y))
        opt().minimize(loss, startup_program=startup)
    return main, startup, loss


def _strategy(mod, **kw):
    s = mod.DistributedStrategy()
    for k, v in kw.items():
        setattr(s, k, v)
    return s


CASES = {
    "merge": dict(gradient_merge_steps=2),
    "recompute": dict(recompute=True),
    "merge_amp_fp16": dict(gradient_merge_steps=2, use_amp=True,
                           amp_dtype="float16", amp_loss_scaling=2.0 ** 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_optimizer_matches_jax(case):
    import paddle_tpu.distributed as jd
    import paddle_tpu_torch.distributed as td
    kw = CASES[case]
    jmain, jstart, jloss = _fc(pt.static, jir, lambda: jd.CollectiveOptimizer(
        pt.optimizer.Momentum(0.05, 0.9), _strategy(jd, **kw)))
    tmain, _, _ = _fc(tstatic, tir, lambda: td.CollectiveOptimizer(
        topt.Momentum(0.05, 0.9), _strategy(td, **kw)))
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    scope = pt.Scope()
    exe = pt.Executor()
    with pt.scope_guard(scope):
        exe.run(jstart)
        state = {v.name: scope.find_np(v.name) for v in jmain.list_vars()
                 if v.persistable and scope.has(v.name)}
        tscope = scope_from_jax(state, Scope(), "cpu", program=tmain)
        texe = TExecutor("cpu")
        tol = 8 * 2.0 ** -10 if "amp" in case else 1e-5
        rng = np.random.RandomState(0)
        w = rng.randn(8, 1).astype(np.float32)
        params = [v.name for v in tmain.all_parameters()]
        for step in range(4):
            xs = rng.randn(16, 8).astype(np.float32)
            feed = {"x": xs, "y": xs @ w}
            jl = float(np.asarray(exe.run(jmain, feed=feed,
                                          fetch_list=[jloss])[0]).ravel()[0])
            tl = float(np.asarray(texe.run(tmain, feed=feed,
                                           fetch_list=[jloss.name],
                                           scope=tscope)[0]).ravel()[0])
            assert abs(tl - jl) <= tol * abs(jl), (step, tl, jl)
            for p in params:
                want = scope.find_np(p)
                err = np.abs(tscope.find_np(p) - want).max()
                assert err <= tol * np.abs(want).max(), (step, p, err)
        # off-boundary steps leave the parameters where the merge put them
        assert np.isfinite(tscope.find_np(params[0])).all()


def test_pipeline_optimizer_merges_microbatches_as_the_reference():
    from paddle_tpu.parallel.pipeline import PipelineOptimizer as JP
    from paddle_tpu_torch.parallel.pipeline import PipelineOptimizer as TP
    jmain, jstart, jloss = _fc(pt.static, jir, lambda: JP(
        pt.optimizer.SGD(0.1), num_microbatches=2))
    tmain, _, _ = _fc(tstatic, tir, lambda: TP(topt.SGD(0.1),
                                                num_microbatches=2))
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert any(n.endswith("@GRAD_MERGE") for n in
               (v.name for v in tmain.list_vars() if v.persistable))
    scope, exe = pt.Scope(), pt.Executor()
    with pt.scope_guard(scope):
        exe.run(jstart)
        state = {v.name: scope.find_np(v.name) for v in jmain.list_vars()
                 if v.persistable and scope.has(v.name)}
        tscope = scope_from_jax(state, Scope(), "cpu", program=tmain)
        rng = np.random.RandomState(1)
        for step in range(4):
            xs = rng.randn(8, 8).astype(np.float32)
            feed = {"x": xs, "y": xs[:, :1]}
            jl = exe.run(jmain, feed=feed, fetch_list=[jloss])[0]
            tl = TExecutor("cpu").run(tmain, feed=feed,
                                      fetch_list=[jloss.name],
                                      scope=tscope)[0]
            np.testing.assert_allclose(tl, jl, rtol=1e-5)
        for v in tmain.all_parameters():
            np.testing.assert_allclose(tscope.find_np(v.name),
                                       scope.find_np(v.name), rtol=1e-5,
                                       atol=1e-7)


# ------------------------------------------- launched fleets (CPU, gloo)
def _tiny_chip_smoke(monkeypatch):
    import chip_smoke as cs
    monkeypatch.setattr(cs, "PS_BATCH", 64)
    monkeypatch.setattr(cs, "PS_RECORDS", 2048)
    monkeypatch.setattr(cs, "PS_FILES", 4)
    monkeypatch.setattr(cs, "PS_FLEET_STEPS", 40)
    monkeypatch.setattr(cs, "PS_COLLECTIVE_STEPS", 3)
    from paddle_tpu_torch.models.deepfm import DeepFMConfig
    return cs, DeepFMConfig.tiny()


def test_sync_ps_leg_passes_and_its_bf16_control_is_refused(monkeypatch,
                                                            tmp_path):
    """chip_smoke phase 39(a) on the CPU (both sides on the CPU): the
    leg's gates pass, the bf16-forward control fails both of them, and
    each step's pulls and pushes are timed."""
    import torch
    cs, cfg = _tiny_chip_smoke(monkeypatch)
    files = cs.ps_write_files(str(tmp_path), 0, cfg)
    out = cs.ps_sync_leg(torch, cfg, files, 0, "[cpu]", dev="cpu")
    assert out["loss_err"] == 0 and out["rows_err"] == 0
    assert out["control_loss_err"] > cs.PS_TOL["loss"]
    assert out["control_rows_err"] > cs.PS_TOL["rows"]
    parts = out["parts_ms"]
    assert parts["pull_ms"] > 0 and parts["push_ms"] > 0
    assert parts["device_ms"] is None


def test_collective_fleet_over_launched_gloo_ranks(monkeypatch):
    """chip_smoke phase 39(c) on the CPU: fleet.init starts the gloo
    group from the launcher's environment, make_mesh and CompiledProgram
    run over it, and each rank's losses equal one process's."""
    import torch
    cs, cfg = _tiny_chip_smoke(monkeypatch)
    out, during = cs.ps_collective_leg(torch, cfg, 0, "[cpu]", dev="cpu",
                                       during=lambda: "ran")
    assert out["backend"] == "gloo" and out["loss_err"] <= 1e-5
    assert during == "ran"


def test_ps_fleet_with_launched_trainers(monkeypatch, tmp_path):
    """chip_smoke phase 39(b) on the CPU: a pserver process and two
    launched trainers (async sparse pushes, geo dense deltas), every
    process exits 0, no child loads jax or paddle_tpu."""
    import torch
    cs, cfg = _tiny_chip_smoke(monkeypatch)
    files = cs.ps_write_files(str(tmp_path), 0, cfg)
    out = cs.ps_fleet_leg(torch, cfg, files, 0, "[cpu]", dev="cpu")
    assert all(n > 0 for n in out["server_rows"])
    assert all(t["undelivered"] == 0 for t in out["trainers"])


# ----------------------------------------------------------- transpiler
def _program(S, ir):
    ir.reset_unique_names()
    main = ir.Program()
    with ir.program_guard(main, ir.Program()):
        ids = S.data("ids", [-1, 1], "int64", append_batch_size=False)
        e = S.embedding(ids, [100, 8], is_distributed=True)
        S.fc(e, 4)
    return main


def test_transpiler_and_lookup_table_finders_match_the_reference():
    import paddle_tpu.distribute_lookup_table as jdl
    import paddle_tpu.transpiler as jt
    import paddle_tpu_torch.distribute_lookup_table as tdl
    import paddle_tpu_torch.transpiler as tt
    jmain, tmain = _program(pt.static, jir), _program(tstatic, tir)
    eps = "127.0.0.1:6174,127.0.0.1:6175"
    out = []
    for mod, main in ((jt, jmain), (tt, tmain)):
        t = mod.DistributeTranspiler()
        t.transpile(1, program=main, pservers=eps, trainers=2)
        prog = t.get_trainer_program()
        ps_prog, start = t.get_pserver_programs("127.0.0.1:6175")
        out.append((t.param_to_endpoint, prog.meta["ps_endpoints"],
                    ps_prog.meta, start.meta))
        with pytest.raises(Exception):
            t.get_pserver_program("1.2.3.4:1")
        d = mod.RoundRobin(["a", "b"])
        out[-1] += (d.dispatch(["x", "y", "z"]),)
    assert out[0] == out[1]
    name = tdl.find_distributed_lookup_table(tmain)
    assert name == jdl.find_distributed_lookup_table(jmain)
    assert tdl.find_distributed_lookup_table_inputs(tmain, name) == \
        jdl.find_distributed_lookup_table_inputs(jmain, name) == ["ids"]
    assert tdl.find_distributed_lookup_table_outputs(tmain, name) == \
        jdl.find_distributed_lookup_table_outputs(jmain, name)
    with pytest.warns(UserWarning):
        assert tt.memory_optimize(tmain) is tmain
