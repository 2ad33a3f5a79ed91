"""Checkpoints of the port (paddle_tpu_torch.io.checkpoint) against the
JAX package's (paddle_tpu.io.checkpoint), on the CPU.

Each case of the JAX package's TestCheckpoint
(tests/test_inference_checkpoint.py) runs on the port: retention and
resume, async saves, the numpy path, program-level resume with equal
losses, bfloat16 and "/" keys, a load scoped to a program. Besides: the
DCP path's round trip in one process without a process group, the async
save's host snapshot, a background failure surfacing on the next call,
and numpy checkpoints crossing both ways (bfloat16 included: the JAX
package restores an ml_dtypes bfloat16 array, the port a torch.bfloat16
CPU tensor). Losses after a resume are bit-equal to the uninterrupted
run's (the same ops on the same CPU).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


@pytest.mark.parametrize("use_dcp", [None, False], ids=["dcp", "numpy"])
def test_manager_roundtrip_retention_resume(tmp_path, use_dcp):
    mgr = tio.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2,
                                async_save=False, use_dcp=use_dcp)
    for step in (1, 2, 3):
        tree = {"w": np.full((4,), float(step), np.float32),
                "opt": {"m": np.ones((2, 2), np.float32) * step}}
        mgr.save(step, tree, metrics={"loss": 1.0 / step})
    assert mgr.all_steps() == [2, 3]  # retention dropped step 1
    restored, step = mgr.restore()
    assert step == 3
    np.testing.assert_array_equal(np.asarray(restored["w"]),
                                  np.full((4,), 3.0, np.float32))
    np.testing.assert_array_equal(np.asarray(restored["opt"]["m"]),
                                  np.ones((2, 2), np.float32) * 3)
    assert mgr.metrics(3) == {"loss": pytest.approx(1 / 3)}
    assert not any(n.endswith(".tmp") for n in os.listdir(mgr.directory))


def test_async_save_snapshots_the_state_before_it_returns(tmp_path):
    """The JAX case (save 7, wait, restore) and the port's reason for the
    snapshot: the caller overwrites its tensor in place right after
    `save` returns (as a captured graph's next replay does), and the
    checkpoint holds the value at the save."""
    mgr = tio.CheckpointManager(str(tmp_path / "ck"), async_save=True)
    a = torch.arange(8, dtype=torch.float32)
    mgr.save(7, {"a": a, "b": np.arange(3)})
    a.fill_(-1.0)
    mgr.wait()
    restored, step = mgr.restore()
    assert step == 7
    np.testing.assert_array_equal(np.asarray(restored["a"]),
                                  np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(restored["b"]), np.arange(3))


def test_background_failure_surfaces_on_the_next_call(tmp_path,
                                                      monkeypatch):
    mgr = tio.CheckpointManager(str(tmp_path / "ck"), async_save=True,
                                use_dcp=False)

    def broken(path, tree):
        raise OSError("disk full")

    monkeypatch.setattr(mgr._ckptr, "save", broken)
    mgr.save(1, {"x": np.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                      # raised once
    assert mgr.all_steps() == []


def test_numpy_fallback(tmp_path):
    mgr = tio.CheckpointManager(str(tmp_path / "ck"), async_save=False,
                                use_dcp=False)
    mgr.save(1, {"x": np.ones(3, np.float32)})
    restored, _ = mgr.restore()
    np.testing.assert_array_equal(restored["x"], np.ones(3, np.float32))
    assert sorted(os.listdir(tmp_path / "ck" / "ckpt-1")) == [
        "dtypes.json", "state.npz"]


def _port_train_program():
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tstatic.data("x", [-1, 4], "float32")
        y = tstatic.data("y", [-1, 1], "float32")
        pred = tstatic.fc(x, 1)
        loss = tstatic.mean(tstatic.square(pred - y))
        toptim.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("async_save", [False, True],
                         ids=["sync", "async"])
def test_program_level_save_load_resume(tmp_path, async_save):
    """Train 5 steps, save (params and momentum buffers), train 3 more
    (state A); resume from step 5 and repeat the 3 steps: the losses
    equal A's, bit for bit. The async save runs while the 3 steps write
    the state."""
    main, startup, loss = _port_train_program()
    exe = TExecutor("cpu")
    exe.run(startup)
    rng = np.random.RandomState(0)
    xv = rng.randn(32, 4).astype(np.float32)
    yv = rng.randn(32, 1).astype(np.float32)
    feed = {"x": xv, "y": yv}
    for _ in range(5):
        exe.run(main, feed=feed, fetch_list=[loss])
    ck = str(tmp_path / "train_ck")
    saved = {n: global_scope().find_np(n) for n in ("fc_0.w_0", "fc_0.b_0")}
    tio.save_checkpoint(exe, ck, main, step=5, async_save=async_save)
    la = [exe.run(main, feed=feed, fetch_list=[loss])[0] for _ in range(3)]
    step = tio.load_checkpoint(exe, ck, main)
    assert step == 5
    for n, v in saved.items():
        np.testing.assert_array_equal(global_scope().find_np(n), v)
    lb = [exe.run(main, feed=feed, fetch_list=[loss])[0] for _ in range(3)]
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_numpy_fallback_bf16_and_slash_keys(tmp_path):
    mgr = tio.CheckpointManager(str(tmp_path / "ck"), async_save=False,
                                use_dcp=False)
    tree = {"layer/kernel": torch.ones((3,), dtype=torch.bfloat16),
            "opt": {"m/v": np.arange(2, dtype=np.float32)}}
    mgr.save(1, tree)
    restored, _ = mgr.restore()
    assert set(restored) == {"layer/kernel", "opt"}
    k = restored["layer/kernel"]
    assert isinstance(k, torch.Tensor) and k.dtype == torch.bfloat16
    np.testing.assert_array_equal(k.float().numpy(), np.ones(3))
    np.testing.assert_array_equal(restored["opt"]["m/v"], np.arange(2))


def test_load_checkpoint_scoped_to_program(tmp_path):
    scope = global_scope()
    scope.set("other_model_w", np.full(3, 7.0, np.float32))
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tstatic.data("x", [-1, 2], "float32")
        tstatic.fc(x, 1)
    exe = TExecutor("cpu")
    exe.run(startup)
    ck = str(tmp_path / "ck2")
    # the checkpoint holds a var colliding with the other model's
    mgr = tio.CheckpointManager(ck, async_save=False)
    names = {v.name for b in main.blocks for v in b.vars.values()
             if v.persistable}
    tree = {n: scope.find_np(n) for n in names}
    tree["other_model_w"] = np.zeros(3, np.float32)
    mgr.save(1, tree)
    tio.load_checkpoint(exe, ck, main)
    # the unrelated var was NOT clobbered
    np.testing.assert_array_equal(scope.find_np("other_model_w"),
                                  np.full(3, 7.0, np.float32))


def test_dcp_round_trip_in_one_process(tmp_path):
    """The sharded path with no process group: one process writes every
    entry; a restore reads them back with or without a template, bfloat16
    and nested "/" keys kept."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    ck = tio.Checkpointer()
    assert ck.use_dcp
    tree = {"a/b": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "bf": torch.linspace(-1, 1, 5).to(torch.bfloat16),
            "nested": {"i": np.arange(4, dtype=np.int64)}}
    path = str(tmp_path / "dcp")
    ck.save(path, tree)
    assert not os.path.exists(os.path.join(path, "state.npz"))
    for template in (None, {"a/b": torch.zeros(2, 3),
                            "bf": torch.zeros(5, dtype=torch.bfloat16),
                            "nested": {"i": torch.zeros(4,
                                                        dtype=torch.int64)}}):
        got = ck.restore(path, template)
        assert torch.equal(got["a/b"], tree["a/b"])
        assert got["bf"].dtype == torch.bfloat16
        assert torch.equal(got["bf"], tree["bf"])
        np.testing.assert_array_equal(got["nested"]["i"].numpy(),
                                      np.arange(4))


@pytest.mark.parametrize("use_dcp", [True, False])
def test_zero_dim_leaves_keep_their_shape(tmp_path, use_dcp):
    """A 0-dim leaf (a numpy step counter, a Python float, a 0-dim
    tensor) comes back 0-dim from either path, with its value."""
    ck = tio.Checkpointer(use_dcp=use_dcp)
    tree = {"step": np.asarray(7, np.int64), "lr": np.float32(0.125),
            "scale": torch.tensor(2.5), "w": np.ones((2, 3), np.float32)}
    path = str(tmp_path / "ck")
    ck.save(path, tree)
    templates = [None]
    if use_dcp:
        templates.append({"step": np.zeros((), np.int64),
                          "lr": np.zeros((), np.float32),
                          "scale": torch.zeros(()),
                          "w": np.zeros((2, 3), np.float32)})
    for template in templates:
        got = ck.restore(path, template)
        for k in ("step", "lr", "scale"):
            assert tuple(got[k].shape) == (), (k, got[k])
        assert int(got["step"]) == 7 and float(got["lr"]) == 0.125
        assert float(got["scale"]) == 2.5
        assert tuple(got["w"].shape) == (2, 3)


def test_numpy_checkpoints_cross_both_packages(tmp_path):
    """A numpy checkpoint the JAX package writes loads in the port, and
    one the port writes loads in the JAX package, bfloat16 included; the
    two write the same keys and dtype records."""
    import jax.numpy as jnp
    import ml_dtypes
    j_tree = {"layer/kernel": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16),
              "opt": {"m": np.arange(4, dtype=np.float32),
                      "step": np.asarray(9, np.int64)}}
    jmgr = pt.io.CheckpointManager(str(tmp_path / "jax"), async_save=False,
                                   use_orbax=False)
    jmgr.save(3, j_tree)
    got, step = tio.CheckpointManager(str(tmp_path / "jax"),
                                      use_dcp=False).restore()
    assert step == 3
    assert got["layer/kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["layer/kernel"].float().numpy(),
                                  [1.5, -2.25, 3.0])
    np.testing.assert_array_equal(got["opt"]["m"], np.arange(4))
    assert got["opt"]["step"].dtype == np.int64 and got["opt"]["step"] == 9

    p_tree = {"layer/kernel": torch.tensor([1.5, -2.25, 3.0],
                                           dtype=torch.bfloat16),
              "opt": {"m": torch.arange(4, dtype=torch.float32),
                      "step": np.asarray(9, np.int64)}}
    tio.CheckpointManager(str(tmp_path / "port"), async_save=False,
                          use_dcp=False).save(3, p_tree)
    back, step = pt.io.CheckpointManager(str(tmp_path / "port"),
                                         use_orbax=False).restore()
    assert step == 3
    assert back["layer/kernel"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["layer/kernel"], np.float32), [1.5, -2.25, 3.0])
    np.testing.assert_array_equal(back["opt"]["m"], np.arange(4))
    for d in ("jax", "port"):
        with open(tmp_path / d / "ckpt-3" / "dtypes.json") as f:
            assert f.read() == ('{"layer/kernel": "bfloat16", '
                                '"opt\\u001fm": "float32", '
                                '"opt\\u001fstep": "int64"}')
