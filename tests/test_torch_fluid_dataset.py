"""Dataset training and the parameter-server DeepFM loop of the port
against the JAX package, on the CPU.

* io.fluid_dataset: InMemoryDataset (load, local and global shuffle,
  release) and QueueDataset give the JAX package's feed dicts (dense
  float32, sparse ids padded to a length bucket plus `<name>.lens`) on
  the same MultiSlot files and seeds; `batches(device)` gives the same
  as tensors; DataFeedDesc and the trainer descs match.
* Executor.train_from_dataset / infer_from_dataset and
  AsyncExecutor.run of chip_smoke phase 39's CTR program (tiny widths)
  against the JAX package's on the same files, from the JAX package's
  startup state: per-batch losses and the final parameters.
* chip_smoke phase 39(a)'s PS trainer (the port's DeepFM.forward_rows on
  pulled rows, synchronous pushes to a port Server) against the same
  loop in the JAX package (the JAX DeepFM's dense_w and MLP under
  jax.value_and_grad, a JAX-package Server), each against a fresh
  server: per-step losses and the final rows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
import chip_smoke as cs
from paddle_tpu.core import ir as jir
from paddle_tpu.io import fluid_dataset as jfd
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr

from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.io import fluid_dataset as tfd
from paddle_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
from paddle_tpu_torch.weights import layer_state_from_jax, scope_from_jax

CFG = DeepFMConfig.tiny()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return cs.ps_write_files(str(tmp_path_factory.mktemp("ctr")), 0, CFG,
                             records=600, files=3)


@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    rng = np.random.RandomState(9)
    p = tmp_path_factory.mktemp("ragged") / "part-0"
    with open(p, "w") as f:
        for _ in range(50):
            n = rng.randint(1, 12)
            ids = " ".join(str(i) for i in rng.randint(0, 99, n))
            f.write(f"2 {rng.rand():.4f} {rng.rand():.4f} {n} {ids}\n")
    return [str(p)]


def _ds(mod, files, kind="InMemoryDataset", slots=None, batch=64):
    ds = mod.DatasetFactory().create_dataset(kind)
    ds.set_slots(slots or cs.ps_slots(CFG))
    ds.set_batch_size(batch)
    ds.set_thread(1)
    ds.set_filelist(files)
    return ds


class _Fleet:
    def __init__(self, i, n):
        self.i, self.n = i, n

    def worker_index(self):
        return self.i

    def worker_num(self):
        return self.n


@pytest.mark.parametrize("case", ["ragged", "local", "global0", "global1",
                                  "queue"])
def test_feeds_equal_the_references(files, ragged, case):
    slots = [("d", "dense", 2), ("ids", "sparse", 0)] \
        if case == "ragged" else None
    src = ragged if case == "ragged" else files
    kind = "QueueDataset" if case == "queue" else "InMemoryDataset"
    feeds = []
    for mod in (jfd, tfd):
        ds = _ds(mod, src, kind, slots, batch=16 if slots else 64)
        if kind == "InMemoryDataset":
            ds.load_into_memory()
            if case == "local":
                ds.local_shuffle(5)
            elif case.startswith("global"):
                ds.global_shuffle(_Fleet(int(case[-1]), 2), seed=3)
        feeds.append(list(ds))
        if kind == "InMemoryDataset":
            ds.release_memory()
            assert ds.get_memory_data_size() == 0
    assert len(feeds[1]) == len(feeds[0]) > 0
    for t, j in zip(*feeds):
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == np.asarray(j[k]).dtype, k
            np.testing.assert_array_equal(t[k], np.asarray(j[k]), err_msg=k)
    if case == "ragged":
        assert {f["ids"].shape[1] for f in feeds[1]} <= {8, 16}


def test_batches_on_a_device_equal_the_numpy_feeds(files):
    ds = _ds(tfd, files)
    ds.load_into_memory()
    for f, t in zip(ds, ds.batches(torch.device("cpu"))):
        assert sorted(f) == sorted(t)
        for k in f:
            assert isinstance(t[k], torch.Tensor)
            np.testing.assert_array_equal(t[k].numpy(), f[k])
    with pytest.raises(RuntimeError, match="local_shuffle"):
        tfd.QueueDataset().local_shuffle()
    with pytest.raises(ValueError):
        tfd.DatasetFactory().create_dataset("NoSuchDataset")


def test_desc_objects_match_the_references():
    from paddle_tpu.data_feed_desc import DataFeedDesc as JD
    from paddle_tpu import trainer_desc as jtd
    from paddle_tpu_torch.data_feed_desc import DataFeedDesc as TD
    from paddle_tpu_torch import trainer_desc as ttd
    text = str(cs.ps_feed_desc(CFG, 32).proto_desc)
    t = cs.ps_feed_desc(CFG, 32)
    src = "\n".join(['name: "MultiSlotDataFeed"', "batch_size: 32",
                     "multi_slot_desc {", "  slots {", '    name: "a"',
                     '    type: "float"', "    is_dense: true",
                     "    shape: 3", "  }", "  slots {", '    name: "b"',
                     '    type: "uint64"', "    is_dense: false", "  }",
                     "}"])
    j, t = JD(src), TD(src)
    for d in (j, t):
        d.set_batch_size(64)
        d.set_use_slots(["a"])
        d.set_dense_slots(["b"])
    assert t.desc() == j.desc() and str(t) == str(j)
    assert text.count("'name'") == len(cs.ps_slots(CFG)) + 1
    for name in ("MultiTrainer", "DistMultiTrainer", "PipelineTrainer"):
        a, b = getattr(jtd, name)(), getattr(ttd, name)()
        for obj in (a, b):
            obj._set_thread(4)
            obj._set_fetch_var_and_info(["loss"], ["l"], 10)
        assert a._desc() == b._desc()


def _programs():
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    jmain, jstart, jloss = cs.ps_ctr_program(pt.static, jir, pt.optimizer,
                                             JParamAttr, CFG)
    tmain, _, tloss = cs.ps_ctr_program(static, ir, optimizer, ParamAttr,
                                        CFG)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    return jmain, jstart, jloss, tmain, tloss


def _persistables(main, scope):
    return {v.name: scope.find_np(v.name) for v in main.list_vars()
            if v.persistable and scope.has(v.name)}


@pytest.mark.parametrize("how", ["train_from_dataset", "async_executor"])
def test_dataset_training_matches_jax(files, how):
    from paddle_tpu.async_executor import AsyncExecutor as JAE
    from paddle_tpu_torch.async_executor import AsyncExecutor as TAE
    jmain, jstart, jloss, tmain, tloss = _programs()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor()
        exe.run(jstart)
        state = _persistables(jmain, scope)
        if how == "train_from_dataset":
            jds = _ds(jfd, files)
            jds.load_into_memory()
            want = exe.train_from_dataset(jmain, jds, fetch_list=[jloss])
        else:
            want = JAE().run(jmain, cs.ps_feed_desc(CFG, 64), files, 1,
                             [jloss])
        jstate = _persistables(jmain, scope)
    tscope = scope_from_jax(state, Scope(), "cpu", program=tmain)
    if how == "train_from_dataset":
        tds = _ds(tfd, files)
        tds.load_into_memory()
        texe = TExecutor("cpu")
        got = texe.train_from_dataset(tmain, tds, fetch_list=[tloss],
                                      scope=tscope)
        test = tmain.clone(for_test=True)
        infer = texe.infer_from_dataset(
            test, tds, fetch_list=[tloss],
            scope=scope_from_jax(state, Scope(), "cpu", program=tmain))
        np.testing.assert_allclose(float(np.asarray(infer[0][0])),
                                   float(np.asarray(want[0][0])), rtol=1e-5)
    else:
        with scope_guard(tscope):
            got = TAE("cpu").run(tmain, cs.ps_feed_desc(CFG, 64), files, 1,
                                 [tloss])
    assert len(got) == len(want) == 10
    np.testing.assert_allclose([float(np.asarray(g[0])) for g in got],
                               [float(np.asarray(w[0])) for w in want],
                               rtol=1e-5)
    for v in tmain.all_parameters():
        np.testing.assert_allclose(tscope.find_np(v.name), jstate[v.name],
                                   rtol=1e-4, atol=1e-6, err_msg=v.name)


def test_async_executor_server_hooks(files):
    from paddle_tpu_torch.async_executor import AsyncExecutor
    ae = AsyncExecutor("cpu")
    port = ae.init_server([{"table_id": 1, "kind": "sparse", "dim": 4}])
    cli = ae.init_worker(None, endpoints=[f"127.0.0.1:{port}"])
    assert cli.pull_sparse(1, np.array([3], np.uint64), 4).shape == (1, 4)
    ae.stop()
    assert ae._server is None and ae._client is None


def _jax_ps_loop(batches, params):
    """phase 39(a)'s loop in the JAX package: rows pulled from a JAX
    Server, DeepFM's logit from them with the JAX DeepFM's dense_w and
    MLP, jax.value_and_grad, row gradients pushed, SGD on the rest."""
    from paddle_tpu import ps as jps
    from paddle_tpu.models.deepfm import DeepFM as JDeepFM
    from paddle_tpu.models.deepfm import DeepFMConfig as JCfg
    jm = JDeepFM(JCfg.tiny())
    dense_names = [k for k in params if not k.startswith(("w1.", "emb."))]

    def loss_fn(p, w1_rows, emb_rows, dense, y):
        jm.load_trainable(p)
        first = jnp.sum(w1_rows[..., 0], axis=1, keepdims=True) \
            + jm.dense_w(dense)
        v = emb_rows
        s = jnp.sum(v, axis=1)
        fm = 0.5 * jnp.sum(s * s - jnp.sum(v * v, axis=1), axis=1,
                           keepdims=True)
        deep = jm.mlp(jnp.concatenate([v.reshape(v.shape[0], -1), dense],
                                      axis=1))
        logit = (first + fm + deep)[:, 0]
        y = y.astype(jnp.float32)
        return jnp.mean(jnp.maximum(logit, 0) - logit * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logit))))

    vg = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2)))
    p = {k: jnp.asarray(params[k]) for k in dense_names}
    srv = jps.Server(tables=[
        jps.TableConfig(1, "sparse", dim=1, optimizer="sgd",
                        lr=cs.PS_SPARSE_LR),
        jps.TableConfig(2, "sparse", dim=CFG.embed_dim, optimizer="sgd",
                        lr=cs.PS_SPARSE_LR)]).start()
    try:
        cli = jps.Client([f"127.0.0.1:{srv.port}"]).connect()
        offsets = (np.arange(CFG.num_slots) * CFG.vocab_per_slot)[None, :]
        losses = []
        for dense, ids, labels in batches:
            b = ids.shape[0]
            flat = (ids + offsets).astype(np.uint64).ravel()
            w1 = cli.pull_sparse(1, flat, 1).reshape(b, -1, 1)
            emb = cli.pull_sparse(2, flat, CFG.embed_dim).reshape(
                b, -1, CFG.embed_dim)
            loss, (gp, g1, g2) = vg(p, w1, emb, dense, labels)
            losses.append(float(loss))
            cli.push_sparse(1, flat, np.asarray(g1).reshape(-1, 1))
            cli.push_sparse(2, flat,
                            np.asarray(g2).reshape(-1, CFG.embed_dim))
            p = {k: p[k] - cs.PS_DENSE_LR * gp[k] for k in p}
        ids_all = np.unique(np.concatenate(
            [(i + offsets).astype(np.uint64).ravel() for _, i, _ in batches]))
        rows = cli.pull_sparse(2, ids_all, CFG.embed_dim)
    finally:
        srv.stop()
    return losses, rows


def test_ps_deepfm_loop_matches_the_jax_package(files):
    from paddle_tpu.models.deepfm import DeepFM as JDeepFM
    from paddle_tpu.models.deepfm import DeepFMConfig as JCfg
    from paddle_tpu_torch import ps as tps
    ds = cs.ps_dataset(files, CFG, 64)
    batches = [cs.ps_arrays(f, CFG) for f in ds][:6]
    jm = JDeepFM(JCfg.tiny())
    params = {k: np.asarray(v) for k, v in jm.trainable_dict().items()}
    want_l, want_r = _jax_ps_loop(batches, params)
    model = DeepFM(CFG, device="cpu")
    layer_state_from_jax(params, {}, model)
    srv = tps.Server(tables=cs.ps_tables(CFG)).start()
    try:
        cli = tps.Client([f"127.0.0.1:{srv.port}"]).connect()
        tr = cs.PSTrainer(torch, model, cli)
        got_l = [tr.step(*b) for b in batches]
        ids = np.unique(np.concatenate([model.flat_ids(i).ravel()
                                        for _, i, _ in batches]))
        got_r = cli.pull_sparse(2, ids, CFG.embed_dim)
    finally:
        srv.stop()
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    np.testing.assert_allclose(got_r, want_r, rtol=1e-4, atol=1e-7)
    b = len(batches[0][0]) * CFG.num_slots
    assert tr.bytes["h2d"] == sum(
        b * 4 * (1 + CFG.embed_dim) + d.nbytes + y.nbytes
        for d, _, y in batches)
