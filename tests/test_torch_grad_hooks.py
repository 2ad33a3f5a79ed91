"""DGC and LocalSGD of the port against the JAX package, on the CPU.

* `dgc_sparsity`: the ramp-up schedule equals the JAX one step by step.
* `dgc_transform`: the sparse send and the error-feedback state (u, v)
  equal the JAX transform's over several steps from zero state.
* `dgc_allreduce` over 4 gloo ranks against the JAX one under shard_map
  on a 4-device mesh (each rank its own gradients), and
  `local_sgd_average` at a sync step and between them.
* The top-k threshold is `jnp.quantile`'s above 2**24 elements, where
  `torch.quantile` refuses its input.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.core.jax_compat import shard_map
from paddle_tpu.parallel import grad_hooks as jhooks
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu_torch.parallel import grad_hooks as thooks
from paddle_tpu_torch.parallel.ranks import RankPool

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_parallel_ranks.py")
WORLD = 4
KW = {"momentum": 0.9, "rampup_begin_step": 1, "rampup_step": 4,
      "sparsity": (0.5, 0.75, 0.9, 0.99)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", device="cpu",
                 store=str(tmp_path_factory.mktemp("ranks") / "store"),
                 timeout=90)
    try:
        yield p
    finally:
        p.close(kill=True)


def test_dgc_sparsity_schedule_matches_jax():
    for step in range(8):
        a = float(thooks.dgc_sparsity(step, 1, 4, KW["sparsity"]))
        b = float(jhooks.dgc_sparsity(step, 1, 4, KW["sparsity"]))
        assert a == b, step


def test_dgc_transform_error_feedback_matches_jax():
    r = np.random.RandomState(0)
    grads = {"w": r.randn(40, 30).astype(np.float32),
             "b": r.randn(30).astype(np.float32)}
    ts = thooks.dgc_init_state({k: torch.tensor(v) for k, v in
                                grads.items()})
    js = jhooks.dgc_init_state({k: jnp.asarray(v) for k, v in
                                grads.items()})
    for step in range(5):
        g = {k: v * (step + 1) for k, v in grads.items()}
        tsend, ts = thooks.dgc_transform(
            ts, {k: torch.tensor(v) for k, v in g.items()}, step, **KW)
        jsend, js = jhooks.dgc_transform(js, g, step, **KW)
        for k in grads:
            np.testing.assert_allclose(tsend[k].numpy(),
                                       np.asarray(jsend[k]), rtol=1e-6)
            for part in ("u", "v"):
                np.testing.assert_allclose(ts[part][k].numpy(),
                                           np.asarray(js[part][k]),
                                           rtol=1e-6, atol=1e-7)


def test_dgc_allreduce_and_local_sgd_match_jax(pool):
    r = np.random.RandomState(1)
    per_rank = {"w": r.randn(WORLD, 16, 8).astype(np.float32)}
    mesh = jmake_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])

    def dev(g):
        g = {"w": g[0]}
        state = jhooks.dgc_init_state(g)
        outs = []
        for s in range(3):
            red, state = jhooks.dgc_allreduce(state, g, s, **KW)
            outs.append(red["w"][None])
        return jnp.stack(outs, 1), state["u"]["w"][None], \
            state["v"]["w"][None]
    outs, u, v = jax.jit(shard_map(dev, mesh=mesh, in_specs=P("dp"),
                                   out_specs=P("dp")))(per_rank["w"])
    got = pool.run(RANKS, "dgc", per_rank, 3, KW)
    for rank, (steps, state) in enumerate(got):
        for s in range(3):
            np.testing.assert_allclose(steps[s]["w"], np.asarray(outs[rank, s]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state["u"]["w"], np.asarray(u[rank]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state["v"]["w"], np.asarray(v[rank]),
                                   rtol=1e-5, atol=1e-6)

    def avg(p, step):
        return jhooks.local_sgd_average({"w": p[0]}, step, 3)["w"][None]
    for step in (2, 3):
        want = jax.jit(shard_map(lambda p: avg(p, step), mesh=mesh,
                                 in_specs=P("dp"), out_specs=P("dp"),
                                 check_vma=False))(
            per_rank["w"])
        got = pool.run(RANKS, "local_sgd", per_rank, step, 3)
        for rank, out in enumerate(got):
            np.testing.assert_allclose(out["w"], np.asarray(want[rank]),
                                       rtol=1e-6, atol=1e-7)


def test_quantile_above_2_pow_24_matches_jnp():
    n = (1 << 24) + 4099
    x = np.random.RandomState(2).standard_normal(n).astype(np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.tensor(x), 0.9)
    q = np.array([0.5, 0.999, 0.9999], np.float32)
    got = thooks.quantile_linear(torch.tensor(x), torch.tensor(q)).numpy()
    want = np.asarray(jax.jit(jnp.quantile)(jnp.asarray(x), q))
    np.testing.assert_array_equal(got, want)
