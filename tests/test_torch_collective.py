"""The 13 collective op types of the port against the JAX package's, on
the CPU: 4 gloo ranks against the JAX op under shard_map over a 4-device
mesh, each rank holding one block of the same numpy input.

* c_allreduce_sum, c_broadcast, c_allgather, c_reducescatter,
  c_alltoall, c_permute and c_allreduce_prod (positive inputs): forward
  outputs and `jax.vjp` gradients equal per block.
* c_allreduce_max / min: forward equal; JAX defines no gradient for
  pmax / pmin, the port's (the summed cotangents to the elements that
  attain the extreme) is held against numpy.
* c_allreduce_prod of negative inputs: the reference's exp(psum(log x))
  is NaN, the port's is the true product (pinned, ROADMAP Queue 3).
* The two stream syncs are the identity and c_comm_init /
  c_gen_unique_id return nothing, on both sides; outside a mesh every
  collective is the identity.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.core import registry as jregistry
from paddle_tpu.core.jax_compat import shard_map
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.parallel.ranks import RankPool

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_parallel_ranks.py")
WORLD = 4
ATTRS = {"root": 1, "shift": 1}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", device="cpu",
                 store=str(tmp_path_factory.mktemp("ranks") / "store"),
                 timeout=90)
    try:
        yield p
    finally:
        p.close(kill=True)


def _jax(op, x, cot, grad=True):
    mesh = jmake_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])

    def f(a):
        return jregistry.get_op(op).fn(
            jregistry.OpContext(ATTRS, None, True, 0), a)
    sm = shard_map(f, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"))
    if not grad:
        return np.asarray(sm(x)), None
    out, vjp = jax.vjp(sm, x)
    g, = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(g)


def _blocks(a):
    return np.split(a, WORLD)


def _run(pool, op, x, cot):
    xs, outs = _blocks(x), None
    got = pool.run_each(RANKS, "collective",
                        [(op, xs[r], cot[r], ATTRS) for r in range(WORLD)])
    assert not any(j for _, _, j in got)
    return got


@pytest.mark.parametrize("op", ["c_allreduce_sum", "c_broadcast",
                                "c_allgather", "c_reducescatter",
                                "c_alltoall", "c_permute",
                                "c_allreduce_prod"])
def test_collective_matches_jax_forward_and_vjp(pool, op):
    r = np.random.RandomState(0)
    x = r.randn(WORLD * 4, 3).astype(np.float32)
    if op == "c_allreduce_prod":
        x = np.abs(x) + 0.5
    out_j, _ = _jax(op, x, None, grad=False)
    cot_blocks = [r.randn(*b.shape).astype(np.float32)
                  for b in _blocks(out_j)]
    out_j, g_j = _jax(op, x, np.concatenate(cot_blocks))
    got = _run(pool, op, x, cot_blocks)
    for rank, (out, g, _) in enumerate(got):
        np.testing.assert_allclose(out, _blocks(out_j)[rank], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{op} rank {rank}")
        np.testing.assert_allclose(g, _blocks(g_j)[rank], rtol=1e-4,
                                   atol=1e-5, err_msg=f"{op} d rank {rank}")


@pytest.mark.parametrize("op,fn", [("c_allreduce_max", np.max),
                                   ("c_allreduce_min", np.min)])
def test_allreduce_extreme_forward_and_port_gradient(pool, op, fn):
    r = np.random.RandomState(1)
    x = r.randn(WORLD * 2, 3).astype(np.float32)
    out_j, _ = _jax(op, x, None, grad=False)
    cot = [r.randn(2, 3).astype(np.float32) for _ in range(WORLD)]
    got = _run(pool, op, x, cot)
    stack = np.stack(_blocks(x))
    ext = fn(stack, axis=0)
    total = np.sum(cot, axis=0)
    for rank, (out, g, _) in enumerate(got):
        np.testing.assert_allclose(out, _blocks(out_j)[rank])
        np.testing.assert_allclose(out, ext)
        want = np.where(stack[rank] == ext, total, 0.0)
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)


def test_allreduce_prod_of_negatives_is_the_true_product(pool):
    x = np.array([[-2.0], [3.0], [-0.5], [4.0]], np.float32)
    out_j, _ = _jax("c_allreduce_prod", x, None, grad=False)
    assert np.isnan(out_j).all()          # the reference: exp(psum(log x))
    got = _run(pool, "c_allreduce_prod", x,
               [np.ones((1, 1), np.float32)] * WORLD)
    for rank, (out, g, _) in enumerate(got):
        np.testing.assert_allclose(out, [[12.0]])
        np.testing.assert_allclose(g, [[12.0 / x[rank, 0] * WORLD]],
                                   rtol=1e-6)


def test_noop_collectives_and_identity_outside_a_mesh(pool):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for outs, empty in pool.run(RANKS, "collective_noops", x):
        for o in outs:
            np.testing.assert_array_equal(o, x)
        assert all(e == () for e in empty)
    ctx = tregistry.OpContext({}, 0, True, 0, "cpu")
    jctx = jregistry.OpContext({}, None, True, 0)
    for op in ("c_sync_calc_stream", "c_sync_comm_stream"):
        np.testing.assert_array_equal(
            np.asarray(jregistry.get_op(op).fn(jctx, jnp.asarray(x))), x)
    for op in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
               "c_allreduce_prod", "c_broadcast", "c_allgather",
               "c_reducescatter", "c_alltoall", "c_permute"):
        t = torch.tensor(x)
        assert tregistry.get_op(op).fn(ctx, t) is t
        np.testing.assert_array_equal(
            np.asarray(jregistry.get_op(op).fn(jctx, jnp.asarray(x))), x)


@pytest.mark.parametrize("backend,kind,device,stages", [
    ("gloo", "send_recv", "cuda", True),
    ("gloo", "send_recv", "cpu", False),
    ("gloo", "all_gather", "cuda", False),
    ("gloo", "all_to_all", "cuda", False),
    ("gloo", "reduce_scatter", "cuda", False),
    ("nccl", "send_recv", "cuda", False),
])
def test_gloo_stages_only_what_it_refuses_on_cuda(backend, kind, device,
                                                  stages):
    """gloo takes CUDA tensors for its collectives but aborts on a CUDA
    send: only send / recv goes through the host, and NCCL never."""
    from paddle_tpu_torch.ops import collective
    from paddle_tpu_torch.parallel.env import AxisInfo
    assert collective.GLOO_STAGED == {"send_recv"}
    ax = AxisInfo("dp", None, 4, 0, backend)
    assert collective._stages(ax, kind, device) is stages
