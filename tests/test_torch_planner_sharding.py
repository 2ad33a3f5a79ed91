"""The planner's sharding half of the port against the JAX package's
(no processes): on LeNet's, ResNet-50's and BERT-base's static programs,
built by each package's static API, under the meshes dp:8, dp:2,tp:4
and tp:8 (BERT's feed-forward weights declared Megatron-sharded over
tp), `propagate_shardings` gives the same specs, hazards and collective
events, `price_collectives` the same prices and `plan_program` /
`PlannerPass` the same plan; the two flags the sharding half reads move
both alike."""
import pytest

from paddle_tpu.analysis import planner as jplanner
from paddle_tpu_torch.analysis import planner as tplanner
from paddle_tpu_torch.analysis.framework import get_pass
from paddle_tpu_torch.core import flags as tflags
from test_torch_planner import SIDES, _lenet, _tiny_bert

MESHES = ["dp:8", "dp:2,tp:4", "tp:8"]


def _resnet50(S, lenet, resnet):
    img = S.data("img", [3, 224, 224], "float32")
    label = S.data("label", [1], "int64")
    return ["img", "label"], resnet.build_static(img, label)[0]


def _bert_base(S, lenet, resnet):
    return _tiny_bert(S, seq=128, hidden=768, heads=12, layers=12,
                      vocab=30522)


MODELS = {"lenet": _lenet, "resnet50": _resnet50, "bert_base": _bert_base}
_BUILT = {}


def _program(side, model):
    key = (side, model)
    if key not in _BUILT:
        ir, S, lenet, resnet, _ = SIDES[side]
        ir.reset_unique_names()
        main, startup = ir.Program(), ir.Program()
        with ir.program_guard(main, startup):
            feeds, fetch = MODELS[model](S, lenet, resnet)
        main.meta["feed_targets"] = feeds
        main.meta["fetch_targets"] = [fetch.name]
        for v in main.global_block().vars.values():
            if v.is_parameter and v.shape == (768, 3072):
                v.sharding = (None, "tp")
            elif v.is_parameter and v.shape == (3072, 768):
                v.sharding = ("tp", None)
        _BUILT[key] = main
    return _BUILT[key]


def _diag(d):
    return (d.code, str(d.severity), d.message, d.block_idx, d.op_index,
            d.op_type, d.var, d.hint)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_sharding_plan_matches_jax(model, mesh):
    jp, tp = _program("jax", model), _program("port", model)
    jspecs, jhaz, jev = jplanner.propagate_shardings(jp, mesh, batch_size=8)
    tspecs, thaz, tev = tplanner.propagate_shardings(tp, mesh, batch_size=8)
    assert tspecs == jspecs
    assert [_diag(d) for d in thaz] == [_diag(d) for d in jhaz]
    assert [e.to_dict() for e in tev] == [e.to_dict() for e in jev]
    assert tplanner.price_collectives(tev, mesh) == \
        jplanner.price_collectives(jev, mesh)
    kw = dict(mesh=mesh, batch_size=8, hbm_budget_bytes=1 << 30)
    jplan = jplanner.plan_program(jp, **kw)
    tplan = tplanner.plan_program(tp, **kw)
    jd, td = jplan.to_dict(), tplan.to_dict()
    for part in ("mesh", "comms", "shardings", "hazards", "batch_size"):
        assert td[part] == jd[part], part


def test_planner_pass_and_flags_match_jax():
    jp, tp = _program("jax", "bert_base"), _program("port", "bert_base")
    jp.meta["mesh_axes"] = tp.meta["mesh_axes"] = {"dp": 2, "tp": 4}
    try:
        codes = [d.code for d in get_pass("plan_resources").run(tp, None)]
        assert "comm-budget" in codes and "reshard-on-hot-path" in codes
        from paddle_tpu.analysis.framework import get_pass as jget
        assert codes == [d.code for d in jget("plan_resources").run(jp,
                                                                   None)]
    finally:
        del jp.meta["mesh_axes"], tp.meta["mesh_axes"]
    from paddle_tpu.core import flags as jflags
    try:
        for fl in (jflags, tflags):
            fl.set_flag("plan_large_param_mb", 1.0)
            fl.set_flag("plan_link_gbps", 10.0)
        j = jplanner.plan_program(jp, mesh="dp:8", batch_size=8).to_dict()
        t = tplanner.plan_program(tp, mesh="dp:8", batch_size=8).to_dict()
        assert t["hazards"] == j["hazards"]
        assert t["comms"] == j["comms"] and t["comms"]["link_gbps"] == 10.0
        assert any(h["code"] == "replicated-large-param"
                   for h in t["hazards"])
    finally:
        for fl in (jflags, tflags):
            fl.set_flag("plan_large_param_mb", 64.0)
            fl.set_flag("plan_link_gbps", 100.0)
