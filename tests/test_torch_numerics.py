"""analysis/numerics.py of the port against the JAX package's, on the CPU.

The same programs (built by the port's static API, or as bare IR by one
function over either package's `core.ir`) and the same numpy parameters,
seeded, go through both packages' analyzers:

* the four planted-hazard programs of tests/test_numerics.py give the
  same code, severity, op index and var, and a calibrated in-range
  program gives none;
* `propagate_intervals` over a LeNet and a small ResNet (width 8,
  blocks (1, 1)) gives every var the same interval (1e-6 relative; they
  come out equal) and the same pedigree;
* the transfer-rule coverage and families are equal;
* `plan_quantization(...).to_dict()` is equal in its weights, bytes,
  vetoes, ladder and regions; the step peaks differ by the planner's
  fusion discount (the port charges every intermediate, the JAX package
  a quarter) and by the working set priced for the quantized ops (the
  port's float64 unfold GEMM, the JAX package's widened weight copy):
  both numbers are asserted, and at the JAX package's 0.25 the peaks
  less the working sets are equal;
* `price_quantized_kv` is equal on kwargs and on a tiny
  PagedDecodeEngine of each package;
* `apply_plan_vetoes` and `quantize_program(plan=...)` veto the
  K = 200000 `mul` of tests/test_slim_passes.py.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.analysis import numerics as jn
from paddle_tpu.core import ir as jir
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.analysis import numerics as tn
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet

REL = 1e-6

IRS = {"jax": jir, "port": tir}


def _mlp_ir(ir, k=8, n=4, calib=None):
    """Bare-IR x @ w (tests/test_numerics.py::_mlp_ir)."""
    p = ir.Program()
    b = p.global_block()
    b.create_var(name="x", shape=[-1, k], dtype="float32", is_data=True)
    w = b.create_var(name="w", shape=[k, n], dtype="float32",
                     persistable=True)
    w.desc.is_parameter = True
    b.create_var(name="out", shape=[-1, n], dtype="float32")
    b.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["out"]})
    if calib is not None:
        b.vars["x"].attrs["calib_abs_max"] = float(calib)
    return p


def _requant_ir(ir):
    """Two chained frozen int8 GEMMs (tests/test_numerics.py)."""
    p = ir.Program()
    b = p.global_block()
    b.create_var(name="x", shape=[-1, 8], dtype="float32", is_data=True)
    for i, (k, n) in enumerate(((8, 8), (8, 4))):
        b.create_var(name=f"w{i}.int8", shape=[k, n], dtype="int8",
                     persistable=True)
        b.create_var(name=f"w{i}.scale", shape=[n], dtype="float32",
                     persistable=True)
        b.create_var(name=f"h{i}", shape=[-1, n], dtype="float32")
        b.append_op("quantized_mul",
                    {"X": ["x" if i == 0 else f"h{i - 1}"],
                     "Y": [f"w{i}.int8"], "YScale": [f"w{i}.scale"]},
                    {"Out": [f"h{i}"]},
                    {"x_scale": 1.0, "bit_length": 8})
    return p


W01 = np.full((8, 4), 0.1, np.float32)
W05 = np.full((8, 4), 0.5, np.float32)
HAZARDS = {
    "int8-range-overflow": (lambda ir: _mlp_ir(ir, k=200000), None),
    "fp8-saturation-risk": (lambda ir: _mlp_ir(ir, calib=600.0),
                            {"w": W01}),
    "uncalibrated-tensor": (lambda ir: _mlp_ir(ir), None),
    "redundant-requant": (_requant_ir, None),
    "clean": (lambda ir: _mlp_ir(ir, calib=2.0), {"w": W05}),
}


def _diag_key(d):
    return (d.code, d.severity, d.op_index, d.op_type, d.var)


@pytest.mark.parametrize("case", sorted(HAZARDS))
def test_planted_hazards_match_jax(case):
    build, params = HAZARDS[case]
    got = [_diag_key(d) for d in
           tn.analyze_numerics(build(tir), params=params).diagnostics]
    want = [_diag_key(d) for d in
            jn.analyze_numerics(build(jir), params=params).diagnostics]
    assert got == want
    if case == "clean":
        assert got == []
    else:
        assert case in {g[0] for g in got}


def _static_net(model):
    """A test clone of a LeNet or a small ResNet from the port's static
    API, its parameters (seeded numpy) and every activation stamped with
    a seeded calibration range."""
    tir.reset_unique_names()
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        if model == "lenet":
            img = tstatic.data("img", [1, 28, 28], "float32")
            label = tstatic.data("label", [1], "int64")
            tlenet.build_static(img, label)
        else:
            img = tstatic.data("img", [3, 32, 32], "float32")
            label = tstatic.data("label", [1], "int64")
            tresnet.build_static(img, label, num_classes=10, width=8,
                                 blocks=(1, 1))
    test = main.clone(for_test=True)
    rng = np.random.RandomState(0)
    params = {}
    for name, d in test.global_block().vars.items():
        if d.persistable and d.shape:
            params[name] = (0.1 * rng.randn(*d.shape)).astype(np.float32)
    for name, d in test.global_block().vars.items():
        if not d.persistable and not d.is_data and rng.rand() < 0.7:
            d.attrs["calib_abs_max"] = float(rng.uniform(0.5, 5.0))
    return test, params


def _close(a, b):
    if a == b:
        return True
    return abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("model", ["lenet", "resnet"])
def test_intervals_match_jax(model):
    test, params = _static_net(model)
    jprog = jir.Program.from_dict(test.to_dict())
    got = tn.propagate_intervals(test, params=params, batch_size=4)
    want = jn.propagate_intervals(jprog, params=params, batch_size=4)
    assert set(got) == set(want) and len(got) > 20
    for name, w in want.items():
        g = got[name]
        assert _close(g.lo, w.lo) and _close(g.hi, w.hi), (name, g, w)
        assert g.calibrated == w.calibrated, name
    # the report: ladder, boundaries, regions and hazards
    tr = tn.analyze_numerics(test, params=params, batch_size=4)
    jr = jn.analyze_numerics(jprog, params=params, batch_size=4)
    assert tr.to_dict() == jr.to_dict()
    assert any(v.rung == "int8" for v in tr.ladder)


def test_transfer_coverage_matches_jax():
    assert tn.numerics_covered_ops() == jn.numerics_covered_ops()
    assert tn.transfer_families() == jn.transfer_families()
    assert tn.QUANT_OPS == jn.QUANT_OPS
    from paddle_tpu_torch.slim.quantization_pass import QUANTIZABLE
    assert set(tn.QUANT_OPS) == set(QUANTIZABLE)
    from paddle_tpu_torch.analysis import get_pass
    assert get_pass("lint_numerics").__class__ is tn.NumericsPass


def test_plan_matches_jax_and_pins_the_step_peak_divergence(monkeypatch):
    test, params = _static_net("resnet")
    jprog = jir.Program.from_dict(test.to_dict())
    want = jn.plan_quantization(jprog, params=params, batch_size=4).to_dict()
    got = tn.plan_quantization(test, params=params, batch_size=4).to_dict()
    same = ("weights", "weights_saved_bytes", "vetoed_ops", "ladder",
            "boundaries", "regions", "kv", "batch_size", "weight_bits")
    for key in same:
        assert got[key] == want[key], key
    assert len(got["weights"]) == 10 and got["weights_saved_bytes"] > 0
    assert sum(w["bytes_int8"] for w in got["weights"]) == sum(
        params[w["param"]].size + 4 * params[w["param"]].shape[
            0 if w["op_type"] == "conv2d" else 1] for w in got["weights"])
    # the working set: the JAX package prices a widened int32 copy of the
    # largest weight; the port its quantized_conv2d's float64 unfold GEMM
    assert want["int8_working_bytes"] == max(
        w["bytes_f32"] for w in want["weights"])
    assert got["int8_working_bytes"] == tn.quant_working_bytes(
        test.global_block(), got["weights"], 4) > want["int8_working_bytes"]
    # the planner's fusion discount: the port charges every intermediate
    # (a captured graph fuses nothing), the JAX package a quarter
    for key in ("baseline_step_peak_bytes", "quantized_step_peak_bytes"):
        assert got[key] > want[key], key
    monkeypatch.setattr(tflags._REGISTRY["plan_fusion_discount"],
                        "value", 0.25)
    at_jax = tn.plan_quantization(test, params=params,
                                  batch_size=4).to_dict()
    assert at_jax["baseline_step_peak_bytes"] == \
        want["baseline_step_peak_bytes"]
    assert (at_jax["quantized_step_peak_bytes"]
            - at_jax["int8_working_bytes"]) == (
        want["quantized_step_peak_bytes"] - want["int8_working_bytes"])
    assert got["quantized_capture_peak_bytes"] == (
        got["quantized"]["capture_peak_bytes"] + got["int8_working_bytes"])


def test_port_working_set_of_one_conv_pinned():
    """ROADMAP Queue 3: the port prices a quantized conv's float64
    unfold GEMM (columns + filter + accumulator), the JAX package the
    widened int32 copy of the filter."""
    progs = {}
    for side, ir in IRS.items():
        p = ir.Program()
        b = p.global_block()
        b.create_var(name="x", shape=[-1, 3, 8, 8], dtype="float32",
                     is_data=True)
        b.create_var(name="w", shape=[4, 3, 3, 3], dtype="float32",
                     persistable=True).desc.is_parameter = True
        b.create_var(name="y", shape=[-1, 4, 8, 8], dtype="float32")
        b.append_op("conv2d", {"Input": ["x"], "Filter": ["w"]},
                    {"Output": ["y"]}, {"strides": [1, 1],
                                        "paddings": [1, 1]})
        b.vars["x"].attrs["calib_abs_max"] = 1.0
        progs[side] = p
    params = {"w": np.full((4, 3, 3, 3), 0.5, np.float32)}
    got = tn.plan_quantization(progs["port"], params=params, batch_size=2)
    want = jn.plan_quantization(progs["jax"], params=params, batch_size=2)
    assert want.int8_working_bytes == 4 * 108
    assert got.int8_working_bytes == 8 * (2 * 27 * 64 + 108 + 2 * 4 * 64)
    assert got.working_bytes(8) == 8 * (8 * 27 * 64 + 108 + 8 * 4 * 64)


def test_kv_pricing_matches_jax():
    import jax
    from paddle_tpu.ops import generation as jgen
    from paddle_tpu_torch.ops import generation as tgen
    from paddle_tpu_torch.weights import params_from_jax
    kw = dict(num_layers=2, num_heads=4, head_dim=8, block_size=16,
              num_blocks=10, blocks_per_slot=2)
    assert tn.price_quantized_kv(**kw) == jn.price_quantized_kv(**kw)
    cfg = dict(vocab_size=32, d_model=16, num_heads=2, num_layers=1,
               max_len=32)
    jlm = jgen.TinyDecoderLM(jgen.LMConfig(**cfg))
    jparams = jlm.init_params(0)
    tlm = tgen.TinyDecoderLM(tgen.LMConfig(**cfg), device="cpu")
    tlm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    ekw = dict(batch_size=2, max_len=32, block_size=8, kv_dtype="int8")
    want = jn.price_quantized_kv(jgen.PagedDecodeEngine(jlm, jparams, **ekw))
    got = tn.price_quantized_kv(
        tgen.PagedDecodeEngine(tlm, device="cpu", **ekw))
    assert got == want and got["servable_slots_multiplier"] > 1
    with pytest.raises(EnforceError):
        tn.price_quantized_kv(num_layers=2, num_heads=4)


def test_plan_vetoes_the_overflowing_mul():
    """tests/test_slim_passes.py::test_apply_plan_vetoes_accepts_a_quant_
    plan on both packages, and the port's sandwich keeps the vetoed op
    in float."""
    from paddle_tpu.slim import apply_plan_vetoes as japply
    from paddle_tpu_torch.slim import apply_plan_vetoes, quantize_program
    tp, jp = _mlp_ir(tir, k=200000), _mlp_ir(jir, k=200000)
    tplan, jplan = tn.plan_quantization(tp), jn.plan_quantization(jp)
    assert tplan.vetoed_ops() == jplan.vetoed_ops() == [0]
    assert tplan.to_dict()["weights"] == jplan.to_dict()["weights"]
    assert apply_plan_vetoes(tp, tplan) == japply(jp, jplan) == 1
    assert tp.global_block().ops[0].attrs["skip_quant"] is True
    with pytest.raises(EnforceError):
        apply_plan_vetoes(tp, [99])
    with pytest.raises(pt.EnforceError):
        japply(jp, [99])
    fresh = _mlp_ir(tir, k=200000)
    diags = quantize_program(fresh, plan=tn.plan_quantization(fresh),
                             freeze=False)
    assert any("1 vetoed by plan" in d.message for d in diags)
    (op,) = fresh.global_block().ops
    assert op.type == "mul" and op.attrs["skip_quant"] is True
