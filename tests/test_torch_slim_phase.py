"""chip_smoke phase 40 on the CPU, at a small depth: a ResNet of one
bottleneck a stage (width 8, 10 classes) at 32 x 32 in place of
ResNet-50 at 224 x 224, every other setting as on the card, both sides
of the card-against-CPU step on the CPU. The phase's gates pass (the
pricing check reads no capture peak here: its legs skip), and its two
controls are refused: the planted K = 200000 `mul` is vetoed and stays
float32 (its unplanned quantization is a `quantized_mul`), and the
planted A -> B / B -> A lock pair gives exactly one lock-order cycle.
"""
import numpy as np
import pytest

SMALL = dict(depth=50, width=8, blocks=(1, 2, 1, 1), num_classes=10)


@pytest.fixture
def cs(monkeypatch):
    """chip_smoke at the small depth; each `quantized_mul` run (one K8
    call through its registered op, the plain version on the CPU)
    counts as the card counts K8's launches."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.core.registry import get_op
    from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
    monkeypatch.setattr(chip_smoke, "SLIM_NET", SMALL)
    monkeypatch.setattr(chip_smoke, "SLIM_IMAGE", 32)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    impl = get_op("quantized_mul")
    plain = impl.fn

    def counted(*args, **kw):
        k8.launch_counts["quantized_matmul"] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(impl, "fn", counted)
    return chip_smoke


def test_phase40_gates_and_controls_on_the_cpu(cs):
    import torch
    from paddle_tpu_torch.analysis import concurrency
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.io import fs
    from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
    out, launches = cs.slim_phase(torch, k8, 0, "[cpu]", dev="cpu")
    pd, q, srv = out["prune_distill"], out["quantize"], out["serving"]
    assert pd["pruned_params"] == 5 and pd["teacher_bit_equal"]
    assert abs(pd["sparsity_pruned"] - 0.5) < 0.01
    assert pd["losses"][-1] < pd["losses"][0] and pd["feeds_equal"]
    assert set(pd["agreement"]) == {"float32", "float64"}
    assert q["int8_bytes_held"] == q["int8_bytes_planned"] > 0
    assert q["vetoed_ops"] == [] and q["fc_ulps"] <= 1
    assert q["k8_launches"] == q["requests"] == 12
    assert {p["status"] for p in q["pricing"].values()} == {"skip"}
    veto = out["planted_veto"]
    assert veto["planned"]["ops"] == ["mul"]
    assert veto["planned"]["rel_err"] <= cs.SLIM_VETO_TOL
    assert veto["unplanned"]["ops"] == ["quantized_mul"]
    assert srv["requests"] >= 64 and srv["captures_plain"] == 0
    assert set(srv["by_version"]) == {"v1", "v2"}
    assert srv["control"]["findings"] == 1
    assert len(out["nas"]["history"]) == cs.SLIM_NAS_STEPS
    assert all(f <= out["nas"]["max_flops"]
               for _, _, f in out["nas"]["history"])
    assert launches["quantized_matmul"] > q["k8_launches"]   # + gateway
    # the phase leaves the checker unarmed and the store empty
    assert not flags.get_flag("concurrency_check")
    assert concurrency.findings() == []
    assert not fs.get_fs(cs.SLIM_DIR)[0].exists(cs.SLIM_DIR)
    assert np.isfinite(out["seconds"])
