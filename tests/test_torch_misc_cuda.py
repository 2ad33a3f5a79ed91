"""The misc, text, CTR and fused op families and a tiny CRNN-CTC on the
card against the CPU, through chip_smoke.py's phase-30 and phase-29(c)
code at small widths.

* Every op type of ops.{misc,text,ctr,fused} on its phase-30 case
  (`chip_smoke.misc_op_cases`) at narrow widths: float64 on the card and
  on the CPU, each continuous output and gradient within
  chip_smoke.MISC_F64_TOL of its max, integer outputs equal, the random
  ops by their contract on the card.
* CRNNConfig.tiny() one float64 training step at batch 2 from the same
  weights (`chip_smoke.crnn_step_check`, CRNN_CHECK's gates).

The card tests are marked `cuda` and skip without a GPU; the case table
is checked here on the CPU (one case an op type). The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_misc_cuda.py -q
"""
import importlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (chip_smoke.py at the repo root)

#: narrow widths of phase 30's cases
SMALL = dict(batch=4, ctr_batch=16, slots=3, emb=4, table=101, dense=5,
             seq=3, rnn_batch=2, steps=4, word=6, hidden=8)
CASES = {c["label"]: c for c in chip_smoke.misc_op_cases(0, SMALL)}
FAMILIES = ("misc", "text", "ctr", "fused")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card against the CPU")


def test_every_op_of_the_families_has_a_case():
    from paddle_tpu_torch.core import registry
    mods = {f"paddle_tpu_torch.ops.{m}" for m in FAMILIES}
    for m in mods:
        importlib.import_module(m)
    ops = {op for op in registry.registered_ops()
           if registry.get_op(op).fn.__module__ in mods}
    assert {c["op"] for c in CASES.values()} == ops
    assert len(ops) == 75


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_on_the_card_matches_the_cpu(cuda, name):
    case = CASES[name]
    got = chip_smoke.misc_run(torch, case, "cuda", torch.float64)
    if case["contract"] is not None:
        assert chip_smoke.misc_contract(torch, case, got), name
        return
    want = chip_smoke.misc_run(torch, case, "cpu", torch.float64)
    assert len(got) == len(want)
    exact = {i: None for i, w in enumerate(want) if not w.is_floating_point()}
    err, equal, _ = chip_smoke.det_errors(got, want, exact)
    assert equal and err <= chip_smoke.MISC_F64_TOL, (name, err)


@pytest.mark.cuda
def test_tiny_crnn_float64_step_on_the_card(cuda):
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import crnn_ctc
    cfg = crnn_ctc.CRNNConfig.tiny()
    main, _, startup, _ = chip_smoke.crnn_programs(cfg, 2, 0)
    scope = Scope()
    Executor("cpu").run(startup, scope=scope)
    state = {v.name: scope.find_np(v.name) for v in main.list_vars()
             if v.persistable and scope.has(v.name)}
    out = chip_smoke.crnn_step_check(torch, cfg, state, 0, "[test]")
    assert out["decode_equal"]
