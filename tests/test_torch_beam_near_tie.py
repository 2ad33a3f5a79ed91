"""chip_smoke phase 24's near-tie rule for beam ids on the CPU
(`chip_smoke.beam_near_ties`): a row whose ids differ from the
reference's is excused only when the other model, teacher forced on the
reference's beams, chooses other candidates only inside groups of tied
ones: at every slot where its choice differs, the reference's score of
its candidate lies within NEAR_TIE of the reference's own choice there.
A difference without a tie fails, a tie at one slot does not excuse an
untied pick at another, and the rule's control, the plain model with
its attention logits scaled by 1.01 (or the next scale that parts
beams past a tie), fails.

The scripted runs' logits do not depend on the beams, so their own
logits are their teacher-forced ones."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops import beam_search as bs

B, K, V, STEPS, EOS = 2, 2, 6, 4, 5


def _scripted(logits):
    """beam_search over scripted logits ([STEPS, B*K, V]): (ids, the
    logits each step saw)."""
    seen = []

    def step_fn(tokens, state):
        seen.append(logits[len(seen)])
        return logits[len(seen) - 1], state

    ids, _ = bs.beam_search(step_fn, {"x": torch.zeros(B * K, 1)}, B, K, V,
                            bos_id=0, eos_id=EOS, max_len=STEPS)
    return ids, seen


def _logits(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(STEPS, B * K, V).astype(np.float32) * 2.0
    x[..., EOS] = -30.0                       # no beam finishes early
    return torch.from_numpy(x)


def _tied_at_step_1():
    """Scripted logits whose row 0 ties exactly at step 1 between the
    K-th and (K+1)-th candidates: step 0 gives its two beams equal
    scores, and at step 1 beam 1's tokens 1 and 2 have equal logits
    below beam 0's token 0. A copy raises token 2 by 1e-6: the two runs
    keep other beams from there."""
    want = _logits(0)
    want[0, 0] = torch.tensor([4.0, 4.0, -5.0, -5.0, -5.0, -30.0])
    want[1, 0] = torch.tensor([5.0, 0.0, 0.0, 0.0, 0.0, -30.0])
    want[1, 1] = torch.tensor([0.0, 4.0, 4.0, 0.0, 0.0, -30.0])
    # step 2 favours what beam 1 holds, so the final beams show the tie
    want[2, 0] = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, -30.0])
    want[2, 1] = torch.tensor([10.0, -5.0, -5.0, -5.0, -5.0, -30.0])
    got = want.clone()
    got[1, 1, 2] += 1e-6
    return want, got


def test_a_constructed_tie_is_excused_with_its_gap(capsys):
    want, got = _tied_at_step_1()
    w_ids, w_steps = _scripted(want)
    g_ids, g_steps = _scripted(got)
    assert not torch.equal(g_ids[0], w_ids[0])
    assert torch.equal(g_ids[1], w_ids[1])
    excused = chip_smoke.beam_near_ties(torch, "tie", g_ids, w_ids, g_steps,
                                        w_steps, B, K, EOS)
    assert [(r, t) for r, t, _ in excused] == [(0, 1)]
    assert 0 <= excused[0][2] < chip_smoke.NEAR_TIE
    assert "near-tie: tie row 0" in capsys.readouterr().out


def test_a_divergence_without_a_tie_fails():
    want = _logits(0)
    got = want.clone()
    got[2, 0] += torch.linspace(-3.0, 3.0, V)        # no tie: a new model
    w_ids, w_steps = _scripted(want)
    g_ids, g_steps = _scripted(got)
    assert not torch.equal(g_ids, w_ids)
    with pytest.raises(AssertionError, match="no tie"):
        chip_smoke.beam_near_ties(torch, "moved", g_ids, w_ids, g_steps,
                                  w_steps, B, K, EOS)


def test_a_tie_does_not_excuse_an_untied_pick_beside_it():
    """At step 1 the reference's two best candidates of row 0 tie (beam
    1's tokens 1 and 2) and it keeps both. The other model prefers token
    2 by 1e-6 and drops token 1 far down, so it keeps token 2 and then
    one of beam 0's candidates, 0.9 below the tie. Its first differing
    slot is the tie; its second is not, and the rule refuses the row."""
    want = _logits(0)
    want[0, 0] = torch.tensor([4.0, 4.0, -5.0, -5.0, -5.0, -30.0])
    want[1, 0] = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, -30.0])
    want[1, 1] = torch.tensor([0.0, 4.0, 4.0, 0.0, 0.0, -30.0])
    got = want.clone()
    got[1, 1] = torch.tensor([0.0, -10.0, 4.0 + 1e-6, 0.0, 0.0, -30.0])
    w_ids, w_steps = _scripted(want)
    g_ids, g_steps = _scripted(got)
    assert not torch.equal(g_ids[0], w_ids[0])
    cw, sw, co, so = chip_smoke.beam_choices(torch, w_steps, B, K, EOS,
                                             g_steps)[1]
    assert cw[0].tolist() == [V + 1, V + 2]       # the tied pair
    assert co[0, 0] == V + 2 and co[0, 1] < V     # the tie, then beam 0
    assert abs(float(so[0, 0] - sw[0, 0])) < chip_smoke.NEAR_TIE
    assert float(sw[0, 1] - so[0, 1]) > 0.5
    with pytest.raises(AssertionError, match="slot 1 .* no tie"):
        chip_smoke.beam_near_ties(torch, "half-tied", g_ids, w_ids, g_steps,
                                  w_steps, B, K, EOS)


def test_equal_ids_pass_and_differing_ids_need_a_differing_choice():
    want = _logits(1)
    w_ids, w_steps = _scripted(want)
    assert chip_smoke.beam_near_ties(torch, "same", w_ids.clone(), w_ids,
                                     w_steps, w_steps, B, K, EOS) == []
    bad = w_ids.clone()
    bad[1, 0, -1] = (bad[1, 0, -1] + 1) % EOS
    with pytest.raises(AssertionError, match="same candidates"):
        chip_smoke.beam_near_ties(torch, "edited", bad, w_ids, w_steps,
                                  w_steps, B, K, EOS)


@pytest.mark.parametrize("gap,drift", [
    pytest.param(1e-6, 0.0, id="1e-06"), pytest.param(0.5, 0.0, id="0.5"),
    pytest.param(1e-6, 1e-6, id="drift-1e-06"),
    pytest.param(1e-6, 0.5, id="drift-0.5")])
def test_a_final_ranking_tie_is_excused_and_nothing_else(capsys, gap,
                                                         drift):
    """Every step chose the reference's candidates, but beam search's
    final ordering by length-penalised score swapped two beams: excused
    only when their final scores lie within NEAR_TIE, each beam's final
    score (`drift` away from the reference's) too, and only a reordering
    of the same beams."""
    want = _logits(2)
    w_ids, w_steps = _scripted(want)
    g_ids = w_ids.clone()
    g_ids[0, [0, 1]] = w_ids[0, [1, 0]]
    scores = torch.tensor([[-1.0, -1.0 - gap], [-2.0, -3.0]])
    g_scores = scores.clone()
    g_scores[0] = scores[0, [1, 0]] + torch.tensor([drift, 0.0])
    if max(gap, drift) < chip_smoke.NEAR_TIE:
        excused = chip_smoke.beam_near_ties(
            torch, "rank", g_ids, w_ids, w_steps, w_steps, B, K, EOS,
            want_scores=scores, got_scores=g_scores)
        assert [(r, t) for r, t, _ in excused] == [(0, "final")]
        assert "the final ranking reorders beams" in capsys.readouterr().out
    else:
        with pytest.raises(AssertionError, match="same candidates"):
            chip_smoke.beam_near_ties(torch, "rank", g_ids, w_ids, w_steps,
                                      w_steps, B, K, EOS, want_scores=scores,
                                      got_scores=g_scores)
    edited = w_ids.clone()
    edited[0, 0, -1] = (edited[0, 0, -1] + 1) % EOS
    with pytest.raises(AssertionError, match="same candidates"):
        chip_smoke.beam_near_ties(torch, "edited", edited, w_ids, w_steps,
                                  w_steps, B, K, EOS, want_scores=scores,
                                  got_scores=scores)


def _tiny_plain():
    """A tiny Transformer (plain attention, its output layer scaled up so
    the candidates stand apart), its beam decode of a seeded batch and
    that decode's record."""
    cfg = dataclasses.replace(T.TransformerConfig.tiny(),
                              attention_impl="xla")
    nn.seed(3)
    plain = T.Transformer(cfg, device="cpu")
    plain.eval()
    with torch.no_grad():
        for p in plain.parameters():
            p.mul_(3.0)
    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randint(2, cfg.src_vocab, (B, 12))).to(
        torch.int32)
    src_len = torch.full((B,), 12, dtype=torch.int32)

    def fn(m):
        return m.beam_search_decode(src, src_len, max_len=10, beam_size=K)

    (ids, scores), rec = chip_smoke.recorded_beam(plain, fn)
    return plain, fn, {"ids": ids, "scores": scores, "rec": rec}


def test_the_sm_scale_control_fails_the_rule():
    """The tiny model against the same model with its attention logits
    scaled by 1.01: the beams differ and the rule refuses them."""
    plain, fn, ref = _tiny_plain()
    rec = ref["rec"]
    assert len(rec["steps"]) == 10
    assert rec["steps"][0].shape == (B * K, T.TransformerConfig.tiny(
    ).trg_vocab)
    forced = chip_smoke.forced_steps(torch, plain, rec, rec)
    for a, b in zip(forced, rec["steps"]):          # its own beams
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    msg = chip_smoke.beam_control(torch, T, plain, fn, ref, (B, K, 1), "cpu")
    assert "no tie" in msg


@pytest.mark.parametrize("tied_scales",
                         [1, len(chip_smoke.BEAM_CONTROL_SCALES)])
def test_a_control_scale_that_parts_beams_only_at_ties_is_passed_over(
        monkeypatch, capsys, tied_scales):
    """A scale whose beams the rule excuses (they part only at ties) is
    no control: the next scale is tried, and the control fails when no
    scale moves a beam past a tie."""
    plain, fn, ref = _tiny_plain()
    calls = []

    def rule(torch_, label, *args, **scores):
        calls.append(label)
        if len(calls) <= tied_scales:
            return [(0, 3, 0.0)]
        raise AssertionError(f"{label} row 0: no tie")

    monkeypatch.setattr(chip_smoke, "beam_near_ties", rule)
    if tied_scales < len(chip_smoke.BEAM_CONTROL_SCALES):
        msg = chip_smoke.beam_control(torch, T, plain, fn, ref, (B, K, 1),
                                      "cpu")
        assert "no tie" in msg and len(calls) == tied_scales + 1
    else:
        with pytest.raises(AssertionError, match="past a tie"):
            chip_smoke.beam_control(torch, T, plain, fn, ref, (B, K, 1),
                                    "cpu")
    assert "x 1.01 part beams only at ties (1 steps, largest gap 0)" in \
        capsys.readouterr().out
