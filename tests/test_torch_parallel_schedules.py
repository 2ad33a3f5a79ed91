"""The port's pipeline schedule tables against the JAX package's, field
for field, for every (schedule, S, M, v) that
tests/test_pipeline_schedules.py builds (training and forward-only
tables), and the reports built on them (no processes)."""
import numpy as np
import pytest

from paddle_tpu.parallel import pipeline as jpipe
from paddle_tpu.parallel import schedules as jsched
from paddle_tpu_torch.parallel import pipeline as tpipe
from paddle_tpu_torch.parallel import schedules as tsched

FIELDS = ("kind", "chunk", "mb", "fwd_src", "rx_store", "send_fwd",
          "res_slot", "bwd_src", "brx_store", "send_bwd")
CAPS = ("cap_rx", "cap_brx", "cap_res_mid", "cap_res_last", "T")

CONFIGS = ([("gpipe", 2, 3, 1), ("1f1b", 2, 3, 1), ("interleaved", 2, 2, 2)]
           + [(s, 4, M, v) for s, v in (("gpipe", 1), ("1f1b", 1),
                                        ("interleaved", 2),
                                        ("interleaved", 3))
              for M in (1, 2, 4, 5, 7, 8, 16)]
           + [("gpipe", 4, 8, 1), ("1f1b", 4, 16, 1)])


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for f in CAPS:
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("schedule,S,M,v", CONFIGS)
def test_tables_equal_the_jax_package(schedule, S, M, v):
    t = tsched.make_schedule(schedule, S, M, v)
    j = jsched.make_schedule(schedule, S, M, v)
    _same(t, j)
    tsched.validate_table(t)
    assert t.stats() == j.stats()
    assert t.counters() == j.counters()
    assert t.tick_profile() == j.tick_profile()
    assert t.bubble_fraction() == j.bubble_fraction()
    assert t.stash_bytes(1024, 512) == j.stash_bytes(1024, 512)
    assert tpipe.schedule_report(schedule, S, M, v) == \
        jpipe.schedule_report(schedule, S, M, v)
    assert tpipe.bubble_fraction(schedule, S, M, v) == \
        jpipe.bubble_fraction(schedule, S, M, v)


@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("interleaved", 2)])
def test_forward_only_tables_equal(schedule, v):
    _same(tsched.make_schedule(schedule, 4, 8, v, fwd_only=True),
          jsched.make_schedule(schedule, 4, 8, v, fwd_only=True))


def test_bad_configs_raise_alike():
    for args in (("pipedream", 4, 4), ("interleaved", 4, 4, 1),
                 ("gpipe", 4, 4, 2), ("gpipe", 4, 0)):
        with pytest.raises(ValueError):
            jsched.make_schedule(*args)
        with pytest.raises(ValueError):
            tsched.make_schedule(*args)
