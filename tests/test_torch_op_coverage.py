"""The op-coverage ratchet: the port's registered op types against the
JAX package's, on the CPU.

* Every op type the port registers is one of the reference's, with the
  same input and output slots (names, order, optional and variadic).
* The reference op types the port still lacks equal MISSING, by the
  module that registers them in the JAX package. Porting an op means
  taking it off this list (ROADMAP Queue 1 item 7 carries the same
  list); an op that leaves the port, or a new reference op, fails here.
* Every op type of paddle_tpu/ops/{tensor,math,nn,random,optimizer_ops,
  metrics,sequence,rnn,control_flow,beam_search,loss,detection,
  detection_train,vision,misc,text,ctr,fused}.py is ported, with amp's
  two loss-scaling ops, ops/collective.py's 13 collectives and
  `parallel.moe`'s `moe_switch`: 338 of the reference's 338 op types.
  MISSING is empty.
* The op library is what the op modules register. `static.py_func`
  and `static.Print` register a host-callback op when a program is
  built (in both packages); those are not library op types and are
  left out of the counts.
"""
import importlib

import pytest

from paddle_tpu.core import registry as jregistry
from paddle_tpu_torch.core import registry as tregistry

MISSING = {}

#: the JAX package's op modules that this port covers in full
FULL_FAMILIES = ("tensor", "math", "nn", "random", "optimizer_ops",
                 "metrics", "sequence", "rnn", "control_flow", "beam_search",
                 "loss", "detection", "detection_train", "vision", "misc",
                 "text", "ctr", "fused")
#: what each family still lacks
FAMILY_LEFT = {}
#: the module of the builders that register host-callback ops
_BUILDERS = ("paddle_tpu.static.extras", "paddle_tpu_torch.static.extras")


def _library(registry):
    """The op types an op module registered (not a builder)."""
    return sorted(op for op in registry.registered_ops()
                  if registry.get_op(op).fn.__module__ not in _BUILDERS)


def _slots(impl):
    return ([(s.name, s.optional, s.variadic) for s in impl.in_slots],
            [(s.name, s.optional, s.variadic) for s in impl.out_slots])


@pytest.mark.parametrize("op_type", _library(tregistry))
def test_port_op_is_a_reference_op_with_its_slots(op_type):
    assert jregistry.has_op(op_type), op_type
    assert _slots(tregistry.get_op(op_type)) == \
        _slots(jregistry.get_op(op_type))


def test_missing_reference_ops_equal_the_list():
    assert len(_library(tregistry)) == 338
    assert len(_library(jregistry)) == 338
    missing = set(_library(jregistry)) - set(_library(tregistry))
    listed = {op for ops in MISSING.values() for op in ops}
    assert sum(len(v) for v in MISSING.values()) == len(listed)
    assert missing == listed, (sorted(missing - listed),
                               sorted(listed - missing))
    for module, ops in MISSING.items():
        for op in ops:
            assert jregistry.get_op(op).fn.__module__ == \
                "paddle_tpu." + module, op


@pytest.mark.parametrize("family", FULL_FAMILIES)
def test_family_is_ported(family):
    importlib.import_module(f"paddle_tpu.ops.{family}")
    ops = {op for op in jregistry.registered_ops()
           if jregistry.get_op(op).fn.__module__ == f"paddle_tpu.ops.{family}"}
    assert ops
    left = ops - set(tregistry.registered_ops())
    assert left == FAMILY_LEFT.get(family, set())
