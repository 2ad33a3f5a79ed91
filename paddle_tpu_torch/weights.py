"""Moving model weights between the JAX package and the port.

TinyDecoderLM (`params_from_jax`, `params_to_numpy`):

The JAX model keeps its weights as a params pytree
({"layers": [per-layer dict, ...], "tok_emb", "pos_emb", "lnf_g",
"lnf_b", "head"}), every matrix `[in, out]` with `x @ w`. The port keeps
that layout as plain `nn.Parameter`s under the same names, so the
mapping is by name with no transposes, and a round trip is exact.

Bert (`bert_params_from_jax`, `bert_params_to_numpy`): the JAX model's
`trainable_dict()` is flat, with names such as
`layers.i0.attn.qkv.weight`; the port's `Bert.state_dict()` has the same
names and `[in, out]` layouts, so the mapping is by name.

All four functions work on numpy arrays (what
`jax.tree_util.tree_map(np.asarray, params)` gives), so this module
imports neither JAX nor the JAX package.
"""
import collections

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["params_from_jax", "params_to_numpy", "bert_params_from_jax",
           "bert_params_to_numpy"]

_TOP = ("tok_emb", "pos_emb", "lnf_g", "lnf_b", "head")
_LAYER = ("ln1_g", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2_g", "ln2_b",
          "w1", "b1", "w2", "b2")


def params_from_jax(tree):
    """JAX params pytree (nested dict/list of arrays) → a state dict for
    the port's `TinyDecoderLM.load_state_dict`: float32 CPU tensors
    named "tok_emb", "layers.<i>.wqkv", ..."""
    enforce(isinstance(tree, dict) and "layers" in tree,
            "expected a TinyDecoderLM params tree with a 'layers' list")
    out = collections.OrderedDict()
    for i, layer in enumerate(tree["layers"]):
        enforce(set(layer) == set(_LAYER),
                "layer %d has keys %s, expected %s", i, sorted(layer),
                sorted(_LAYER))
        for name in _LAYER:
            out[f"layers.{i}.{name}"] = _tensor(layer[name])
    for name in _TOP:
        out[name] = _tensor(tree[name])
    return out


def params_to_numpy(module):
    """The port's TinyDecoderLM → the JAX params pytree layout, as
    float32 numpy arrays (what the JAX model's functions accept after
    jnp.asarray)."""
    state = module.state_dict()
    layers = []
    for i in range(len(module.layers)):
        layers.append({name: _array(state[f"layers.{i}.{name}"])
                       for name in _LAYER})
    tree = {"layers": layers}
    for name in _TOP:
        tree[name] = _array(state[name])
    return tree


def bert_params_from_jax(flat):
    """JAX `Bert.trainable_dict()` as {name: numpy array} → a state dict
    for the port's `Bert.load_state_dict`: CPU tensors under the same
    names, float32 (bfloat16 arrays, as `ml_dtypes` gives them, become
    bfloat16 tensors with the same values)."""
    enforce(isinstance(flat, dict) and "tok_emb.weight" in flat,
            "expected a flat Bert trainable_dict with 'tok_emb.weight'")
    out = collections.OrderedDict()
    for name, a in flat.items():
        a = np.asarray(a)
        t = _tensor(a)
        if a.dtype.name == "bfloat16":
            t = t.to(torch.bfloat16)
        out[name] = t
    return out


def bert_params_to_numpy(module):
    """The port's Bert → {name: float32 numpy array} in the JAX
    `trainable_dict()` layout (bfloat16 values are exact in float32)."""
    return collections.OrderedDict(
        (name, _array(p)) for name, p in module.named_parameters())


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _array(t):
    return t.detach().to("cpu", torch.float32).numpy().copy()
