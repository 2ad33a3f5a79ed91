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

KV pools and state documents (`kv_from_numpy`, `kv_to_numpy`,
`state_doc_to_jax`): the paged engines of both packages keep int8 or
float8 e4m3 payloads with float32 scales. JAX's float8 arrays are
`ml_dtypes.float8_e4m3fn` numpy arrays; the port cannot import
`ml_dtypes` (a machine with only torch lacks it), so it moves e4m3
payloads to the host as their bytes in uint8, and these functions view
them as whichever dtype the other side needs, over the same bytes.

Static programs (`scope_from_jax`, `scope_to_numpy`): a Program's
persistable vars carry the same names in both packages, so a JAX scope's
arrays (as numpy, what `scope.find_np` gives) load into a port Scope by
name, on a chosen device, and back. The saved inference artifact
(`__model__.json` + `params.npz`) carries them between processes.

All these functions work on numpy arrays (what
`jax.tree_util.tree_map(np.asarray, params)` gives), so this module
imports neither JAX nor the JAX package.
"""
import collections

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.places import resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "bert_params_from_jax",
           "bert_params_to_numpy", "kv_from_numpy", "kv_to_numpy",
           "state_doc_to_jax", "scope_from_jax", "scope_to_numpy"]

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


def kv_from_numpy(arr, kv_dtype=None):
    """A KV payload or scale array (numpy) → a CPU tensor over the same
    bytes. An `ml_dtypes.float8_e4m3fn` array (a JAX pool or JAX state
    document), or a uint8 array when `kv_dtype` is "fp8_e4m3" (a port
    document), becomes a torch.float8_e4m3fn tensor; int8 and float32
    arrays keep their dtype."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "float8_e4m3fn" or (
            kv_dtype == "fp8_e4m3" and a.dtype == np.uint8):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    enforce(a.dtype in (np.int8, np.float32),
            "a KV array is float32, int8 or float8_e4m3fn, got %s", a.dtype)
    return torch.from_numpy(a.copy())


def kv_to_numpy(t, fp8_dtype=None):
    """A copy of a port KV tensor (any device) as numpy, over the same
    bytes: never a view of the tensor, which the engine overwrites in
    place. A float8_e4m3fn tensor comes back as its bytes in uint8, or
    viewed as `fp8_dtype` when given (e.g. `ml_dtypes.float8_e4m3fn`,
    for the JAX package)."""
    t = t.detach()
    if t.dtype == torch.float8_e4m3fn:
        a = t.view(torch.uint8).to("cpu", copy=True).numpy()
        return a if fp8_dtype is None else a.view(fp8_dtype)
    return t.to("cpu", copy=True).numpy()


def state_doc_to_jax(doc, fp8_dtype=None):
    """A port export_state document → one the JAX package's import_state
    takes: e4m3 payloads (uint8 here) viewed as `fp8_dtype`
    (`ml_dtypes.float8_e4m3fn`), every other field as it is. Both
    packages hash e4m3 bytes under the tag "float8_e4m3fn", so the
    document's crc32 stays valid. The port's import_state takes a JAX
    document as it is."""
    if doc.get("kv_dtype") != "fp8_e4m3":
        return dict(doc)
    enforce(fp8_dtype is not None,
            "an fp8_e4m3 document needs the JAX side's float8 dtype")
    out = dict(doc)
    out["kv"] = [dict(e, k=np.asarray(e["k"]).view(fp8_dtype),
                      v=np.asarray(e["v"]).view(fp8_dtype))
                 for e in doc.get("kv", ())]
    return out


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _array(t):
    return t.detach().to("cpu", torch.float32).numpy().copy()


def scope_from_jax(arrays, scope, device=None):
    """Put {name: numpy array} (a JAX scope's persistables) into a port
    `Scope` as tensors on `device`, copying each array. `device=None`
    means CUDA, and raises without a GPU, as every entry point does."""
    device = resolve_device(device)
    for name, arr in arrays.items():
        scope.set(name, torch.from_numpy(np.array(arr, copy=True)).to(device))
    return scope


def scope_to_numpy(scope, names):
    """{name: numpy copy} of the named vars of a port `Scope` (what a JAX
    scope's `set` takes)."""
    out = {}
    for name in names:
        arr = scope.find_np(name)
        enforce(arr is not None, "scope holds no var %r", name)
        out[name] = arr
    return out
