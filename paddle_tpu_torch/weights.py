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

Eager layers (`layer_state_from_jax`, `layer_state_to_numpy`): a JAX
`nn.Layer`'s parameters (`trainable_dict()`) and buffers (the rest of
its `state_dict()`: batch norm's `mean` / `var`, the Transformer's `pe`,
SpectralNorm's `u` / `v`) carry flat names that the port's layers share,
with the same layouts, so both move by name.

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
           "bert_params_to_numpy", "layer_state_from_jax",
           "layer_state_to_numpy", "kv_from_numpy", "kv_to_numpy",
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


def layer_state_from_jax(flat_params, flat_buffers, module):
    """Copy a JAX layer's {name: array} parameters and buffers into the
    port's `module` in place, by name, each keeping the module's dtype
    and device (bfloat16 arrays, as `ml_dtypes` gives them, go through
    float32, which holds them exactly). The names must be exactly the
    module's parameters and buffers. Returns the module."""
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    for kind, given, own in (("parameters", flat_params, params),
                             ("buffers", flat_buffers, buffers)):
        enforce(set(given) == set(own), "%s differ: JAX only %s, port only "
                "%s", kind, sorted(set(given) - set(own)),
                sorted(set(own) - set(given)))
        with torch.no_grad():
            for name, a in given.items():
                a = np.asarray(a)
                enforce(tuple(a.shape) == tuple(own[name].shape),
                        "%s: JAX shape %s, port %s", name, a.shape,
                        tuple(own[name].shape))
                if a.dtype.name == "bfloat16":
                    a = a.astype(np.float32)
                own[name].copy_(torch.from_numpy(np.array(a, copy=True)))
    return module


def layer_state_to_numpy(module):
    """The port's layer -> ({name: parameter}, {name: buffer}) as numpy
    copies in their own dtypes (bfloat16 as float32), what a JAX layer's
    `load_trainable` / `set_state_dict` take after jnp.asarray."""
    def host(t):
        t = t.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return ({k: host(p) for k, p in module.named_parameters()},
            {k: host(b) for k, b in module.named_buffers()})


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


def scope_from_jax(arrays, scope, device=None, program=None):
    """Put {name: numpy array} (a JAX scope's persistables) into a port
    `Scope` as tensors on `device`, copying each array. `device=None`
    means CUDA, and raises without a GPU, as every entry point does.

    Optimizer state moves like the parameters: the accumulators are
    persistable vars named `{param}_{suffix}_{optimizer name}`
    (`_moment1_Adam`, `_inf_norm_Adamax`, `_mean_square_RMSProp`, ...),
    the rate `learning_rate_{optimizer name}` and the LR schedulers'
    step counter `lr_global_step`, in both packages. Given the training
    `program`, every persistable var it declares must be in `arrays`
    (a missing accumulator or counter raises instead of restarting
    from zero), and each array takes the var's declared shape and dtype
    (the JAX package holds a declared int64 as int32 with x64 off)."""
    device = resolve_device(device)
    if program is not None:
        from paddle_tpu_torch.core import dtypes
        arrays = dict(arrays)
        for v in program.list_vars():
            if not v.persistable:
                continue
            enforce(v.name in arrays, "the JAX state has no var %r", v.name)
            arr = np.asarray(arrays[v.name])
            if v.shape is not None:
                enforce(tuple(arr.shape) == tuple(v.shape),
                        "var %r: shape %s, declared %s", v.name,
                        tuple(arr.shape), tuple(v.shape))
            if v.dtype is not None:
                arrays[v.name] = arr.astype(dtypes.numpy_dtype(v.dtype))
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
