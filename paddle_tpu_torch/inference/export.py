"""Program export: the deployable artifact and the AOT serving bundle.

Counterpart of the export half of paddle_tpu/inference/__init__.py
(`_build_export_fn`, `export_stablehlo`, `StableHLORunner`,
`load_stablehlo`, `export_aot_bundle`, `_AOTRung`, `AOTBundle`,
`load_aot_bundle`). The JAX package lowers a Program to StableHLO text
that any PJRT runtime compiles; here `torch.export` is that artifact's
counterpart, an AOTInductor package XLA's serialized executable's, and
the libtorch binary `pt_aoti_run` (`native.build_pt_aoti_run`)
`pt_pjrt_run`'s:

* `export_program(program, feed_specs, dirname)` writes `model.pt2`
  (`torch.export.save` of one pure function, feed -> fetch, with the
  scope's parameters held as constants of the module) and `meta.json`
  with the JAX package's keys (`feeds`, `feed_order`, `fetches`),
  `format: "torch_export"` and the `device` it was traced on (where it
  loads). K8 is a registered op
  (`paddle_tpu_torch::fused_dequant_matmul`), so the graph of a frozen
  int8 program names the kernel, as the JAX package's StableHLO names
  its Pallas custom call;
* `load_exported(dirname)` / `ExportedRunner` serve from the artifact
  alone, never from the Program, checking every feed's name, shape and
  dtype;
* `export_aot_bundle` / `load_aot_bundle` / `AOTBundle`: the whole
  bucket ladder, one `bucket_<b>/` directory a rung, CRC-manifested in
  `BUNDLE.json` (published atomically), format `"ptt-aot-bundle-v1"`
  stamped with `core.compile_cache.device_stamp()`. A rung's tiers, best
  first: `native` (`model.aoti.pt2`, the rung's exported program
  compiled by `torch._inductor.aoti_compile_and_package`, loaded only
  where the stamp matches; written only by an export on the card, as
  the JAX package writes its native tier only where the backend
  serializes executables) and `exported` (`model.pt2` through
  `ExportedRunner`). A rung with no viable tier raises at load, listing
  every tier's failure.

`export_stablehlo`, `load_stablehlo` and `StableHLORunner` are aliases,
so code written against the JAX package runs unchanged; the artifact's
`format` says what it is.

Where the port differs: a program whose capture plan has a host segment
(a `while` or `conditional_block` reading its condition on the host, a
`py_func`) is refused, naming the op, where the JAX package lowers it
through `lax.while_loop` (ROADMAP Queue 3). Entry points take
`device=None`, which means the card and raises without one.
"""
import json
import os
import time

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.places import resolve_device

__all__ = ["EXPORT_FORMAT", "BUNDLE_FORMAT", "export_program",
           "ExportedRunner", "load_exported", "export_stablehlo",
           "StableHLORunner", "load_stablehlo", "export_aot_bundle",
           "AOTBundle", "load_aot_bundle"]

EXPORT_FORMAT = "torch_export"
BUNDLE_FORMAT = "ptt-aot-bundle-v1"
#: the stamp keys a native tier must match to be loaded
STAMP_KEYS = ("platform", "device_kind", "capability", "torch", "cuda",
              "kernels")


class _ProgramModule(torch.nn.Module):
    """One pure function of a Program, feed -> fetch: the step function
    over the state held as buffers (constants of the exported module)."""

    def __init__(self, step, state, feeds):
        super().__init__()
        self._step = step
        self._feeds = list(feeds)
        self._names = list(state)
        for i, name in enumerate(self._names):
            self.register_buffer(f"state_{i}", state[name])

    def forward(self, *feed_vals):
        state = {n: getattr(self, f"state_{i}")
                 for i, n in enumerate(self._names)}
        outs, _ = self._step(state, dict(zip(self._feeds, feed_vals)), 0)
        return tuple(outs)


def _refuse_host_segments(program):
    from paddle_tpu_torch.core.lowering import capture_plan
    ops = program.blocks[0].ops
    for seg in capture_plan(program):
        if seg.kind == "host":
            enforce(False, "export: op %d %r runs on the host (%s); "
                    "torch.export takes a program without host segments "
                    "(the JAX package lowers it through lax.while_loop)",
                    seg.start, ops[seg.start].type, seg.reason)
        enforce(seg.kind == "graph", "export: %s", seg.reason)


def _state_tensor(value, device):
    if isinstance(value, torch.Tensor):
        return value.detach().clone().to(device)
    return torch.from_numpy(np.array(value, copy=True)).to(device)


def _build_export_fn(program, feed_specs, scope=None, device=None):
    """The export lowering: (module, example args, feed order, fetch
    names) of the feed -> fetch function with the scope's parameters
    baked in as constants."""
    from paddle_tpu_torch.core.lowering import make_step_fn, referenced_state
    from paddle_tpu_torch.core.scope import global_scope
    # K8's op must be registered before a frozen int8 program is traced
    from paddle_tpu_torch.ops.kernels import quantized_matmul  # noqa: F401

    device = resolve_device(device)
    scope = global_scope() if scope is None else scope
    feeds = program.meta.get("feed_targets") or list(feed_specs)
    fetches = program.meta.get("fetch_targets")
    enforce(fetches, "program has no fetch_targets meta: export via "
            "save_inference_model first or set program.meta")
    for n in feeds:
        enforce(n in feed_specs, "export: no feed spec for %r", n)
    _refuse_host_segments(program)
    names = referenced_state(program, scope)
    state = {n: _state_tensor(scope.get(n), device) for n in names}
    step = make_step_fn(program, feeds, fetches, names, training=False,
                        device=device)
    module = _ProgramModule(step, state, feeds).eval()
    args = tuple(torch.from_numpy(np.zeros(tuple(shape), np.dtype(dtype)))
                 .to(device) for shape, dtype in
                 (feed_specs[n] for n in feeds))
    return module, args, list(feeds), list(fetches)


def _export(program, feed_specs, dirname, scope, device):
    """Export one rung: writes model.pt2 and meta.json, returns (path,
    ExportedProgram)."""
    module, args, feeds, fetches = _build_export_fn(program, feed_specs,
                                                    scope, device)
    with torch.no_grad():
        ep = torch.export.export(module, args)
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, "model.pt2")
    torch.export.save(ep, path)
    meta = {"feeds": {n: [list(feed_specs[n][0]),
                          str(np.dtype(feed_specs[n][1]))] for n in feeds},
            # explicit order: a JSON object carries none for non-Python
            # readers (pt_aoti_run binds its inputs by it)
            "feed_order": feeds, "fetches": fetches,
            "format": EXPORT_FORMAT, "device": resolve_device(device).type}
    with open(os.path.join(dirname, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path, ep


def export_program(program, feed_specs, dirname, scope=None, device=None):
    """Export the program's feed -> fetch function, its parameters held
    as constants, with `torch.export`: the deployable artifact.

    feed_specs: {feed name: (shape, dtype)} with concrete shapes. The
    program is traced on `device` (None: the card). Writes
    <dirname>/model.pt2 + meta.json; returns the model's path."""
    return _export(program, feed_specs, dirname, scope, device)[0]


def _read_meta(dirname):
    path = os.path.join(dirname, "meta.json")
    enforce(os.path.isfile(path), "no meta.json in %s", dirname)
    with open(path) as f:
        meta = json.load(f)
    enforce(meta.get("format") == EXPORT_FORMAT,
            "%s holds a %r artifact, not %r (the JAX package's StableHLO "
            "text does not load here)", dirname, meta.get("format"),
            EXPORT_FORMAT)
    return meta


def _feed_args(meta, feed, device, who):
    """The feeds in meta's order as tensors on `device`, each converted
    to the exported dtype and checked against the exported name and
    shape."""
    args = []
    for n in meta.get("feed_order", list(meta["feeds"])):
        enforce(n in feed, "%s: missing feed %r", who, n)
        shape, dtype = meta["feeds"][n]
        a = np.ascontiguousarray(np.asarray(feed[n], dtype=dtype))
        enforce(list(a.shape) == list(shape),
                "feed %r shape %s != exported %s", n, a.shape, shape)
        args.append(torch.from_numpy(a).to(device))
    return args


class ExportedRunner:
    """Load-and-execute side of `export_program`: serves the artifact
    alone (NOT the original Program) on `device` (None: the card)."""

    def __init__(self, dirname, device=None):
        # K8's op must be registered before a graph naming it loads
        from paddle_tpu_torch.ops.kernels import quantized_matmul  # noqa
        self.device = resolve_device(device)
        self.meta = _read_meta(dirname)
        enforce(self.meta["device"] == self.device.type, "%s was exported "
                "on %s; load it there, not on %s", dirname,
                self.meta["device"], self.device.type)
        self.feed_order = self.meta.get("feed_order",
                                        list(self.meta["feeds"]))
        self.exported_program = torch.export.load(
            os.path.join(dirname, "model.pt2"))
        self._module = self.exported_program.module()

    def run(self, feed):
        """feed: {name: array} -> list of np.ndarray fetch values."""
        args = _feed_args(self.meta, feed, self.device, "ExportedRunner")
        with torch.no_grad():
            outs = self._module(*args)
        return [o.cpu().numpy() for o in outs]


def load_exported(dirname, device=None):
    """Load an exported artifact for serving on `device` (None: the
    card)."""
    return ExportedRunner(dirname, device=device)


export_stablehlo = export_program
StableHLORunner = ExportedRunner
load_stablehlo = load_exported


# ---- AOT serving-ladder bundle ------------------------------------------

def _crc(dirname, relpath, files):
    from paddle_tpu_torch.reliability.checkpoint import _crc32_file
    p = os.path.join(dirname, relpath)
    files[relpath] = {"size": os.path.getsize(p), "crc32": _crc32_file(p)}


#: C++ compilers AOTInductor may use, in order: its wrapper is linked
#: with -fopenmp, which a toolchain without libgomp refuses
AOTI_CXX = ("g++", "c++", "/usr/bin/g++", "/usr/bin/c++", "clang++")
_aoti_cxx = []


def aoti_compiler():
    """The first of $CXX and AOTI_CXX that links a program with
    -fopenmp (probed once a process); raises naming each refusal."""
    if _aoti_cxx:
        return _aoti_cxx[0]
    import shutil
    import subprocess
    import tempfile
    tried = []
    for name in (os.environ.get("CXX"),) + AOTI_CXX:
        path = shutil.which(name) if name else None
        if path is None or path in (t for t, _ in tried):
            continue
        with tempfile.TemporaryDirectory() as d:
            proc = subprocess.run(
                [path, "-fopenmp", "-x", "c++", "-", "-o",
                 os.path.join(d, "a.out")], input="int main() { return 0; }",
                capture_output=True, text=True, timeout=120)
        if proc.returncode == 0:
            _aoti_cxx.append(path)
            return path
        tried.append((path, proc.stderr.strip().splitlines()[-1:]))
    raise RuntimeError(f"no C++ compiler links with -fopenmp for "
                       f"AOTInductor; tried {tried}")


def _compile_aoti(ep, path):
    """AOTInductor: the exported program compiled into a package that
    Python (`aoti_load_package`) or libtorch (`pt_aoti_run`) loads."""
    import torch._inductor
    return torch._inductor.aoti_compile_and_package(
        ep, package_path=path,
        inductor_configs={"cpp.cxx": (aoti_compiler(),)})


def export_aot_bundle(program, feed_specs, dirname, buckets=None,
                      scope=None, device=None, native=None):
    """Export the whole serving bucket ladder as one AOT bundle: each
    rung ships its exported program (`model.pt2` + `meta.json`, the
    `export_program` layout) and, where `native` (None: when `device` is
    the card), its AOTInductor package `model.aoti.pt2`.

    feed_specs: {name: (shape, dtype)}; `buckets` replaces each shape's
    leading (batch) dim per rung; None exports one rung as it is. Writes
    BUNDLE.json (CRC-manifested, published with os.replace) and returns
    its path. Each rung records its export and compile seconds."""
    from paddle_tpu_torch.core.compile_cache import device_stamp

    device = resolve_device(device)
    if native is None:
        native = device.type == "cuda"
    feeds = program.meta.get("feed_targets") or list(feed_specs)
    rungs = sorted(set(int(b) for b in buckets)) if buckets else [None]
    os.makedirs(dirname, exist_ok=True)
    bundle = {"format": BUNDLE_FORMAT, "stamp": device_stamp(),
              "feed_order": list(feeds), "buckets": [], "files": {}}
    for b in rungs:
        if b is None:
            specs, sub = dict(feed_specs), "bucket_default"
        else:
            specs = {n: ((b,) + tuple(shape[1:]), dtype)
                     for n, (shape, dtype) in feed_specs.items()}
            sub = f"bucket_{b}"
        rung_dir = os.path.join(dirname, sub)
        t0 = time.perf_counter()
        _, ep = _export(program, specs, rung_dir, scope, device)
        rung = {"bucket": b, "dir": sub, "tiers": ["exported"],
                "fetches": program.meta.get("fetch_targets"),
                "export_seconds": time.perf_counter() - t0}
        for name in ("model.pt2", "meta.json"):
            _crc(dirname, os.path.join(sub, name), bundle["files"])
        if native:
            t0 = time.perf_counter()
            _compile_aoti(ep, os.path.join(rung_dir, "model.aoti.pt2"))
            rung["aoti_seconds"] = time.perf_counter() - t0
            _crc(dirname, os.path.join(sub, "model.aoti.pt2"),
                 bundle["files"])
            rung["tiers"].insert(0, "native")
        bundle["buckets"].append(rung)
    tmp = os.path.join(dirname, f"BUNDLE.json.tmp-{os.getpid()}")
    path = os.path.join(dirname, "BUNDLE.json")
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=1)
    os.replace(tmp, path)
    return path


class _AOTRung:
    """One loaded bundle rung: run(feed) -> [numpy arrays] through its
    best viable tier."""

    def __init__(self, tier, meta, rung, call, device):
        self.tier = tier
        self._meta = meta
        self._rung = rung
        self._call = call
        self.device = device

    def run(self, feed):
        args = _feed_args(self._meta, feed, self.device, "AOT bundle")
        with torch.no_grad():
            outs = self._call(args)
        return [o.cpu().numpy() for o in outs]


def _load_aoti(path, device):
    """The native tier's runner: the AOTInductor package loaded on the
    device it was compiled for."""
    import torch._inductor
    loaded = torch._inductor.aoti_load_package(path)
    return lambda args: list(loaded(*args))


class AOTBundle:
    """A loaded `export_aot_bundle` artifact: one runner per bucket rung
    (`runners[bucket].run(feed)`, its tier in `tiers[bucket]`), each the
    best tier that loads: `native` where the stamp matches, else
    `exported`; a rung with no viable tier raises at load with every
    tier's failure."""

    def __init__(self, dirname, device=None):
        from paddle_tpu_torch.core.compile_cache import device_stamp
        from paddle_tpu_torch.reliability.checkpoint import _crc32_file

        self.device = resolve_device(device)
        path = os.path.join(dirname, "BUNDLE.json")
        enforce(os.path.isfile(path), "AOT bundle file missing: BUNDLE.json")
        with open(path) as f:
            self.bundle = json.load(f)
        fmt = self.bundle.get("format")
        enforce(fmt == BUNDLE_FORMAT, "AOT bundle format %r is not %r (the "
                "JAX package's bundles do not load in the port)", fmt,
                BUNDLE_FORMAT)
        for rel, rec in self.bundle.get("files", {}).items():
            p = os.path.join(dirname, rel)
            enforce(os.path.isfile(p), "AOT bundle file missing: %s", rel)
            enforce(os.path.getsize(p) == rec["size"]
                    and _crc32_file(p) == rec["crc32"],
                    "AOT bundle file corrupt (size/CRC): %s", rel)
        saved, now = self.bundle.get("stamp", {}), device_stamp()
        self.stamp_ok = all(saved.get(k) == now.get(k) for k in STAMP_KEYS)
        self.runners, self.tiers, self.errors = {}, {}, {}
        for rung in self.bundle["buckets"]:
            runner = self._load_rung(dirname, rung)
            self.runners[rung["bucket"]] = runner
            self.tiers[rung["bucket"]] = runner.tier

    def _load_rung(self, dirname, rung):
        rung_dir = os.path.join(dirname, rung["dir"])
        errors = []
        meta = None
        try:
            meta = _read_meta(rung_dir)
        except Exception as e:  # every tier reads it: all fail below
            errors.append(f"meta.json: {e}")
        native_path = os.path.join(rung_dir, "model.aoti.pt2")
        if meta is None:
            pass
        elif "native" not in rung.get("tiers", ()):
            errors.append("native: not in this bundle (exported off the "
                          "card)")
        elif not self.stamp_ok:
            errors.append("native: device stamp mismatch")
        elif meta.get("device") != self.device.type:
            errors.append(f"native: compiled for {meta.get('device')}, "
                          f"loading on {self.device.type}")
        else:
            try:
                call = _load_aoti(native_path, self.device)
                self.errors[rung["bucket"]] = errors
                return _AOTRung("native", meta, rung, call, self.device)
            except Exception as e:
                errors.append(f"native: {e}")
        if meta is not None:
            try:
                runner = ExportedRunner(rung_dir, device=self.device)
                self.errors[rung["bucket"]] = errors
                return _AOTRung("exported", meta, rung,
                                lambda args, _m=runner._module: list(
                                    _m(*args)), self.device)
            except Exception as e:
                errors.append(f"exported: {e}")
        raise RuntimeError(f"AOT bundle rung {rung['dir']}: no viable tier "
                           f"({'; '.join(errors)})")


def load_aot_bundle(dirname, device=None):
    """Load an `export_aot_bundle` artifact for warm serving on `device`
    (None: the card)."""
    return AOTBundle(dirname, device=device)
