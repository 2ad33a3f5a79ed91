"""Inference engine.

Counterpart of paddle_tpu/inference/__init__.py (the reference's
AnalysisPredictor + ZeroCopyRun, api/analysis_predictor.h:47, and
AnalysisConfig):

* `Config`: the model path and precision (float32, bfloat16 through
  the AMP program rewrite at load, or int8 with post-training
  quantization at load). `device=None` means the GPU;
  `disable_gpu()` selects the CPU, as in the reference API. The device is
  resolved when the predictor is created, which raises without a GPU
  unless the CPU was selected.
* `Predictor`: loads a saved inference model into a private scope on its
  device, runs the export passes on old (un-optimized) artifacts, applies
  the precision (bfloat16: `amp.rewrite_program`; int8: the freeze pass
  on a QAT model, PTQ with the config's calibration loader otherwise)
  and serves
  `get_input_handle` / `run` / `get_output_handle`.
* `create_predictor`, `Predictor.clone` (shares weights, private
  handles).

On the card a Predictor's requests replay its Executor's captured
graphs, one entry per feed signature (batch 1, 8 and 32 are three); the
first request of a signature captures it. A clone shares the Executor,
so its requests and the original's are serialised on the Executor's
graphs: two threads never interleave one entry's input copies, replays
and output copies.

`Config.enable_native_engine()` serves float32 through the C++
Program-IR interpreter instead (`paddle_tpu_torch.native`, the
pd_predictor_* C API, as the reference's NativePredictor): host-only,
requests touch no tensor of torch's; an artifact saved without the
export passes gets them first, written to `ir_opt_cache/` beside it.

Not ported in this slice, and raising NotImplementedError: StableHLO
export and the AOT bundle (ROADMAP Queue 1 item 9).
"""
import json
import os

import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.reliability.faults import inject_point

__all__ = ["PrecisionType", "Config", "Predictor", "create_predictor"]


class PrecisionType:
    Float32 = "float32"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


class Config:
    """AnalysisConfig parity."""

    def __init__(self, model_dir=None, model_filename=None,
                 params_filename=None, device=None):
        self.model_dir = model_dir
        self.model_filename = model_filename
        self.params_filename = params_filename
        self.device = device
        self.precision = PrecisionType.Float32
        self.use_native_engine = False
        self._calib_loader = None
        self.ir_optim = True

    def disable_gpu(self):
        self.device = "cpu"

    def enable_int8(self, calibration_loader=None):
        """int8 inference. A QAT-trained model needs no loader (its
        scales are in the model); a float model needs a calibration data
        loader (an iterable of feed dicts): PTQ runs at load."""
        self.precision = PrecisionType.Int8
        self._calib_loader = calibration_loader

    def switch_ir_optim(self, flag=True):
        """Rerun the export pass list at load on artifacts that were not
        optimized at save."""
        self.ir_optim = bool(flag)

    def enable_bfloat16(self):
        """Serve in bfloat16: the AMP rewrite casts around the matmuls
        and convolutions at load (parameters stay float32)."""
        self.precision = PrecisionType.Bfloat16

    def enable_native_engine(self):
        """Serve through the C++ interpreter (the reference's
        NativePredictor against AnalysisPredictor, api/api_impl.cc):
        float32 on the host; create_predictor raises NativeBuildError
        when the library does not build (nothing falls back)."""
        self.use_native_engine = True


class _Handle:
    """Zero-copy-style tensor handle (ZeroCopyTensor parity)."""

    def __init__(self, name):
        self.name = name
        self._value = None
        self._shape = None

    def copy_from_cpu(self, arr):
        self._value = np.array(arr, copy=True, order="C")
        if self._shape is not None:  # reference call order: reshape first
            self._value = self._value.reshape(self._shape)

    def reshape(self, shape):
        self._shape = tuple(shape)
        if self._value is not None:
            self._value = self._value.reshape(self._shape)

    def copy_to_cpu(self):
        return np.array(self._value, copy=True)

    @property
    def shape(self):
        return None if self._value is None else self._value.shape


class Predictor:
    """AnalysisPredictor parity: one loaded model, persistent state on the
    device, run through an Executor (captured graphs on the card)."""

    def __init__(self, config):
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.scope import Scope, scope_guard
        from paddle_tpu_torch.static import io

        self.config = config
        self._exe = Executor(config.device)
        self._scope = Scope()
        with scope_guard(self._scope):
            prog, feeds, fetches = io.load_inference_model(
                config.model_dir, self._exe,
                model_filename=config.model_filename,
                params_filename=config.params_filename)
        self._program = prog
        self._fetch_vars = fetches
        if config.ir_optim:
            self._optimize_loaded()
        self._init_handles(feeds, [v.name for v in fetches])
        self._apply_precision()

    def _init_handles(self, feed_names, fetch_names):
        self._feed_order = list(feed_names)
        self._fetch_order = list(fetch_names)
        self._inputs = {n: _Handle(n) for n in self._feed_order}
        self._outputs = {n: _Handle(n) for n in self._fetch_order}

    def _optimize_loaded(self):
        """Run the export pass list on a loaded program that was NOT
        optimized at save; fresh exports carry meta['ir_optimized']."""
        if self._program.meta.get("ir_optimized"):
            return
        from paddle_tpu_torch.inference.optimize import (
            optimize_inference_program,
        )
        params = {v.name: self._scope.find_np(v.name)
                  for v in self._program.list_vars()
                  if v.persistable and self._scope.has(v.name)}
        before = dict(params)
        self._program, params = optimize_inference_program(self._program,
                                                           params)
        for n, arr in params.items():
            if before.get(n) is not arr:   # only what a pass rewrote
                self._scope.set(n, arr)
        for n in set(before) - set(params):
            self._scope.erase(n)
        self._program._version += 1

    def _apply_precision(self):
        if self.config.precision == PrecisionType.Bfloat16:
            from paddle_tpu_torch.amp.decorator import rewrite_program
            rewrite_program(self._program, dest_dtype="bfloat16")
            return
        if self.config.precision != PrecisionType.Int8:
            return
        from paddle_tpu_torch import slim
        qat = any(op.attrs.get("quantization_type") == "qat"
                  for op in self._program.global_block().ops)
        if qat:
            slim.QuantizationFreezePass().apply(self._program, self._scope)
            return
        enforce(self.config._calib_loader is not None,
                "int8 on a float model needs a calibration loader "
                "(Config.enable_int8(loader))")
        slim.PostTrainingQuantization(
            self._exe, self._program, self._feed_order,
            self.config._calib_loader, scope=self._scope).quantize()

    def get_input_names(self):
        return list(self._feed_order)

    def get_output_names(self):
        return list(self._fetch_order)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_handle(self, name):
        return self._outputs[name]

    def run(self, feed=None, fetch_list=None):
        """ZeroCopyRun: runs on the input handles' contents (or an
        explicit feed dict), fills the output handles and returns the
        outputs in get_output_names order (numpy arrays). `fetch_list`
        fetches other vars of the program besides (returned after the
        outputs, not put in handles)."""
        if feed is None:
            feed = {}
            for n, h in self._inputs.items():
                enforce(h._value is not None,
                        "input %s not set (copy_from_cpu)", n)
                feed[n] = h._value
        extra = list(fetch_list or [])
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_order + extra,
                             scope=self._scope, training=False)
        # reliability choke point: seeded fault plans fail, delay or poison
        # whole predictor runs here
        outs = inject_point("predictor.run", value=outs)
        for n, o in zip(self._fetch_order, outs):
            self._outputs[n]._value = o
        return outs

    def clone(self):
        """AnalysisPredictor::Clone: a predictor sharing the loaded
        weights, the program and the executor's step functions, with
        private input/output handles."""
        c = object.__new__(Predictor)
        c.config = self.config
        c._exe = self._exe
        c._scope = self._scope
        c._program = self._program
        c._fetch_vars = self._fetch_vars
        c._init_handles(list(self._feed_order),
                        [v.name for v in self._fetch_vars])
        return c


class _NativeEnginePredictor(Predictor):
    """The Predictor's handle surface over the C++ interpreter
    (Config.enable_native_engine)."""

    def __init__(self, config):
        from paddle_tpu_torch import native
        enforce(config.precision == PrecisionType.Float32,
                "the native engine serves float32")
        self.config = config
        self._pred = native.NativePredictor(
            self._maybe_optimize_artifact(config), config.model_filename,
            config.params_filename)
        self._init_handles(self._pred.input_names(),
                           self._pred.output_names())
        # the saved program's declared feed dtypes: both engines cast
        # feeds alike (the Executor in _prepare_feed)
        with open(os.path.join(
                config.model_dir,
                config.model_filename or "__model__.json")) as f:
            feed_vars = json.load(f)["blocks"][0]["vars"]
        self._feed_dtypes = {n: feed_vars[n].get("dtype") or "float32"
                             for n in self._feed_order if n in feed_vars}

    @staticmethod
    def _maybe_optimize_artifact(config):
        """An artifact saved without the export passes gets them before
        the interpreter loads it, written to `ir_opt_cache/` beside it
        (built in a temporary directory and renamed into place); a
        read-only model directory serves the artifact as it is."""
        import shutil
        import tempfile
        if not config.ir_optim:
            return config.model_dir
        mf = config.model_filename or "__model__.json"
        pf = config.params_filename or "params.npz"
        try:
            with open(os.path.join(config.model_dir, mf)) as f:
                model = json.load(f)
        except OSError:
            return config.model_dir   # the C++ loader reports the error
        if model.get("meta", {}).get("ir_optimized"):
            return config.model_dir
        cache = os.path.join(config.model_dir, "ir_opt_cache")

        def src_sig():
            return "|".join(
                f"{fn}:{st.st_size}:{st.st_mtime_ns}"
                for fn, st in ((fn, os.stat(os.path.join(
                    config.model_dir, fn))) for fn in (mf, pf)))

        try:
            with open(os.path.join(cache, ".src_sig")) as f:
                if f.read().strip() == src_sig() and \
                        os.path.exists(os.path.join(cache, mf)):
                    return cache
        except OSError:
            pass
        from paddle_tpu_torch.core.ir import Program
        from paddle_tpu_torch.inference.optimize import (
            optimize_inference_program,
        )
        program = Program.from_dict(model)
        with np.load(os.path.join(config.model_dir, pf)) as data:
            params = {n: np.asarray(data[n]) for n in data.files}
        program, params = optimize_inference_program(program, params)
        program.meta["ir_optimized"] = True
        try:
            tmp = tempfile.mkdtemp(dir=config.model_dir,
                                   prefix=".ir_opt_tmp")
            with open(os.path.join(tmp, pf), "wb") as f:
                np.savez(f, **params)
            with open(os.path.join(tmp, ".src_sig"), "w") as f:
                f.write(src_sig())
            with open(os.path.join(tmp, mf), "w") as f:
                json.dump(program.to_dict(), f)
            shutil.rmtree(cache, ignore_errors=True)
            try:
                os.rename(tmp, cache)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)   # raced: reuse
            return (cache if os.path.exists(os.path.join(cache, mf))
                    else config.model_dir)
        except OSError:
            return config.model_dir

    def run(self, feed=None, fetch_list=None):
        """ZeroCopyRun on the interpreter; `fetch_list` is refused (the
        C API returns the saved fetch targets only)."""
        enforce(not fetch_list, "the native engine fetches only the "
                "saved fetch targets")
        if feed is None:
            feed = {}
            for n, h in self._inputs.items():
                enforce(h._value is not None,
                        "input %s not set (copy_from_cpu)", n)
                feed[n] = h._value
        cast = {}
        for n, a in feed.items():
            a = np.asarray(a)
            want = self._feed_dtypes.get(n)
            cast[n] = a.astype(want) if want and str(a.dtype) != want else a
        outs = inject_point("predictor.run", value=self._pred.run(cast))
        for n, o in zip(self._fetch_order, outs):
            self._outputs[n]._value = np.asarray(o)
        return outs

    def clone(self):
        """A clone sharing the C++ model (weights and parsed program),
        with its own handles."""
        c = object.__new__(_NativeEnginePredictor)
        c.config = self.config
        c._pred = self._pred.clone()
        c._feed_dtypes = self._feed_dtypes
        c._init_handles(list(self._feed_order), list(self._fetch_order))
        return c


def create_predictor(config):
    """paddle_infer::CreatePredictor parity: the Executor's Predictor, or
    the C++ interpreter after `Config.enable_native_engine()`."""
    if config.use_native_engine:
        return _NativeEnginePredictor(config)
    return Predictor(config)


def export_stablehlo(*args, **kwargs):
    raise NotImplementedError(
        "StableHLO export has no counterpart in the port yet (ROADMAP "
        "Queue 1 item 9: torch.export or out of scope)")


def export_aot_bundle(*args, **kwargs):
    raise NotImplementedError(
        "the AOT serving bundle has no counterpart in the port yet (ROADMAP "
        "Queue 1 items 9 and 13)")
