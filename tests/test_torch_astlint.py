"""analysis/astlint.py of the port, on the CPU.

* The concurrency arm gives the JAX package's findings (rule, function,
  line, message) on tests/test_concurrency.py's fixture sources.
* The host arm flags what stalls the stream or breaks a CUDA-graph
  capture inside a registered op function: `.item()`, `.tolist()`,
  `.cpu()`, `.numpy()`, `np.asarray` of a tensor, `bool()` / `int()` /
  `float()` of one (also through a name assigned from it),
  `torch.cuda.synchronize()`, a host clock, an unseeded host draw; a
  `# host-ok` line, an op registered with `host=` and metadata reads
  (`x.shape`, `x.size(0)`) pass.
* Both arms over all of paddle_tpu_torch/ find nothing unmarked.
"""
import pathlib
import textwrap

import pytest

from paddle_tpu.analysis import astlint as jlint
from paddle_tpu_torch.analysis import astlint as tlint

PKG = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch"

CONC_FIXTURES = {
    "raw-lock": ("import threading\n"
                 "mu = threading.Lock()\n"
                 "ok = threading.Lock()  # lock-ok: test fixture\n", {}),
    "no-with": ("def f(mu):\n    mu.acquire()\n    mu.release()\n", {}),
    "thread-unbounded": ("import threading\n"
                         "t = threading.Thread(target=print)\n"
                         "t.start()\n", {}),
    "thread-joined": ("import threading\n"
                      "t = threading.Thread(target=print)\n"
                      "t.start()\nt.join()\n", {}),
    "thread-marked": ("import threading\n"
                      "t = threading.Thread(  # thread-ok: one-shot\n"
                      "    target=print)\n", {}),
    "thread-loop-alias": ("import threading\n"
                          "class P:\n"
                          "    def start(self):\n"
                          "        self._threads = [threading.Thread(\n"
                          "            target=print) for _ in range(4)]\n"
                          "    def stop(self):\n"
                          "        for t in self._threads:\n"
                          "            t.join()\n", {}),
    "wallclock-off": ("import time\ndef f():\n    return time.time()\n",
                      {}),
    "wallclock-on": ("import time\ndef f():\n    return time.time()\n",
                     {"wallclock_rule": True}),
    "wallclock-marked": ("import time\ndef f():\n"
                         "    return time.time()  # wallclock-ok: stamp\n",
                         {"wallclock_rule": True}),
    "guarded-by": ("class C:\n"
                   "    def __init__(self):\n"
                   "        self._mu = object()\n"
                   "        self._q = []  # guarded_by(_mu)\n"
                   "    def good(self):\n"
                   "        with self._mu:\n"
                   "            self._q.append(1)\n"
                   "    def bad(self):\n"
                   "        self._q.append(2)\n"
                   "    def holds_ok(self):  # holds(_mu)\n"
                   "        self._q.append(3)\n"
                   "    def escape_ok(self):\n"
                   "        return len(self._q)  # unlocked-ok: a stat\n",
                   {}),
}


@pytest.mark.parametrize("name", sorted(CONC_FIXTURES))
def test_concurrency_arm_matches_jax(name):
    src, kw = CONC_FIXTURES[name]
    got = [f.to_dict() for f in tlint.check_concurrency_source(
        src, "m.py", **kw)]
    want = [f.to_dict() for f in jlint.check_concurrency_source(
        src, "m.py", **kw)]
    assert got == want
    flagged = not any(m in name for m in ("joined", "marked", "alias",
                                          "off"))
    assert bool(got) == flagged, got


HOST_SRC = textwrap.dedent('''
    import time
    import numpy as np
    import torch
    from paddle_tpu_torch.core.registry import register_op

    @register_op("a", inputs=["X"], outputs=["Out"])
    def _a(ctx, x):
        n = x.item()
        y = x * 2
        rows = y.tolist()
        z = y.cpu()
        w = z.numpy()
        v = np.asarray(y)
        return x

    @register_op("b", inputs=["X", "Y"], outputs=["Out"])
    def _b(ctx, x, y):
        s = x.sum()
        if bool(s):
            pass
        k = int(y[0])
        f = float(x.float().mean())
        torch.cuda.synchronize()
        t = time.time()
        r = np.random.rand()
        return x

    @register_op("clean", inputs=["X"], outputs=["Out"])
    def _clean(ctx, x):
        n, c = int(x.shape[0]), int(x.size(1))
        m = x.dim()
        for d in x.shape:
            m *= int(d)
        rng = np.random.RandomState(0)
        ok = x.item()  # host-ok: the fixture's marked read
        return x.reshape(n, c)

    @register_op("host", inputs=["X"], outputs=["Out"], host="reads X")
    def _host(ctx, x):
        return x.item()

    def plain(x):
        return x.item()
''')


def test_host_arm_on_torch_fixtures():
    found = tlint.check_module_source(HOST_SRC, "ops.py")
    by_func = {}
    for f in found:
        by_func.setdefault(f.func.split("::")[1].split()[0], []).append(
            f.rule)
    assert by_func == {
        "_a": ["host-sync"] * 5,
        "_b": ["host-scalar"] * 3 + ["device-sync", "impure-time",
                                     "impure-random"],
    }, by_func
    assert all(isinstance(f.to_dict()["lineno"], int) for f in found)
    plain = tlint.check_module_source(HOST_SRC, "ops.py",
                                      include_plain_funcs=("plain",))
    assert len(plain) == len(found)      # no tensor names in `plain`


def test_the_port_lints_clean():
    out = tlint.lint_package(str(PKG))
    assert out == {}, {k: [f.to_dict() for f in v] for k, v in out.items()}
    # the rules do fire on the port's own code once a marker goes
    src = (PKG / "core" / "compile_cache.py").read_text()
    stripped = src.replace("# wallclock-ok", "#")
    hits = tlint.check_concurrency_source(stripped, "compile_cache.py",
                                          wallclock_rule=True)
    assert {f.rule for f in hits} == {"wall-clock-fake-clock"}
    src = (PKG / "core" / "scope.py").read_text().replace(
        'make_lock("core.scope")', "threading.Lock()")
    hits = tlint.check_concurrency_source(src, "scope.py")
    assert [f.rule for f in hits] == ["raw-threading-lock"]
