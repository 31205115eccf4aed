"""XF11x host-sync taint: device values blocking the port's hot loops.

CUDA launches are asynchronous: the host runs ahead of the card until
something asks for a value the card has not produced yet. Each such
read (`.item()`, `.cpu()`, a Python `if` on a tensor) drains the stream
and leaves the card idle while the host catches up. The port keeps the
reference's answer, the one-step-behind discipline (StepTimer,
HealthMonitor, the trainer's staged records): a step's metrics are read
only AFTER the next step's dispatch, so the blocking read hides under
device time. These rules are that discipline's static complement, on
the flow-sensitive dataflow engine (analysis/dataflow.py):

- XF110 explicit-host-sync: a device value flows into a blocking host
  read (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, a blocking
  `.to("cpu")`, `float`/`int`/`bool`/`str`/`print`/`np.asarray`,
  `str.format`, f-string interpolation, `.synchronize()` on an event
  recorded this iteration) inside a hot loop, in the SAME iteration
  that dispatched it (the value is still "fresh"); and
  `torch.cuda.synchronize()` or a stream's `.synchronize()` anywhere in
  a hot loop, since it waits for the newest dispatch whatever it reads.
- XF111 implicit-host-sync: the same fresh device value driving a host
  branch (`if`/`while`/ternary/`assert` test) or being iterated.

Device-origin sources: the step callables (`train_step`, `eval_step`,
`predict_step`, `_predict_step`, `step_fn`); the kernel wrappers of
`xflow_tpu_torch/ops/` (every function there that counts a launch, and
every function there that calls one); `.cuda()` and `.to(<device>)`;
and `torch.*` factories with a `device=` that is not the CPU. Each
source ages every older device value (fresh -> stale) before its own
fresh result, so the one-behind read stays silent. A `torch.*` function
of a device value, or a method called on one, is a device value of the
same freshness; `len()`, `.shape`, `.size()` and their kin read
metadata, not the value. `.to("cpu", non_blocking=True)` (the copy into
a pinned buffer) is not a sink.

Scope: the reference's hot paths by qualified name, the trainer's fit
loops (`*._fit`, `*._fit_tail`), the serve device worker
(`*._worker_loop`) and the prefetch producer (`prefetch`), with their
nested closures; and only sites inside a loop that DISPATCHES device
work there. A loop that only reads (a post-run sweep) performs
mandatory one-time syncs and is exempt by construction. The pass is
intraprocedural, as the reference's: a sync inside a helper the loop
calls is not seen.
"""

from __future__ import annotations

import ast
import fnmatch
import os
from dataclasses import replace

from xflow_tpu_torch.analysis import astutil, dataflow
from xflow_tpu_torch.analysis.core import Finding, Project, register_pass

RULES = ("XF110", "XF111")

# the hot-path functions, by qualname pattern (nested closures included)
HOT_QUALNAMES = (
    "*._fit", "*._fit.*",
    "*._fit_tail", "*._fit_tail.*",
    "*._worker_loop", "*._worker_loop.*",
    "prefetch", "prefetch.*",
)

# callables whose results live on the card: the step factories' products,
# bound by the names the trainer and the serving tier call them by
SOURCE_ATTRS = {"train_step", "eval_step", "predict_step", "_predict_step", "step_fn"}
OPS_DIR = ("xflow_tpu_torch", "ops")

SINK_CALLS = {
    "float", "int", "bool", "str", "print",
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
    "np.float32", "numpy.float32", "np.float64", "numpy.float64",
}
SINK_METHODS = {"item", "tolist", "cpu", "numpy"}
STREAM_SYNCS = {"torch.cuda.synchronize"}
STREAM_GETTERS = {"torch.cuda.current_stream", "torch.cuda.default_stream",
                  "torch.cuda.Stream"}
# reads of a tensor's metadata: no device read
METADATA_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda", "layout"})
METADATA_METHODS = {"size", "dim", "numel", "element_size", "stride", "data_ptr",
                    "is_contiguous", "get_device"}


def _short(node) -> str:
    s = ast.unparse(node)
    return s if len(s) <= 48 else s[:45] + "..."


def kernel_wrappers(root: str) -> frozenset:
    """Names of the kernel wrappers under `root`'s xflow_tpu_torch/ops/:
    every function that counts a launch (`LAUNCHES[...] += 1`), and
    every function or autograd Function there that calls one of those
    (`C.apply(...)` calls the Function C), to a fixpoint."""
    ops = os.path.join(root, *OPS_DIR)
    defs = {}
    for fn in sorted(os.listdir(ops)) if os.path.isdir(ops) else ():
        if fn.endswith(".py"):
            with open(os.path.join(ops, fn), encoding="utf-8") as f:
                tree = ast.parse(f.read())
            defs.update((n.name, n) for n in tree.body
                        if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
    out = {name for name, node in defs.items() if any(
        isinstance(sub, ast.AugAssign) and isinstance(sub.target, ast.Subscript)
        and (astutil.dotted(sub.target.value) or "").endswith("LAUNCHES")
        for sub in ast.walk(node))}

    def calls_one(node) -> bool:
        for sub in ast.walk(node):
            parts = (astutil.call_name(sub) or "").split(".") if isinstance(sub, ast.Call) else []
            if parts and (parts[-1] in out or parts[-1] == "apply" and parts[-2:-1] and
                          parts[-2] in out):
                return True
        return False

    grew = True
    while grew:
        grew = False
        for name, node in defs.items():
            if name not in out and calls_one(node):
                out.add(name)
                grew = True
    return frozenset(out)


def _device_expr(node) -> bool:
    """Does this `.to(...)` / `device=` argument name a device other
    than the CPU? (a dtype, another tensor or the CPU: no)"""
    s = astutil.const_str(node)
    if s is not None:
        return s.startswith("cuda")
    if isinstance(node, ast.Call) and astutil.call_name(node) == "torch.device":
        return bool(node.args) and _device_expr(node.args[0])
    name = (astutil.dotted(node) or "").split(".")[-1].lower()
    return ("device" in name or name == "dev") and "cpu" not in name and "host" not in name


def _cpu_expr(node) -> bool:
    s = astutil.const_str(node)
    if s is not None:
        return s == "cpu"
    if isinstance(node, ast.Call) and astutil.call_name(node) == "torch.device":
        return bool(node.args) and _cpu_expr(node.args[0])
    return False


def _kw(node: ast.Call, name: str):
    return next((kw.value for kw in node.keywords if kw.arg == name), None)


def _to_target(node: ast.Call):
    """The device argument of a `.to(...)` call, or None."""
    return node.args[0] if node.args else _kw(node, "device")


def _non_blocking(node: ast.Call) -> bool:
    v = _kw(node, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


class _Sources:
    """Which calls dispatch device work (and yield a fresh device value)."""

    def __init__(self, aliases: dict, wrappers: frozenset):
        self.aliases = aliases
        self.wrappers = wrappers

    def is_source(self, node: ast.Call) -> bool:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in SOURCE_ATTRS or func.attr in self.wrappers or func.attr == "cuda":
                return True
            if func.attr == "to":
                tgt = _to_target(node)
                return tgt is not None and _device_expr(tgt)
        if isinstance(func, ast.Name) and (func.id in SOURCE_ATTRS or func.id in self.wrappers):
            return True
        callee = astutil.canonical(astutil.call_name(node), self.aliases) or ""
        dev = _kw(node, "device")
        return (callee.startswith("torch.") and not callee.startswith("torch.cuda.")
                and dev is not None and _device_expr(dev))


def _dispatching_loops(tree, sources: _Sources) -> set:
    """ids of loop nodes whose body issues a device dispatch. Only such
    loops can have a sync bubble: blocking between dispatches stalls
    the pipeline, while a loop that only reads performs mandatory
    one-time syncs, exempt by construction."""
    return {id(node) for node in ast.walk(tree)
            if isinstance(node, (ast.For, ast.AsyncFor, ast.While))
            and any(isinstance(sub, ast.Call) and sources.is_source(sub)
                    for sub in astutil.walk_scope(node))}


class _Hooks(dataflow.Hooks):
    metadata_attrs = METADATA_ATTRS

    def __init__(self, mod, parents, sources: _Sources, dispatch_loops: set):
        self.mod = mod
        self.parents = parents
        self.sources = sources
        self.dispatch_loops = dispatch_loops
        self.findings: list = []

    # ------------------------------------------------------------ helpers
    def _hot(self, node, df) -> bool:
        """Inside a hot function AND inside a loop of it that dispatches
        device work: only there can a blocking read be a bubble."""
        qn = df.current_qn
        if not qn or not any(fnmatch.fnmatch(qn, p) for p in HOT_QUALNAMES):
            return False
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)) \
                    and id(cur) in self.dispatch_loops:
                return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return False
            cur = self.parents.get(cur)
        return False

    @staticmethod
    def _fresh_device(val) -> bool:
        return val.tagged("device") and val.fresh

    def _age(self, env: dict) -> None:
        """A new device dispatch: every older device value's blocking
        read now hides under it (fresh -> stale), containers included."""
        for k, v in list(env.items()):
            env[k] = self._aged(v)

    def _aged(self, v):
        if v.elems is not None:
            v = replace(v, elems=tuple(self._aged(e) for e in v.elems))
        return replace(v, fresh=False) if v.fresh else v

    def _flag(self, rule: str, node, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.mod.relpath, line=node.lineno, message=message,
            hint="stage the value and read it AFTER the next step's dispatch "
                 "(the StepTimer pattern), copy it with .to('cpu', "
                 "non_blocking=True) into pinned memory, or move the read "
                 "out of the loop",
        ))

    def _blocks(self, rule: str, node, how: str, expr_node) -> None:
        self._flag(rule, node, f"{how} `{_short(expr_node)}` blocks on a device value "
                               "dispatched THIS iteration of the hot loop: a host/device "
                               "sync bubble (the one-step-behind discipline)")

    def _drains(self, node, what: str) -> None:
        self._flag("XF110", node, f"`{_short(node)}` drains {what} inside the hot loop: "
                                  "the host waits for this iteration's dispatch")

    # -------------------------------------------------------------- hooks
    def at_call(self, node, callee, argvals, kwvals, env, df, fval):
        func = node.func
        meth = func.attr if isinstance(func, ast.Attribute) else None
        if self.sources.is_source(node):
            self._age(env)
            return dataflow.AbsVal(tags=frozenset({"device"}), fresh=True)
        hot = self._hot(node, df)
        if callee in STREAM_SYNCS:
            if hot:
                self._drains(node, "the stream")
            return dataflow.BOTTOM
        if callee in STREAM_GETTERS:
            return dataflow.AbsVal(ref=("stream",))
        if meth in METADATA_METHODS:
            return dataflow.BOTTOM
        if meth == "record":  # an event marks this point of the stream
            owner = astutil.dotted(func.value)
            if owner is not None:
                env[owner] = dataflow.AbsVal(tags=frozenset({"device"}), fresh=True)
            return dataflow.BOTTOM
        if meth == "synchronize":
            recv = func.value
            stream = (astutil.canonical(astutil.call_name(recv), df.aliases) in STREAM_GETTERS
                      if isinstance(recv, ast.Call)
                      else env.get(astutil.dotted(recv) or "", dataflow.BOTTOM).ref == ("stream",))
            if hot and stream:
                self._drains(node, "a stream")
            elif hot and self._fresh_device(fval):
                self._blocks("XF110", node, "blocking host sync `.synchronize()` on",
                             func.value)
            return dataflow.BOTTOM
        if meth == "to" and (tgt := _to_target(node)) is not None and _cpu_expr(tgt):
            if hot and self._fresh_device(fval) and not _non_blocking(node):
                self._blocks("XF110", node, "blocking host copy `.to(cpu)` of", func.value)
            return dataflow.BOTTOM  # a host tensor
        if callee in SINK_CALLS and hot:
            for av, anode in zip(argvals, node.args):
                if self._fresh_device(av):
                    self._blocks("XF110", node, f"blocking host sync `{callee}(...)` on", anode)
                    break
        if meth in SINK_METHODS:
            if hot and self._fresh_device(fval):
                self._blocks("XF110", node, f"blocking host sync `.{meth}()` on", func.value)
            return dataflow.BOTTOM  # a host value
        if meth == "format" and hot:
            for av, anode in zip(argvals, node.args):
                if self._fresh_device(av):
                    self._blocks("XF110", node, "string formatting of", anode)
                    break
        if (callee or "").startswith("torch.") and not (callee or "").startswith("torch.cuda."):
            # a torch function of device values is a device value
            out = dataflow.BOTTOM
            for v in [*argvals, *kwvals.values()]:
                if v.tagged("device"):
                    out = dataflow.join(out, dataflow.propagated(v))
            return out
        return None

    def at_branch(self, node, val, env, df):
        if self._fresh_device(val) and self._hot(node, df):
            self._blocks("XF111", node, "host branch condition on", node)

    def at_iter(self, node, val, env, df):
        if self._fresh_device(val) and self._hot(node, df):
            self._blocks("XF111", node, "host iteration over", node)

    def at_format(self, node, val, env, df):
        if self._fresh_device(val) and self._hot(node, df):
            self._blocks("XF110", node, "f-string interpolation of", node.value)


@register_pass("host-sync", RULES)
def run(project: Project) -> list:
    findings: list = []
    wrappers = None
    for mod in project.modules:
        if mod.tree is None:
            continue
        defs = astutil.func_defs(mod.tree)
        if not any(fnmatch.fnmatch(qn, p) for qn, _n, _c in defs for p in HOT_QUALNAMES):
            continue
        if wrappers is None:
            wrappers = kernel_wrappers(project.root)
        sources = _Sources(astutil.import_aliases(mod.tree), wrappers)
        hooks = _Hooks(mod, astutil.parent_map(mod.tree), sources,
                       _dispatching_loops(mod.tree, sources))
        dataflow.Dataflow(mod, hooks).run_all()
        findings.extend(hooks.findings)
    return findings
