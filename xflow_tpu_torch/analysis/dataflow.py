"""Flow-sensitive intraprocedural forward dataflow over stdlib `ast`.

The host-sync pass needs "what is this VALUE at this program point": is
it device-origin, and has a newer device dispatch been issued since it
was produced. Nothing under analysis is imported or executed (the
core.py contract): abstract values propagate through assignments,
tuple unpacking, attribute chains, calls resolved through the
scope-aware astutil helpers, and loop bodies iterated to a (capped)
fixpoint with join = may-union.

Abstract value (`AbsVal`):
- `tags`    may-facts: "device" (produced by a step callable, a kernel
            wrapper, or a copy or factory onto the card).
- `fresh`   device-origin AND no later device dispatch has been issued
            on this path. A blocking read of a *fresh* value stalls the
            host behind the step just dispatched; a *stale* one hides
            under the newer dispatch's device time: the one-step-behind
            StepTimer discipline, stated as dataflow. Every source call
            ages the whole environment (fresh -> stale) before producing
            its own fresh result.
- `ref`     an opaque identity token, ("def", qualname) for a
            module-local function object, so an invoked name links back
            to its definition.
- `elems`   element values for tuples/lists of known shape, so
            `state, m = step(state, batch)` taints both names.

Soundness posture: under-approximate on purpose. Unknown calls return
BOTTOM (host, untainted); closures see their free variables as BOTTOM
(a value staged into an enclosing scope and read back in a nested
function has, by construction, crossed the one-behind seam); `global`
state is not modeled. Rules built on this engine therefore miss some
true positives but do not invent false ones.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, replace
from typing import Optional

from xflow_tpu_torch.analysis import astutil


@dataclass(frozen=True)
class AbsVal:
    """One abstract value (see the module docstring for the fields)."""

    tags: frozenset = frozenset()
    fresh: bool = False
    ref: Optional[tuple] = None
    elems: Optional[tuple] = None

    def tagged(self, *tags) -> bool:
        return any(t in self.tags for t in tags)


BOTTOM = AbsVal()


def join(a: AbsVal, b: AbsVal) -> AbsVal:
    """May-union of two values (path join)."""
    if a == b:
        return a
    elems = None
    if a.elems is not None and b.elems is not None and len(a.elems) == len(b.elems):
        elems = tuple(join(x, y) for x, y in zip(a.elems, b.elems))
    return AbsVal(
        tags=a.tags | b.tags,
        fresh=a.fresh or b.fresh,
        ref=a.ref if a.ref == b.ref else None,
        elems=elems,
    )


def join_env(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        cur = out.get(k)
        out[k] = v if cur is None else join(cur, v)
    return out


def propagated(val: AbsVal) -> AbsVal:
    """The value seen through an attribute/subscript/element access:
    taint facts carry, identity facts (ref/elems) do not."""
    return AbsVal(tags=val.tags, fresh=val.fresh)


class Hooks:
    """Override points for a pass built on the engine. Every hook is
    optional; `at_call` returning a non-None AbsVal short-circuits the
    default call handling (a module-local callee's return value, else the
    taint of the object a method is called on)."""

    # attribute loads that read metadata, not the value (`x.shape`)
    metadata_attrs: frozenset = frozenset()

    def at_call(self, node, callee, argvals, kwvals, env, df, fval):
        return None

    def at_branch(self, node, val, env, df):  # if/while/ternary/assert tests
        pass

    def at_iter(self, node, val, env, df):  # for-loop / comprehension iter
        pass

    def at_format(self, node, val, env, df):  # f-string interpolation
        pass


class Dataflow:
    """Forward abstract interpreter for one module. `run_all()` analyzes
    the module body and every function definition (each in isolation:
    intraprocedural; parameters and free variables start at BOTTOM)."""

    MAX_LOOP_PASSES = 3
    MAX_CALL_DEPTH = 4

    def __init__(self, module, hooks: Hooks):
        self.module = module
        self.hooks = hooks
        self.tree = module.tree
        self.aliases = astutil.import_aliases(self.tree)
        self.defs = astutil.func_defs(self.tree)
        self.by_qn = {qn: node for qn, node, _cls in self.defs}
        self.by_name = astutil.defs_by_name(self.defs)
        self.current_qn = ""
        self._ret_cache: dict = {}
        self._ret_stack: set = set()
        self._depth = 0

    # ------------------------------------------------------- entry points
    def run_all(self) -> None:
        self.current_qn = ""
        self.exec_stmts(self.tree.body, {}, [])
        for qn, node, _cls in self.defs:
            self.run_function(qn, node)

    def run_function(self, qn: str, node) -> AbsVal:
        """Analyze one function; returns the join of its return values."""
        prev = self.current_qn
        self.current_qn = qn
        args = node.args
        env: dict = {a.arg: BOTTOM for a in args.posonlyargs + args.args + args.kwonlyargs}
        for a in (args.vararg, args.kwarg):
            if a is not None:
                env[a.arg] = BOTTOM
        ret: list = []
        self.exec_stmts(node.body, env, ret)
        self.current_qn = prev
        if not ret:
            return BOTTOM
        # fold WITHOUT a BOTTOM seed: a single return path keeps its
        # identity facts; join only erases what differs between paths
        out = ret[0]
        for v in ret[1:]:
            out = join(out, v)
        return out

    # --------------------------------------------------------- statements
    def exec_stmts(self, stmts, env: dict, ret: list) -> None:
        for st in stmts:
            self.exec_stmt(st, env, ret)

    def exec_stmt(self, st, env: dict, ret: list) -> None:
        if isinstance(st, ast.Assign):
            val = self.eval(st.value, env)
            for tgt in st.targets:
                self.assign(tgt, val, env)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.assign(st.target, self.eval(st.value, env), env)
        elif isinstance(st, ast.AugAssign):
            old = self.eval(st.target, env)
            self.assign(st.target, join(old, self.eval(st.value, env)), env)
        elif isinstance(st, ast.Expr):
            self.eval(st.value, env)
        elif isinstance(st, ast.Return):
            ret.append(self.eval(st.value, env) if st.value else BOTTOM)
        elif isinstance(st, ast.If):
            tv = self.eval(st.test, env)
            self.hooks.at_branch(st.test, tv, env, self)
            e1, e2 = dict(env), dict(env)
            self.exec_stmts(st.body, e1, ret)
            self.exec_stmts(st.orelse, e2, ret)
            env.clear()
            env.update(join_env(e1, e2))
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            itv = self.eval(st.iter, env)
            self.hooks.at_iter(st.iter, itv, env, self)
            loopval = AbsVal(tags=itv.tags, fresh=itv.fresh)
            self._loop(st, env, ret, bind=lambda e: self.assign(st.target, loopval, e))
            self.exec_stmts(st.orelse, env, ret)
        elif isinstance(st, ast.While):
            def test_hook(e, _st=st):
                tv = self.eval(_st.test, e)
                self.hooks.at_branch(_st.test, tv, e, self)

            self._loop(st, env, ret, bind=test_hook)
            self.exec_stmts(st.orelse, env, ret)
        elif isinstance(st, ast.Try):
            pre = dict(env)
            self.exec_stmts(st.body, env, ret)
            merged = join_env(pre, env)
            # outs[0] must be a COPY: with zero handlers `acc` would
            # alias `env`, and the final clear()+update(acc) would wipe
            # every binding a try/finally body made
            outs = [dict(env)]
            for h in st.handlers:
                henv = dict(merged)
                if h.name:
                    henv[h.name] = BOTTOM
                self.exec_stmts(h.body, henv, ret)
                outs.append(henv)
            self.exec_stmts(st.orelse, outs[0], ret)
            acc = outs[0]
            for o in outs[1:]:
                acc = join_env(acc, o)
            self.exec_stmts(st.finalbody, acc, ret)
            env.clear()
            env.update(acc)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                v = self.eval(item.context_expr, env)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, v, env)
            self.exec_stmts(st.body, env, ret)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in st.decorator_list:
                self.eval(dec, env)
            child_qn = f"{self.current_qn}.{st.name}" if self.current_qn else st.name
            env[st.name] = AbsVal(ref=("def", child_qn))
        elif isinstance(st, ast.ClassDef):
            env[st.name] = BOTTOM
        elif isinstance(st, ast.Assert):
            tv = self.eval(st.test, env)
            self.hooks.at_branch(st.test, tv, env, self)
        elif isinstance(st, ast.Raise):
            if st.exc is not None:
                self.eval(st.exc, env)
        elif isinstance(st, ast.Delete):
            for tgt in st.targets:
                d = astutil.dotted(tgt)
                if d is not None:
                    env.pop(d, None)
        # Import/Global/Nonlocal/Pass/Break/Continue: no value flow
        # (break/continue are approximated by the loop join)

    def _loop(self, st, env: dict, ret: list, bind) -> None:
        """Fixpoint over a loop body: env_in = join(env_before,
        env_after_body), capped at MAX_LOOP_PASSES iterations."""
        state = dict(env)
        for _ in range(self.MAX_LOOP_PASSES):
            body_env = dict(state)
            bind(body_env)
            self.exec_stmts(st.body, body_env, ret)
            nxt = join_env(state, body_env)
            if nxt == state:
                break
            state = nxt
        env.clear()
        env.update(state)

    # -------------------------------------------------------- assignment
    def assign(self, tgt, val: AbsVal, env: dict) -> None:
        if isinstance(tgt, ast.Name):
            env[tgt.id] = val
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            star_free = not any(isinstance(e, ast.Starred) for e in tgt.elts)
            if val.elems is not None and len(val.elems) == len(tgt.elts) and star_free:
                for e, v in zip(tgt.elts, val.elems):
                    self.assign(e, v, env)
            else:
                each = propagated(val)
                for e in tgt.elts:
                    self.assign(e, each, env)
        elif isinstance(tgt, ast.Starred):
            self.assign(tgt.value, propagated(val), env)
        elif isinstance(tgt, ast.Attribute):
            d = astutil.dotted(tgt)
            if d is not None:
                env[d] = val
        elif isinstance(tgt, ast.Subscript):
            d = astutil.dotted(tgt.value)
            if d is not None:
                # weak update: the container keeps its other elements
                env[d] = join(env.get(d, BOTTOM), propagated(val))

    # -------------------------------------------------------- expressions
    def eval(self, node, env: dict) -> AbsVal:
        if node is None or isinstance(node, ast.Constant):
            return BOTTOM
        if isinstance(node, ast.Name):
            val = env.get(node.id)
            return self._def_ref(node.id) if val is None else val
        if isinstance(node, ast.Attribute):
            if node.attr in self.hooks.metadata_attrs:
                self.eval(node.value, env)
                return BOTTOM
            d = astutil.dotted(node)
            if d is not None and d in env:
                return env[d]
            return propagated(self.eval(node.value, env))
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value, env)
            self.eval(node.slice, env)
            return propagated(base)
        if isinstance(node, ast.Call):
            return self.eval_call(node, env)
        if isinstance(node, (ast.Tuple, ast.List)):
            elems = tuple(self.eval(e, env) for e in node.elts)
            out = BOTTOM
            for e in elems:
                out = join(out, propagated(e))
            return replace(out, elems=elems)
        if isinstance(node, ast.Set):
            out = BOTTOM
            for e in node.elts:
                out = join(out, propagated(self.eval(e, env)))
            return out
        if isinstance(node, ast.Dict):
            out = BOTTOM
            for k, v in zip(node.keys, node.values):
                if k is not None:
                    self.eval(k, env)
                out = join(out, propagated(self.eval(v, env)))
            return out
        if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare)):
            if isinstance(node, ast.BinOp):
                parts = [node.left, node.right]
            elif isinstance(node, ast.BoolOp):
                parts = node.values
            else:
                parts = [node.left, *node.comparators]
            out = BOTTOM
            for p in parts:
                out = join(out, propagated(self.eval(p, env)))
            return out
        if isinstance(node, ast.UnaryOp):
            return propagated(self.eval(node.operand, env))
        if isinstance(node, ast.IfExp):
            tv = self.eval(node.test, env)
            self.hooks.at_branch(node.test, tv, env, self)
            return join(self.eval(node.body, env), self.eval(node.orelse, env))
        if isinstance(node, ast.JoinedStr):
            for part in node.values:
                if isinstance(part, ast.FormattedValue):
                    self.hooks.at_format(part, self.eval(part.value, env), env, self)
            return BOTTOM
        if isinstance(node, ast.FormattedValue):
            self.hooks.at_format(node, self.eval(node.value, env), env, self)
            return BOTTOM
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            # comprehension scope: bindings live in a COPY of the env
            # (the target must neither leak out nor clobber an outer
            # binding), and the target varies per iteration like a
            # for-loop target
            cenv = dict(env)
            for gen in node.generators:
                itv = self.eval(gen.iter, cenv)
                self.hooks.at_iter(gen.iter, itv, cenv, self)
                self.assign(gen.target, AbsVal(tags=itv.tags, fresh=itv.fresh), cenv)
                for cond in gen.ifs:
                    self.eval(cond, cenv)
            if isinstance(node, ast.DictComp):
                self.eval(node.key, cenv)
                return propagated(self.eval(node.value, cenv))
            return propagated(self.eval(node.elt, cenv))
        if isinstance(node, ast.NamedExpr):
            val = self.eval(node.value, env)
            self.assign(node.target, val, env)
            return val
        if isinstance(node, (ast.Starred, ast.Await, ast.YieldFrom)):
            return self.eval(node.value, env)
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                self.eval(part, env)
            return BOTTOM
        if isinstance(node, ast.Yield):
            self.eval(node.value, env)
            return BOTTOM
        return BOTTOM  # lambdas and the rest: opaque

    def eval_call(self, node: ast.Call, env: dict) -> AbsVal:
        fval = self.eval(node.func, env)
        argvals = [self.eval(a, env) for a in node.args]
        kwvals = {kw.arg: self.eval(kw.value, env) for kw in node.keywords}
        callee = astutil.canonical(astutil.call_name(node), self.aliases)
        res = self.hooks.at_call(node, callee, argvals, kwvals, env, self, fval)
        if res is not None:
            return res
        rv = self._local_return(callee, fval)
        if rv is not None:
            return propagated(rv) if rv.ref is None else rv
        if fval.tags or fval.fresh:
            # a method call on a tainted object (x.sum(), x.reshape())
            # yields a tainted result: the callee rides the value
            return propagated(fval)
        return BOTTOM

    # ----------------------------------------------- local-call resolution
    def _def_ref(self, name: str) -> AbsVal:
        """A bare Name that resolves (scope-aware) to exactly one
        visible function definition becomes a function reference
        (flow-sensitive bindings in env take precedence)."""
        if name not in self.by_name:
            return BOTTOM
        qns = astutil.resolve_scoped(name, self.current_qn, self.by_name)
        return AbsVal(ref=("def", qns[0])) if len(qns) == 1 else BOTTOM

    def _local_return(self, callee, fval: AbsVal) -> Optional[AbsVal]:
        """Join of return values of a module-local callee, analyzed in
        isolation (params at BOTTOM) and memoized. None = not local."""
        qns: list = []
        if fval.ref is not None and fval.ref[0] == "def":
            qns = [fval.ref[1]]
        elif callee is not None:
            simple = callee.split(".")[-1]
            if callee in (simple, f"self.{simple}", f"cls.{simple}"):
                qns = astutil.resolve_scoped(simple, self.current_qn, self.by_name)
        qns = [qn for qn in qns if qn in self.by_qn]
        if not qns or self._depth >= self.MAX_CALL_DEPTH:
            return None
        out = None
        for qn in qns:
            if qn in self._ret_stack:
                continue  # recursion: contribute nothing
            if qn not in self._ret_cache:
                self._ret_stack.add(qn)
                self._depth += 1
                try:
                    self._ret_cache[qn] = self.run_function(qn, self.by_qn[qn])
                finally:
                    self._depth -= 1
                    self._ret_stack.discard(qn)
            rv = self._ret_cache[qn]
            out = rv if out is None else join(out, rv)
        return out
