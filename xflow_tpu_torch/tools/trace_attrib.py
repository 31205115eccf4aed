"""Attribute a `torch.profiler` trace's device time to the train step's
scopes, the port's counterpart of the JAX package's `tools/trace_attrib.py`:

    python -m xflow_tpu_torch.tools.trace_attrib RUN/prof
    python -m xflow_tpu_torch.tools.trace_attrib trace_118_0.json --json -

The trace window (`train.profile_dir`, `train.trace_start_step`,
`train.trace_num_steps`) writes `<profile_dir>/trace_<pid>_<n>.json`,
a Chrome trace of the steps it covered. The train steps open the JAX
package's named scopes as `torch.profiler` ranges (`telemetry.scope`:
gather / loss / grad / optimizer / scatter_optimizer / train_step),
which the trace holds as `user_annotation` events on the thread that
opened them. This tool prints the per-scope device-time table, the
before/after evidence of a kernel change, in the JAX tool's format.

Device events are the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
events; host events are left out. Each device event is joined to its
launch, the `cuda_runtime` or `cuda_driver` event with the same
`correlation` (or, lacking that arg, the one its `ac2g` flow starts
at), and takes the innermost scope range that contains the launch:

1. a range on the launching thread (the port's own kernels launch from
   ctypes on the fit loop's thread and are joined like any operator's);
2. a launch from an autograd worker thread (named `pt_autograd_*`, or
   inside an `autograd::engine::evaluate_function` op) takes the
   innermost range of another thread that contains it: the thread
   that waits in `autograd.grad` for the backward it runs, whose range
   is `grad`. Any other thread (the prefetch thread's copies) keeps its
   own, and with no range of its own its events fall under `other`;
3. a device event with no launch in the trace takes the innermost
   `gpu_user_annotation` span of a scope that contains it;
4. a trace without any scope range falls back to a keyword match on the
   kernel name, as blind to the phase as the JAX tool's fallback:
   `gather_flat` -> gather, `row_sums_` -> loss, `scatter_ftrl` ->
   scatter_optimizer, the staged scatter (`staged_scatter`,
   `tile_offsets`, `scatter_staged`, `scatter_sorted`) -> grad.

Everything else falls under `other`. The JAX tool's `--run-dir` is gone:
its join read `kind="compile"` records for an op -> scope map, and the
port has no compile step and needs no map.

Exit codes: 0 = table printed; 1 = no device events in the trace (a CPU
run's trace has none); 2 = no trace found or an unreadable one.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import sys
from collections import defaultdict

from xflow_tpu_torch.telemetry import SCOPE_LABELS

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
AUTOGRAD_OP = "autograd::engine::evaluate_function"
# the fallback's kernel-name keywords, first match wins
KEYWORDS = (
    ("gather_flat", "gather"),
    ("row_sums_", "loss"),
    ("scatter_ftrl", "scatter_optimizer"),
    ("staged_scatter", "grad"),
    ("tile_offsets", "grad"),
    ("scatter_staged", "grad"),
    ("scatter_sorted", "grad"),
)


def find_trace(path: str) -> str:
    """`path` itself when it is a file, else the newest `trace_*.json`
    (or `.json.gz`) under it."""
    if os.path.isfile(path):
        return path
    hits = []
    for pat in ("trace_*.json", "trace_*.json.gz"):
        hits += glob.glob(os.path.join(path, "**", pat), recursive=True)
    if not hits:
        raise FileNotFoundError(f"no trace_*.json under {path!r}")
    return max(hits, key=os.path.getmtime)


def load_trace(path: str) -> list:
    """The trace's event list, from plain or gzipped Chrome-trace JSON."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    if isinstance(data, dict):
        return data.get("traceEvents", [])
    return data if isinstance(data, list) else []


class _Spans:
    """Intervals by key, for the innermost one that contains an instant.
    The ranges of one thread nest, so the spans that contain an instant
    form a chain of parents: from the last span that starts before it,
    walk up the parents to the first that has not ended."""

    def __init__(self):
        self._by = defaultdict(list)

    def add(self, key, ts: float, dur: float, name: str) -> None:
        self._by[key].append((ts, ts + dur, name))

    def seal(self) -> "_Spans":
        self._starts, self._parent = {}, {}
        for key, spans in self._by.items():
            spans.sort(key=lambda s: (s[0], -s[1]))  # an outer span first
            parent, stack = [], []
            for i, (start, end, _) in enumerate(spans):
                while stack and spans[stack[-1]][1] < end:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self._starts[key] = [s[0] for s in spans]
            self._parent[key] = parent
        return self

    def keys(self):
        return self._by.keys()

    def innermost(self, key, t: float):
        """(start, name) of the innermost span of `key` containing t, or None."""
        spans = self._by.get(key)
        if not spans:
            return None
        i = bisect.bisect_right(self._starts[key], t) - 1
        parent = self._parent[key]
        while i >= 0:
            start, end, name = spans[i]
            if end >= t:
                return start, name
            i = parent[i]
        return None


def _args(e: dict) -> dict:
    a = e.get("args")
    return a if isinstance(a, dict) else {}


def event_scopes(events: list, scopes: tuple = SCOPE_LABELS) -> list:
    """[(device event, scope)] for every device event with a positive
    duration, in trace order (see the module docstring for the join)."""
    wanted = set(scopes)
    ranges, gpu_ranges, autograd_ops = _Spans(), _Spans(), _Spans()
    workers, launches, flow_start, flow_end = set(), {}, {}, {}
    for e in events:
        ph, cat, name = e.get("ph"), e.get("cat"), str(e.get("name", ""))
        key = (e.get("pid"), e.get("tid"))
        if ph == "M":
            if name == "thread_name" and "autograd" in str(_args(e).get("name", "")):
                workers.add(key)
            continue
        if ph in ("s", "f") and cat == "ac2g":
            (flow_start if ph == "s" else flow_end)[e.get("id")] = e
            continue
        if ph != "X":
            continue
        if cat == "user_annotation" and name in wanted:
            ranges.add(key, e["ts"], e.get("dur", 0.0), name)
        elif cat == "gpu_user_annotation" and name in wanted:
            gpu_ranges.add(e.get("pid"), e["ts"], e.get("dur", 0.0), name)
        elif cat == "cpu_op" and name.startswith(AUTOGRAD_OP):
            autograd_ops.add(key, e["ts"], e.get("dur", 0.0), name)
        elif cat in LAUNCH_CATS and "correlation" in _args(e):
            launches[_args(e)["correlation"]] = e
    ranges.seal()
    gpu_ranges.seal()
    autograd_ops.seal()
    # a flow's end lies on its device event (same row, same instant)
    by_flow_end = {(f.get("pid"), f.get("tid"), f.get("ts")): flow_start.get(i)
                   for i, f in flow_end.items()}
    any_range = bool(ranges.keys()) or bool(gpu_ranges.keys())
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dur = e.get("dur")
        if not isinstance(dur, (int, float)) or dur <= 0:
            continue
        launch = launches.get(_args(e).get("correlation"))
        if launch is None:
            launch = by_flow_end.get((e.get("pid"), e.get("tid"), e.get("ts")))
        scope = None
        if launch is not None:
            key, t = (launch.get("pid"), launch.get("tid")), launch["ts"]
            hit = ranges.innermost(key, t)
            if hit is None and (key in workers or autograd_ops.innermost(key, t)):
                hits = [h for k in ranges.keys() if k != key and k not in workers
                        for h in [ranges.innermost(k, t)] if h is not None]
                hit = max(hits) if hits else None
            scope = hit[1] if hit else None
        else:
            hit = gpu_ranges.innermost(e.get("pid"), e["ts"])
            scope = hit[1] if hit else None
        if scope is None and not any_range:
            name = str(e.get("name", ""))
            scope = next((s for kw, s in KEYWORDS if kw in name and s in wanted), None)
        out.append((e, scope or "other"))
    return out


def attribute(events: list, scopes: tuple = SCOPE_LABELS) -> tuple[dict, dict, float]:
    """({scope: total us}, {scope: event count}, total us) over the
    trace's device events."""
    totals: dict = {}
    counts: dict = {}
    total_us = 0.0
    for e, scope in event_scopes(events, scopes):
        dur = float(e["dur"])
        totals[scope] = totals.get(scope, 0.0) + dur
        counts[scope] = counts.get(scope, 0) + 1
        total_us += dur
    return totals, counts, total_us


def render(totals: dict, counts: dict, total_us: float) -> str:
    rows = sorted(totals.items(), key=lambda kv: -kv[1])
    lines = ["scope                 device_ms       %   events",
             "-----                 ---------       -   ------"]
    for scope, us in rows:
        lines.append(
            f"{scope:<20}  {us / 1e3:>9.3f}  {100.0 * us / total_us:>6.1f}"
            f"   {counts[scope]:>6}"
        )
    lines.append(
        f"{'total':<20}  {total_us / 1e3:>9.3f}   100.0   {sum(counts.values()):>6}"
    )
    return "\n".join(lines)


def payload(totals: dict, counts: dict, total_us: float) -> dict:
    """The `--json` object: {"total_ms", "scopes": {scope: {ms, pct, events}}}."""
    return {"total_ms": round(total_us / 1e3, 3), "scopes": {
        scope: {"ms": round(us / 1e3, 3), "pct": round(100.0 * us / total_us, 2),
                "events": counts[scope]}
        for scope, us in sorted(totals.items(), key=lambda kv: -kv[1])
    }}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m xflow_tpu_torch.tools.trace_attrib",
        description="bucket a torch.profiler trace's device time by the train "
        "step's scopes")
    ap.add_argument("trace", help="the trace window's directory (train.profile_dir) "
                                  "or a trace_*.json(.gz) file")
    ap.add_argument("--scopes", default=",".join(SCOPE_LABELS),
                    help="comma-separated scope labels (default: the train "
                         "steps' scopes)")
    ap.add_argument("--json", default="", metavar="OUT",
                    help="also write {total_ms, scopes: {scope: {ms, pct, events}}} "
                         "JSON ('-' = stdout)")
    args = ap.parse_args(argv)

    scopes = tuple(s for s in args.scopes.split(",") if s)
    try:
        trace_path = find_trace(args.trace)
        events = load_trace(trace_path)
    except (OSError, ValueError) as e:
        print(f"trace_attrib: {e}", file=sys.stderr)
        return 2
    totals, counts, total_us = attribute(events, scopes)
    if total_us <= 0:
        print(f"trace_attrib: no device-op events in {trace_path!r} "
              "(a CPU run's trace, or a window before any step dispatched?)",
              file=sys.stderr)
        return 1
    print(f"# trace: {trace_path}")
    print(render(totals, counts, total_us))
    if args.json:
        out = json.dumps(payload(totals, counts, total_us))
        if args.json == "-":
            print(out)
        else:
            with open(args.json, "w") as f:
                f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
