"""The paper's §2 synchronization models, instrumented (Table 2).

Every model executes the same :class:`TiledTaskGraph` on the :class:`Sim`
substrate and is measured on the five overhead axes.  The generated-code
structure follows §4 exactly:

* ``prescribed``     — OCR-style Method 1: a master (dominator) creates every
                       task and declares every dependence before execution.
* ``tags1``          — one tag per dependence; get/put loops; one-use tags.
* ``tags2``          — one tag per predecessor task ([27]); tags disposable
                       only at graph completion.
* ``counted``        — master initializes every task's counter using the
                       §4.3 predecessor-count function, then lets completions
                       decrement.
* ``autodec``        — the paper's proposal ("w/ src"): master preschedules
                       only the statically-computed root set; the first
                       predecessor to decrement a successor creates it.
* ``autodec_nosrc``  — "w/o src": the root set is not known statically; the
                       master preschedules *all* tasks, concurrently with
                       execution (still O(1) sequential start-up).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .executor import Counters, Sim
from .taskgraph import TaskId, TiledTaskGraph


@dataclass
class RunResult:
    model: str
    counters: Counters
    order: list  # [(task, start_time)]
    n_tasks: int
    n_edges: Optional[int] = None

    def started(self) -> list:
        return [t for t, _ in self.order]


Hook = Optional[Callable[[TaskId], None]]


def _succ_list(graph: TiledTaskGraph, task: TaskId, params) -> list[TaskId]:
    return list(graph.successors(task, params))


# --------------------------------------------------------------------------
def run_prescribed(graph: TiledTaskGraph, params: dict, workers: int = 4,
                   task_dur: float = 1.0, setup_cost: float = 0.01,
                   on_execute: Hook = None) -> RunResult:
    g = graph.materialize(params)  # the O(n^2) explicit representation
    sim = Sim(workers, task_dur, setup_cost)
    C = sim.counters
    remaining = dict(g.pred_n)
    in_satisfied: dict[TaskId, int] = {t: 0 for t in g.tasks}
    started: set[TaskId] = set()

    def make_runner(t: TaskId):
        def start_side_effects():
            # GC: input dependence objects freed when the task starts.
            n_in = g.pred_n[t]
            C.garbage.dec(in_satisfied[t])
            C.spatial.dec(n_in)
            C.inflight_tasks.dec()
            started.add(t)
            if on_execute:
                on_execute(t)

        def completion():
            for s in g.succ[t]:
                # satisfy edge object
                C.inflight_deps.dec()
                C.garbage.inc()   # dead until target starts
                in_satisfied[s] += 1
                remaining[s] -= 1
                if remaining[s] == 0:
                    sim.make_ready(s, lambda s=s: completion_of[s]())
            return None

        return start_side_effects, completion

    completion_of: dict[TaskId, Callable] = {}
    start_of: dict[TaskId, Callable] = {}
    for t in g.tasks:
        st, co = make_runner(t)
        start_of[t], completion_of[t] = st, co

    ops = []
    for t in g.tasks:  # create every task
        ops.append(lambda t=t: C.inflight_tasks.inc())
    for t in g.tasks:  # declare every dependence edge
        for _ in g.succ[t]:
            def declare():
                C.spatial.inc()
                C.inflight_deps.inc()
            ops.append(declare)

    sim.run_master(ops, gate_after_all=True)

    # once the gate opens, zero-pred tasks become ready
    def seed():
        for t in g.tasks:
            if g.pred_n[t] == 0:
                sim.make_ready(t, completion_of[t])
    sim.at(len(ops) * setup_cost, seed)

    order = _install_start_hook(sim, start_of)
    sim.run()
    return RunResult("prescribed", C, order, len(g.tasks), g.n_edges)


def _install_start_hook(sim: Sim, start_of: dict[TaskId, Callable]) -> list:
    """Run per-task start side effects at dispatch time (GC-at-start etc.).

    Uses the first-class :attr:`Sim.on_start` hook — the side effects run
    inside the real dispatch loop (exactly-once guard, worker accounting,
    error handling all apply), so they can never drift from it.  Returns
    the ``[(task, start_time)]`` list the model's :class:`RunResult`
    reports; ``start_of`` may keep growing after installation (the autodec
    models register tasks as they fire).
    """
    order: list = []

    def on_start(key) -> None:
        order.append((key, sim.now))
        fn = start_of.get(key)
        if fn is not None:
            fn()

    sim.on_start = on_start
    return order


# --------------------------------------------------------------------------
def _run_tags(graph: TiledTaskGraph, params: dict, per_dep_tags: bool,
              workers: int, task_dur: float, setup_cost: float,
              on_execute: Hook) -> RunResult:
    sim = Sim(workers, task_dur, setup_cost)
    C = sim.counters
    table: dict = {}            # tag key -> 'present'
    pending: dict = {}          # tag key -> list of waiting tasks
    waiting_n: dict[TaskId, int] = {}
    tag_consumers_left: dict = {}  # tags2 garbage tracking
    n_tasks = 0

    all_tasks = list(graph.tasks(params))
    n_tasks = len(all_tasks)
    succs = {t: _succ_list(graph, t, params) for t in all_tasks}
    preds: dict[TaskId, list[TaskId]] = {t: [] for t in all_tasks}
    for t, ss in succs.items():
        for s in ss:
            preds[s].append(t)

    start_of: dict[TaskId, Callable] = {}

    def tag_key(src: TaskId, dst: TaskId):
        return (src, dst) if per_dep_tags else src

    def make_task(t: TaskId):
        def on_scheduled():
            # the task issues its gets (asynchronously)
            n_wait = 0
            for p in preds[t]:
                k = tag_key(p, t)
                if table.get(k):
                    _consume(k, t)
                else:
                    pending.setdefault(k, []).append(t)
                    C.inflight_deps.inc()   # outstanding get record
                    C.spatial.inc()
                    n_wait += 1
            waiting_n[t] = n_wait
            if n_wait == 0:
                sim.make_ready(t, completion)

        def start_side_effects():
            C.inflight_tasks.dec()
            if on_execute:
                on_execute(t)

        def completion():
            if per_dep_tags:
                for s in succs[t]:
                    _put(tag_key(t, s), t)
            elif succs[t]:
                # one tag per producer ([27]): a single put serves every
                # consumer; the key is the producer itself
                _put(tag_key(t, succs[t][0]), t)
            return None

        start_of[t] = start_side_effects
        return on_scheduled, completion

    def _consume(k, t: TaskId):
        """A get matched an existing tag."""
        if per_dep_tags:
            # one-use tag: disposed by the runtime right after the get.
            # The table counts tags per key — a multigraph (two dependences
            # relating the same task pair, e.g. cholesky_like's panel
            # columns) legitimately puts the same (src, dst) key twice.
            table[k] -= 1
            if table[k] == 0:
                del table[k]
            C.spatial.dec()
            C.inflight_deps.dec()
        else:
            tag_consumers_left[k] -= 1
            if tag_consumers_left[k] == 0:
                C.garbage.inc()  # dead but not destroyable until graph end

    def _put(k, src: TaskId):
        C.spatial.inc()
        C.inflight_deps.inc()
        if per_dep_tags:
            waiters = pending.get(k)
            if waiters:
                # each put satisfies exactly ONE outstanding get (one-use
                # tags pair 1:1 with dependence instances, so a duplicate
                # (src, dst) key must burn one tag per waiting get)
                w = waiters.pop(0)
                if not waiters:
                    del pending[k]
                C.inflight_deps.dec()   # the pending get record
                C.spatial.dec()
                C.spatial.dec()         # the tag, consumed by its getter
                C.inflight_deps.dec()
                waiting_n[w] -= 1
                if waiting_n[w] == 0:
                    sim.make_ready(w, completions[w])
            else:
                table[k] = table.get(k, 0) + 1
        else:
            table[k] = True
            tag_consumers_left[k] = len(succs[src])
            C.inflight_deps.dec()  # tags2: the tag itself resolves on put
            for w in pending.pop(k, []):
                C.inflight_deps.dec()   # the pending get record
                C.spatial.dec()
                tag_consumers_left[k] -= 1
                if tag_consumers_left[k] == 0:
                    C.garbage.inc()
                waiting_n[w] -= 1
                if waiting_n[w] == 0:
                    sim.make_ready(w, completions[w])

    scheduled_hooks: dict[TaskId, Callable] = {}
    completions: dict[TaskId, Callable] = {}
    for t in all_tasks:
        sh, co = make_task(t)
        scheduled_hooks[t] = sh
        completions[t] = co

    # master: schedule all tasks upfront; execution overlaps (O(1) startup)
    ops = []
    for t in all_tasks:
        def op(t=t):
            C.inflight_tasks.inc()
            scheduled_hooks[t]()
        ops.append(op)
    sim.run_master(ops, gate_after_all=False)

    order = _install_start_hook(sim, start_of)
    sim.run()
    name = "tags1" if per_dep_tags else "tags2"
    return RunResult(name, C, order, n_tasks)


def run_tags1(graph, params, workers=4, task_dur=1.0, setup_cost=0.01,
              on_execute=None) -> RunResult:
    return _run_tags(graph, params, True, workers, task_dur, setup_cost, on_execute)


def run_tags2(graph, params, workers=4, task_dur=1.0, setup_cost=0.01,
              on_execute=None) -> RunResult:
    return _run_tags(graph, params, False, workers, task_dur, setup_cost, on_execute)


# --------------------------------------------------------------------------
def run_counted(graph: TiledTaskGraph, params: dict, workers: int = 4,
                task_dur: float = 1.0, setup_cost: float = 0.01,
                on_execute: Hook = None) -> RunResult:
    """Master computes every counter with the §4.3 function: O(n·d) startup."""
    sim = Sim(workers, task_dur, setup_cost)
    C = sim.counters
    all_tasks = list(graph.tasks(params))
    counter: dict[TaskId, int] = {}
    start_of: dict[TaskId, Callable] = {}
    completions: dict[TaskId, Callable] = {}

    def make_task(t: TaskId):
        def start_side_effects():
            C.inflight_tasks.dec()
            C.spatial.dec()        # counter GC'd when the task starts
            C.garbage.dec()
            if on_execute:
                on_execute(t)

        def completion():
            for s in graph.successors(t, params):
                counter[s] -= 1
                if counter[s] == 0:
                    C.inflight_deps.dec()
                    C.garbage.inc()  # dead counter until task start
                    sim.make_ready(s, completions[s])

        start_of[t] = start_side_effects
        completions[t] = completion

    for t in all_tasks:
        make_task(t)

    ops = []
    for t in all_tasks:
        def op(t=t):
            # evaluate predecessor count (cost d), create counter, schedule
            counter[t] = graph.pred_count(t, params)
            C.spatial.inc()
            C.inflight_deps.inc()
            C.inflight_tasks.inc()
        ops.append(op)
    sim.run_master(ops, gate_after_all=True)

    def seed():
        for t in all_tasks:
            if counter[t] == 0:
                C.inflight_deps.dec()
                C.garbage.inc()
                sim.make_ready(t, completions[t])
    sim.at(len(ops) * setup_cost, seed)

    order = _install_start_hook(sim, start_of)
    sim.run()
    return RunResult("counted", C, order, len(all_tasks))


# --------------------------------------------------------------------------
def _run_autodec(graph: TiledTaskGraph, params: dict, with_src: bool,
                 workers: int, task_dur: float, setup_cost: float,
                 on_execute: Hook) -> RunResult:
    sim = Sim(workers, task_dur, setup_cost)
    C = sim.counters
    counter: dict[TaskId, int] = {}
    scheduled: set[TaskId] = set()
    start_of: dict[TaskId, Callable] = {}

    def start_side_effects_for(t: TaskId):
        def f():
            C.inflight_tasks.dec()
            C.spatial.dec()
            C.garbage.dec()
            if on_execute:
                on_execute(t)
        return f

    def completion_for(t: TaskId):
        def f():
            for s in graph.successors(t, params):
                autodec(s)
        return f

    def _get_or_create(t: TaskId) -> None:
        """The atomic init of a counted dependence (autodec & preschedule)."""
        if t not in counter:
            counter[t] = graph.pred_count(t, params)
            C.spatial.inc()
            C.inflight_deps.inc()

    def _fire(t: TaskId) -> None:
        C.inflight_deps.dec()
        C.garbage.inc()          # counter dead until the task starts
        scheduled.add(t)
        C.inflight_tasks.inc()
        start_of[t] = start_side_effects_for(t)
        sim.make_ready(t, completion_for(t))

    def autodec(t: TaskId) -> None:
        _get_or_create(t)
        counter[t] -= 1
        if counter[t] == 0 and t not in scheduled:
            _fire(t)

    def preschedule(t: TaskId) -> None:
        _get_or_create(t)
        if with_src is False:
            pass  # task known to master anyway; scheduling happens on fire
        if counter[t] == 0 and t not in scheduled:
            _fire(t)

    if with_src:
        seeds = list(graph.roots(params))   # §4.3 static root set
        n_tasks = graph.num_tasks(params)
    else:
        seeds = list(graph.tasks(params))   # preschedule everything
        n_tasks = len(seeds)

    ops = [lambda t=t: preschedule(t) for t in seeds]
    sim.run_master(ops, gate_after_all=False)

    order = _install_start_hook(sim, start_of)
    sim.run()
    name = "autodec" if with_src else "autodec_nosrc"
    return RunResult(name, C, order, n_tasks)


def run_autodec(graph, params, workers=4, task_dur=1.0, setup_cost=0.01,
                on_execute=None) -> RunResult:
    return _run_autodec(graph, params, True, workers, task_dur, setup_cost, on_execute)


def run_autodec_nosrc(graph, params, workers=4, task_dur=1.0, setup_cost=0.01,
                      on_execute=None) -> RunResult:
    return _run_autodec(graph, params, False, workers, task_dur, setup_cost, on_execute)


MODELS: dict[str, Callable] = {
    "prescribed": run_prescribed,
    "tags1": run_tags1,
    "tags2": run_tags2,
    "counted": run_counted,
    "autodec": run_autodec,
    "autodec_nosrc": run_autodec_nosrc,
}


def run_model(name: str, graph: TiledTaskGraph, params: dict, **kw) -> RunResult:
    return MODELS[name](graph, params, **kw)


def validate_order(graph: TiledTaskGraph, params: dict, result: RunResult,
                   task_dur: float = 1.0) -> None:
    """Every task ran exactly once; no successor started before its
    predecessor completed."""
    start = {}
    for t, at in result.order:
        assert t not in start, f"task {t} executed twice"
        start[t] = at
    all_tasks = set(graph.tasks(params))
    assert set(start) == all_tasks, (
        f"executed {len(start)} of {len(all_tasks)} tasks; "
        f"missing e.g. {list(all_tasks - set(start))[:3]}")
    for t in all_tasks:
        for s in graph.successors(t, params):
            assert start[s] >= start[t] + task_dur, f"dependence violated: {t} -> {s}"
