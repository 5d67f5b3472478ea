"""Event-driven task graphs: construction (§3/§4), sync models (§2), execution.

The host side — graph generation in process or sharded over a process
pool, the six synchronization models on the instrumented simulator, their
Table-2 overhead atlas, the threaded autodec runtime and the
generated-code emitters — and the counted-sync engines on the card (the
device and fused sweeps, the distributed rank engine).

Execution knobs go through :class:`ExecutionConfig`/:class:`Session`;
the per-call ``shards=``/``parallel=``/``pool=``/``faults=``/``recovery=``
kwargs are deprecated shims.  A session's :class:`GraphCache` answers
repeated sizes warm, and :class:`ScheduleService` serves it to
concurrent clients.
"""
from .atlas import (ATLAS_COUNTERS, AtlasWorkload, Instance, WORKLOADS,
                    atlas_crossover, atlas_sweep, build_instances, fit_class,
                    fit_rows, growth_rows, measure, reference_curves)
from .cache import GraphCache, graph_cache_info
from .config import CachePolicy, ExecutionConfig, Session
from .device import (DeviceCounters, DeviceExecutor, DeviceGraph, DeviceRun,
                     DeviceSchedule, decrement_reference, pack_graph,
                     pack_schedule, wavefront_step, wavefront_step_torch)
from .distributed import (DistributedRun, Mailbox, MsgBatch, RankEngine,
                          RankFailureError, RankSlice, RankStats,
                          partition_graph, plan_ranks, run_distributed)
from .executor import Counters, Gauge, Sim
from .faults import (DROPPED_DECREMENT, MESSAGE_LOSS, RANK_CRASH,
                     SHM_ATTACH_FAIL, TASK_BODY_ERROR, WORKER_CRASH,
                     WORKER_HANG, Fault, FaultPlan, InjectedRankCrash,
                     InjectedTaskError)
from .fused import (FusedExecutor, FusedRun, graph_tile, host_execute,
                    pack_origins)
from .recovery import (FailureReport, ResilientRun, RetryPolicy,
                       ScheduleValidationError, ShardRecoveryError,
                       StallError, StallReport, TaskGroupError, Watchdog,
                       poisoned_cone, simulate_indexed_resilient)
from .service import ScheduleService
from .shard import ShardPlan, ShardSpec, plan_shards, scan_sharded
from .syncmodels import (MODELS, RunResult, run_autodec, run_autodec_nosrc,
                         run_counted, run_model, run_prescribed, run_tags1,
                         run_tags2, validate_order)
from .taskgraph import (Dependence, IndexedGraph, MaterializedGraph,
                        PolyhedralProgram, Statement, TaskId, TiledTaskGraph)
from .threaded import (ThreadedAutodec, ThreadedRunResult, run_graph_threaded,
                       run_graph_threaded_resilient)
from .wavefront import (IndexedSchedule, WavefrontSchedule, levels_from_array,
                        schedule_from_graph, simulate_indexed,
                        simulate_schedule, synthesize, synthesize_indexed)

__all__ = [
    "PolyhedralProgram", "Statement", "Dependence", "TiledTaskGraph",
    "MaterializedGraph", "IndexedGraph", "TaskId",
    "ExecutionConfig", "CachePolicy", "Session",
    "GraphCache", "graph_cache_info", "ScheduleService",
    "ShardSpec", "ShardPlan", "plan_shards", "scan_sharded",
    "DeviceExecutor", "DeviceRun", "DeviceCounters", "DeviceGraph",
    "DeviceSchedule", "pack_graph", "pack_schedule",
    "wavefront_step", "wavefront_step_torch", "decrement_reference",
    "run_distributed", "DistributedRun", "RankEngine", "RankSlice",
    "RankStats", "RankFailureError", "Mailbox", "MsgBatch",
    "plan_ranks", "partition_graph",
    "FusedExecutor", "FusedRun", "pack_origins", "host_execute",
    "graph_tile",
    "Sim", "Counters", "Gauge",
    "AtlasWorkload", "Instance", "WORKLOADS", "ATLAS_COUNTERS",
    "atlas_sweep", "atlas_crossover", "build_instances", "measure",
    "reference_curves", "fit_class", "fit_rows", "growth_rows",
    "MODELS", "run_model", "RunResult", "validate_order",
    "run_prescribed", "run_tags1", "run_tags2", "run_counted",
    "run_autodec", "run_autodec_nosrc",
    "ThreadedAutodec", "run_graph_threaded", "run_graph_threaded_resilient",
    "ThreadedRunResult",
    "Fault", "FaultPlan", "InjectedTaskError", "InjectedRankCrash",
    "WORKER_CRASH", "WORKER_HANG", "SHM_ATTACH_FAIL", "TASK_BODY_ERROR",
    "DROPPED_DECREMENT", "RANK_CRASH", "MESSAGE_LOSS",
    "RetryPolicy", "FailureReport", "StallReport", "StallError",
    "ShardRecoveryError", "TaskGroupError", "ScheduleValidationError",
    "Watchdog", "poisoned_cone", "simulate_indexed_resilient", "ResilientRun",
    "WavefrontSchedule", "synthesize", "simulate_schedule",
    "IndexedSchedule", "synthesize_indexed", "simulate_indexed",
    "levels_from_array", "schedule_from_graph",
]
