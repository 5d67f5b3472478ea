"""Event-driven task graphs and their counted-sync execution on the card."""
from .device import (DeviceCounters, DeviceExecutor, DeviceGraph, DeviceRun,
                     DeviceSchedule, decrement_reference, pack_graph,
                     pack_schedule, wavefront_step, wavefront_step_torch)
from .distributed import (DistributedRun, Mailbox, MsgBatch, RankEngine,
                          RankFailureError, RankSlice, RankStats,
                          partition_graph, plan_ranks, run_distributed)
from .faults import (DROPPED_DECREMENT, MESSAGE_LOSS, RANK_CRASH, Fault,
                     FaultPlan, InjectedRankCrash)
from .fused import (FusedExecutor, FusedRun, graph_tile, host_execute,
                    pack_origins)
from .recovery import (FailureReport, RetryPolicy, ScheduleValidationError,
                       StallError, StallReport, Watchdog)
from .taskgraph import (Dependence, IndexedGraph, MaterializedGraph,
                        PolyhedralProgram, Statement, TiledTaskGraph)
from .wavefront import (IndexedSchedule, levels_from_array,
                        schedule_from_graph, synthesize_indexed)

__all__ = [
    "DROPPED_DECREMENT", "Dependence", "DeviceCounters", "DeviceExecutor",
    "DeviceGraph", "DeviceRun", "DeviceSchedule", "DistributedRun",
    "FailureReport", "Fault", "FaultPlan", "FusedExecutor", "FusedRun",
    "IndexedGraph", "IndexedSchedule", "InjectedRankCrash", "MESSAGE_LOSS",
    "Mailbox", "MaterializedGraph", "MsgBatch", "PolyhedralProgram",
    "RANK_CRASH", "RankEngine", "RankFailureError", "RankSlice", "RankStats",
    "RetryPolicy", "ScheduleValidationError", "StallError", "StallReport",
    "Statement", "TiledTaskGraph", "Watchdog", "decrement_reference",
    "graph_tile", "host_execute", "levels_from_array", "pack_graph",
    "pack_origins", "pack_schedule", "partition_graph", "plan_ranks",
    "run_distributed", "schedule_from_graph", "synthesize_indexed",
    "wavefront_step", "wavefront_step_torch",
]
