"""Event-driven task graphs and their counted-sync execution on the card."""
from .device import (DeviceCounters, DeviceExecutor, DeviceGraph, DeviceRun,
                     DeviceSchedule, decrement_reference, pack_graph,
                     pack_schedule, wavefront_step, wavefront_step_torch)
from .faults import DROPPED_DECREMENT, Fault, FaultPlan
from .fused import (FusedExecutor, FusedRun, graph_tile, host_execute,
                    pack_origins)
from .recovery import ScheduleValidationError, StallError, StallReport
from .taskgraph import (Dependence, IndexedGraph, MaterializedGraph,
                        PolyhedralProgram, Statement, TiledTaskGraph)
from .wavefront import (IndexedSchedule, levels_from_array,
                        schedule_from_graph, synthesize_indexed)

__all__ = [
    "DROPPED_DECREMENT", "Dependence", "DeviceCounters", "DeviceExecutor",
    "DeviceGraph", "DeviceRun", "DeviceSchedule", "Fault", "FaultPlan",
    "FusedExecutor", "FusedRun", "IndexedGraph", "IndexedSchedule",
    "MaterializedGraph", "PolyhedralProgram", "ScheduleValidationError",
    "StallError", "StallReport", "Statement", "TiledTaskGraph",
    "decrement_reference", "graph_tile", "host_execute", "levels_from_array",
    "pack_graph", "pack_origins", "pack_schedule", "schedule_from_graph",
    "synthesize_indexed", "wavefront_step", "wavefront_step_torch",
]
