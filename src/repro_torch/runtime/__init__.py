"""Fault-tolerant training runtime (host-side orchestration via autodec EDTs)."""
from .driver import DriverConfig, StepResult, TrainDriver, run_with_backup

__all__ = ["TrainDriver", "DriverConfig", "StepResult", "run_with_backup"]
