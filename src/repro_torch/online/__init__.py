"""Online adaptation: judgment-free shadow labeling, continuous cascade
retraining, and hot-swap predictors in the serving path (the port of
``repro.online``; ``controller.py`` draws the loop)."""

from repro_torch.online.controller import OnlineConfig, OnlineController
from repro_torch.online.drift import DriftConfig, DriftDecision, EnvelopeMonitor
from repro_torch.online.replay import replay, shifted_queries
from repro_torch.online.shadow import (ShadowBatch, ShadowExecutor,
                                 reference_param, serving_med_table)
from repro_torch.online.store import PredictorStore, PredictorVersion
from repro_torch.online.telemetry import TelemetryBuffer, TelemetryRecord
from repro_torch.online.trainer import CascadeTrainer, TrainerConfig

__all__ = [
    "OnlineConfig", "OnlineController",
    "DriftConfig", "DriftDecision", "EnvelopeMonitor",
    "replay", "shifted_queries",
    "ShadowBatch", "ShadowExecutor", "reference_param",
    "serving_med_table",
    "PredictorStore", "PredictorVersion",
    "TelemetryBuffer", "TelemetryRecord",
    "CascadeTrainer", "TrainerConfig",
]
