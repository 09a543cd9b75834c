"""Serving: the bucketed inference engine and the micro-batching HTTP daemon."""
from .engine import DEFAULT_BUCKETS, InferenceEngine, clip_hba_engine
from .server import MicroBatcher, ServingDaemon

__all__ = ["DEFAULT_BUCKETS", "InferenceEngine", "clip_hba_engine",
           "MicroBatcher", "ServingDaemon"]
