"""Serving: the bucketed inference engines, the micro-batching HTTP daemon
and the AOT serving artifacts (serve/export.py)."""
from .engine import (DEFAULT_BUCKETS, InferenceEngine, clip_hba_engine,
                     vit_classifier_engine, vit_features_engine)
from .server import MicroBatcher, ServingDaemon

__all__ = ["DEFAULT_BUCKETS", "InferenceEngine", "clip_hba_engine",
           "vit_classifier_engine", "vit_features_engine", "MicroBatcher",
           "ServingDaemon"]
