"""Serving: the continuous-batching engine and its replica."""

from ray_tpu_torch.exceptions import OverloadedError
from ray_tpu_torch.serve.engine import (InferenceEngine, InferenceReplica,
                                        TokenEvent)

__all__ = ["InferenceEngine", "InferenceReplica", "OverloadedError",
           "TokenEvent"]
