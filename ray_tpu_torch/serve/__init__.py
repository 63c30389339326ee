"""Serving: the continuous-batching engine and its replica, and the
role-split replicas of disaggregated prefill/decode serving."""

from ray_tpu_torch.exceptions import OverloadedError
from ray_tpu_torch.serve.disagg import (DecodeReplica, PrefillReplica,
                                        disagg_resume)
from ray_tpu_torch.serve.engine import (InferenceEngine, InferenceReplica,
                                        TokenEvent)

__all__ = ["DecodeReplica", "InferenceEngine", "InferenceReplica",
           "OverloadedError", "PrefillReplica", "TokenEvent",
           "disagg_resume"]
