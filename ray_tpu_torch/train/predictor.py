"""Predictors: the counterpart of `ray_tpu/train/predictor.py`'s
`Predictor` and `JaxPredictor`.

`TorchPredictor` owns one apply function and the weights it reads:
they are placed on the device once, batches arrive as numpy, ride one
copy to the device, run under ``torch.no_grad()`` and come back as
numpy. There is nothing to jit, so it has no ``jit`` argument.
`BatchPredictor` maps a predictor over a ``ray_tpu.data`` Dataset
through an actor pool; it waits for the runtime and Data (ROADMAP A5).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ray_tpu_torch.train.checkpoint import Checkpoint


class Predictor:
    """Base: subclass with `_predict_numpy` (`ray_tpu.train.predictor.
    Predictor`)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, data, **kwargs):
        if isinstance(data, dict):
            return self._predict_numpy(data, **kwargs)
        arr = np.asarray(data)
        return self._predict_numpy({"__value__": arr}, **kwargs)

    def _predict_numpy(self, batch: Dict[str, np.ndarray], **kwargs):
        raise NotImplementedError


def _place(tree, device):
    from ray_tpu_torch.train import ft

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x))
        return x.to(device) if isinstance(x, torch.Tensor) else x
    return ft.tree_map(put, tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class TorchPredictor(Predictor):
    """Wraps ``(apply_fn, params)``: ``apply_fn(params, batch_tensor)`` ->
    output tensor, the counterpart of `ray_tpu.train.predictor.
    JaxPredictor`. ``params`` (a tree of tensors or numpy arrays) is
    placed on ``device`` (the card unless told otherwise) once, array
    leaves as tensors of their own dtype.

    `input_column` picks the feature column of dict batches
    ("__value__" for plain arrays); output lands in `output_column`."""

    def __init__(self, apply_fn: Callable, params: Any,
                 input_column: str = "__value__",
                 output_column: str = "predictions", device=None):
        from ray_tpu_torch.models.gpt import resolve_device
        self.device = resolve_device(device)
        self._apply = apply_fn
        self._params = _place(params, self.device)
        self.input_column = input_column
        self.output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable, **kwargs) -> "TorchPredictor":
        state = checkpoint.to_dict()
        params = state.get("params", state)
        return cls(apply_fn, params, **kwargs)

    @torch.no_grad()
    def _predict_numpy(self, batch: Dict[str, np.ndarray], **kwargs):
        col = self.input_column if self.input_column in batch \
            else next(iter(batch))
        x = torch.as_tensor(np.asarray(batch[col])).to(self.device)
        out = self._apply(self._params, x)
        result = dict(batch)
        result[self.output_column] = _to_numpy(out)
        return result
