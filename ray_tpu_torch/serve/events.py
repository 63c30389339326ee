"""`TokenEvent`, the item an engine's token stream yields, in a module
of its own that imports no ``torch``: the serve control plane's processes
(the HTTP proxy, an ingress replica composing an engine deployment)
unpickle streamed tokens without loading the engine."""

from __future__ import annotations


class TokenEvent(int):
    """A generated token id that is also an ``int``, carrying
    ``logprob`` (the model's natural log-likelihood of this token given
    its prefix, f32 log_softmax of the logits) and ``params_version``."""

    def __new__(cls, token: int, logprob: float = 0.0,
                params_version: int = 0):
        ev = super().__new__(cls, token)
        ev.logprob = float(logprob)
        ev.params_version = int(params_version)
        return ev

    def __reduce__(self):
        return (TokenEvent, (int(self), self.logprob, self.params_version))

    def __repr__(self):
        return (f"TokenEvent({int(self)}, logprob={self.logprob:.4f}, "
                f"params_version={self.params_version})")
