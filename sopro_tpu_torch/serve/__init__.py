"""Serving (counterpart: sopro_tpu/serve): the continuous-batching
scheduler and the HTTP servers (`server.py`, `server_stdlib.py`)."""

from sopro_tpu_torch.serve.scheduler import ContinuousBatcher, SessionHandle

__all__ = ["ContinuousBatcher", "SessionHandle"]
