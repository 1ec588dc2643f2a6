"""Serving: the continuous-batching engine over Setokim."""

from setok_tpu_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
