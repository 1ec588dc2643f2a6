"""Serving: the continuous-batching engine over Setokim, and the int4
calibration."""

from setok_tpu_torch.serve.calibrate import collect_row_weights
from setok_tpu_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine", "collect_row_weights"]
