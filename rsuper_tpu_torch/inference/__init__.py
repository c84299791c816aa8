from .sliding_window import sliding_window_inference, sliding_window_probs_device
from .sliding_window2d import sliding_window_inference_2d

__all__ = ["sliding_window_inference", "sliding_window_probs_device",
           "sliding_window_inference_2d"]
