from .sliding_window import sliding_window_inference, sliding_window_probs_device

__all__ = ["sliding_window_inference", "sliding_window_probs_device"]
