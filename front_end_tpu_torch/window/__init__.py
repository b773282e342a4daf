"""Sliding-window landmark tracking (counterpart of `front_end_tpu/window/`)."""
