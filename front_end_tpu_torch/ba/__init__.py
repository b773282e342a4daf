"""Windowed bundle adjustment (counterpart of `front_end_tpu/ba/`)."""
