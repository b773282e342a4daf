"""Studies, reports and exploration (counterpart of
`front_end_tpu/analysis/`)."""
