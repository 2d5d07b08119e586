"""Single-device join core of the port (mirrors arrow_go_tpu.parallel)."""
