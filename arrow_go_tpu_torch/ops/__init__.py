"""Device operators of the port (mirrors arrow_go_tpu.ops)."""
