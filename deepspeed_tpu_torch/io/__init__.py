"""Host IO for the port (ref: deepspeed/ops/aio)."""
