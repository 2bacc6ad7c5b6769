"""Host IO for the port (ref: deepspeed/ops/aio): the aio pool, the host
runtime natives and the safetensors format."""
