"""Parallelism strategies of the port (port of ``deepspeed_tpu/parallel``).

- :mod:`moe` — mixture-of-experts: the capacity-limited top-k gate and the
  MoE layer on one device; expert parallelism over a mesh comes with the
  distributed slice (ROADMAP A9), as do tensor, sequence and pipeline
  parallelism.
"""
