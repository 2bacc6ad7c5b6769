"""Parallelism strategies of the port (port of ``deepspeed_tpu/parallel``).

- :mod:`tensor_parallel` — Megatron-style intra-layer model parallelism over
  the ``model`` axis: spec builders and the mappings that perform the
  collectives XLA inserts for the JAX package.
- :mod:`sequence_parallel` — DeepSpeed-Ulysses all-to-all head/sequence
  parallel attention over the ``seq`` axis.
- :mod:`ring_attention` — ring attention (blockwise, online softmax) over
  the ``seq`` axis.
- :mod:`pipeline` — pipeline parallelism over the ``pipe`` axis (the tick
  schedule with a ``ppermute`` handoff, and its reverse for the backward).
- :mod:`moe` — mixture-of-experts with expert parallelism over the
  ``expert`` axis.
"""

from deepspeed_tpu_torch.parallel import moe  # noqa: F401
from deepspeed_tpu_torch.parallel import pipeline  # noqa: F401
from deepspeed_tpu_torch.parallel import ring_attention  # noqa: F401
from deepspeed_tpu_torch.parallel import sequence_parallel  # noqa: F401
from deepspeed_tpu_torch.parallel import tensor_parallel  # noqa: F401
