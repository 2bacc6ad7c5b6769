"""The compressed steps over data ranks with a masked-mean loss whose
counts differ on the ranks: qwZ, qgZ and 1-bit Adam keep a mean of each
rank's local mean, as JAX's shard_map steps do (only the exact step takes
the global mean, test_torch_masked_mean_ranks.py).  Tiny Llama's
packed-document loss over data = 2 on two gloo ranks, held to the JAX
engine in the same mode: losses at rtol 1e-4, parameters after two steps at
the one-device BERT test's rtol 1e-3 / atol 1e-4 (1-bit Adam at one step of
lr: test_torch_masked_mean_ranks.ONEBIT_TOL).  Tiny BERT's MLM mean (10 and
15 labels on the ranks) trains under qwZ too: its pooler is a leaf the loss
does not reach, which takes a zero gradient, as JAX's grad gives it."""

import pytest
import torch

from test_torch_masked_mean_ranks import _conf, check_against_jax, start_ranks

torch.set_num_threads(1)
CASES = {
    "bert_qwz": _conf({"stage": 3, "zero_quantized_weights": True}),
    "llama_qwz": _conf({"stage": 3, "zero_quantized_weights": True}),
    "llama_qgz": _conf({"stage": 2, "zero_quantized_gradients": True}),
    "llama_onebit": _conf(opt="OnebitAdam",
                          opt_params={"lr": 3e-3, "freeze_step": 4}),
}


@pytest.fixture(scope="module")
def runs():
    yield from start_ranks(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compressed_steps_keep_local_means_as_jax(runs, name):
    check_against_jax(runs, name, CASES[name])
