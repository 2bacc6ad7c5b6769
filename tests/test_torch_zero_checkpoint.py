"""Checkpoints across ZeRO stages and world sizes on gloo ranks
(tests/_torch_dist.py): a stage-3 engine on 4 ranks trains 2 steps and
saves (each leaf gathered whole, written by rank 0); a stage-1 engine on 2
ranks and a stage-0 engine on 1 rank load it, each rank cutting its own
slices.  Every master and moment leaf comes back bit for bit, the step
counters too, and each goes on training (the next step's loss within f32
reordering, rtol 1e-5, of the saving engine's).  ``zero_to_fp32`` of the
4-rank checkpoint equals that engine's ``module_params()`` bit for bit."""

import numpy as np
import pytest

import _torch_dist as td


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("zero_ckpt"))
    saved = td.run_ranks("ckpt", 4, spec={"stage": 3, "save": True,
                                          "dir": d})
    loaded = {W: td.run_ranks("ckpt", W, spec={"stage": s, "save": False,
                                               "dir": d})
              for W, s in ((2, 1), (1, 0))}
    with np.load(d + "/fp32.npz") as z:
        fp32 = {k: z[k] for k in z.files}
    return saved, loaded, fp32


def _state(res):
    return {k: v for k, v in res.items()
            if k.split("/")[0] in ("params", "mu", "nu")}


@pytest.mark.parametrize("W", [2, 1])
def test_loads_at_another_stage_and_world_bit_for_bit(runs, W):
    saved, loaded, _ = runs
    want = _state(saved[0])
    assert len(want) == 12
    for r in range(W):
        got = _state(loaded[W][r])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(loaded[W][r]["step"], [2, 2])
        np.testing.assert_allclose(loaded[W][r]["next_loss"],
                                   saved[0]["next_loss"], rtol=1e-5)


def test_every_saving_rank_holds_the_same_state(runs):
    saved, _, _ = runs
    for r in range(1, 4):
        for k, v in _state(saved[0]).items():
            np.testing.assert_array_equal(saved[r][k], v, err_msg=k)


def test_zero_to_fp32_equals_module_params(runs):
    saved, _, fp32 = runs
    params = {k[len("params/"):]: v for k, v in saved[0].items()
              if k.startswith("params/")}
    assert fp32.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_array_equal(fp32[k], v, err_msg=k)
