"""yolo26-master-moa-mot-n's training in the port against the JAX package, on
the CPU at 64 px: MoA's aux loss at P3 (C2fMoA, layer 16), MoT's aux loss and
exploration floor at P4/P5 (C2fMoT, layers 13, 19, 22: top-2, top-2, top-1),
the deformable expert's gradient through its gather, with the zero-initialised
routers and offsets woken. The gates are tests/_torch_mixture_graphs.py's: one
step (loss terms, the aux of each family, every kept-expert set, the gradient
the optimizer takes, the routing stats) and three steps, each from JAX's state
and on the port's own, against one compiled JAX fp32 step; a bf16 step with MoT's kept sets pinned to JAX bf16's, by PERF.md
§7's statistic; the loop and MultiTrainer held to the port's own step, as
tests/test_torch_yolo26_train.py holds yolo26-master-n's.
"""

import pytest
import torch

import _torch_mixture_graphs as mg  # noqa: E402 (tests/ is on the path)
from test_train import synth_dataset  # noqa: F401 (fixture reuse: 16 train, 8 val 96-px images)

NAME = "yolo26-master-moa-mot-n"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def g():
    return mg.setup(NAME)


@pytest.fixture(scope="module")
def run(g):
    return mg.trajectory(g)


def test_one_step_matches_jax(g, run):
    mg.check_first_step(g, run)


def test_three_steps_match_jax_make_train_step(g, run):
    mg.check_trajectory(g, run)


def test_own_steps_follow_jax(g, run):
    mg.check_free_run(g, run, held=mg.K)


def test_bf16_step_with_jax_bf16_picks_follows_jax(g):
    port, own, n_flips = mg.check_bf16(g)
    print(f"{NAME} bf16 trace rel-RMS from JAX fp32: port {port:.4g}, JAX bf16 {own:.4g}; "
          f"flips of the port's own bf16 picks by batch {n_flips}")


@pytest.fixture(scope="module")
def start(synth_dataset):  # noqa: F811
    return mg.start_weights(NAME, synth_dataset)


def test_moa_mot_loop_is_its_own_step(synth_dataset, start, tmp_path):  # noqa: F811
    mg.check_loop(NAME, synth_dataset, start, tmp_path)


def test_moa_mot_amp_run_resumes_bitwise(synth_dataset, start, tmp_path):  # noqa: F811
    mg.check_amp_resume(NAME, synth_dataset, start, tmp_path)


def test_moa_mot_multitrainer_runs_and_restores_the_base(synth_dataset, start, tmp_path):  # noqa: F811
    mg.check_multitrainer(NAME, synth_dataset, start, tmp_path)
