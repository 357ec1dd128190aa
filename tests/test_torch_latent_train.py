"""yolo26-master-latent-n's training in the port against the JAX package, on
the CPU at 64 px: the three LatentMixtures before the head (layers 23-25:
their aux loss, published at every train-mode forward, and the router's logit
noise, at noise_std 0.5 here, JAX's draw bit for bit) beside the six routed
blocks of layers 4, 6 and 8's A2C2fMoE, with the residual gains and router
heads woken. The gates are tests/_torch_mixture_graphs.py's: one
step (loss terms, the aux of each family, every kept-expert set, the gradient
the optimizer takes, the routing stats), three steps each from JAX's state and
the port's own run as far as step 1's knife edge lets it be held, against one
compiled JAX fp32 step; a bf16 step with the routed blocks' picks pinned to JAX
bf16's, by PERF.md §7's statistic. The loop, resume and MultiTrainer run the
same trainer code as yolo26-master-moa-mot-n's (tests/test_torch_moa_mot_train.py);
tests/test_torch_trainer.py trains this graph for an epoch through ``YOLO.train``.
"""

import pytest
import torch

import _torch_mixture_graphs as mg  # noqa: E402 (tests/ is on the path)

NAME = "yolo26-master-latent-n"


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
    mg.check_free_run(g, run, held=1)


def test_latent_noise_is_jax_draw_bit_for_bit(g, run):
    """After the first step each LatentMixture's router holds the noise of step
    0, normal(_path_key(0, "layers.N.router"), [4, 4]) * 0.5, as jax.random
    draws it, and the first step's loss and aux (tests above) are JAX's; the
    three routers' draws differ; a router at step 1 draws JAX's step-1 noise."""
    import jax
    import numpy as np

    from yolo_master_tpu.nn.moe import mixtures as jmix
    from yolo_master_tpu_torch.nn.latent_mixture import LatentRouter

    routers = [(n, m) for n, m in run["carried"][0]["model"].named_modules() if isinstance(m, LatentRouter)]
    assert [m.jax_path for _, m in routers] == [f"layers.{i}.router" for i in (23, 24, 25)]
    draws = []
    for _, m in routers:
        key = jmix._path_key(0, m.jax_path)
        assert m._draws[0][:2] == (0, (4, 4))
        np.testing.assert_array_equal(m._draws[1].numpy(), np.asarray(jax.random.normal(key, (4, 4)) * mg.NOISE))
        draws.append(m._draws[1])
    assert not torch.equal(draws[0], draws[1])
    m = routers[0][1]
    m.step = 1
    np.testing.assert_array_equal(m.noise((4, 4), "cpu").numpy(),
                                  np.asarray(jax.random.normal(jmix._path_key(1, m.jax_path), (4, 4)) * mg.NOISE))


def test_bf16_step_with_jax_bf16_picks_follows_jax(g):
    port, own, n_flips = mg.check_bf16(g)
    print(f"{NAME} bf16 trace rel-RMS from JAX fp32: port {port:.4g}, JAX bf16 {own:.4g}; "
          f"flips of the port's own bf16 picks by batch {n_flips}")
