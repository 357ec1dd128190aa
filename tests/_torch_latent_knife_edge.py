"""The knife edge of yolo26-master-latent-n's step 1 at 64 px, in JAX and in the
port, on the CPU (tests/_torch_mixture_graphs.py's weights, batches and
compiled JAX fp32 step):

    JAX_PLATFORMS=cpu python tests/_torch_latent_knife_edge.py

sJ is JAX's state after step 0, sP the port's own fp32 state after step 0
(1e-6 apart). On the line sJ + t (sP - sJ), each package's step-1 gradient
(the SGD trace of a fresh optimizer: clipped, with the coupled decay) is
printed as its relative distance from JAX's at the first t, beside the port's
fp32 and float64 distances from JAX's at the same t, and whether the assigner's
targets moved. Two values about 14% apart show up in every column: the split
is JAX's own, not the port's.
"""

import copy
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_mixture_graphs as mg  # noqa: E402
from yolo_master_tpu.engine import train_step as jts  # noqa: E402
from yolo_master_tpu.nn.mixture_loss import init_aux_ema  # noqa: E402
from yolo_master_tpu_torch.engine import train_step as ts  # noqa: E402
from yolo_master_tpu_torch.nn import losses  # noqa: E402
from yolo_master_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402
from test_torch_train_step import _jb  # noqa: E402

TS = (-8, -2, 0, 0.5, 1, 2, 8)


def main():
    torch.set_num_threads(2)
    g = mg.setup("yolo26-master-latent-n")
    jstates, _, _, jstats = mg.jax_run(g, batches=g["batches"][:1])
    pin = mg.kept_lists(jstats[0][1])
    model, ptx, step = mg._model_and_step(g, torch.float32)
    mg._pinned_step(step, ts.make_train_state(model, ptx), g["batches"][0], torch.float32, pin, [], [])
    s_p = {k: v.clone() for k, v in model.state_dict().items()}
    s_j = state_dict_from_jax(jstates[1].params)
    batch = g["batches"][1]
    print("states apart:", max((s_j[k] - s_p[k]).abs().max().item() for k in s_j if s_j[k].is_floating_point()))

    def jax_grad(sd):
        m = copy.deepcopy(g["base"])
        m.load_state_dict(sd)
        p = mg.jax_params_of(g["jm"], m)
        st = jts.TrainState(p, g["tx"].init(p), jax.tree_util.tree_map(jnp.copy, p), jnp.asarray(1, jnp.int32),
                            jnp.zeros((), jnp.float32), init_aux_ema())
        st, met = g["steps"][jnp.float32](st, _jb(batch))
        return mg.jax_trace(g, mg._copy_np(st)), mg.kept_lists(mg.split_stats(met.pop("moe_stats"))[1])

    assigned = []
    plain = losses.task_aligned_assign

    def recording(*a, **k):
        out = plain(*a, **k)
        assigned.append(torch.cat([out.fg_mask.flatten().float(), out.target_gt_idx.flatten().float()]))
        return out

    def port_grad(sd, dtype, pin):
        m, tx, fn = mg._model_and_step(g, dtype)
        m.load_state_dict(sd)
        state = ts.make_train_state(m, tx)
        state.step = 1
        state, _ = mg._pinned_step(fn, state, batch, dtype, pin, [], [])
        return state.opt_state.buffers["trace"]

    keys, first, first_assign = None, None, None
    for t in TS:
        sd = {k: v + t * (s_p[k] - v) if v.is_floating_point() else v for k, v in s_j.items()}
        tj, pin = jax_grad(sd)
        assigned.clear()
        losses.task_aligned_assign = recording
        try:
            t32 = port_grad(sd, torch.float32, pin)
        finally:
            losses.task_aligned_assign = plain
        t64 = port_grad(sd, torch.float64, pin)
        keys = keys or sorted(t32)
        j, p32, p64 = (torch.cat([d[k].double().flatten() for k in keys]) for d in (tj, t32, t64))
        first = j if first is None else first
        assign = torch.cat(assigned)
        first_assign = assign if first_assign is None else first_assign

        def rel(a, b):
            return ((a - b).norm() / b.norm()).item()

        print(f"t={t:>4}: JAX from JAX at t={TS[0]} {rel(j, first):.4g}; port fp32 from JAX {rel(p32, j):.4g}; "
              f"port float64 from JAX {rel(p64, j):.4g}; assignment as at t={TS[0]}: {torch.equal(assign, first_assign)}")


if __name__ == "__main__":
    main()
