"""Sparse expert dispatch: compute only the top-k routed experts (counterpart of
``yolo_master_tpu/nn/moe/dispatch.py``).

1. :func:`stack_expert_params` stacks the E experts' parameters into ``[E, ...]``
   banks (depthwise kernels of 3/5/7 centre-padded to the largest, which is
   exact for stride-1 SAME convs); :func:`expert_bank` keeps them between
   forwards until a parameter changes;
2. :func:`gather_dispatch` gathers the ``[B, K]`` selected experts' banks and
   runs them with (b, k) written out as a batch dimension, where the JAX
   package vmaps twice: each expert type's ``forward_gathered`` does it (a
   grouped conv over ``[1, B*K*C, H, W]`` for a depthwise conv, a batched
   matmul over per-(b, k) weights for a 1x1).

The FLOPs scale with K, not E. The sum matches the masked-dense path to float
rounding: masked-dense adds exact zeros for the unselected experts, the
gathered path leaves them out. Plain PyTorch: the JAX package leaves this to XLA.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _pad_kernel_center(w: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Zero-pad an OIHW conv kernel to [O, I, kh, kw], centred (exact for
    stride-1 convs with (k-1)//2 padding: the extra taps are zero)."""
    dh, dw = kh - w.shape[-2], kw - w.shape[-1]
    if dh < 0 or dw < 0 or dh % 2 or dw % 2:
        raise ValueError(f"kernel {tuple(w.shape[-2:])} cannot be centred in ({kh}, {kw})")
    return F.pad(w, (dw // 2, dw // 2, dh // 2, dh // 2))


def stack_expert_params(experts: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
    """E structurally identical experts -> {state_dict name: [E, ...] bank}.

    4-D conv kernels whose spatial sizes differ are centre-padded to the largest.
    """
    sds = [e.state_dict() for e in experts]
    bank = {}
    for name in sds[0]:
        if name.endswith("num_batches_tracked"):
            continue
        leaves = [sd[name] for sd in sds]
        if len({tuple(t.shape) for t in leaves}) > 1:
            if not all(t.dim() == 4 for t in leaves):
                raise ValueError(f"cannot stack heterogeneous non-conv leaves {name}: "
                                 f"{sorted({tuple(t.shape) for t in leaves})}")
            kh, kw = max(t.shape[2] for t in leaves), max(t.shape[3] for t in leaves)
            leaves = [_pad_kernel_center(t, kh, kw) for t in leaves]
        bank[name] = torch.stack(leaves)
    return bank


def _tensors(module: nn.Module, out: list) -> list:
    """Every parameter and buffer under ``module``, by a direct walk: several
    times cheaper on the host than ``parameters()`` + ``buffers()``."""
    out.extend(t for t in (*module._parameters.values(), *module._buffers.values()) if t is not None)
    for child in module._modules.values():
        if child is not None:
            _tensors(child, out)
    return out


def expert_bank(experts: nn.Module) -> Dict[str, torch.Tensor]:
    """:func:`stack_expert_params` of ``experts`` (an ``nn.ModuleList``), kept on
    it between calls, so that eval does not restack the banks on every forward.

    The bank is rebuilt when a tensor of the experts is another one (``.to()``,
    ``fuse()``) or was written in place (``load_state_dict``, an optimizer step:
    each bumps the tensor's version counter). BatchNorm updates its running
    statistics without a bump, but bumps ``num_batches_tracked`` in the same
    training-mode forward. The cache holds the tensors it was built from, so no
    new tensor can take their address. A write through ``.data`` is not seen.
    """
    tensors = _tensors(experts, [])
    key = [(t.data_ptr(), t._version) for t in tensors]
    cached = experts.__dict__.get("_expert_bank")
    if cached is None or cached[0] != key:
        cached = (key, [t.detach() for t in tensors], stack_expert_params(experts))
        experts.__dict__["_expert_bank"] = cached
    return cached[2]


def gather_dispatch(expert: nn.Module, bank: Dict[str, torch.Tensor], x: torch.Tensor, idx: torch.Tensor,
                    wts: torch.Tensor) -> torch.Tensor:
    """out[b] = sum_k wts[b,k] * expert_{idx[b,k]}(x[b]), summed in fp32.

    ``expert`` is any expert of the bank (its type's ``forward_gathered`` runs
    the gathered parameters); ``x`` [B, C, H, W]; ``idx`` [B, K] expert indices;
    ``wts`` [B, K] weights (zeros allowed).
    """
    sel = {name: t[idx.long()] for name, t in bank.items()}  # [B, K, ...]
    y = expert.forward_gathered(sel, x)  # [B, K, O, H, W]
    out = (y.float() * wts.float()[:, :, None, None, None]).sum(1)
    return out.to(x.dtype).contiguous(memory_format=torch.channels_last)


def top_k_from_weights(w: torch.Tensor, k: int):
    """[B, E] weights (zero outside the top-k) -> ([B, K] weights, [B, K] int32
    indices), largest first and, on ties, the lower index first (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order)."""
    vals, order = torch.sort(w, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k].to(torch.int32)
