"""Core blocks of the YOLO-Master backbone and neck, as ``torch.nn`` modules.

Counterpart of ``yolo_master_tpu/nn/layers.py`` for the modules of the
yolo-master and yolo26-master detection graphs (SPPF and the PSA
attention family: Attention, PSABlock, C2PSA, C3k2's ``attn`` form).
Activations are NCHW tensors in ``torch.channels_last`` memory (the JAX
package's NHWC, viewed as NCHW); conv weights are OIHW. Module and parameter
names follow the ultralytics state_dict (``cv1.conv.weight``,
``cv1.bn.running_mean``, ``m.0.cv2...``), so
``yolo_master_tpu/utils/torch_import.py:import_state_dict`` maps them onto the
JAX parameter tree one to one.

BatchNorm uses eps 1e-3 and momentum 0.03, as the JAX package does.

Every module follows the JAX package's per-op casts, so that one module serves
the fp32 model, a bf16 copy of it (``utils/fuse.py:compute_dtype_copy``) and
bf16 training of its fp32 parameters: convs in the activation dtype, their
weights cast to it on each call (:class:`Conv2d`; JAX ``w.astype(x.dtype)``,
``yolo_master_tpu/nn/layers.py:65,74``), eval BatchNorm folded in fp32 and
applied as one multiply-add in the activation dtype, train-mode BatchNorm in
fp32 rounded once, GroupNorm and average pooling in fp32, attention logits in
the activation dtype with the softmax in fp32, A2C2f's ``gamma`` cast to the
activation dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k, p=None, d: int = 1):
    """'same' padding for odd kernels; ``k`` is an int or a tuple."""
    if isinstance(k, (tuple, list)):
        return tuple(autopad(kk, p, d) for kk in k)
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: the weight and bias are cast to it on
    each call (a no-op where they already have it), and the gradient reaches
    them in their own dtype through the cast."""

    def forward(self, x):
        b = self.bias
        return self._conv_forward(x, self.weight.to(x.dtype), None if b is None else b.to(x.dtype))


class Conv(nn.Module):
    """conv2d (no bias) + BatchNorm + SiLU; after :meth:`fuse`, conv2d with bias + SiLU."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act is True else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))

    @torch.no_grad()
    def fuse(self):
        """Fold the BatchNorm into the conv (the deploy form)."""
        if isinstance(self.bn, nn.Identity):
            return
        w, b = fold_bn(self.conv.weight, None, self.bn)
        conv = self.conv
        fused = Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, conv.padding,
                       groups=conv.groups, dilation=conv.dilation, bias=True, device=w.device, dtype=w.dtype)
        fused.weight.copy_(w)
        fused.bias.copy_(b)
        self.conv = fused
        self.bn = nn.Identity()


def bn_scale_shift(mean, var, weight, bias, eps: float):
    """Eval BatchNorm as (scale, shift) with y = x * scale + shift, in the statistics' dtype."""
    scale = weight * torch.rsqrt(var + eps)
    return scale, bias - mean * scale


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d``, on an input of lower precision than its statistics
    (bf16 against fp32) in the JAX package's form
    (``yolo_master_tpu/nn/layers.py:BatchNorm``). In eval the statistics fold
    in fp32 into a scale and a shift, both rounded to the input's dtype, and
    one multiply-add in that dtype. In training PyTorch's own mixed-dtype batch
    norm is JAX's form (``layers.py:130-144``): the statistics of the input
    widened to fp32, the biased variance in the normalisation and the unbiased
    one in the running statistics, ``(x - mean) * inv + bias`` in fp32 rounded
    once to the input's dtype."""

    def forward(self, x):
        if self.training or x.dtype == self.running_var.dtype:
            return super().forward(x)
        scale, shift = bn_scale_shift(self.running_mean, self.running_var, self.weight, self.bias, self.eps)
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def fold_bn(weight: torch.Tensor, bias, bn: nn.BatchNorm2d):
    """(w, b) of a conv followed by eval-mode BN, as one conv (``utils/fuse.py:fuse_bn_params``)."""
    inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    w = weight * inv[:, None, None, None]
    b = (bias if bias is not None else 0.0) * inv + bn.bias - bn.running_mean * inv
    return w, b


class DWConv(Conv):
    """Depthwise conv: groups = gcd(c1, c2)."""

    def __init__(self, c1, c2, k=1, s=1, d=1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, bottleneck_k=((1, 1), (3, 3))):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut, g, k=bottleneck_k, e=1.0) for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    """C3 with square k x k bottleneck kernels."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=3):
        super().__init__(c1, c2, n, shortcut, g, e, bottleneck_k=((k, k), (k, k)))


class C2f(nn.Module):
    """CSP bottleneck with 2 convs, every inner output concatenated."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=((3, 3), (3, 3)), e=1.0) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3k2(C2f):
    """C2f whose inner blocks are C3k (``c3k``), Bottleneck, or with ``attn`` a
    Bottleneck followed by a :class:`PSABlock` of ``max(c // 64, 1)`` heads
    (``attn`` wins over ``c3k``, as in the JAX package)."""

    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, attn=False, g=1, shortcut=True):
        super().__init__(c1, c2, n, shortcut, g, e)

        def inner():
            if attn:
                return nn.Sequential(Bottleneck(self.c, self.c, shortcut, g),
                                     PSABlock(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1)))
            return C3k(self.c, self.c, 2, shortcut, g) if c3k else Bottleneck(self.c, self.c, shortcut, g)

        self.m = nn.ModuleList(inner() for _ in range(n))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: cv1 (no activation), then ``n`` chained
    k x k max pools (stride 1, 'same' padding by -inf, as the JAX package's
    ``max_pool``), every map concatenated into cv2."""

    def __init__(self, c1, c2, k=5, n=3, shortcut=False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, act=False)
        self.cv2 = Conv(c_ * (n + 1), c2, 1, 1)
        self.k, self.n = k, n
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(self.n):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        out = self.cv2(torch.cat(y, 1))
        return out + x if self.add else out


ATTN_KEY_CHUNK = 1024  # keys a partial product of an fp32 attention's probabilities with V takes (attend)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over tokens: q, k, v [B, N, heads, d] -> [B, N,
    heads, d]. The logits are a plain product in the activation dtype and the
    softmax reduces in fp32, rounded back to that dtype, as the JAX package
    does. In fp32, past ``ATTN_KEY_CHUNK`` keys the product of the
    probabilities with V sums the keys in chunks of that many, adding the
    partial products in fp32: one cuBLAS product over 6,400 keys
    (yolo26-master's P3 at 640 px) lands about 10x as far from fp64 as the
    CPU's, and the chunks bring it to twice the CPU's (``chip_smoke.py``'s
    yolo26 phase prints both). The same sum, rounded more closely."""
    attn = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    n_keys = k.shape[1]
    if n_keys <= ATTN_KEY_CHUNK or q.dtype != torch.float32:
        return torch.einsum("bhnm,bmhd->bnhd", attn, v)
    vt = v.transpose(1, 2)  # [B, heads, N, d]
    out = sum(torch.matmul(attn[..., s:s + ATTN_KEY_CHUNK], vt[:, :, s:s + ATTN_KEY_CHUNK])
              for s in range(0, n_keys, ATTN_KEY_CHUNK))
    return out.transpose(1, 2)


class AAttn(nn.Module):
    """Area attention: softmax attention within ``area`` horizontal bands of the
    map, plus a 7x7 depthwise positional conv on V.

    Tokens are the row-major pixels; the area split reshapes them to
    ``[B*area, N/area, ...]`` (H*W must divide by ``area``). Logits are plain
    matmuls and the softmax reduces in fp32, as the JAX package does
    (:func:`attend`).
    """

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.area = area
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        ahd = self.head_dim * num_heads
        self.qkv = Conv(dim, ahd * 3, 1, act=False)
        self.proj = Conv(ahd, dim, 1, act=False)
        self.pe = Conv(ahd, ahd, 7, 1, 3, g=ahd, act=False)

    def forward(self, x):
        B, _, H, W = x.shape
        N = H * W
        nh, hd = self.num_heads, self.head_dim
        ahd = nh * hd
        qkv = self.qkv(x).flatten(2).transpose(1, 2)  # [B, N, 3*ahd], row-major tokens
        bq, nq = B * self.area, N // self.area
        q, k, v = qkv.reshape(bq, nq, nh, 3, hd).unbind(3)  # [bq, nq, nh, hd] each
        o = attend(q, k, v, hd ** -0.5)

        def to_map(t):  # [bq, nq, nh, hd] -> [B, ahd, H, W] channels_last
            return t.reshape(B, H, W, ahd).permute(0, 3, 1, 2)

        return self.proj(to_map(o) + self.pe(to_map(v)))


class ABlock(nn.Module):
    """x + attn(x), then x + mlp(x)."""

    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads=num_heads, area=area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, hidden, 1), Conv(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """Area-attention C2f: each of the ``n`` inner blocks is two attention blocks
    of ``c_ // 32`` heads (``block(c_)``, :class:`ABlock` unless given), or a
    C3k without ``a2``."""

    def __init__(self, c1, c2, n=1, a2=True, area=1, residual=False, mlp_ratio=2.0, e=0.5, g=1, shortcut=True,
                 block=None):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 32:
            raise ValueError(f"{type(self).__name__} hidden dim must be a multiple of 32")
        block = block or (lambda c: ABlock(c, c // 32, mlp_ratio, area))
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = nn.Parameter(0.01 * torch.ones(c2)) if a2 and residual else None
        self.m = nn.ModuleList(
            nn.Sequential(block(c_), block(c_)) if a2 else C3k(c_, c_, 2, shortcut, g) for _ in range(n))

    def forward(self, x):
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.cv2(torch.cat(ys, 1))
        if self.gamma is not None:
            return x + self.gamma.to(y.dtype).view(1, -1, 1, 1) * y
        return y


class Attention(nn.Module):
    """Multi-head self-attention over every pixel of the map (the PSA family),
    plus a 3x3 depthwise positional conv on V.

    ``qkv``'s channels are head-major, ``[heads, 2 * key_dim + head_dim]``, each
    head's slice q, then k, then v, as the JAX package reshapes them; V and the
    output go back to the map head-major. Logits are plain matmuls in the
    activation dtype and the softmax reduces in fp32 (:func:`attend`).
    """

    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        nh, kd = self.num_heads, self.key_dim
        qkv = self.qkv(x).flatten(2).transpose(1, 2).reshape(B, H * W, nh, 2 * kd + self.head_dim)
        q, k, v = qkv.split((kd, kd, self.head_dim), -1)  # [B, N, nh, *] each
        o = attend(q, k, v, self.scale)

        def to_map(t):  # [B, N, nh, hd] -> [B, C, H, W] channels_last, head-major channels
            return t.reshape(B, H, W, C).permute(0, 3, 1, 2)

        return self.proj(to_map(o) + self.pe(to_map(v)))


class PSABlock(nn.Module):
    """x + attn(x), then x + ffn(x) (without ``shortcut``, each stage's output alone)."""

    def __init__(self, c, attn_ratio=0.5, num_heads=4, shortcut=True):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x):
        y = self.attn(x)
        x = x + y if self.add else y
        y = self.ffn(x)
        return x + y if self.add else y


class C2PSA(nn.Module):
    """CSP wrapper around ``n`` PSABlocks of ``c // 64`` heads (1 below 64
    channels) on the second half of cv1's output."""

    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"C2PSA needs c1 == c2, got {c1} and {c2}")
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, 0.5, self.c // 64 if self.c >= 64 else 1) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


def get_safe_groups(channels: int, groups: int = 8) -> int:
    """Largest group count <= ``groups`` that divides ``channels``."""
    g = min(groups, channels)
    while g > 1 and channels % g:
        g -= 1
    return max(g, 1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with a safe group count and eps 1e-5 (the MoE experts' norm),
    computed in its affine's dtype (fp32 in a bf16 copy) and returned in the input's."""

    def __init__(self, c: int, groups: int = 8, eps: float = 1e-5):
        super().__init__(get_safe_groups(c, groups), c, eps=eps)

    def forward(self, x):
        return F.group_norm(x.to(self.weight.dtype), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class PlainConv(Conv2d):
    """A bare conv2d with 'same' padding, no norm or activation, optional bias;
    dilated, it pads ``dilation * (k - 1) // 2`` as the JAX package does."""

    def __init__(self, c1, c2, k=1, s=1, g=1, bias=False, dilation=1):
        p = autopad(k) if dilation == 1 else dilation * (k - 1) // 2
        super().__init__(c1, c2, k, s, p, groups=g, dilation=dilation, bias=bias)


def avg_pool(x: torch.Tensor, k: int, stride: int = None) -> torch.Tensor:
    """k x k average pooling over VALID windows (no padding), stride k unless
    given, as the JAX package's ``avg_pool``: the window sum in fp32, rounded to
    x's dtype, then divided by k*k in that dtype (in bf16 with k = 3 that rounds
    twice; with k = 2 or 4 the division is exact)."""
    return F.avg_pool2d(x.float(), k, stride or k, divisor_override=1).to(x.dtype) / (k * k)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour upsampling by an integer factor."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


class Linear(nn.Linear):
    """``nn.Linear`` (weight [out, in]) in its input's dtype, as the JAX
    package's ``Linear`` (``x @ w.astype(x.dtype)``); the gated MoE blocks feed
    it fp32 statistics, and a bf16 copy keeps its weights fp32."""

    def forward(self, x):
        b = self.bias
        return F.linear(x, self.weight.to(x.dtype), None if b is None else b.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5, in its affine's dtype (fp32),
    returned in the input's."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__(c, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class GlobalAvgPool(nn.Module):
    """Spatial mean [B, C, H, W] -> [B, C, 1, 1], summed in fp32. With ``fp32``
    the mean stays fp32 (the JAX blocks' ``mean(x.astype(float32))``), else it
    is rounded to the input's dtype (``jnp.mean(x)``). Sits where the
    reference's ``nn.AdaptiveAvgPool2d(1)`` sits, so the state_dict indices of
    the layers after it are the reference's."""

    def __init__(self, fp32: bool = False):
        super().__init__()
        self.fp32 = fp32

    def forward(self, x):
        m = x.float().mean((2, 3), keepdim=True)
        return m if self.fp32 else m.to(x.dtype)


class Concat(nn.Module):
    """Concatenate a list of maps along channels."""

    def __init__(self, dim=1):
        super().__init__()
        self.d = dim

    def forward(self, xs):
        return torch.cat(xs, self.d)


class Upsample(nn.Module):
    """Nearest-neighbour upsampling by an integer factor."""

    def __init__(self, size=None, scale=2, mode="nearest"):
        super().__init__()
        if mode != "nearest":
            raise ValueError(f"Upsample mode {mode!r} not supported (only 'nearest')")
        self.scale = int(scale)

    def forward(self, x):
        return upsample_nearest(x, self.scale)


class FusedStem(nn.Module):
    """The two leading k3/s2 Convs as one kernel (``ops/stem.py``), over the
    letterboxed NHWC image (uint8 with the /255 folded into ``w0``, or float).

    Counterpart of ``yolo_master_tpu/nn/layers.py:PallasStem``; built by
    ``utils/fuse.py:fused_stem_fuse`` from BN-folded convs. The OIHW weights
    are stored once in the kernel's HWIO memory order, as ``[9*c_in, c_out]``
    matrices: a 2-D parameter is left alone by the model's channels_last
    conversion, and :meth:`weights` views it as OIHW without a copy. The
    weights stay fp32 in a bf16 copy of the model; ``out_dtype`` (set by
    ``utils/fuse.py:compute_dtype_copy``) is then the output's dtype.
    """

    def __init__(self, w0, b0, w1, b1):
        from ..ops.stem import stem_weight_layout

        super().__init__()
        self.w0 = nn.Parameter(stem_weight_layout(w0).permute(2, 3, 1, 0).flatten(0, 2), requires_grad=False)
        self.w1 = nn.Parameter(stem_weight_layout(w1).permute(2, 3, 1, 0).flatten(0, 2), requires_grad=False)
        self.b0, self.b1 = nn.Parameter(b0, requires_grad=False), nn.Parameter(b1, requires_grad=False)
        self.out_dtype = None  # None: the kernel's default (float32 for uint8 input)

    def weights(self):
        """(w0, b0, w1, b1) as :func:`~..ops.stem.fused_stem` takes them: OIHW views of HWIO memory."""
        oihw = lambda w: w.unflatten(0, (3, 3, -1)).permute(3, 2, 0, 1)  # noqa: E731
        return oihw(self.w0), self.b0, oihw(self.w1), self.b1

    def forward(self, x_nhwc):
        from ..ops.stem import fused_stem

        return fused_stem(x_nhwc.contiguous(), *self.weights(), out_dtype=self.out_dtype).permute(0, 3, 1, 2)


class Passthrough(nn.Module):
    """Identity for a graph node absorbed by a fused kernel."""

    def forward(self, x):
        return x
