"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's six hand-written CUDA kernel sources from the checkout
(csrc/stem.cu, nms.cu, esmoe.cu, cw_nms.cu, moe.cu, c3k2.cu, and the self-checks
of the split-TF32 header that stem.cu, esmoe.cu, moe.cu and c3k2.cu share and of
the split-bf16 header of stem.cu's bf16 forms, one nvcc each, in parallel),
holds each kernel against its plain PyTorch version on the card, and
drives yolo_master_tpu_torch's paths (predict, val, training, the MoE
tools) at the full width of yolo-master-n, yolo-master-v0_1-n,
yolo-master-v0_10-n, yolo26-master-n, -latent-n and -moa-mot-n, and the task
heads' predict and val at the full width of yolo-master-seg-n, -pose-n,
-obb-n and -cls-n, with seeded random weights. Phases:

  1. environment (versions, card name and power limit); fails without CUDA
  2. build the six kernel sources (c3k2.cu's and stem.cu's bf16 kernel's
     registers, spills and wgmma instructions, from cuobjdump); the split-TF32
     and split-bf16 headers' self-checks against fp64, and how the tensor cores
     round a bf16 accumulation
  3. stem kernel vs F.conv2d x2 + SiLU (the cuDNN pair; uint8 640x640 input)
     at the stem widths of scales n (B=1, 2, 16), s, m/l and x (B=16)
  4. NMS kernel vs the plain greedy loop (exact keep sets, ties included;
     candidates in order and shuffled; N up to 4096)
  5. ES_MOE kernel vs its plain version at the four placements' shapes, B=1
     and 16, beside the unfused ES_MOE.forward it replaces
  6. CW-NMS kernel vs its plain loop (equal seeds, scores and validity;
     candidates in order and shuffled)
  7. the gathered expert matmul through its entry point at the shapes of
     yolo-master-v0_1-n's expert banks at 640, B=1 and 16, K=2 (a repeated
     expert, a zero weight), vs its plain version, beside torch.bmm in fp32
     (the yardstick) and once with TF32 allowed (one pass, less accurate)
  8. sparse ES_MOE (top_k=2 of 3, dynamic_threshold 0.4) at the four
     placements' shapes, B=16: sparse eval vs the masked-dense sum
  9. the predict path, YOLO("yolo-master-n").fuse().predict(...), at batch 1
     and 16: launch counts, max_det detections per image, GPU vs CPU decode,
     kernel vs plain NMS on the GPU's candidates; then the same path at scale
     m, YOLO("yolo-master-m").fuse().predict(...) (the stem at 64/128):
     launch counts, detections, GPU vs CPU decode, the stem's share of the
     device time at bs 16 (torch.profiler); phase 15 runs it in bf16
 10. the C3k2 kernel through its entry point on the live model's folded
     layers 2 and 5 and their inputs from the bs-1 and bs-16 frames (and an
     n=2 block at layer 2's width), vs its plain version and the C3k2 module;
     its weight bank's build time (plain PyTorch, once per weight set)
 11. the same predict path with fused_esmoe_fuse: 4 ES_MOE launches per
     forward, decode against the unswapped model, device time per image
 12. YOLO("yolo-master-v0_1-n").fuse().predict(...) at batch 1 and 16 (sparse
     gathered MoE dispatch): launch counts, detections, GPU vs CPU decode,
     sparse vs dense eval, the expert banks' host cost per forward (restacked
     vs kept), device time per image in both evals beside yolo-master-n's
 13. SparseSAHIPredictor on a 2160x3840 frame: tiles skipped, the CW-NMS
     kernel's merge equal to its plain version on the same candidates
 14. the bf16 forms of the stem kernel (split-bf16 wgmma; uint8 -> bf16 and
     bf16 -> bf16 at every scale's widths) and of the ES_MOE kernel (bf16 in and
     out, the four placements, B=1 and 16) vs their plain versions (fp32 rounded
     once to bf16: within 1 bf16 ulp of |ref| plus the fp32 gate, at most 1% of
     the outputs a rounding apart), beside the cuDNN bf16 pair and
     the bf16 ES_MOE.forward
 15. the four bf16 predict paths, predict(..., compute_dtype=torch.bfloat16)
     of yolo-master-n, of it with fused_esmoe_fuse, of yolo-master-v0_1-n and
     of yolo-master-m, at batch 1 and 16: launch counts (one bf16 copy, so one
     stem bank, a path), max_det detections per image, device
     ms/img beside the fp32 path's in turns; the card's bf16 raw head outputs
     against the port's CPU fp32 (rel-RMS within 1.5x that of the port's CPU
     bf16) and decoded on the CPU (keep sets equal to the card's own)
 16. the validation path, YOLO("yolo-master-n").fuse().val(data=..., imgsz=640,
     batch=16), on a synthetic set of 40 images (long side 640, varied aspect
     ratios, uniform noise; the last batch wraps), labelled from the model's own detections,
     with phase 9's calibrated weights (class biases at 0), in fp32 and bf16:
     launch counts (stem and NMS once a batch), finite metrics, the time split
     (host load, device forward + decode + NMS, host matching); the NMS kernel
     on one val batch's multi-label candidates (B=16, N=4096, iou 0.7) against
     its plain loop, beside the best 2048; the candidate sort's device time;
     seeded detections through the card's NMS give the CPU's metrics exactly;
     the card's own decoded outputs through the CPU's NMS and matching give
     its metrics exactly (their distance from the CPU's printed); detection
     counts equal to the CPU validator's and each metric within 1e-3, beside the
     CPU's own fused-vs-unfused and fp32-vs-fp64 differences; bf16 decoded
     outputs within 1.5x the CPU bf16's rel-RMS from the CPU fp32
 17. the train step (engine/train_step.py) of yolo-master-n at 640, fp32: one
     step at bs 2 on the card against the CPU; two timed steps of bs 16 x
     accumulate 4 (times, peak memory, a profiled step); the EMA model's val()
 18. the training loop, YOLO("yolo-master-n").train(data=..., epochs=2,
     batch=16, imgsz=640, amp=False, workers=4, save_period=1, close_mosaic=1),
     on 64 train and 16 val synthetic PNGs: finite losses and val metrics, the
     run's files, the Gini rule moving the MoE gain, the NMS kernel once a val
     batch of the EMA; each epoch's time split (loader wait, optimizer steps,
     val, checkpoint writes), the loader's images/s, peak memory, the NMS
     kernel at the EMA val's shape (B=8, N=4096); resume=True from epoch 1's
     checkpoint against the run's epoch 2; last.npz fused through predict()
 19. the train step in bf16 (compute_dtype=torch.bfloat16, the trainer's
     default): one step at bs 2 on the card against the CPU's fp32 and bf16
     steps, on two batches (the gradient trees' rel-RMS from the CPU fp32
     within 1.5x the CPU bf16's); two timed steps of bs 16 x accumulate 4 (times by layer, peak memory,
     a profiled step) beside phase 17's fp32 numbers
 20. the training loop with amp at its default (bf16): phase 18's run, resume
     and predict of last.npz (fp32 weights), in bf16
 21. MultiTrainer: YOLO("yolo-master-n").train(data=[a, b], epochs=1, ...) on two
     synthetic sets: two runs from the base weights, the base restored bitwise
 22. yolo-master-v0_1-n's train step at 640 with phase 12's weights (router
     noise, progressive sparsity, expert dropout and aux loss; warmup_steps 2
     and dropout_interval 2 on the routed blocks): one fp32 step at bs 2 on the
     card against the CPU (phase 17's gate), the draws of the card's step
     equal to the CPU's bit for bit; one bf16 step at bs 2 on two batches with
     the card's routing pinned to the CPU bf16's picks (phase 19's statistic),
     and the unpinned picks' flips counted; two timed steps of bs 16 x
     accumulate 4 in fp32 and bf16 (times by layer, peak memory, a profiled step) beside
     yolo-master-n's
 23. the training loop of yolo-master-v0_1-n with amp at its default (bf16),
     warmup_steps 1 and dropout_interval 1: phase 20's run, resume and
     predict of last.npz
 24. device time by kernel of the predict path, with fused_esmoe_fuse, of the
     v0_1 path in sparse and dense eval and of the scale-m path at batch 16,
     each fp32 path also in bf16, and the stem's share of each (torch.profiler)
 25. no module of jax or of the JAX package was imported
 26. (run after phase 16) yolo-master-v0_10-n, the released EsMoE graph
     (VisualEnhancedAdaptiveGateMoE blocks of 4/8/16 experts at layers 5, 8,
     11; nn/moe/gated.py, plain PyTorch), phase 9's recipe:
     fuse().predict(...) at batch 1 and 16 in fp32 and bf16 (launch counts,
     max_det detections); GPU vs CPU decode at the fixed limits with both
     programs' routing recorded (the card pinned to the CPU's where a pick or
     kept count differs); the card's bf16 head outputs, pinned to the CPU
     bf16's routing, within 1.5x the CPU bf16's rel-RMS from the CPU fp32;
     device ms/img of both dtypes beside yolo-master-n's in turns, the busy
     share and peak memory at bs 16; fuse().val() in fp32 on phase 16's kind
     of set (the NMS kernel at N=4096, metrics within 1e-3 of the CPU
     validator's); a bs-16 fp32 predict of v0_10-s and v0_10-m
 27. yolo-master-v0_10-n's training with phase 26's weights (the gated
     blocks' temperature anneal, complexity gate and aux loss): one fp32 step
     at bs 2 on the card against the CPU (phase 17's gate, the card routed by
     the CPU's picks and kept counts); one bf16 step at bs 2 on two batches,
     pinned to the CPU bf16's routing (phase 19's statistic); one step of
     v0_13-n and of v0_15-n at bs 2 (router noise, soft expert dropout and
     drop-path set to fire) whose draws equal the CPU's bit for bit; two timed
     steps of bs 16 x accumulate 4 in fp32 and bf16 beside yolo-master-n's and
     v0_1-n's (times by layer, busy share, kernels, host-to-device copies,
     peak memory); the loop with amp at its default (phase 20's run); then the
     MoE tools: diagnose_model and prune_moe_model on yolo-master-n (pruned,
     fused, through predict and against the CPU), v0_10-n's
     quantization_report and its dequantized weights through predict
 28. (run after phase 26) yolo26-master-n, the NMS-free end2end generation
     (A2C2fMoE of 4/8/16 experts at layers 4, 6, 8, SPPF, C2PSA, the attn
     C3k2, the one2one head at reg_max 1; plain PyTorch but for the stem),
     phase 9's recipe: fuse().predict(...) at batch 1 and 16 in fp32 and bf16
     (the stem kernel and its bank, no NMS launch; max_det fixed-shape
     detections); GPU vs CPU decode at the fixed limits with both programs'
     routing recorded (the card pinned to the CPU's where a pick differs); the
     card's bf16 one2one head outputs, pinned to the CPU bf16's routing, within
     1.5x the CPU bf16's rel-RMS from the CPU fp32; device ms/img of both
     dtypes beside yolo-master-n's in turns, the busy share and peak memory at
     bs 16; fuse().val() in fp32 on phase 16's kind of set (no NMS, metrics
     within 1e-3 of the CPU validator's); a bs-16 fp32 predict of
     yolo26-master-s and -m
 29. (run after phase 27) yolo26-master-n's training with phase 28's weights
     (the end2end dual-assignment loss, L1 at reg_max 1; the six routed
     blocks' noise, annealed k and expert dropout, warmup_steps 2 and
     dropout_interval 2): one fp32 step at bs 2 from step 50 on the card
     against the CPU (phase 17's gate, the card pinned to the CPU's picks
     where one flips), the draws bit for bit; two timed steps of bs 16 x
     accumulate 4 in fp32 and bf16 (times by layer, layer 4's share of a
     micro-batch, busy share, launches and copies, peak memory, a profiled
     step) beside yolo-master-n's and v0_1-n's; the loop with amp at its
     default (phase 20's run; the EMA's val through the end2end validator, no
     NMS) and MultiTrainer (phase 21's run)
 30. (run after phase 28) yolo26-master-latent-n (LatentMixture before each
     head scale) and yolo26-master-moa-mot-n (C2fMoA at P3, C2fMoT at P4 and
     P5), their zero-initialised mixture parts set non-zero
     (utils/weights.py:wake_mixtures): phase 28's recipe for each (predict at
     batch 1 and 16 in fp32 and bf16: the stem kernel and its bank, no NMS,
     max_det fixed-shape detections; GPU vs CPU decode at the fixed limits,
     bf16 by rel-RMS, the routing pinned where it flips, MoT's kept experts
     included; device ms/img beside yolo26-master-n's in turns, busy share and
     peak memory at bs 16; val() on 16 images, metrics within 1e-3 of the CPU
     validator's)
 31. (run after phase 30) the task heads in eval, fp32: yolo-master-seg-n,
     -pose-n and -obb-n at 640 and -cls-n at 224 (Segment, Pose, OBB, Classify
     on the yolo-master graph; plain PyTorch but for the stem and NMS), seeded,
     BN calibrated on four frames, the class biases at 0: fuse().predict() at
     batch 1 and 16 (the stem kernel and its bank on all four, the NMS kernel
     on seg and pose only); card vs CPU decode at the fixed limits, keypoints
     within 5e-2 px, angles within 1e-3 rad, cls log-probabilities within
     1e-3, the masks of shared detections within 0.1% of their pixels; the NMS
     kernel equal to its plain loop with 32 and 51 extra columns; device
     ms/img beside yolo-master-n's in turns, the host's result assembly, busy
     share, kernels and peak memory at bs 16; val() on 8 frames labelled from
     the card's predictions, metrics within 1e-3 of the CPU validator's
 32. (run after phase 29) yolo26-master-latent-n and -moa-mot-n in training
     with phase 30's weights, the latent routers' noise_std at 0.5 (the moa,
     mot and latent aux losses, MoT's exploration floor, the latent noise,
     MoA's linear global attention at P3 under autograd): one fp32 step at bs
     2 from step 50 on the card against the CPU (phase 17's gate, the card
     pinned to the CPU's MoT kept sets and top-k picks, flips counted, each
     family's aux within 1e-5 relative, the latent noise bit for bit,
     _rf_matrix unchanged); two timed steps of bs 16 x accumulate 4 in fp32
     and bf16 beside yolo26-master-n's of phase 29; the loop with amp at its
     default for both; MultiTrainer on -moa-mot-n

Each path's launch counts are set to 0 just before it runs and read just
after (the stem wrapper's weight-bank launch, once per w1, is counted apart,
as "stem_bank"); the gathered matmul's and C3k2's path is their own entry point,
as in the JAX package, where no model path reaches them. fp32 outside the bf16
phases: TF32 is off for PyTorch's convs and matmuls, and the four kernels that
use the tensor cores (stem.cu, esmoe.cu, moe.cu, c3k2.cu) compute a three-term
split-TF32 product that holds fp32 accuracy, at the same tolerances as before;
the stem's bf16 forms split in bf16 (three passes) and ES_MOE's bf16 form
computes in fp32 with bf16 loads and stores. Any
failing check raises and the script exits non-zero. The second-to-last stdout
line is a JSON object of per-kernel results (bound_ms: the largest of the
bytes moved over 3.35 TB/s, the matrix-product operations of stem.cu's two
convs, esmoe.cu, moe.cu and c3k2.cu's convs, counted once, over 495 TFLOP/s, the H100 SXM's TF32
tensor-core peak (989 TFLOP/s, its bf16 peak, for the stem's bf16 forms), and
every other operation over 67 TFLOP/s, its fp32
CUDA-core peak; bound_peak names the one that sets it); the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import functools
import importlib
import json
import platform
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

IMGSZ = 640  # letterbox size of the main path
FRAME_HW = (480, 640)  # synthetic frames: letterboxed to IMGSZ by padding alone
SAHI_HW = (2160, 3840)  # a 4K frame for the sparse SAHI path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# the four dense ES_MOE placements of yolo-master-n at 640: (layer, H=W, C=O)
ESMOE_PLACEMENTS = ((3, 160, 64), (6, 80, 128), (9, 40, 128), (12, 20, 256))
# the first 1x1 of yolo-master-v0_1-n's SimpleExpert banks at 640: (layer, H=W, C, hidden O, experts E)
MOE_BANKS = ((5, 80, 128, 256, 4), (8, 40, 128, 256, 8), (11, 20, 256, 512, 16))
STEM_WIDTHS = {"n": (16, 32), "s": (32, 64), "m/l": (64, 128), "x": (96, 192)}  # c0/c1 of the YAMLs' scales
C3K2_LAYERS = (2, 5)  # yolo-master-n's C3k2 blocks with Bottleneck inner blocks (c3k=False) at scale n
KW = dict(imgsz=IMGSZ, conf=0.0, iou=0.45, max_det=300)
# the port's CUDA kernels as the profiler names them (substrings of the mangled names)
NMS_PHASES = ("sort_candidates_kernel", "iou_mask_kernel", "scan_kernel")
PORT_KERNEL_NAMES = ("stem_kernel", "stem_bf16_kernel", "stem_bank_kernel", "stem_bank_bf16_kernel", *NMS_PHASES,
                     "fused_esmoe_kernel", "split_bank_kernel", "gathered_expert_matmul_kernel")
BF16_FRAMES = 4  # frames of the bf16 paths' GPU-vs-CPU checks
VAL_IMAGES = 40  # the val phase's synthetic set: not a multiple of the batch, so the last batch wraps
VAL_BATCH = 16
VAL_NMS = dict(conf_thres=0.001, iou_thres=0.7, max_det=300, max_nms=4096)  # the validator's defaults
VAL_METRICS = ("precision", "recall", "mAP50", "mAP50-95")
TRAIN_IMAGES, TRAIN_VAL_IMAGES = 64, 16  # the train loop phase's synthetic set
V01 = "yolo-master-v0_1-n"
V10 = "yolo-master-v0_10-n"
Y26 = "yolo26-master-n"
V01_STEP_SCHEDULE = (2, 2)  # phase 22's warmup_steps, dropout_interval: steps 2 and 50 drop experts
V01_LOOP_SCHEDULE = (1, 1)  # phase 23's: the loop's second optimizer step (step 1) drops experts
BENCH_STEPS = 2  # timed optimizer steps of train_step_bench (the first of them cold)
RESUME_REL_TOL_BF16 = 1e-4  # the bf16 loop's resumed epoch 2 against the run's: measured 1.6e-8 (PERF.md §7)
VAL_METRIC_TOL = 1e-3  # the card's validator vs the CPU's: tests/test_torch_validator.py:METRIC_TOL (port vs JAX)


T_START = time.perf_counter()  # log lines carry the seconds since the script started


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3, inner: int = 1) -> float:
    """Median milliseconds of one ``fn`` over ``reps`` runs, timed with CUDA events
    around ``inner`` calls enqueued back to back (more than one where a call's
    device time is shorter than the host's time to enqueue it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(nbytes: float, flops: float, tensor_flops: float = 0.0, tensor_peak: str = "tf32"):
    """(bound_ms, bound_by, peak): the least time for moving ``nbytes`` once, doing
    ``flops`` fp32 operations on the CUDA cores and ``tensor_flops`` matrix-product
    operations on the tensor cores at the TF32 peak, or the bf16 peak where
    ``tensor_peak`` is "bf16" (the operands are bf16: the stem's bf16 forms, as
    cuDNN's bf16 pair); counted once: a kernel's split in two or three passes is
    its way to the accuracy it keeps, not work the function needs. The bound is
    the largest of the three; ``peak`` names it."""
    rate, name = {"tf32": (TF32_FLOPS_PER_S, "495 TFLOP/s (TF32)"), "bf16": (BF16_FLOPS_PER_S, "989 TFLOP/s (bf16)")}[
        tensor_peak]
    times = {"bytes at 3.35 TB/s": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32 operations at 67 TFLOP/s": flops / FP32_FLOPS_PER_S * 1e3,
             f"matrix-product operations at {name}": tensor_flops / rate * 1e3}
    peak = max(times, key=times.get)
    return times[peak], "bytes" if peak.startswith("bytes") else "operations", peak


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bf16_rounding_apart(out, ref) -> bool:
    """A kernel's bf16 output against its plain version's, both one rounding of an
    fp32 result that the fp32 gate holds within 1e-4 + 1e-4*|ref|: each pair within
    1 bf16 ulp of |ref| plus that gate, and at most 1% of the outputs apart (a
    wrong rounding mode would move about half; ops/_bf16.py:bf16_rounding_apart)."""
    from yolo_master_tpu_torch.ops._bf16 import bf16_rounding_apart as apart

    within, share = apart(out, ref)
    return within and share <= 1e-2


def rel_rms(a, ref) -> float:
    """sqrt(mean((a - ref)^2) / mean(ref^2)) of two float tensors."""
    a, ref = a.double(), ref.double()
    return ((a - ref).pow(2).mean() / ref.pow(2).mean()).sqrt().item()


def _wrappers() -> dict:
    from yolo_master_tpu_torch.ops import c3k2, cuda_nms, esmoe, moe, stem

    return {"stem": stem.fused_stem, "nms": cuda_nms.batched_greedy_nms, "esmoe": esmoe.fused_esmoe,
            "cw_nms": cuda_nms.batched_cw_nms, "moe": moe.gathered_expert_matmul, "c3k2": c3k2.fused_c3k2}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["stem"].bank_launches = 0


def read_launches() -> dict:
    """Each wrapper's kernel launches, and apart from them the stem wrapper's weight-bank launches."""
    wrappers = _wrappers()
    return {**{name: fn.launches for name, fn in wrappers.items()}, "stem_bank": wrappers["stem"].bank_launches}


def phase_environment():
    import torch

    log(f"[env] python {platform.python_version()} torch {torch.__version__} cuda {torch.version.cuda}")
    for mod in ("yaml", "cv2", "PIL"):
        try:
            importlib.import_module(mod)
            log(f"[env] {mod}: importable")
        except ImportError:
            log(f"[env] {mod}: not installed")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    log(f"[env] {gpu_name_and_power()} ({torch.cuda.device_count()} visible)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_build():
    """One nvcc per kernel source, all started together."""
    from yolo_master_tpu_torch.ops import _bf16, _tf32, c3k2, cuda_nms, esmoe, moe, stem

    def timed(lib):
        t0 = time.perf_counter()
        lib()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    libs = {"stem.cu": stem._lib, "nms.cu": cuda_nms._lib, "esmoe.cu": esmoe._lib, "cw_nms.cu": cuda_nms._cw_lib,
            "moe.cu": moe._lib, "c3k2.cu": c3k2._lib, "mma_tf32_check.cu": _tf32._lib,
            "mma_bf16_check.cu": _bf16._lib}
    with ThreadPoolExecutor(len(libs)) as ex:
        secs = {name: ex.submit(timed, lib) for name, lib in libs.items()}
        secs = {name: f.result() for name, f in secs.items()}
    log(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}; wall {time.perf_counter() - t0:.1f} s")
    return {"c3k2": c3k2_sass_check(), "stem_bf16": stem_bf16_sass_check()}


def sass_resources(source: str):
    """(cuobjdump -res-usage lines, {mangled function: its SASS}) of a built library."""
    from pathlib import Path

    from yolo_master_tpu_torch.ops import _build

    lib = str(_build._library_path(source, ()))
    tool = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True, timeout=120, check=True).stdout
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=120, check=True).stdout
    return res.splitlines(), {block.split(None, 1)[0]: block for block in sass.split("Function : ")[1:]}


def stem_bf16_sass_check() -> dict:
    """Registers and stack of each instantiation of stem.cu's stem_bf16_kernel
    (cuobjdump), and its bf16 wgmma instructions (HGMMA ... .BF16 in SASS), which
    must be there: both convs' products run on the bf16 tensor cores."""
    lines, sass = sass_resources("stem")
    found = {}
    for k, line in enumerate(lines):
        name = line.strip().removeprefix("Function ").rstrip(":")
        if "stem_bf16_kernel" in name:
            usage = dict(re.findall(r"(REG|STACK):(\d+)", lines[k + 1]))
            hgmma = [ln for ln in sass.get(name, "").splitlines() if "HGMMA" in ln]
            found[name] = {"registers": int(usage["REG"]), "stack_bytes": int(usage["STACK"]),
                           "hgmma_instructions": len(hgmma), "bf16_hgmma": sum(".BF16" in ln for ln in hgmma)}
            log(f"[build] {name}: {found[name]}")
    require(len(found) == 8 and all(f["bf16_hgmma"] > 0 and f["bf16_hgmma"] == f["hgmma_instructions"]
                                    for f in found.values()),
            f"stem_bf16_kernel's eight instantiations, each with bf16 wgmma (HGMMA .BF16) instructions only: {found}")
    return found


def c3k2_sass_check() -> dict:
    """What the built c3k2 library holds for each instantiation of c3k2_kernel
    (cuobjdump): registers and stack (spills) per thread, and its wgmma
    instructions (HGMMA in SASS), which must be there: the convs run on the
    tensor cores."""
    lines, sass = sass_resources("c3k2")
    hgmma = {name: block.count("HGMMA") for name, block in sass.items()}
    found = {}
    for k, line in enumerate(lines):
        name = line.strip().removeprefix("Function ").rstrip(":")
        if "c3k2_kernel" in name:
            usage = dict(re.findall(r"(REG|STACK):(\d+)", lines[k + 1]))
            # c3k2_kernel<2> (two blocks an SM, registers capped at 128) or <1>
            blocks_per_sm = 2 if "ILi2E" in name else 1
            found[blocks_per_sm] = {"registers": int(usage["REG"]), "stack_bytes": int(usage["STACK"]),
                                    "hgmma_instructions": hgmma.get(name, 0)}
            log(f"[build] c3k2_kernel<{blocks_per_sm}>: {found[blocks_per_sm]}")
    require(set(found) == {1, 2} and all(f["hgmma_instructions"] > 0 for f in found.values()),
            f"c3k2_kernel's two instantiations, each with wgmma (HGMMA) instructions: {found}")
    return {f"{b}_blocks_per_sm": f for b, f in sorted(found.items())}


def phase_split_tf32(dev):
    """csrc/mma_tf32.cuh on its own: one warpgroup's [64, depth] x [depth, N]
    split-TF32 product in both wgmma forms against the fp64 product, within
    2e-6 * sum_k |a||b| (fp32's rounding step times the three products and the
    sum over depth), beside what one TF32 pass would give."""
    import numpy as np
    import torch

    from yolo_master_tpu_torch.ops._tf32 import matmul_tf32_plain, split_product_check

    rng = np.random.default_rng(0)
    a = (rng.standard_normal((64, 32)) * 10.0 ** rng.integers(-2, 3, (64, 32))).astype(np.float32)
    b = (rng.standard_normal((128, 32)) * 10.0 ** rng.integers(-2, 3, (128, 32))).astype(np.float32)
    for depth in (32, 20):
        d_ss, d_rs = split_product_check(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), depth)
        torch.cuda.synchronize()
        a64, b64 = a[:, :depth].astype(np.float64), b[:, :depth].astype(np.float64)
        ref, scale = a64 @ b64.T, np.abs(a64) @ np.abs(b64).T
        one_pass = matmul_tf32_plain(torch.from_numpy(a[:, :depth]), torch.from_numpy(b[:, :depth]).T).numpy()
        rel = {name: float((np.abs(got.astype(np.float64) - ref[:, :got.shape[1]]) / scale[:, :got.shape[1]]).max())
               for name, got in (("shared-memory form", d_ss.cpu().numpy()), ("register form", d_rs.cpu().numpy()),
                                 ("one TF32 pass", one_pass))}
        log(f"[tf32] depth {depth}: max err / sum|a||b| vs fp64: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        require(rel["shared-memory form"] <= 2e-6 and rel["register form"] <= 2e-6,
                f"the split-TF32 product is off fp64 by more than 2e-6 of sum|a||b|: {rel}")


def phase_split_bf16(dev):
    """csrc/mma_bf16.cuh on its own (mma_bf16_check.cu): one warpgroup's
    [64, depth] x [depth, 128] product as the stem's bf16 forms compute it (bf16
    hi/lo splits, three passes a depth-16 step, chains from zero joined in fp32)
    against the fp64 product, within 6e-5 * sum_k |a||b| (three terms of about
    2^-16 |a||b| each: lo*lo dropped, lo and hi rounded; and fp32's sums),
    beside one bf16 pass; and how the tensor cores round an accumulation: c +
    bf16(a) @ bf16(b) accumulated onto c in rows whose terms share one sign,
    against the exact sum (toward zero: never above it in magnitude)."""
    import numpy as np
    import torch

    from yolo_master_tpu_torch.ops._bf16 import matmul_bf16_plain, round_bf16, split_product_check_bf16

    rng = np.random.default_rng(0)

    def mixed(shape):  # float32 of magnitudes 1e-2 to 1e2
        return (rng.standard_normal(shape) * 10.0 ** rng.integers(-2, 3, shape)).astype(np.float32)

    a, b, c = mixed((64, 32)), mixed((128, 32)), mixed((64, 128))
    on = lambda t: torch.from_numpy(t).to(dev)  # noqa: E731
    for depth in (32, 20):
        d_split, _ = split_product_check_bf16(on(a), on(b), on(c), depth)
        torch.cuda.synchronize()
        a64, b64 = a[:, :depth].astype(np.float64), b[:, :depth].astype(np.float64)
        ref, scale = a64 @ b64.T, np.abs(a64) @ np.abs(b64).T
        one_pass = matmul_bf16_plain(torch.from_numpy(a[:, :depth]), torch.from_numpy(b[:, :depth]).T).numpy()
        rel = {name: float((np.abs(got.astype(np.float64) - ref) / scale).max())
               for name, got in (("split bf16 (three passes)", d_split.cpu().numpy()), ("one bf16 pass", one_pass))}
        log(f"[bf16] depth {depth}: max err / sum|a||b| vs fp64: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        require(rel["split bf16 (three passes)"] <= 6e-5,
                f"the split-bf16 product is off fp64 by more than 6e-5 of sum|a||b|: {rel}")
    # the rounding of an accumulation: row r's terms all take the sign of row r
    sign = np.where(np.arange(64) % 2 == 0, 1.0, -1.0).astype(np.float32)[:, None]
    a_s = np.abs(round_bf16(torch.from_numpy(a)).numpy()) * sign
    b_s = np.abs(round_bf16(torch.from_numpy(b)).numpy())
    c_s = np.abs(c) * sign
    _, d_acc = split_product_check_bf16(on(a_s), on(b_s), on(c_s), 32)
    exact = c_s.astype(np.float64) + a_s.astype(np.float64) @ b_s.astype(np.float64).T
    got = d_acc.cpu().numpy().astype(np.float64)
    below, above = int((np.abs(got) < np.abs(exact)).sum()), int((np.abs(got) > np.abs(exact)).sum())
    log(f"[bf16] accumulation onto c by the tensor cores, {got.size} outputs: {below} below the exact sum in "
        f"magnitude, {above} above, {got.size - below - above} equal ("
        + ("rounded toward zero" if above == 0 and below > 0 else "not toward zero") + ")")
    return {"below": below, "above": above}


def phase_stem(dev):
    """Kernel vs plain (the cuDNN pair) at 640x640: the main path's widths
    c0/c1 = 16/32 (scale n) at B=1, 16 and 2, and the widths of scales s, m/l
    and x at B=16, with the block layout each width takes."""
    import torch

    from yolo_master_tpu_torch.ops import stem
    from yolo_master_tpu_torch.ops._build import check, stream_ptr
    from yolo_master_tpu_torch.ops.stem import fused_stem, fused_stem_plain, stem_plan, stem_weight_layout

    result = {}
    for scale, (c0, c1) in STEM_WIDTHS.items():
        g = torch.Generator().manual_seed(0)
        w0 = stem_weight_layout(((torch.rand(c0, 3, 3, 3, generator=g) - 0.5) * 0.6 / 255.0).to(dev))
        b0 = (torch.rand(c0, generator=g) - 0.5).to(dev)
        # 0.3 at c0 = 16, shrinking as 1/sqrt(c0): conv1's outputs keep one scale at every width
        w1 = stem_weight_layout(((torch.rand(c1, c0, 3, 3, generator=g) - 0.5) * 1.2 / c0 ** 0.5).to(dev))
        b1 = (torch.rand(c1, generator=g) - 0.5).to(dev)
        plan = stem_plan(c0, c1)
        bank = torch.empty(plan["bank_floats"], device=dev)
        bank_ms = cuda_ms(lambda: check(stem._lib().ymt_stem_bank(w1.data_ptr(), bank.data_ptr(), c0, c1,
                                                                  stream_ptr(dev)), "stem weight-bank kernel"),
                          inner=10)
        for b in ((2, 1, 16) if scale == "n" else (16,)):
            x = torch.randint(0, 256, (b, 640, 640, 3), generator=g, dtype=torch.uint8).to(dev)
            out = fused_stem(x, w0, b0, w1, b1)
            ref = fused_stem_plain(x, w0, b0, w1, b1)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            require(out.shape == (b, 160, 160, c1) and bool(torch.isfinite(out).all()), "stem output shape/finite")
            require(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()),
                    f"stem kernel disagrees at c0/c1 {c0}/{c1}: max abs err {err.max().item()}")
            ms = cuda_ms(lambda: fused_stem(x, w0, b0, w1, b1))  # w1's bank is kept: the stem kernel alone
            plain_ms = cuda_ms(lambda: fused_stem_plain(x, w0, b0, w1, b1))
            # 2 flops per multiply-add: both convs' are matrix products (tensor cores); bias + SiLU
            # (5 operations) per output of each conv count as fp32 operations
            n0, n1 = b * 320 * 320 * c0, b * 160 * 160 * c1
            bound_ms, bound_by, peak = bound(nbytes(x, w0, b0, w1, b1, out), (n0 + n1) * 5,
                                             n0 * 2 * 27 + n1 * 2 * 9 * c0)
            log(f"[stem] scale {scale} B={b} 640x640 u8 -> [{b},160,160,{c1}] (plan {plan}): max abs err "
                f"{err.max().item():.3e}, kernel {ms:.4f} ms, cuDNN pair {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({peak}); w1's weight bank, written once per w1, {bank_ms:.4f} ms")
            result[(scale, b)] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, bound_peak=peak)
    return result


def phase_stem_bf16(dev):
    """The stem kernel's bf16 forms (stem_bf16_kernel: split-bf16 wgmma) against
    their plain version (fp32 convs, the output rounded once to bf16;
    bf16_rounding_apart): uint8 -> bf16 (the bf16 predict path) and bf16 -> bf16
    (a bf16 image, /255 not folded) at the widths of every scale, B=16, and
    uint8 -> bf16 at n also at B=1 and 2; beside the cuDNN bf16 pair (the image
    cast to bf16, two bf16 F.conv2d + SiLU) and the bound at the bf16 peak."""
    import torch
    import torch.nn.functional as F

    from yolo_master_tpu_torch.ops.stem import fused_stem, fused_stem_plain, stem_plan, stem_weight_layout

    bf16 = torch.bfloat16
    result = {}
    for scale, (c0, c1) in STEM_WIDTHS.items():
        g = torch.Generator().manual_seed(0)  # phase_stem's weights and images
        w0 = stem_weight_layout(((torch.rand(c0, 3, 3, 3, generator=g) - 0.5) * 0.6 / 255.0).to(dev))
        b0 = (torch.rand(c0, generator=g) - 0.5).to(dev)
        w1 = stem_weight_layout(((torch.rand(c1, c0, 3, 3, generator=g) - 0.5) * 1.2 / c0 ** 0.5).to(dev))
        b1 = (torch.rand(c1, generator=g) - 0.5).to(dev)
        plan = stem_plan(c0, c1, bf16)
        for b in ((2, 1, 16) if scale == "n" else (16,)):
            img = torch.randint(0, 256, (b, 640, 640, 3), generator=g, dtype=torch.uint8).to(dev)
            forms = [("uint8", img, w0)]
            if b == 16:
                forms.append(("bf16", (img.float() / 255.0).to(bf16), stem_weight_layout(w0 * 255.0)))
            for form, x, w0x in forms:
                out = fused_stem(x, w0x, b0, w1, b1, out_dtype=bf16)
                ref = fused_stem_plain(x, w0x, b0, w1, b1, out_dtype=bf16)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                require(out.dtype == bf16 and out.shape == (b, 160, 160, c1) and bool(torch.isfinite(out).all()),
                        "bf16 stem output dtype/shape/finite")
                require(bf16_rounding_apart(out, ref),
                        f"bf16 stem kernel disagrees at c0/c1 {c0}/{c1} ({form} in): max abs err {err.max().item()}")
                flips = int((err > 0).sum())
                wb = [t.to(bf16) for t in (w0x, b0, w1, b1)]

                def cudnn_pair(x=x, wb=wb):
                    y = F.silu(F.conv2d(x.permute(0, 3, 1, 2).to(bf16), wb[0], wb[1], stride=2, padding=1))
                    return F.silu(F.conv2d(y, wb[2], wb[3], stride=2, padding=1))

                ms = cuda_ms(lambda: fused_stem(x, w0x, b0, w1, b1, out_dtype=bf16))
                plain_ms = cuda_ms(lambda: fused_stem_plain(x, w0x, b0, w1, b1, out_dtype=bf16))
                pair_ms = cuda_ms(cudnn_pair)
                n0, n1 = b * 320 * 320 * c0, b * 160 * 160 * c1
                bound_ms, bound_by, peak = bound(nbytes(x, w0x, b0, w1, b1, out), (n0 + n1) * 5,
                                                 n0 * 2 * 27 + n1 * 2 * 9 * c0, tensor_peak="bf16")
                log(f"[stem-bf16] scale {scale} B={b} 640x640 {form} -> bf16 [{b},160,160,{c1}] (plan {plan}): max abs "
                    f"err {err.max().item():.3e} ({flips} of {err.numel()} outputs a rounding apart), kernel {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms, cuDNN bf16 pair {pair_ms:.4f} ms, bound {bound_ms:.4f} ms ({peak})")
                result[(scale, b, form)] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                                                cudnn_bf16_pair_ms=pair_ms, bound_ms=bound_ms, bound_by=bound_by,
                                                bound_peak=peak, rounding_apart=flips / err.numel())
    return result


def nms_inputs(b: int, n: int, dev, seed: int = 0, shuffle: bool = False):
    """Class-offset boxes and scores: exact ties in every row, row 1 all invalid,
    row 2 with 5 valid candidates (exhausts long before max_det); with
    ``shuffle``, each row's candidates in a random order (the main path hands
    them over sorted by score; the kernels take any order)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, n, 2, generator=g) * 600
    wh = torch.rand(b, n, 2, generator=g) * 110 + 10
    cls = torch.randint(0, 80, (b, n, 1), generator=g).float() * 7680.0
    boxes = torch.cat([xy, xy + wh], -1) + cls
    scores = torch.rand(b, n, generator=g)
    scores[:, 1::7] = scores[:, :1]  # exact ties
    if b > 2:
        scores[1] = 0.0
        scores[2, 5:] = 0.0
    if shuffle:
        perm = torch.stack([torch.randperm(n, generator=g) for _ in range(b)])
        boxes, scores = boxes.gather(1, perm[..., None].expand(-1, -1, 4)), scores.gather(1, perm)
    return boxes.to(dev).contiguous(), scores.to(dev).contiguous()


def phase_nms(dev):
    import torch

    from yolo_master_tpu_torch.ops.cuda_nms import batched_greedy_nms, batched_greedy_nms_plain, greedy_nms

    result = {}
    for b, n, shuffle in ((16, 1024, False), (16, 2048, False), (1, 2048, False), (1, 4096, False),
                          (16, 2048, True), (1, 4096, True)):
        boxes, scores = nms_inputs(b, n, dev, shuffle=shuffle)
        ki, kv = batched_greedy_nms(boxes, scores, 0.45, 300)
        ki_p, kv_p = batched_greedy_nms_plain(boxes, scores, 0.45, 300)
        torch.cuda.synchronize()
        require(torch.equal(ki, ki_p) and torch.equal(kv, kv_p), f"NMS kernel keep sets differ at B={b} N={n}")
        if b > 2:
            require(not bool(kv[1].any()) and int(kv[2].sum()) <= 5, "NMS all-invalid / early-exit rows")
        k1, v1 = greedy_nms(boxes[0], scores[0], 0.45, 300)
        require(torch.equal(k1, ki_p[0]) and torch.equal(v1, kv_p[0]), "NMS B=1 entry point differs")
        ms = cuda_ms(lambda: batched_greedy_nms(boxes, scores, 0.45, 300), inner=10)
        plain_ms = cuda_ms(lambda: batched_greedy_nms_plain(boxes, scores, 0.45, 300), reps=3, warmup=1)
        idx_err = (ki.long() - ki_p.long()).abs().max().item()
        # steps this data takes (the picks, then the step that finds none), each over all N
        # candidates: IoU 13 operations, the threshold test and the argmax compare
        steps = (kv.sum(1) + (kv.sum(1) < 300).long()).sum().item()
        bound_ms, bound_by, _ = bound(nbytes(boxes, scores, ki, kv), steps * n * 15)
        order = " shuffled" if shuffle else ""
        log(f"[nms] B={b} N={n} max_det=300{order}: keep sets equal ({int(kv.sum())} kept), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        result[(b, n, shuffle)] = dict(max_abs_err=idx_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
    return result


def esmoe_block(c: int, dev, seed: int = 0, top_k=None):
    """An ES_MOE block (E=3, k=3/5/7; dense unless ``top_k``) with seeded weights
    and BN statistics (as tests/test_pallas_esmoe.py seeds them), eval mode,
    channels_last."""
    import torch

    from yolo_master_tpu_torch.nn.moe import ES_MOE

    g = torch.Generator().manual_seed(seed)
    block = ES_MOE(c, c, top_k=top_k)
    with torch.no_grad():
        for bn in (m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.running_mean.copy_(torch.randn(bn.num_features, generator=g) * 0.2)
            bn.running_var.copy_(torch.rand(bn.num_features, generator=g) * 1.5 + 0.5)
        for conv in (m for m in block.modules() if isinstance(m, torch.nn.Conv2d)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / conv.weight[0].numel() ** 0.5)
    return block.eval().to(dev, memory_format=torch.channels_last)


def esmoe_flops(b: int, h: int, w: int, c: int, o: int, ks):
    """(fp32 operations, matrix-product operations): 2 flops per multiply-add of
    each expert's own k*k taps; per (pixel, expert, output) bias + SiLU + mix, 6
    operations; per (pixel, output) the norm and SiLU, 6; and apart from these,
    2 flops per multiply-add of each expert's pointwise product."""
    px = b * h * w
    return 2 * px * c * sum(k * k for k in ks) + px * o * (6 * len(ks) + 6), 2 * px * len(ks) * c * o


def phase_esmoe(dev):
    """Kernel vs plain at the four placements' shapes, B=1 and 16, beside the
    unfused ES_MOE.forward (routing included) that the kernel replaces."""
    import torch

    from yolo_master_tpu_torch.ops.esmoe import fused_esmoe, fused_esmoe_plain, pack_esmoe_params

    result = {}
    for b in (1, 16):
        for layer, hw, c in ESMOE_PLACEMENTS:
            block = esmoe_block(c, dev, seed=layer)
            g = torch.Generator().manual_seed(layer)
            x = torch.randn(b, c, hw, hw, generator=g).to(dev).contiguous(memory_format=torch.channels_last)
            xh = x.permute(0, 2, 3, 1)  # NHWC view of the channels_last map, as FusedESMOE passes it
            with torch.no_grad():
                w, _ = block.routing(x)
                banks = pack_esmoe_params(block)
                out = fused_esmoe(xh, w, *banks)
                ref = fused_esmoe_plain(xh, w, *banks)
                unfused = block(x).permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            require(out.shape == (b, hw, hw, c) and bool(torch.isfinite(out).all()), "esmoe output shape/finite")
            require(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()), f"esmoe kernel disagrees: max abs err {err.max().item()}")
            module_err = (out - unfused).abs().max().item()
            require(module_err <= 1e-3, f"esmoe kernel vs the unfused block: {module_err}")
            with torch.no_grad():
                ms = cuda_ms(lambda: fused_esmoe(xh, w, *banks), inner=5)
                plain_ms = cuda_ms(lambda: fused_esmoe_plain(xh, w, *banks))
                module_ms = cuda_ms(lambda: block(x))
            bound_ms, bound_by, peak = bound(nbytes(xh, w, *banks[:5], out), *esmoe_flops(b, hw, hw, c, c, banks[5]))
            log(f"[esmoe] layer {layer} B={b} [{b},{hw},{hw},{c}]: max abs err {err.max().item():.3e} "
                f"(vs unfused block {module_err:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"ES_MOE.forward {module_ms:.4f} ms, bound {bound_ms:.4f} ms ({peak})")
            result[(b, layer)] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, module_ms=module_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, bound_peak=peak)
    return result


def phase_esmoe_bf16(dev):
    """The ES_MOE kernel's bf16 form (bf16 x in and out, fp32 weights) against its
    plain version (fp32, rounded once: bf16_rounding_apart) at the
    four placements' shapes, B=1 and 16, beside the ES_MOE.forward of the
    block's bf16 copy (its ops round to bf16 one by one, the kernel once at the
    end: within 8 * 2^-8 * max |module|; 2.2-4.0 of it on an H100)."""
    import torch

    from yolo_master_tpu_torch.ops.esmoe import fused_esmoe, fused_esmoe_plain, pack_esmoe_params
    from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy

    bf16 = torch.bfloat16
    result = {}
    for b in (1, 16):
        for layer, hw, c in ESMOE_PLACEMENTS:
            fp32_block = esmoe_block(c, dev, seed=layer)
            block = compute_dtype_copy(fp32_block, bf16)
            g = torch.Generator().manual_seed(layer)
            x = torch.randn(b, c, hw, hw, generator=g).to(dev).contiguous(memory_format=torch.channels_last).to(bf16)
            xh = x.permute(0, 2, 3, 1)
            with torch.no_grad():
                w = block.routing(x)[0].float()
                banks = pack_esmoe_params(fp32_block)  # fp32 banks, as FusedESMOE keeps them in a bf16 copy
                out = fused_esmoe(xh, w, *banks)
                ref = fused_esmoe_plain(xh, w, *banks)
                module = block(x).permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            require(out.dtype == bf16 and out.shape == (b, hw, hw, c) and bool(torch.isfinite(out).all()),
                    "bf16 esmoe output dtype/shape/finite")
            require(bf16_rounding_apart(out, ref), f"bf16 esmoe kernel disagrees: max abs err {err.max().item()}")
            module_err = (out.float() - module.float()).abs().max().item()
            module_max = module.float().abs().max().item()
            require(module_err <= 8 * 2.0 ** -8 * module_max,
                    f"bf16 esmoe kernel vs the bf16 block: {module_err} of max {module_max}")
            with torch.no_grad():
                ms = cuda_ms(lambda: fused_esmoe(xh, w, *banks), inner=5)
                plain_ms = cuda_ms(lambda: fused_esmoe_plain(xh, w, *banks))
                module_ms = cuda_ms(lambda: block(x))
            bound_ms, bound_by, peak = bound(nbytes(xh, w, *banks[:5], out), *esmoe_flops(b, hw, hw, c, c, banks[5]))
            log(f"[esmoe-bf16] layer {layer} B={b} [{b},{hw},{hw},{c}] bf16: max abs err {err.max().item():.3e} "
                f"({int((err > 0).sum())} of {err.numel()} outputs a rounding apart; vs the bf16 block "
                f"{module_err:.3e} of max {module_max:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bf16 ES_MOE.forward {module_ms:.4f} ms, bound {bound_ms:.4f} ms ({peak})")
            result[(b, layer)] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, module_ms=module_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, bound_peak=peak)
    return result


def phase_cw_nms(dev):
    """Kernel vs plain: class-offset boxes (80 classes) with exact ties, an
    all-invalid row and a row that runs out after 5 picks."""
    import torch

    from yolo_master_tpu_torch.ops.cuda_nms import batched_cw_nms, batched_cw_nms_plain

    result = {}
    for b, n, shuffle in ((1, 4096, False), (4, 2048, False), (1, 4096, True)):
        boxes, scores = nms_inputs(b, n, dev, seed=1, shuffle=shuffle)
        for weighted in ((True, False) if not shuffle else (True,)):
            fb, fs, seed, valid = batched_cw_nms(boxes, scores, 0.45, 300, 0.1, weighted)
            pb, ps, pseed, pvalid = batched_cw_nms_plain(boxes, scores, 0.45, 300, 0.1, weighted)
            torch.cuda.synchronize()
            require(torch.equal(valid, pvalid) and torch.equal(seed, pseed) and torch.equal(fs, ps),
                    f"CW-NMS kernel seeds/scores/valid differ at B={b} N={n} weighted={weighted}")
            # sums over the cluster in another order: a few ulp of the class-offset
            # coordinates (up to 6e5, where an fp32 ulp is 0.0625)
            err = (fb - pb).abs()
            require(bool((err <= 1e-4 + 5e-7 * pb.abs()).all()), f"CW-NMS fused boxes differ: {err.max().item()}")
            if b > 2:
                require(not bool(valid[1].any()) and int(valid[2].sum()) <= 5, "CW-NMS all-invalid / early-exit rows")
            ms = cuda_ms(lambda: batched_cw_nms(boxes, scores, 0.45, 300, 0.1, weighted), inner=10)
            plain_ms = cuda_ms(lambda: batched_cw_nms_plain(boxes, scores, 0.45, 300, 0.1, weighted), reps=3,
                               warmup=1)
            # per step (the picks, then the step that finds none) over all N candidates:
            # IoU 13 operations, the membership test 3, the argmax compare 1; per member
            # (at most every candidate with a score) the weight 6 and the five sums 10
            steps = (valid.sum(1) + (valid.sum(1) < 300).long()).sum().item()
            members = int((scores > 0).sum())
            bound_ms, bound_by, _ = bound(nbytes(boxes, scores, fb, fs, seed, valid), steps * n * 17 + members * 16)
            order = " shuffled" if shuffle else ""
            log(f"[cw_nms] B={b} N={n}{order} weighted_iou={weighted}: seeds/scores/valid equal "
                f"({int(valid.sum())} kept), box max err {err.max().item():.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.5f} ms ({bound_by})")
            result[(b, n, weighted, shuffle)] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                                                     bound_ms=bound_ms, bound_by=bound_by)
    return result


def moe_inputs(b: int, n: int, c: int, o: int, e: int, dev, seed: int):
    """x [B,N,C], w [E,C,O], idx [B,2] (two distinct experts per row, but row 0
    repeats one), wts [B,2] (softmax; the last row's second slot is 0)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, c, generator=g)
    w = torch.randn(e, c, o, generator=g) / c ** 0.5
    idx = torch.stack([torch.randperm(e, generator=g)[:2] for _ in range(b)]).int()
    idx[0, 1] = idx[0, 0]
    wts = torch.softmax(torch.randn(b, 2, generator=g), -1)
    wts[-1, 1] = 0.0
    return [t.to(dev).contiguous() for t in (x, w, idx, wts)]


def phase_moe(dev):
    """The gathered expert matmul through its entry point at the v0_1-n expert
    banks' shapes (its path: counts set to 0 before, read after), then each
    output against the plain version, beside the one-call library form."""
    import torch

    from yolo_master_tpu_torch.ops.moe import dense_expert_matmul, gathered_expert_matmul

    inputs = {(b, layer): moe_inputs(b, hw * hw, c, o, e, dev, seed=layer)
              for b in (1, 16) for layer, hw, c, o, e in MOE_BANKS}
    reset_launches()
    outs = {key: gathered_expert_matmul(*inp) for key, inp in inputs.items()}
    torch.cuda.synchronize()
    launches = read_launches()["moe"]
    log(f"[moe] entry point at the v0_1-n banks, B=1 and 16: {launches} launches")
    require(launches == len(inputs), "the gathered matmul's path did not launch its kernel once per call")
    result = {}
    for (b, layer), (x, w, idx, wts) in inputs.items():
        out = outs[(b, layer)]
        ref = dense_expert_matmul(x, w, idx, wts)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        require(out.shape == ref.shape and bool(torch.isfinite(out).all()), "gathered matmul shape/finite")
        require(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()), f"gathered matmul disagrees: max abs err {err.max().item()}")
        # ten calls enqueued back to back per reading, all three alike: at B=1 a
        # call's device time is shorter than the host's time to enqueue it
        def library():
            return torch.bmm(x, (wts[:, :, None, None] * w[idx.long()]).sum(1))

        ms = cuda_ms(lambda: gathered_expert_matmul(x, w, idx, wts), inner=10)
        plain_ms = cuda_ms(lambda: dense_expert_matmul(x, w, idx, wts), inner=10)
        library_ms = cuda_ms(library, inner=10)
        # one TF32 pass: less accurate than the kernel's three-term product, so context, not the yardstick
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            library_tf32_ms = cuda_ms(library, inner=10)
            tf32_err = (library() - ref).abs().max().item()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        # the function is linear in w: mixing the K selected experts' weights first
        # (2*B*K*C*O flops, CUDA cores) leaves one matrix product, 2*B*N*C*O; the
        # experts this run reads, once each
        k = idx.shape[1]
        n_experts = int(torch.unique(idx).numel())
        c, o = x.shape[2], w.shape[2]
        bound_ms, bound_by, peak = bound(nbytes(x, idx, wts, out) + n_experts * w[0].numel() * 4,
                                         2 * b * k * c * o, 2 * b * x.shape[1] * c * o)
        log(f"[moe] layer {layer} B={b} [{b},{x.shape[1]},{x.shape[2]}]x[{w.shape[0]},{w.shape[1]},{w.shape[2]}] K={k}: "
            f"max abs err {err.max().item():.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bmm {library_ms:.4f} ms (with TF32 allowed {library_tf32_ms:.4f} ms, max abs err {tf32_err:.3e}), "
            f"bound {bound_ms:.4f} ms ({peak})")
        result[(b, layer)] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                  library_tf32_ms=library_tf32_ms, bound_ms=bound_ms, bound_by=bound_by,
                                  bound_peak=peak)
    return result, launches


def phase_sparse_esmoe(dev):
    """ES_MOE(C, C, 3 experts, top_k=2, dynamic_threshold 0.4) at the four
    placements' shapes, B=16: sparse eval (gathered dispatch) vs the
    masked-dense sum over the same retained weights, within 1e-4."""
    import torch

    for layer, hw, c in ESMOE_PLACEMENTS:
        block = esmoe_block(c, dev, seed=layer, top_k=2)
        g = torch.Generator().manual_seed(layer)
        x = torch.randn(16, c, hw, hw, generator=g).to(dev).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            ys = block(x)
            w = block._sparse_retained_weights(block.routing(x)[0])
            yd = block.norm(sum(e(x) * w[:, i, None, None, None] for i, e in enumerate(block.experts)))
            torch.cuda.synchronize()
            err = (ys - yd).abs().max().item()
            require(bool(torch.isfinite(ys).all()) and err <= 1e-4, f"sparse ES_MOE vs masked dense: {err}")
            sparse_ms = cuda_ms(lambda: block(x), reps=10)
            block.sparse_inference = False
            dense_ms = cuda_ms(lambda: block(x), reps=10)
        kept = int((w > 0).sum())
        log(f"[sparse-esmoe] layer {layer} [16,{hw},{hw},{c}]: sparse vs masked dense max abs err {err:.3e}; "
            f"{kept} of {2 * 16} top-2 slots kept after the 0.4 threshold; sparse eval {sparse_ms:.4f} ms, "
            f"dense eval {dense_ms:.4f} ms")


def c3k2_ops(px: int, c1: int, c: int, cb: int, c2: int, n: int):
    """(fp32 operations, matrix-product operations) of a C3k2 block over px pixels:
    its convs' multiply-adds (cv1, two 3x3 convs per bottleneck, cv2 over the
    concat), 2 flops each, run as matrix products on the tensor cores; bias +
    SiLU, 5 operations per output of each conv, and the shortcut add on the
    CUDA cores."""
    macs = c1 * 2 * c + n * 2 * 9 * c * cb + (2 + n) * c * c2
    return px * (5 * (2 * c + n * (cb + c) + c2) + n * c), px * 2 * macs


def c3k2_block(c1: int, c2: int, n: int, dev, seed: int = 0):
    """C3k2(c1, c2, n, c3k=False, e=0.25) with seeded weights and BN statistics, BN folded, channels_last."""
    import torch

    from yolo_master_tpu_torch.nn.layers import C3k2
    from yolo_master_tpu_torch.utils.fuse import fuse_bn

    g = torch.Generator().manual_seed(seed)
    block = C3k2(c1, c2, n=n, c3k=False, e=0.25)
    with torch.no_grad():
        for bn in (m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.running_mean.copy_(torch.randn(bn.num_features, generator=g) * 0.2)
            bn.running_var.copy_(torch.rand(bn.num_features, generator=g) * 1.5 + 0.5)
        for conv in (m for m in block.modules() if isinstance(m, torch.nn.Conv2d)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / conv.weight[0].numel() ** 0.5)
    block.eval()
    fuse_bn(block)
    return block.to(dev, memory_format=torch.channels_last)


def phase_c3k2(dev, model, imgs):
    """The C3k2 kernel through its entry point on the live yolo-master-n's
    folded layers 2 and 5, fed the activations those layers receive from the
    bs-1 and bs-16 frames (its path: counts set to 0 before, read after); then
    each output against the plain version and the C3k2 module (cuDNN), and an
    n=2 block at layer 2's width."""
    import torch

    from yolo_master_tpu_torch.ops.c3k2 import build_c3k2_bank, fused_c3k2, fused_c3k2_plain, prepare_c3k2_weights

    layers = model.model.model
    captured, inputs = {}, {}
    hooks = [layers[i].register_forward_pre_hook(lambda m, a, i=i: captured.__setitem__(i, a[0]))
             for i in C3K2_LAYERS]
    with torch.no_grad():
        for bs in (1, 16):
            xb, _ = model._predictor.preprocess(imgs[:bs])
            model.model(xb)
            inputs.update({(bs, i): captured[i].permute(0, 2, 3, 1).contiguous() for i in C3K2_LAYERS})
    for h in hooks:
        h.remove()
    blocks = {(i, 1): layers[i] for i in C3K2_LAYERS}
    blocks[(2, 2)] = c3k2_block(32, 64, 2, dev, seed=2)
    cases = {(bs, i, 1): x for (bs, i), x in inputs.items()}
    cases[(16, 2, 2)] = inputs[(16, 2)]
    weights = {key: prepare_c3k2_weights(block) for key, block in blocks.items()}
    for (i, n), w in weights.items():
        bank_ms = cuda_ms(lambda: build_c3k2_bank(w, blocks[(i, n)].c, n), reps=5)
        log(f"[c3k2] layer {i} n={n}: weight bank ({build_c3k2_bank(w, blocks[(i, n)].c, n).numel()} floats, "
            f"plain PyTorch, once per weight set) {bank_ms:.4f} ms")

    reset_launches()
    builds = fused_c3k2.bank_builds
    outs = {key: fused_c3k2(x, weights[key[1:]], blocks[key[1:]].c, key[2]) for key, x in cases.items()}
    torch.cuda.synchronize()
    launches, builds = read_launches()["c3k2"], fused_c3k2.bank_builds - builds
    log(f"[c3k2] entry point on layers {C3K2_LAYERS} (bs 1, 16) and an n=2 block: {launches} launches, "
        f"{builds} weight banks built")
    require(launches == len(cases), "the C3k2 path did not launch its kernel once per call")
    require(builds == len(weights), "the C3k2 path did not build each weight set's bank once")
    result = {}
    for (bs, i, n), x in cases.items():
        block, w, out = blocks[(i, n)], weights[(i, n)], outs[(bs, i, n)]
        xc = x.permute(0, 3, 1, 2)  # the channels_last map the module takes
        with torch.no_grad():
            ref = fused_c3k2_plain(x, w, block.c, n)
            mod = block(xc).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        require(out.shape == ref.shape and bool(torch.isfinite(out).all()), "c3k2 output shape/finite")
        require(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()), f"c3k2 kernel disagrees: max abs err {err.max().item()}")
        mod_err = (out - mod).abs()
        require(bool((mod_err <= 1e-4 + 1e-4 * mod.abs()).all()), f"c3k2 kernel vs module: {mod_err.max().item()}")
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_c3k2(x, w, block.c, n), inner=10)  # the bank is kept: the kernel alone
            plain_ms = cuda_ms(lambda: fused_c3k2_plain(x, w, block.c, n))
            module_ms = cuda_ms(lambda: block(xc))
        b, h, wd, c1 = x.shape
        cb, c2 = w["m0_b1"].shape[0], w["cv2_b"].shape[0]
        live = [t for k, t in w.items() if not k.endswith("_sel")]
        # bytes: x, out and the weights once (the kernel's split bank is its own copy of them)
        bound_ms, bound_by, peak = bound(nbytes(x, out, *live), *c3k2_ops(b * h * wd, c1, block.c, cb, c2, n))
        log(f"[c3k2] layer {i} n={n} B={bs} [{bs},{h},{wd},{c1}] -> {c2}: max abs err {err.max().item():.3e} "
            f"(vs module {mod_err.max().item():.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"C3k2 module {module_ms:.4f} ms, bound {bound_ms:.4f} ms ({peak})")
        result[(bs, i, n)] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, module_ms=module_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, bound_peak=peak)
    return result, launches


def check_detections(results, frame_hw=FRAME_HW):
    """max_det finite detections per image, boxes inside the frame, scores in (0, 1]."""
    import numpy as np

    for r in results:
        d = r.boxes.data
        require(len(d) == KW["max_det"], f"expected {KW['max_det']} detections, got {len(d)}")
        require(bool(np.isfinite(d).all()), "non-finite detections")
        require(bool((d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= frame_hw[1]).all()
                     and (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= frame_hw[0]).all()), "boxes outside the image")
        require(bool((d[:, 4] > 0).all() and (d[:, 4] <= 1).all()), "scores outside (0, 1]")


def phase_main_path(dev):
    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.ops import cuda_nms, nms
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(0)
    # 480x640 BGR frames letterbox to 640x640 by padding alone (no resize library needed)
    imgs = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(16)]
    kw = KW

    # seeded random weights; BN statistics calibrated on four frames so that
    # activations keep unit scale through the depth and detections depend on
    # the image (at the bare init they vanish by the neck)
    model = YOLO("yolo-master-n", device=dev)
    x_cal, _ = DetectionPredictor(model.model, imgsz=IMGSZ).preprocess(imgs[:4])  # float /255 before fuse()
    calibrate_bn(model.model, x_cal)
    state = {k: v.detach().clone() for k, v in model.model.state_dict().items()}
    cpu = YOLO("yolo-master-n", device="cpu").load_state_dict(state)
    model.fuse()
    cpu.fuse()

    reset_launches()
    r1 = model.predict(imgs[0], batch=1, **kw)
    r16 = model.predict(imgs, batch=16, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[main] predict bs1 + bs16 launches: {launches}")
    # the stem's weight bank is written at the fused model's first call and kept after it
    require(launches["stem"] == 2 and launches["stem_bank"] == 1 and launches["nms"] == 2,
            "main path did not launch the stem and NMS kernels")
    require(len(r1) == 1 and len(r16) == 16, "result counts")
    check_detections(r1 + r16)
    counts = [len(r.boxes) for r in r16]
    log(f"[main] detections per image (bs16): {counts}; image 0 top: {np.round(r1[0].boxes.data[0], 2).tolist()}")

    # kernel vs plain NMS on the model's own candidates for the same 16 frames;
    # the predict() counts above must be these keep counts
    pred = model._predictor
    x16, _ = pred.preprocess(imgs)
    with torch.inference_mode():
        top16 = model.model.head.decode_topk(model.model(x16), k=pred.max_nms)
    cboxes, scores, cls_idx, _ = nms._prep_candidates(top16, 80, 0.0, pred.max_nms, False, None, True)
    cand = (cboxes + cls_idx[..., None] * nms.MAX_WH).float().contiguous()
    ki, kv = cuda_nms.batched_greedy_nms(cand, scores.contiguous(), 0.45, 300)
    ki_p, kv_p = cuda_nms.batched_greedy_nms_plain(cand, scores, 0.45, 300)
    require(torch.equal(ki, ki_p) and torch.equal(kv, kv_p), "NMS kernel vs plain differ on model candidates")
    require(kv.sum(1).tolist() == counts, "predict() counts differ from the NMS keep counts")
    log(f"[main] NMS kernel == plain on the model's own {cand.shape[1]} candidates x 16 frames")

    # GPU vs CPU: the same port, same seed, same uint8 frames
    x = x16[:2]
    with torch.inference_mode():
        p_gpu = model.model(x)
        p_cpu = cpu.model(x.cpu())
        full_gpu = model.model.head.decode(p_gpu, raw_scores=True).cpu()
        full_cpu = cpu.model.head.decode(p_cpu, raw_scores=True)
        top_gpu = model.model.head.decode_topk(p_gpu, k=pred.max_nms)
        top_cpu = cpu.model.head.decode_topk(p_cpu, k=pred.max_nms)
    full_cpu64 = exact_decode("yolo-master-n", state, x, dev)
    box_err = (full_gpu[..., :4] - full_cpu[..., :4]).abs().max().item()
    logit_err = (full_gpu[..., 4:] - full_cpu[..., 4:]).abs().max().item()
    conf_err = (top_gpu[..., 4:].max(-1).values.cpu() - top_cpu[..., 4:].max(-1).values).abs().max().item()
    # fixed limits: with calibrated BN the CPU's own fp32-vs-fp64 error reaches
    # ~1.0e-2 px on boxes and ~4e-4 on logits at this input (printed below), so
    # boxes are held to 5e-2 px and logits to 1e-3
    box_noise = (full_cpu[..., :4] - full_cpu64[..., :4]).abs().max().item()
    logit_noise = (full_cpu[..., 4:] - full_cpu64[..., 4:]).abs().max().item()
    box_tol, logit_tol = 5e-2, 1e-3
    log(f"[main] GPU vs CPU decode, all {full_gpu.shape[1]} anchors: box max err {box_err:.3e} px, "
        f"logit max err {logit_err:.3e}; top-{pred.max_nms} selected max-logit err {conf_err:.3e}; "
        f"CPU fp32 vs fp64 noise: box {box_noise:.3e} px, logit {logit_noise:.3e}")
    require(box_err <= box_tol and logit_err <= logit_tol and conf_err <= logit_tol,
            f"GPU and CPU decode disagree beyond {box_tol:.3e} px / {logit_tol:.3e}")

    return model, state, imgs, launches


def phase_scale_m(dev, imgs):
    """YOLO("yolo-master-m").fuse().predict(...) at batch 1 and 16, full width
    (stem c0/c1 = 64/128: the stem kernel's sliced plan; C3k2 with C3k inner
    blocks), seeded weights with BN calibrated on four frames, as the main
    path: launch counts, max_det detections per image, GPU vs CPU decode at the
    fixed limits, device time per image at bs 16."""
    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    model = YOLO("yolo-master-m", device=dev)
    x_cal, _ = DetectionPredictor(model.model, imgsz=IMGSZ).preprocess(imgs[:4])
    calibrate_bn(model.model, x_cal)
    state = {k: v.detach().clone() for k, v in model.model.state_dict().items()}
    cpu = YOLO("yolo-master-m", device="cpu").load_state_dict(state)
    model.fuse()
    cpu.fuse()

    reset_launches()
    r1 = model.predict(imgs[0], batch=1, **KW)
    r16 = model.predict(imgs, batch=16, **KW)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[scale-m] predict bs1 + bs16 launches: {launches}")
    require(launches["stem"] == 2 and launches["stem_bank"] == 1 and launches["nms"] == 2,
            "the scale-m path did not launch the stem and NMS kernels")
    require(len(r1) == 1 and len(r16) == 16, "scale-m result counts")
    check_detections(r1 + r16)
    log(f"[scale-m] image 0 top: {np.round(r1[0].boxes.data[0], 2).tolist()}")

    pred = model._predictor
    x, _ = pred.preprocess(imgs[:2])
    with torch.inference_mode():
        full_gpu = model.model.head.decode(model.model(x), raw_scores=True).cpu()
        full_cpu = cpu.model.head.decode(cpu.model(x.cpu()), raw_scores=True)
    full_cpu64 = exact_decode("yolo-master-m", state, x, dev)
    box_err, logit_err = decode_err(full_gpu, full_cpu)
    box_noise, logit_noise = decode_err(full_cpu, full_cpu64)
    log(f"[scale-m] GPU vs CPU decode, all {full_gpu.shape[1]} anchors: box max err {box_err:.3e} px, logit max err "
        f"{logit_err:.3e}; CPU fp32 vs fp64 noise: box {box_noise:.3e} px, logit {logit_noise:.3e}")
    require(box_err <= 5e-2 and logit_err <= 1e-3, "scale-m GPU and CPU decode disagree beyond 5e-2 px / 1e-3")

    xb, _ = pred.preprocess(imgs)
    ms = cuda_ms(lambda: pred.run(xb), reps=5, warmup=2)
    log(f"[scale-m] bs=16: device {ms / 16:.4f} ms/img (uint8 on card -> detections)")
    busy_ms, ours = device_time_by_kernel(pred.run, xb)
    stem_ms = ours["stem_kernel"] + ours["stem_bank_kernel"]  # the bank is kept: 0 ms of it here
    log(f"[scale-m] bs=16 under torch.profiler: device busy {busy_ms:.3f} ms/batch, stem {stem_ms:.4f} ms/batch "
        f"(stem_kernel {ours['stem_kernel']:.4f}, stem_bank_kernel {ours['stem_bank_kernel']:.4f}): "
        f"{100 * stem_ms / busy_ms:.1f}% of the device time")
    require(stem_ms > 0, "the scale-m profile shows no stem kernel")
    return model, launches


def phase_fused_esmoe_path(dev, model, state, imgs):
    """The predict path after fused_esmoe_fuse, on the same calibrated weights."""
    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.nn.moe import FusedESMOE
    from yolo_master_tpu_torch.utils.fuse import fused_esmoe_fuse

    kw = dict(imgsz=IMGSZ, conf=0.0, iou=0.45, max_det=300)
    moe = YOLO("yolo-master-n", device=dev).load_state_dict(state).fuse()
    fused_esmoe_fuse(moe.model)
    swapped = [m.i for m in moe.model.model if isinstance(m, FusedESMOE)]
    require(swapped == [3, 6, 9, 12], f"fused_esmoe_fuse swapped layers {swapped}")

    reset_launches()
    r1 = moe.predict(imgs[0], batch=1, **kw)
    r16 = moe.predict(imgs, batch=16, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[esmoe-path] predict bs1 + bs16 launches: {launches}")
    require(launches["esmoe"] == 4 * 2 and launches["stem"] == 2 and launches["nms"] == 2,
            "the fused-ES_MOE path must launch the ES_MOE kernel 4 times per forward")
    for r in r1 + r16:
        d = r.boxes.data
        require(len(d) == kw["max_det"] and bool(np.isfinite(d).all()), "fused-ES_MOE path detections")

    # decode against the same weights without the surgery, at the smoke's fixed limits
    pred = moe._predictor
    x, _ = pred.preprocess(imgs[:2])
    with torch.inference_mode():
        full_moe = moe.model.head.decode(moe.model(x), raw_scores=True)
        full_base = model.model.head.decode(model.model(x), raw_scores=True)
    box_err = (full_moe[..., :4] - full_base[..., :4]).abs().max().item()
    logit_err = (full_moe[..., 4:] - full_base[..., 4:]).abs().max().item()
    log(f"[esmoe-path] decode vs the unswapped model, all {full_moe.shape[1]} anchors: box max err {box_err:.3e} px, "
        f"logit max err {logit_err:.3e}")
    require(box_err <= 5e-2 and logit_err <= 1e-3, "fused-ES_MOE decode disagrees beyond 5e-2 px / 1e-3")

    # device time per image, uint8 batch on the card -> detections, with and
    # without the surgery, in turns (base, swapped, swapped, base)
    e2e = {}
    for bs in (1, 16):
        xb, _ = pred.preprocess(imgs[:bs])
        runs = {"base": [], "esmoe": []}
        for name in ("base", "esmoe", "esmoe", "base"):
            run = (model if name == "base" else moe)._predictor.run
            runs[name].append(cuda_ms(lambda: run(xb), reps=5, warmup=2))
        t0 = time.perf_counter()
        for _ in range(3):
            model.predict(imgs[:bs], batch=bs, **kw)
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        e2e[bs] = {k: statistics.median(v) / bs for k, v in runs.items()}
        log(f"[e2e] bs={bs}: device ms/img (uint8 on card -> detections), predict path "
            f"{[round(t / bs, 4) for t in runs['base']]}, with fused_esmoe_fuse {[round(t / bs, 4) for t in runs['esmoe']]}; "
            f"predict() with letterbox and Results {host_ms / bs:.3f} ms/img (host clock)")
    return moe, launches, e2e


def exact_decode(name, state, x_u8, dev):
    """The raw-score decode of ``name`` on ``state`` (unfused) in fp64 on the card,
    on the uint8 frames ``x_u8`` / 255: the exact reference that a fused fp32
    model's rounding is measured against (folding BN and the /255 changes no value
    in exact arithmetic, and an fp64 result does not depend on the device)."""
    import torch

    from yolo_master_tpu_torch import YOLO

    y = YOLO(name, device=dev).load_state_dict(state)
    y.model.double()
    with torch.inference_mode():
        return y.model.head.decode(y.model(x_u8.to(dev).double() / 255.0), raw_scores=True).cpu()


def decode_err(a, b):
    """(box, logit) max abs difference of two [B, A, 4+nc] raw-score decodes."""
    return (a[..., :4] - b[..., :4]).abs().max().item(), (a[..., 4:] - b[..., 4:]).abs().max().item()


def phase_v0_1_path(dev, base, imgs):
    """yolo-master-v0_1-n's predict path (OptimizedMOEImproved blocks of 4/8/16
    SimpleExperts, top-2, sparse gathered dispatch), seeded weights with BN
    calibrated on four frames, as the main path."""
    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    v01 = YOLO("yolo-master-v0_1-n", device=dev)
    x_cal, _ = DetectionPredictor(v01.model, imgsz=IMGSZ).preprocess(imgs[:4])
    calibrate_bn(v01.model, x_cal)
    state = {k: v.detach().clone() for k, v in v01.model.state_dict().items()}
    cpu = YOLO("yolo-master-v0_1-n", device="cpu").load_state_dict(state)
    v01.fuse()
    cpu.fuse()
    require(v01.model.sparse_inference, "sparse eval is the default")

    reset_launches()
    r1 = v01.predict(imgs[0], batch=1, **KW)
    r16 = v01.predict(imgs, batch=16, **KW)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[v0_1] predict bs1 + bs16 launches: {launches}")
    require(launches["stem"] == 2 and launches["nms"] == 2, "the v0_1 path did not launch the stem and NMS kernels")
    require(len(r1) == 1 and len(r16) == 16, "v0_1 result counts")
    check_detections(r1 + r16)
    log(f"[v0_1] image 0 top: {np.round(r1[0].boxes.data[0], 2).tolist()}")

    # GPU vs CPU (the same port and weights), and sparse vs dense eval on the card
    pred = v01._predictor
    x, _ = pred.preprocess(imgs[:2])
    with torch.inference_mode():
        full_gpu = v01.model.head.decode(v01.model(x), raw_scores=True).cpu()
        full_cpu = cpu.model.head.decode(cpu.model(x.cpu()), raw_scores=True)
        v01.model.sparse_inference = False
        full_dense = v01.model.head.decode(v01.model(x), raw_scores=True).cpu()
        v01.model.sparse_inference = True
    (box_err, logit_err), (sd_box, sd_logit) = decode_err(full_gpu, full_cpu), decode_err(full_gpu, full_dense)
    log(f"[v0_1] GPU vs CPU decode, all {full_gpu.shape[1]} anchors: box max err {box_err:.3e} px, logit max err "
        f"{logit_err:.3e}; sparse vs dense eval on the card: box {sd_box:.3e} px, logit {sd_logit:.3e}")
    require(box_err <= 5e-2 and logit_err <= 1e-3, "v0_1 GPU and CPU decode disagree beyond 5e-2 px / 1e-3")
    require(sd_box <= 5e-2 and sd_logit <= 1e-3, "v0_1 sparse and dense eval disagree beyond 5e-2 px / 1e-3")

    # host cost per forward of the three blocks' expert banks: restacked on every
    # call (stack_expert_params) against kept until a parameter changes
    # (expert_bank, what sparse eval calls); 20 calls enqueued, then one sync
    from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved
    from yolo_master_tpu_torch.nn.moe.dispatch import expert_bank, stack_expert_params

    banks = [m.experts for m in v01.model.modules() if isinstance(m, OptimizedMOEImproved)]
    require(len(banks) == 3, f"v0_1-n has three MoE blocks, found {len(banks)}")

    def host_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    restack_ms = host_ms(lambda: [stack_expert_params(e) for e in banks])
    kept_ms = host_ms(lambda: [expert_bank(e) for e in banks])
    log(f"[v0_1] expert banks of the 3 MoE blocks, per forward (host clock): restacked {restack_ms:.4f} ms, "
        f"kept {kept_ms:.4f} ms")

    # device time per image, uint8 batch on the card -> detections: v0_1 in
    # sparse and in dense eval, beside yolo-master-n, in turns
    e2e = {}
    for bs in (1, 16):
        xb, _ = pred.preprocess(imgs[:bs])
        runs = {"yolo-master-n": [], "sparse": [], "dense": []}
        for name in ("yolo-master-n", "sparse", "dense", "dense", "sparse", "yolo-master-n"):
            v01.model.sparse_inference = name != "dense"
            run = (base if name == "yolo-master-n" else v01)._predictor.run
            runs[name].append(cuda_ms(lambda: run(xb), reps=5, warmup=2) / bs)
        v01.model.sparse_inference = True
        e2e[bs] = {k: statistics.median(v) for k, v in runs.items()}
        log(f"[e2e] bs={bs}: device ms/img, yolo-master-n {[round(t, 4) for t in runs['yolo-master-n']]}, "
            f"yolo-master-v0_1-n sparse eval {[round(t, 4) for t in runs['sparse']]}, "
            f"dense eval {[round(t, 4) for t in runs['dense']]}")
    return v01, launches, e2e, state


def phase_sahi(dev, moe):
    """SparseSAHIPredictor on a 2160x3840 gray frame with bright rectangles,
    through the fused-ES_MOE model."""
    import numpy as np
    import torch

    from yolo_master_tpu_torch.engine.sahi import MAX_NMS, SparseSAHIPredictor
    from yolo_master_tpu_torch.ops import cuda_nms, nms

    h, w = SAHI_HW
    img = np.full((h, w, 3), 114, np.uint8)
    rng = np.random.default_rng(2)
    for _ in range(4):
        y0, x0 = int(rng.integers(0, h - 300)), int(rng.integers(0, w - 300))
        img[y0:y0 + int(rng.integers(60, 300)), x0:x0 + int(rng.integers(60, 300))] = rng.integers(0, 256, 3)
    sahi = SparseSAHIPredictor(moe.model, names=moe.names, conf=0.0)
    # random weights give no meaningful objectness: gate at the 99.95th
    # percentile of the low-res anchors whose centres lie in the frame (not in
    # the letterbox padding), so that a few tiles run and most are skipped
    _, obj, cx, cy, _ = sahi._lowres_pass(img)
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    sahi.objectness_threshold = float(np.quantile(obj[inside], 0.9995))

    reset_launches()
    r = sahi(img)
    torch.cuda.synchronize()
    launches = read_launches()
    stats = sahi.last_stats
    log(f"[sahi] {h}x{w} frame: {stats['tiles']} tiles, {stats['active']} active; launches {launches}")
    require(0 < stats["active"] < stats["tiles"], f"the objectness gate must skip some tiles: {stats}")
    require(launches["cw_nms"] == 1, "the SAHI path did not launch the CW-NMS kernel")
    d = r.boxes.data
    require(len(d) > 0 and bool(np.isfinite(d).all()), "SAHI detections")
    require(bool((d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all()
                 and (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= h).all()), "SAHI boxes outside the frame")

    # the merge: kernel vs plain on the same merged candidates
    cand = sahi.candidates(img)
    cboxes, scores, cls_idx, _ = nms._prep_candidates(cand, moe.model.nc, sahi.conf, MAX_NMS, False, None, False)
    cb = (cboxes + cls_idx[..., None] * nms.MAX_WH).float().contiguous()
    out = cuda_nms.batched_cw_nms(cb, scores.contiguous(), sahi.iou, sahi.max_det, sahi.sigma)
    ref = cuda_nms.batched_cw_nms_plain(cb, scores, sahi.iou, sahi.max_det, sahi.sigma)
    require(torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2]) and torch.equal(out[3], ref[3]),
            "SAHI merge: CW-NMS kernel seeds/scores/valid differ from the plain version")
    box_err = (out[0] - ref[0]).abs()
    require(bool((box_err <= 1e-4 + 5e-7 * ref[0].abs()).all()), f"SAHI merge: fused boxes differ {box_err.max()}")
    log(f"[sahi] merge of {cand.shape[1]} candidates (top {cb.shape[1]}): CW-NMS kernel == plain "
        f"({int(out[3].sum())} kept, box max err {box_err.max().item():.3e}); {len(d)} detections")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sahi(img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[sahi] host ms/frame: {[round(t, 2) for t in times]} (median {statistics.median(times):.2f})")
    return launches


def phase_bf16_paths(dev, facades, imgs):
    """The bf16 predict paths through the facade (yolo-master-n, with fused ES_MOE,
    v0_1-n and yolo-master-m), predict(..., compute_dtype=torch.bfloat16), at
    batch 1 and 16 (launch counts
    set to 0 before, read after); device ms/img beside each fp32 path's
    predictor in turns (fp32, bf16, bf16, fp32); the card's bf16 raw head
    outputs against the port's CPU fp32 (rel-RMS, box and class logits apart,
    within 1.5x that of the port's CPU bf16: two bf16 programs on calibrated
    random weights differ by error statistics, not element by element); and
    those bf16 head outputs decoded and NMS'd on the CPU: the card's keep sets,
    classes equal, boxes within 2e-3 px, scores within 1e-6."""
    import torch

    from yolo_master_tpu_torch.ops.nms import non_max_suppression
    from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy, current_dtype_copy

    bf16 = torch.bfloat16
    out = {}
    for name, facade in facades.items():
        fp32_pred = facade._predictor
        require(fp32_pred.compute_dtype == torch.float32, f"{name}: the fp32 path's predictor")
        esmoe_per_forward = sum(type(m).__name__ == "FusedESMOE" for m in facade.model.model)
        reset_launches()
        r1 = facade.predict(imgs[0], batch=1, compute_dtype=bf16, **KW)
        r16 = facade.predict(imgs, batch=16, compute_dtype=bf16, **KW)
        torch.cuda.synchronize()
        launches = read_launches()
        pred = facade._predictor
        log(f"[bf16] {name}: predict bs1 + bs16 launches: {launches}")
        # the bs-1 and bs-16 predictors share the model's one bf16 copy (utils/fuse.py:current_dtype_copy),
        # whose stem writes its bf16 weight bank once
        require(launches["stem"] == 2 and launches["stem_bank"] == 1 and launches["nms"] == 2
                and launches["esmoe"] == 2 * esmoe_per_forward,
                f"{name}: the bf16 path did not launch the stem, NMS (and ES_MOE) kernels")
        require(pred.compute_dtype == bf16 and pred.model is not facade.model
                and all(t.dtype == torch.float32 for t in facade.model.parameters()),
                f"{name}: the bf16 predictor runs a copy and the facade's model stays fp32")
        require(len(r1) == 1 and len(r16) == 16, f"{name}: bf16 result counts")
        check_detections(r1 + r16)
        # what each bf16 predict pays to find its copy current (utils/fuse.py:model_key), host clock
        kept = pred.model
        t0 = time.perf_counter()
        for _ in range(200):
            require(current_dtype_copy(facade.model, bf16) is kept, f"{name}: the bf16 copy was made anew")
        check_ms = (time.perf_counter() - t0) / 200 * 1e3
        log(f"[bf16] {name}: the copy kept, its check {check_ms:.4f} ms a predict (host clock)")

        e2e = {}
        for bs in (1, 16):
            xb, _ = pred.preprocess(imgs[:bs])
            runs = {"fp32": [], "bf16": []}
            for dt in ("fp32", "bf16", "bf16", "fp32"):
                run = (fp32_pred if dt == "fp32" else pred).run
                runs[dt].append(cuda_ms(lambda: run(xb), reps=5, warmup=2) / bs)
            e2e[bs] = {k: statistics.median(v) for k, v in runs.items()}
            log(f"[e2e] {name} bs={bs}: device ms/img (uint8 on card -> detections), fp32 "
                f"{[round(t, 4) for t in runs['fp32']]}, bf16 {[round(t, 4) for t in runs['bf16']]}")

        x, _ = pred.preprocess(imgs[:BF16_FRAMES])
        cpu32 = copy.deepcopy(facade.model).to("cpu")
        cpu16 = compute_dtype_copy(cpu32, bf16)
        with torch.inference_mode():
            g16 = pred.model(x)
            c32, c16 = cpu32(x.cpu()), cpu16(x.cpu())
        stats = {}
        for key in ("boxes", "scores"):
            require(g16[key].dtype == c16[key].dtype == bf16, f"{name}: bf16 head outputs")
            gpu, own = rel_rms(g16[key].float().cpu(), c32[key]), rel_rms(c16[key].float(), c32[key])
            stats[key] = (gpu, own)
            require(bool(torch.isfinite(g16[key]).all()) and 0 < own and gpu <= 1.5 * own,
                    f"{name}: GPU bf16 {key} rel-RMS {gpu} from CPU fp32, more than 1.5x the CPU bf16's {own}")
        nms_kw = dict(nc=facade.model.nc, conf_thres=pred.conf, iou_thres=pred.iou, max_det=pred.max_det,
                      max_nms=pred.max_nms, scores_are_logits=True)
        with torch.inference_mode():
            det_gpu = non_max_suppression(pred.model.head.decode_topk(g16, k=pred.max_nms), **nms_kw)
            on_cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in g16.items()}
            det_cpu = non_max_suppression(cpu16.head.decode_topk(on_cpu, k=pred.max_nms), **nms_kw)
        det_gpu = {k: v.cpu() for k, v in det_gpu.items()}
        box_err = (det_gpu["boxes"] - det_cpu["boxes"]).abs().max().item()
        score_err = (det_gpu["scores"] - det_cpu["scores"]).abs().max().item()
        require(torch.equal(det_gpu["valid"], det_cpu["valid"]) and torch.equal(det_gpu["classes"], det_cpu["classes"])
                and box_err <= 2e-3 and score_err <= 1e-6,
                f"{name}: the card's bf16 head outputs decoded on the CPU give other keep sets "
                f"(box {box_err}, score {score_err})")
        log(f"[bf16] {name}: {BF16_FRAMES} frames, rel-RMS from the CPU fp32 head outputs: box logits GPU bf16 "
            f"{stats['boxes'][0]:.4e} (CPU bf16 {stats['boxes'][1]:.4e}), class logits GPU bf16 "
            f"{stats['scores'][0]:.4e} (CPU bf16 {stats['scores'][1]:.4e}); the card's bf16 head outputs decoded on "
            f"the CPU: keep sets equal ({int(det_gpu['valid'].sum())} kept), box max err {box_err:.3e} px, "
            f"score max err {score_err:.3e}")
        out[name] = dict(launches=launches, e2e=e2e, run=pred.run, rel_rms=stats, copy_check_ms=check_ms)
    return out


def write_val_set(root, n: int, seed: int = 0):
    """``n`` PNGs under ``root/images`` with their long side at IMGSZ (no resize,
    so no resampler is needed to load them), of varied aspect ratios, portrait
    and landscape: uniform noise, as phase 9's frames, on which its BN was
    calibrated (on images unlike them, such as flat rectangles, the random
    network turns fp32 rounding into boxes hundreds of pixels apart, in either
    package and against fp64). Returns the dataset yaml (the 80 COCO names, so
    that COCO rows take the 80 -> 91 map)."""
    import numpy as np
    from PIL import Image

    from yolo_master_tpu_torch.utils import coco_names

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    shorts = (352, 384, 427, 480, 512, 576, 640)
    for i in range(n):
        s = shorts[i % len(shorts)]
        h, w = (s, IMGSZ) if i % 2 == 0 else (IMGSZ, s)
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(im).save(root / "images" / f"{i + 1:06d}.png", compress_level=1)
    yaml_path = root / "data.yaml"
    lines = [f"path: {root}", "val: images", "names:"] + [f"  {k}: {v}" for k, v in coco_names().items()]
    yaml_path.write_text("\n".join(lines) + "\n")
    return yaml_path


def label_from_detections(model, yaml_path, seed: int = 7):
    """Write each image's labels from ``model``'s own fp32 val detections: its 4
    best, each box jittered by up to 10% of its size, so that the metrics count
    real matches at every IoU threshold (random weights find none of the drawn
    rectangles); tests/test_torch_validator.py labels its set the same way."""
    from pathlib import Path

    import numpy as np

    from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset, img2label_path
    from yolo_master_tpu_torch.engine.validator import DetectionValidator

    ds = YOLODataset(str(yaml_path), imgsz=IMGSZ)
    v = DetectionValidator(model, imgsz=IMGSZ)
    rng = np.random.default_rng(seed)
    seen = 0
    for b in DataLoader(ds, VAL_BATCH).epoch():
        det = {k: t.cpu().numpy() for k, t in v.run(v.preprocess(b["images"])).items()}
        for i in range(min(VAL_BATCH, len(ds) - seen)):
            h0, w0 = ds.shapes[seen]
            boxes = v._to_original(det["boxes"][i, :4], *v._letterbox_params(h0, w0), w0, h0, clip=True)
            rows = []
            for box, c in zip(boxes, det["classes"][i, :4]):
                box = box + rng.uniform(-0.1, 0.1, 4) * np.tile(box[2:] - box[:2], 2)
                x1, x2 = np.clip(box[[0, 2]], 0, w0)
                y1, y2 = np.clip(box[[1, 3]], 0, h0)
                if x2 - x1 >= 1 and y2 - y1 >= 1:
                    rows.append(f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} "
                                f"{(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
            Path(img2label_path(ds.img_files[seen])).write_text("\n".join(rows) + "\n")
            seen += 1


def seeded_val_predictions(batch, seed: int, anchors: int = 8400, nc: int = 80):
    """Decoded predictions [B, anchors, 4 + nc] (xywh letterboxed px, probabilities)
    for one val batch: three jittered copies of each GT box (its class at
    0.55-0.95, another class at 0.2-0.5), distractor boxes, class noise on a 1/4096
    grid over (0, 0.003) (a third below conf 0.001, many exact ties), and a run
    of rows copied from one (the form of tests/test_torch_validator.py's gate 2)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = batch["images"].shape[0]
    xy = rng.uniform(0, IMGSZ, (b, anchors, 2))
    wh = rng.uniform(4, IMGSZ / 2, (b, anchors, 2))
    scores = np.round(rng.uniform(0, 0.003, (b, anchors, nc)) * 4096) / 4096
    for i in range(b):
        row = 0
        for box, c in zip(batch["boxes"][i][batch["mask"][i]], batch["classes"][i][batch["mask"][i]]):
            for _ in range(3):
                x1, y1, x2, y2 = box + rng.uniform(-0.08, 0.08, 4) * np.tile(box[2:] - box[:2], 2)
                xy[i, row], wh[i, row] = ((x1 + x2) / 2, (y1 + y2) / 2), (x2 - x1, y2 - y1)
                scores[i, row, c] = rng.uniform(0.55, 0.95)
                scores[i, row, (c + 1 + rng.integers(0, nc - 1)) % nc] = rng.uniform(0.2, 0.5)
                row += 1
    scores[:, 60:70] = scores[:, 60:61]
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


def phase_val(dev, state):
    """YOLO("yolo-master-n").fuse().val(data=..., imgsz=640, batch=16) on a
    synthetic set of VAL_IMAGES, in fp32 and bf16 (a set written under the
    checkout and removed after)."""
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix=".val_set_", dir=Path(__file__).resolve().parent))
    try:
        return _phase_val(dev, state, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_val(dev, state, root):
    import math
    from pathlib import Path

    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset
    from yolo_master_tpu_torch.engine.validator import DetectionValidator
    from yolo_master_tpu_torch.ops import cuda_nms, nms

    bf16 = torch.bfloat16
    yaml_path = write_val_set(root, VAL_IMAGES)
    # phase 9's calibrated weights with the class biases at 0: the init's bias (a
    # prior of ~1e-5 a class) puts nearly every score below conf 0.001, where a
    # trained detector passes nearly every candidate
    def facade(where, fuse=True):
        y = YOLO("yolo-master-n", device=where).load_state_dict(state)
        with torch.no_grad():
            for branch in y.model.head.cv3:
                branch[-1].bias.zero_()
        return y.fuse() if fuse else y

    gpu, cpu = facade(dev), facade("cpu")
    label_from_detections(gpu.model, yaml_path)
    ds = YOLODataset(str(yaml_path), imgsz=IMGSZ)
    n_batches = math.ceil(VAL_IMAGES / VAL_BATCH)
    val_kw = dict(data=str(yaml_path), imgsz=IMGSZ, batch=VAL_BATCH)

    def rows_per_image(path):
        rows = json.loads(Path(path).read_text())
        return [sum(r["image_id"] == i + 1 for r in rows) for i in range(VAL_IMAGES)]

    out = {}
    for name, dt in (("fp32", torch.float32), ("bf16", bf16)):
        reset_launches()
        m = gpu.val(compute_dtype=dt, save_json=str(root / f"{name}.json"), **val_kw)
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"[val] {name}: launches {launches}; {m['images']} images, P {m['precision']:.6f} R {m['recall']:.6f} "
            f"mAP50 {m['mAP50']:.6f} mAP50-95 {m['mAP50-95']:.6f}")
        require(m["images"] == VAL_IMAGES and all(math.isfinite(m[k]) for k in VAL_METRICS),
                f"val {name}: images or metrics")
        # the fp32 stem bank was written by the label pass; the bf16 copy is new and writes its own
        require(launches["stem"] == n_batches and launches["nms"] == n_batches
                and launches["stem_bank"] == (1 if dt == bf16 else 0),
                f"val {name} did not launch the stem and NMS kernels once a batch")
        counts = rows_per_image(root / f"{name}.json")
        warm = [gpu.val(compute_dtype=dt, **val_kw) for _ in range(2)]
        log(f"[val] {name}: detections per image {counts}")
        for w in warm:
            s = w["speed"]
            log(f"[val] {name}, warm: {1e3 * w['sec'] / VAL_IMAGES:.3f} ms/img in all (host clock); host load + "
                f"resize + letterbox {s['load']:.3f}, device forward + decode + NMS {s['device']:.3f} (CUDA events), "
                f"host matching {s['match']:.3f} ms/img")
        out[name] = dict(metrics=m, launches=launches, counts=counts, speed=[w["speed"] for w in warm],
                         ms_per_img=[1e3 * w["sec"] / VAL_IMAGES for w in warm])

    def replayed(y, batches):
        """``y``'s validator over the set, each batch's forward replaced by the given
        decoded outputs (NMS and matching as they are, NMS on ``y``'s device)."""
        vv = DetectionValidator(y.model, data=str(yaml_path), imgsz=IMGSZ, batch=VAL_BATCH)
        it = iter(batches)
        vv.run = lambda x: nms.non_max_suppression(next(it).to(vv.device), nc=80, multi_label=True, **VAL_NMS)
        return vv()

    # the card's own decoded outputs, captured in a val run, through the CPU's NMS and matching:
    # the card's metrics exactly (everything after the forward agrees bit for bit)
    captured = []
    vc = DetectionValidator(gpu.model, data=str(yaml_path), imgsz=IMGSZ, batch=VAL_BATCH)

    def run_capture(x):
        with torch.inference_mode():
            decoded = gpu.model.forward_predict(x)
            captured.append(decoded.cpu())
            return nms.non_max_suppression(decoded, nc=80, multi_label=True, **VAL_NMS)
    vc.run = run_capture
    m_card, m_replay = vc(), replayed(cpu, captured)
    require(all(m_card[k] == m_replay[k] for k in (*VAL_METRICS, "fitness")),
            "val: the card's decoded outputs give other metrics through the CPU's NMS and matching")
    log(f"[val] the card's own decoded outputs through the CPU's NMS and matching: the card's metrics exactly "
        f"(mAP50-95 {m_card['mAP50-95']:.6f})")

    # the whole validator, card against CPU: detection counts equal, each metric within VAL_METRIC_TOL;
    # beside it what rounding alone does on the CPU (fused vs unfused, fp32 vs fp64)
    m_cpu = cpu.val(save_json=str(root / "cpu.json"), **val_kw)
    require(rows_per_image(root / "cpu.json") == out["fp32"]["counts"], "val: GPU and CPU detection counts differ")
    unfused = facade("cpu", fuse=False)
    m_u32 = unfused.val(**val_kw)
    unfused.model.double()
    m_u64 = unfused.val(**val_kw)
    diffs = {"card vs CPU": (out["fp32"]["metrics"], m_cpu), "CPU fused vs unfused": (m_cpu, m_u32),
             "CPU unfused fp32 vs fp64": (m_u32, m_u64)}
    diff = {name: {k: abs(a[k] - b[k]) for k in VAL_METRICS} for name, (a, b) in diffs.items()}
    log(f"[val] |metric differences| (fp32): {json.dumps(diff)}")
    # the forward's part: decoded outputs of 4 val images, card against CPU, and the CPU's fp32 against fp64
    x4 = next(DataLoader(ds, VAL_BATCH).epoch())["images"][:4]
    exact = facade(dev, fuse=False)  # fp64 on the card: an exact result does not depend on the device
    exact.model.double()
    with torch.inference_mode():
        d_cpu = cpu.model.forward_predict(torch.from_numpy(x4))
        d64 = exact.model.forward_predict(torch.from_numpy(x4).to(dev).double() / 255.0).cpu()
        d32 = facade("cpu", fuse=False).model.forward_predict(torch.from_numpy(x4).float() / 255.0)
    errs = {name: ((a[..., :4] - b[..., :4]).abs().max().item(), (a[..., 4:] - b[..., 4:]).abs().max().item())
            for name, (a, b) in {"card vs CPU": (captured[0][:4], d_cpu), "CPU fp32 vs fp64": (d32, d64)}.items()}
    log(f"[val] decoded outputs of 4 val images, max |diff| (box px, score): {errs}")
    require(max(diff["card vs CPU"].values()) <= VAL_METRIC_TOL and m_cpu["mAP50-95"] > 0.05,
            f"val: the card's metrics differ from the CPU validator's beyond {VAL_METRIC_TOL}")

    # the NMS kernel on one val batch's multi-label candidates, against its plain loop
    batch = next(DataLoader(ds, VAL_BATCH).epoch())
    v = DetectionValidator(gpu.model, imgsz=IMGSZ)
    with torch.inference_mode():
        decoded = gpu.model.forward_predict(v.preprocess(batch["images"]))
        cboxes, scores, cls_idx, _ = nms._prep_candidates(decoded, 80, VAL_NMS["conf_thres"], VAL_NMS["max_nms"],
                                                          True, None, False)
    cand = (cboxes + cls_idx[..., None] * nms.MAX_WH).float().contiguous()
    scores = scores.contiguous()
    iou, max_det = VAL_NMS["iou_thres"], VAL_NMS["max_det"]
    ki, kv = cuda_nms.batched_greedy_nms(cand, scores, iou, max_det)
    ki_p, kv_p = cuda_nms.batched_greedy_nms_plain(cand, scores, iou, max_det)
    torch.cuda.synchronize()
    require(torch.equal(ki, ki_p) and torch.equal(kv, kv_p), "NMS kernel vs plain differ on the val candidates")
    valid = (scores > 0).float().mean().item()
    # the same box under two or more classes among a batch's candidates: apart only by the class offset
    shared = (cboxes[:, :64, None] == cboxes[:, None]).all(-1).sum(-1).gt(1).float().mean().item()
    steps = (kv.sum(1) + (kv.sum(1) < max_det).long()).sum().item()
    bound_ms, bound_by, _ = bound(nbytes(cand, scores, ki, kv), steps * cand.shape[1] * 15)
    ms = cuda_ms(lambda: cuda_nms.batched_greedy_nms(cand, scores, iou, max_det), inner=10)
    plain_ms = cuda_ms(lambda: cuda_nms.batched_greedy_nms_plain(cand, scores, iou, max_det), reps=3, warmup=1)
    top = cand[:, :2048].contiguous(), scores[:, :2048].contiguous()  # sorted by score: the best 2048
    ms_2048 = cuda_ms(lambda: cuda_nms.batched_greedy_nms(*top, iou, max_det), inner=10)
    scratch = cuda_nms._lib().nms_scratch_bytes(VAL_BATCH, cand.shape[1], max_det)
    log(f"[val] NMS kernel == plain on one val batch's multi-label candidates, B={VAL_BATCH} N={cand.shape[1]} "
        f"iou {iou}: {valid:.4f} of the candidates valid, {shared:.4f} of the first 64 share their box with another "
        f"class, {int(kv.sum())} kept; kernel {ms:.4f} ms (the best 2048 of the same candidates {ms_2048:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); scratch {scratch / 2**20:.1f} MiB")
    flat = decoded[..., 4:].reshape(decoded.shape[0], -1)
    sort_ms = cuda_ms(lambda: nms.stable_topk(flat, VAL_NMS["max_nms"]), reps=10)
    prep_ms = cuda_ms(lambda: nms._prep_candidates(decoded, 80, VAL_NMS["conf_thres"], VAL_NMS["max_nms"], True,
                                                   None, False), reps=10)
    log(f"[val] the candidate sort (stable sort of [{flat.shape[0]}, {flat.shape[1]}] probabilities): "
        f"{sort_ms:.4f} ms a batch; the whole candidate step {prep_ms:.4f} ms")

    # seeded detections through the card's NMS and through the CPU's: the same metrics, exactly
    decoded_batches = [torch.from_numpy(seeded_val_predictions(b, seed))
                       for seed, b in enumerate(DataLoader(ds, VAL_BATCH).epoch())]
    seeded = {"card": replayed(gpu, decoded_batches), "cpu": replayed(cpu, decoded_batches)}
    log(f"[val] seeded detections, card NMS vs CPU: {[(k, seeded['card'][k], seeded['cpu'][k]) for k in VAL_METRICS]}")
    require(all(seeded["card"][k] == seeded["cpu"][k] for k in (*VAL_METRICS, "fitness"))
            and seeded["cpu"]["mAP50-95"] > 0.3, "val: seeded detections give other metrics on the card")

    # bf16: the card's bf16 copy against the CPU fp32, within 1.5x the CPU bf16 copy's own distance
    x8 = batch["images"][:8]
    with torch.inference_mode():
        g16 = DetectionValidator(gpu.model, compute_dtype=bf16).model.forward_predict(
            torch.from_numpy(x8).to(dev)).cpu()
        c32 = cpu.model.forward_predict(torch.from_numpy(x8))
        c16 = DetectionValidator(cpu.model, compute_dtype=bf16).model.forward_predict(torch.from_numpy(x8))
    stats = {}
    for key, sl in (("boxes", np.s_[..., :4]), ("scores", np.s_[..., 4:])):
        stats[key] = (rel_rms(g16[sl], c32[sl]), rel_rms(c16[sl], c32[sl]))
        require(bool(torch.isfinite(g16).all()) and 0 < stats[key][1] and stats[key][0] <= 1.5 * stats[key][1],
                f"val bf16: GPU {key} rel-RMS {stats[key][0]} from CPU fp32, more than 1.5x the CPU bf16's")
    log(f"[val] bf16 decoded outputs of 8 val images, rel-RMS from the CPU fp32: boxes GPU {stats['boxes'][0]:.4e} "
        f"(CPU bf16 {stats['boxes'][1]:.4e}), scores GPU {stats['scores'][0]:.4e} (CPU bf16 {stats['scores'][1]:.4e})")
    out.update(decode_err=errs,
               nms_4096=dict(max_abs_err=(ki.long() - ki_p.long()).abs().max().item(), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, ms_best_2048=ms_2048, valid_share=valid,
                             scratch_bytes=scratch),
               sort_ms=sort_ms, prep_ms=prep_ms, metric_diffs=diff, seeded=seeded["card"], bf16_rel_rms=stats)
    return out


class gated_routing:
    """Within this context every gated block (nn/moe/gated.py) records its top-k
    indices and kept expert count into ``seen``, in forward order, or, given
    ``picks`` (such a list), routes by them over its own probabilities."""

    def __init__(self, seen=None, picks=None):
        self.seen, self.picks = seen, picks

    def __enter__(self):
        import torch

        from yolo_master_tpu_torch.nn.moe import gated

        self.saved = plain_topk, plain_keep = gated.topk_renorm, gated.keep_count
        it, state = iter(self.picks or []), {}

        def topk(probs, k):
            w, idx = plain_topk(probs, k)
            if self.picks is not None:
                state["pick"] = next(it)
                idx = state["pick"][0].to(probs.device)
                w = probs.gather(1, idx)
                w = w / (w.sum(-1, keepdim=True) + 1e-6)
            elif self.seen is not None:
                self.seen.append([idx.cpu()])
            return w, idx

        def keep(complexity, k):
            own = plain_keep(complexity, k)
            if self.picks is not None:
                return torch.tensor(state["pick"][1], device=complexity.device)
            if self.seen is not None:
                self.seen[-1].append(float(own))
            return own

        gated.topk_renorm, gated.keep_count = topk, keep
        return self

    def __exit__(self, *exc):
        from yolo_master_tpu_torch.nn.moe import gated

        gated.topk_renorm, gated.keep_count = self.saved


def routing_flips(a, b) -> int:
    """(sample, block) top-k sets that differ between two recorded routings, plus
    each block whose kept count differs (one count a batch)."""
    return sum(sum(set(r.tolist()) != set(q.tolist()) for r, q in zip(ia, ib)) + int(ka != kb)
               for (ia, ka), (ib, kb) in zip(a, b))


def phase_v0_10_path(dev, base_run, imgs):
    """yolo-master-v0_10-n (VisualEnhancedAdaptiveGateMoE at layers 5, 8, 11: 4,
    8 and 16 experts, top-2, the complexity gate; plain PyTorch, no kernel of its
    own), seeded weights with BN calibrated on four frames, as the main path:
    fuse().predict() at batch 1 and 16 in fp32 and bf16 (launch counts, max_det
    detections); GPU vs CPU decode at the fixed limits, fp32, with the routing
    recorded on both and the card's pinned to the CPU's where a pick flips; the
    card's bf16 raw head outputs, pinned to the CPU bf16's routing, within 1.5x
    the CPU bf16's rel-RMS from the CPU fp32; device ms/img of both dtypes
    beside yolo-master-n's in turns, the busy share and peak memory at bs 16;
    val() in fp32 on write_val_set's images (stem and NMS once a batch, the
    NMS kernel at N=4096, metrics within VAL_METRIC_TOL of the CPU's); and a
    bs-16 fp32 predict of v0_10-s and v0_10-m."""
    import math
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.nn.moe import AdaptiveGateMoE
    from yolo_master_tpu_torch.ops import nms as tnms
    from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    bf16 = torch.bfloat16

    def calibrated(name, where):
        y = YOLO(name, device=where)
        x_cal, _ = DetectionPredictor(y.model, imgsz=IMGSZ).preprocess(imgs[:4])
        calibrate_bn(y.model, x_cal)
        return y

    v10 = calibrated(V10, dev)
    blocks = [m for m in v10.model.model if isinstance(m, AdaptiveGateMoE)]
    require([(m.i, type(m).__name__, m.num_experts) for m in blocks]
            == [(i, "VisualEnhancedAdaptiveGateMoE", e) for i, e in ((5, 4), (8, 8), (11, 16))],
            "v0_10-n's gated blocks")
    state = {k: v.detach().clone() for k, v in v10.model.state_dict().items()}
    cpu = YOLO(V10, device="cpu").load_state_dict(state)
    v10.fuse()
    cpu.fuse()
    out = {"launches": {}, "e2e": {}, "flips": {}}
    preds = {}
    for name, dt in (("fp32", torch.float32), ("bf16", bf16)):
        reset_launches()
        r1 = v10.predict(imgs[0], batch=1, compute_dtype=dt, **KW)
        r16 = v10.predict(imgs, batch=16, compute_dtype=dt, **KW)
        torch.cuda.synchronize()
        launches = out["launches"][name] = read_launches()
        log(f"[v0_10] predict {name} bs1 + bs16 launches: {launches}")
        # fp32: the fused model's stem bank, written at its first call; bf16: the one bf16 copy's own
        require(launches["stem"] == 2 and launches["nms"] == 2 and launches["stem_bank"] == 1,
                f"the v0_10 {name} path did not launch the stem and NMS kernels")
        require(len(r1) == 1 and len(r16) == 16, "v0_10 result counts")
        check_detections(r1 + r16)
        preds[name] = v10._predictor
    log(f"[v0_10] image 0 top: {np.round(r1[0].boxes.data[0], 2).tolist()}")

    # GPU vs CPU, fp32: the routing of both recorded, the card pinned to the CPU's where one flips
    x, _ = preds["fp32"].preprocess(imgs[:BF16_FRAMES])
    seen_gpu, seen_cpu = [], []
    with torch.inference_mode():
        with gated_routing(seen=seen_gpu):
            full_gpu = v10.model.head.decode(v10.model(x[:2]), raw_scores=True).cpu()
        with gated_routing(seen=seen_cpu):
            full_cpu = cpu.model.head.decode(cpu.model(x[:2].cpu()), raw_scores=True)
        out["flips"]["fp32"] = routing_flips(seen_gpu, seen_cpu)
        if out["flips"]["fp32"]:
            with gated_routing(picks=seen_cpu):
                full_gpu = v10.model.head.decode(v10.model(x[:2]), raw_scores=True).cpu()
    box_err, logit_err = decode_err(full_gpu, full_cpu)
    log(f"[v0_10] GPU vs CPU decode, all {full_gpu.shape[1]} anchors: box max err {box_err:.3e} px, logit max err "
        f"{logit_err:.3e}; routings that differ between the two fp32 programs: {out['flips']['fp32']} of "
        f"{2 * len(blocks)} picks and {len(blocks)} kept counts (pinned where they do); kept counts "
        f"{[k for _, k in seen_cpu]}")
    require(box_err <= 5e-2 and logit_err <= 1e-3, "v0_10 GPU and CPU decode disagree beyond 5e-2 px / 1e-3")
    out["decode_err"] = (box_err, logit_err)

    # bf16: the card's copy pinned to the CPU bf16 copy's routing, against the CPU fp32
    cpu16 = compute_dtype_copy(cpu.model, bf16)
    seen16, seen_g16 = [], []
    with torch.inference_mode():
        c32 = cpu.model(x.cpu())
        with gated_routing(seen=seen16):
            c16 = cpu16(x.cpu())
        with gated_routing(seen=seen_g16):
            preds["bf16"].model(x)
        with gated_routing(picks=seen16):
            g16 = preds["bf16"].model(x)
    out["flips"]["bf16"] = routing_flips(seen_g16, seen16)
    stats = {}
    for key in ("boxes", "scores"):
        gpu, own = rel_rms(g16[key].float().cpu(), c32[key]), rel_rms(c16[key].float(), c32[key])
        stats[key] = (gpu, own)
        require(bool(torch.isfinite(g16[key]).all()) and 0 < own and gpu <= 1.5 * own,
                f"v0_10 bf16: GPU {key} rel-RMS {gpu} from CPU fp32, more than 1.5x the CPU bf16's {own}")
    log(f"[v0_10] bf16, {BF16_FRAMES} frames, the card pinned to the CPU bf16's routing "
        f"({out['flips']['bf16']} of {BF16_FRAMES * len(blocks)} picks and {len(blocks)} kept counts differ "
        f"unpinned), rel-RMS from the CPU fp32 head outputs: box logits GPU {stats['boxes'][0]:.4e} (CPU bf16 "
        f"{stats['boxes'][1]:.4e}), class logits GPU {stats['scores'][0]:.4e} (CPU bf16 {stats['scores'][1]:.4e})")
    out["bf16_rel_rms"] = stats

    # device ms/img, uint8 batch on the card -> detections: v0_10-n fp32 and bf16 beside yolo-master-n, in turns
    for bs in (1, 16):
        xb, _ = preds["fp32"].preprocess(imgs[:bs])
        runs = {"yolo-master-n": [], "fp32": [], "bf16": []}
        for name in ("yolo-master-n", "fp32", "bf16", "bf16", "fp32", "yolo-master-n"):
            run = base_run if name == "yolo-master-n" else preds[name].run
            runs[name].append(cuda_ms(lambda: run(xb), reps=5, warmup=2) / bs)
        out["e2e"][bs] = {k: statistics.median(v) for k, v in runs.items()}
        log(f"[e2e] bs={bs}: device ms/img, yolo-master-n fp32 {[round(t, 4) for t in runs['yolo-master-n']]}, "
            f"yolo-master-v0_10-n fp32 {[round(t, 4) for t in runs['fp32']]}, bf16 {[round(t, 4) for t in runs['bf16']]}")
    xb, _ = preds["fp32"].preprocess(imgs)
    out["profile"], out["peak_gib"] = {}, {}
    for name in ("fp32", "bf16"):
        wall_ms, dev_us, count = profile_kernels(preds[name].run, xb)
        busy_ms = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        preds[name].run(xb)
        torch.cuda.synchronize()
        out["peak_gib"][name] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["profile"][name] = dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms, kernels=count)
        log(f"[v0_10] {name} bs=16 under torch.profiler: wall {wall_ms:.3f} ms/batch, device busy {busy_ms:.3f} "
            f"ms/batch ({100 * busy_ms / wall_ms:.1f}%), {count:.0f} kernels/batch, peak memory of a batch "
            f"{out['peak_gib'][name]:.3f} GiB; top: " + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))

    # val, fp32: the set of the val phase, labelled from the card's own detections (class biases at 0)
    root = Path(tempfile.mkdtemp(prefix=".val_set_", dir=Path(__file__).resolve().parent))
    try:
        yaml_path = write_val_set(root, VAL_IMAGES)

        def facade(where):
            y = YOLO(V10, device=where).load_state_dict(state)
            with torch.no_grad():
                for branch in y.model.head.cv3:
                    branch[-1].bias.zero_()
            return y.fuse()

        gpu_v, cpu_v = facade(dev), facade("cpu")
        label_from_detections(gpu_v.model, yaml_path)
        val_kw = dict(data=str(yaml_path), imgsz=IMGSZ, batch=VAL_BATCH)
        shapes, kernel = [], tnms.batched_greedy_nms

        def recorded(cand, scores, iou, max_det):
            shapes.append(tuple(cand.shape))
            return kernel(cand, scores, iou, max_det)

        reset_launches()
        tnms.batched_greedy_nms = recorded
        try:
            m = gpu_v.val(**val_kw)
        finally:
            tnms.batched_greedy_nms = kernel
        torch.cuda.synchronize()
        launches = out["launches"]["val"] = read_launches()
        n_batches = math.ceil(VAL_IMAGES / VAL_BATCH)
        m_cpu = cpu_v.val(**val_kw)
        diff = {k: abs(m[k] - m_cpu[k]) for k in VAL_METRICS}
        log(f"[v0_10] val fp32: launches {launches}, NMS candidates {shapes}; {m['images']} images, P "
            f"{m['precision']:.6f} R {m['recall']:.6f} mAP50 {m['mAP50']:.6f} mAP50-95 {m['mAP50-95']:.6f}; "
            f"|card - CPU| {json.dumps(diff)}; speed {json.dumps(m['speed'])} ms/img")
        require(launches["stem"] == n_batches and launches["nms"] == n_batches
                and all(sh[1] == VAL_NMS["max_nms"] for sh in shapes),
                "the v0_10 val did not launch the stem and NMS kernels (N=4096) once a batch")
        require(m["images"] == VAL_IMAGES and max(diff.values()) <= VAL_METRIC_TOL and m_cpu["mAP50-95"] > 0.05,
                f"v0_10 val: the card's metrics differ from the CPU validator's beyond {VAL_METRIC_TOL}")
        out["val"] = dict(metrics={k: m[k] for k in VAL_METRICS}, diff=diff, speed=m["speed"], nms_shapes=shapes)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the other two released scales, bs 16 in fp32
    out["scales"] = {}
    for name in ("yolo-master-v0_10-s", "yolo-master-v0_10-m"):
        y = calibrated(name, dev).fuse()
        reset_launches()
        r16 = y.predict(imgs, batch=16, **KW)
        torch.cuda.synchronize()
        launches = read_launches()
        require(launches["stem"] == 1 and launches["nms"] == 1 and len(r16) == 16,
                f"{name}: the stem and NMS kernels once at bs 16")
        check_detections(r16)
        xb, _ = y._predictor.preprocess(imgs)
        ms = cuda_ms(lambda: y._predictor.run(xb), reps=5, warmup=2) / 16
        out["scales"][name] = dict(launches=launches, ms_per_img=ms)
        log(f"[v0_10] {name} bs=16 fp32: launches {launches}, device {ms:.4f} ms/img")
        del y
    return v10, out, state


class moe_routing:
    """Within this context every OptimizedMOEImproved block (nn/moe/mixtures.py)
    records its [B, E] top-k mask into ``seen``, in forward order, or, given
    ``picks`` (such a list), routes by them over its own probabilities."""

    def __init__(self, seen=None, picks=None):
        self.seen, self.picks = seen, picks

    def __enter__(self):
        from yolo_master_tpu_torch.nn.moe import mixtures as tmix

        self.plain = tmix.process_logits
        tmix.process_logits = (routing_pinned(self.picks) if self.picks is not None
                               else routing_recorder(self.plain, self.seen))
        return self

    def __exit__(self, *exc):
        from yolo_master_tpu_torch.nn.moe import mixtures as tmix

        tmix.process_logits = self.plain


def mask_flips(a, b) -> int:
    """(sample, block) top-k sets that differ between two recorded [B, E] masks."""
    return sum(int((x != y).any(1).sum()) for x, y in zip(a, b))


class mot_routing:
    """Within this context every MoT router (nn/mot.py) records its [B, E, H, W]
    kept-expert mask into ``seen``, in forward order, or, given ``picks`` (such
    a list), keeps those experts over its own probabilities, renormalised (in
    training then lifted to the router's exploration floor)."""

    def __init__(self, seen=None, picks=None):
        self.seen, self.picks = seen, picks

    def __enter__(self):
        from yolo_master_tpu_torch.nn import mot as tmot

        self.plain = plain = tmot.MoTRouter.forward
        it = iter(self.picks or [])

        def forward(mod, x):
            w, probs, logits = plain(mod, x)
            if self.picks is not None:
                w = probs * next(it).to(probs.device)
                w = w / w.sum(1, keepdim=True).clamp_min(1e-9)
                if mod.training and mod.eps > 0:  # the training floor, as the router's own
                    w = (1 - mod.eps) * w + mod.eps / mod.num_experts
            else:  # the kept set (in training the floor lifts every weight above 0)
                self.seen.append((probs >= probs.topk(mod.top_k, 1).values[:, -1:]).cpu())
            return w, probs, logits

        tmot.MoTRouter.forward = forward
        return self

    def __exit__(self, *exc):
        from yolo_master_tpu_torch.nn import mot as tmot

        tmot.MoTRouter.forward = self.plain


class e2e_routing:
    """moe_routing and mot_routing together: ``seen`` (or ``picks``) is a dict
    {"moe": list, "mot": list} of the routed blocks' masks in forward order."""

    def __init__(self, seen=None, picks=None):
        rec = seen if picks is None else picks
        self.parts = [moe_routing(**{("seen" if picks is None else "picks"): rec["moe"]}),
                      mot_routing(**{("seen" if picks is None else "picks"): rec["mot"]})]

    def __enter__(self):
        for p in self.parts:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in reversed(self.parts):
            p.__exit__(*exc)


def routings():
    return {"moe": [], "mot": []}


def e2e_pin(seen=None, picks=None):
    """e2e_routing in card_vs_cpu_step's protocol: ``seen`` / ``picks`` a list
    holding one routings() dict (made on first use)."""
    rec = seen if picks is None else picks
    if not rec:
        rec.append(routings())
    return e2e_routing(seen=rec[0]) if picks is None else e2e_routing(picks=rec[0])


def e2e_pin_flips(a, b) -> int:
    return e2e_flips(a[0], b[0])


def e2e_flips(a, b) -> int:
    """(sample, block) top-k sets of the MoE blocks and (sample, pixel, router) kept sets of MoT that differ."""
    return mask_flips(a["moe"], b["moe"]) + mask_flips(a["mot"], b["mot"])


def phase_yolo26_path(dev, base_run, imgs):
    """yolo26-master-n, the NMS-free end2end generation (A2C2fMoE of 4, 8 and 16
    experts, top-2, at layers 4, 6, 8; SPPF, C2PSA, the attn C3k2 and the
    one2one head at reg_max 1; plain PyTorch but for the stem kernel), seeded
    weights with BN calibrated on four frames, as the main path:
    phase_end2end_path beside yolo-master-n (``base_run``), the attention's
    fp32 error at layer 4's 6,400 keys, and a bs-16 fp32 predict of
    yolo26-master-s and -m. Returns the numbers, the calibrated weights and the
    fp32 and bf16 predictors."""
    import torch

    from yolo_master_tpu_torch.nn.layers import attend

    out, state, preds = phase_end2end_path(dev, Y26, {"yolo-master-n": base_run}, imgs, blocks=6, mot_routers=0,
                                           min_map50=0.05)
    # attention's product with V at layer 4's shape (6,400 keys, two heads of 32): one cuBLAS product
    # against nn/layers.py:attend's chunked sum, each against fp64, on the card and on the CPU
    gen = torch.Generator().manual_seed(3)
    q, k = (torch.randn(2, 6400, 2, 32, generator=gen, dtype=torch.float64) for _ in range(2))
    v = 8 * torch.rand(2, 6400, 2, 32, generator=gen, dtype=torch.float64)  # values of one sign, as after a SiLU
    exact = attend(q, k, v, 32 ** -0.5)

    def one_product(q, k, v):
        a = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q * 32 ** -0.5, k), -1)
        return torch.einsum("bhnm,bmhd->bnhd", a, v)

    acc = {f"{name} {where}": (fn(*(t.float().to(where) for t in (q, k, v))).double().cpu() - exact).abs().max().item()
           for name, fn in (("one product", one_product), ("attend", lambda q, k, v: attend(q, k, v, 32 ** -0.5)))
           for where in (dev, "cpu")}
    log("[yolo26] attention at 6,400 keys, max |fp32 - fp64|: " + ", ".join(f"{k} {v:.3e}" for k, v in acc.items()))
    require(acc[f"attend {dev}"] < acc[f"one product {dev}"], "the chunked product is no closer to fp64 on the card")
    out["attention_fp32_err"] = acc

    # the other two scales, bs 16 in fp32
    x16, _ = preds["fp32"].preprocess(imgs)
    out["scales"] = {}
    for name in ("yolo26-master-s", "yolo26-master-m"):
        y = calibrated_yolo(name, dev, imgs).fuse()
        reset_launches()
        r16 = y.predict(imgs, batch=16, **KW)
        torch.cuda.synchronize()
        launches = read_launches()
        require(launches["stem"] == 1 and launches["nms"] == 0 and len(r16) == 16,
                f"{name}: the stem kernel once at bs 16, no NMS")
        check_detections(r16)
        ms = cuda_ms(lambda: y._predictor.run(x16), reps=5, warmup=2) / 16
        out["scales"][name] = dict(launches=launches, ms_per_img=ms)
        log(f"[yolo26] {name} bs=16 fp32: launches {launches}, device {ms:.4f} ms/img")
        del y
    return out, state, preds


def calibrated_yolo(name, where, imgs, wake: bool = False):
    """YOLO(name) on ``where``, seeded, (``wake``: wake_mixtures) with BN calibrated on four frames."""
    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    y = YOLO(name, device=where)
    if wake:
        from yolo_master_tpu_torch.utils.weights import wake_mixtures

        wake_mixtures(y.model)
    x_cal, _ = DetectionPredictor(y.model, imgsz=IMGSZ).preprocess(imgs[:4])
    calibrate_bn(y.model, x_cal)
    return y


def phase_end2end_path(dev, name, base_runs, imgs, blocks: int, mot_routers: int, wake: bool = False,
                       val_images: int = VAL_IMAGES, min_map50: float = 0.0):
    """An end2end (NMS-free) graph, ``name``, with seeded weights (``wake``:
    the mixtures' zero-initialised parts set non-zero, utils/weights.py:
    wake_mixtures) and BN calibrated on
    four frames, as the main path: fuse().predict() at batch 1 and 16 in fp32
    and bf16 (the stem kernel and its bank, no NMS launch; max_det fixed-shape
    detections); GPU vs CPU decode at the fixed limits, fp32, with the routing
    (``blocks`` OptimizedMOEImproved blocks, ``mot_routers`` MoT routers)
    recorded on both and the card's pinned to the CPU's where a pick flips;
    the card's bf16 one2one head outputs, pinned to the CPU bf16's routing,
    within 1.5x the CPU bf16's rel-RMS from the CPU fp32; device ms/img of both
    dtypes beside ``base_runs`` ({label: run}) in turns, the busy share and
    peak memory at bs 16; val() in fp32 on write_val_set's ``val_images``
    images (the stem once a batch, no NMS, metrics within VAL_METRIC_TOL of
    the CPU's, mAP50 above ``min_map50``). Returns (numbers, weights, {dtype:
    predictor})."""
    import math
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.nn import mot as tmot
    from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved
    from yolo_master_tpu_torch.utils.fuse import compute_dtype_copy

    bf16 = torch.bfloat16
    tag = "yolo26" if name == Y26 else name
    y26 = calibrated_yolo(name, dev, imgs, wake=wake)
    moe = [m for m in y26.model.modules() if isinstance(m, OptimizedMOEImproved)]
    n_mot = sum(isinstance(m, tmot.MoTRouter) for m in y26.model.modules())
    require(len(moe) == blocks and n_mot == mot_routers, f"{name}: {len(moe)} MoE blocks and {n_mot} MoT routers")
    require(y26.model.head.end2end and y26.model.head.reg_max == 1, f"{name}'s end2end head")
    state = {k: v.detach().clone() for k, v in y26.model.state_dict().items()}
    cpu = YOLO(name, device="cpu").load_state_dict(state)
    y26.fuse()
    cpu.fuse()
    out = {"launches": {}, "e2e": {}, "flips": {}}
    preds = {}
    x16 = None
    for dname, dt in (("fp32", torch.float32), ("bf16", bf16)):
        reset_launches()
        r1 = y26.predict(imgs[0], batch=1, compute_dtype=dt, **KW)
        r16 = y26.predict(imgs, batch=16, compute_dtype=dt, **KW)
        torch.cuda.synchronize()
        launches = out["launches"][dname] = read_launches()
        log(f"[{tag}] predict {dname} bs1 + bs16 launches: {launches}")
        require(launches["stem"] == 2 and launches["stem_bank"] == 1 and launches["nms"] == 0,
                f"the {name} {dname} path: the stem kernel twice, its bank once, and no NMS")
        require(len(r1) == 1 and len(r16) == 16, f"{name} result counts")
        check_detections(r1 + r16)
        preds[dname] = y26._predictor
        x16 = x16 if x16 is not None else preds[dname].preprocess(imgs)[0]
        with torch.inference_mode():
            det = preds[dname].run(x16)
        require(tuple(det["boxes"].shape) == (16, KW["max_det"], 4) and bool(det["valid"].all()),
                f"{name} {dname}: {KW['max_det']} fixed-shape detections an image")
    log(f"[{tag}] image 0 top: {np.round(r1[0].boxes.data[0], 2).tolist()}")

    # GPU vs CPU, fp32: the routing of both recorded, the card pinned to the CPU's where one flips
    x = x16[:BF16_FRAMES]
    seen_gpu, seen_cpu = routings(), routings()
    cpu64 = copy.deepcopy(cpu.model).double()  # outside inference mode: the expert banks read version counters
    with torch.inference_mode():
        with e2e_routing(seen=seen_gpu):
            full_gpu = y26.model.head.decode(y26.model(x[:2]), raw_scores=True).cpu()
        with e2e_routing(seen=seen_cpu):
            full_cpu = cpu.model.head.decode(cpu.model(x[:2].cpu()), raw_scores=True)
        with e2e_routing(picks=seen_cpu):
            full_cpu64 = cpu64.head.decode(cpu64(x[:2].cpu()), raw_scores=True)
        out["flips"]["fp32"] = e2e_flips(seen_gpu, seen_cpu)
        if out["flips"]["fp32"]:
            with e2e_routing(picks=seen_cpu):
                full_gpu = y26.model.head.decode(y26.model(x[:2]), raw_scores=True).cpu()
    box_err, logit_err = decode_err(full_gpu, full_cpu)
    box_noise, logit_noise = decode_err(full_cpu, full_cpu64)
    log(f"[{tag}] GPU vs CPU decode (xyxy), all {full_gpu.shape[1]} anchors: box max err {box_err:.3e} px, logit "
        f"max err {logit_err:.3e}; routings that differ between the two fp32 programs: {out['flips']['fp32']} "
        f"(MoE: of {2 * blocks} (sample, block) picks; MoT: (sample, pixel, router) kept sets) (pinned where they "
        f"do); CPU fp32 vs fp64 noise: box {box_noise:.3e} px, logit {logit_noise:.3e}; largest |box| "
        f"{full_cpu[..., :4].abs().max().item():.1f} px")
    require(box_err <= 5e-2 and logit_err <= 1e-3, f"{name} GPU and CPU decode disagree beyond 5e-2 px / 1e-3")
    out["decode_err"] = (box_err, logit_err)
    out["cpu_fp64_noise"] = (box_noise, logit_noise)

    # bf16: the card's copy pinned to the CPU bf16 copy's routing, against the CPU fp32
    cpu16 = compute_dtype_copy(cpu.model, bf16)
    seen16, seen_g16 = routings(), routings()
    with torch.inference_mode():
        c32 = cpu.model(x.cpu())
        with e2e_routing(seen=seen16):
            c16 = cpu16(x.cpu())
        with e2e_routing(seen=seen_g16):
            preds["bf16"].model(x)
        with e2e_routing(picks=seen16):
            g16 = preds["bf16"].model(x)
    out["flips"]["bf16"] = e2e_flips(seen_g16, seen16)
    stats = {}
    for key in ("boxes", "scores"):
        gpu, own = rel_rms(g16[key].float().cpu(), c32[key]), rel_rms(c16[key].float(), c32[key])
        stats[key] = (gpu, own)
        require(bool(torch.isfinite(g16[key]).all()) and 0 < own and gpu <= 1.5 * own,
                f"{name} bf16: GPU {key} rel-RMS {gpu} from CPU fp32, more than 1.5x the CPU bf16's {own}")
    log(f"[{tag}] bf16, {BF16_FRAMES} frames, the card pinned to the CPU bf16's routing "
        f"({out['flips']['bf16']} picks or kept sets differ unpinned), rel-RMS from the CPU fp32 one2one head "
        f"outputs: box GPU {stats['boxes'][0]:.4e} (CPU bf16 {stats['boxes'][1]:.4e}), class logits GPU "
        f"{stats['scores'][0]:.4e} (CPU bf16 {stats['scores'][1]:.4e})")
    out["bf16_rel_rms"] = stats

    # device ms/img, uint8 batch on the card -> detections: both dtypes beside the base runs, in turns
    for bs in (1, 16):
        xb = x16[:bs]
        runs = {**{k: [] for k in base_runs}, "fp32": [], "bf16": []}
        order = [*base_runs, "fp32", "bf16", "bf16", "fp32", *reversed(list(base_runs))]
        for key in order:
            run = base_runs[key] if key in base_runs else preds[key].run
            runs[key].append(cuda_ms(lambda: run(xb), reps=3, warmup=2) / bs)
        out["e2e"][bs] = {k: statistics.median(v) for k, v in runs.items()}
        log(f"[e2e] bs={bs}: device ms/img, " + ", ".join(f"{k} {[round(t, 4) for t in v]}" for k, v in runs.items()
                                                          if k in base_runs)
            + f", {name} fp32 {[round(t, 4) for t in runs['fp32']]}, bf16 {[round(t, 4) for t in runs['bf16']]}")
    out["profile"], out["peak_gib"] = {}, {}
    for dname in ("fp32", "bf16"):
        wall_ms, dev_us, count = profile_kernels(preds[dname].run, x16)
        busy_ms = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        preds[dname].run(x16)
        torch.cuda.synchronize()
        out["peak_gib"][dname] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["profile"][dname] = dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms, kernels=count,
                                     stem_ms=ports_kernels(dev_us)["stem_kernel"] / 1e3)
        log(f"[{tag}] {dname} bs=16 under torch.profiler: wall {wall_ms:.3f} ms/batch, device busy {busy_ms:.3f} "
            f"ms/batch ({100 * busy_ms / wall_ms:.1f}%), {count:.0f} kernels/batch, peak memory of a batch "
            f"{out['peak_gib'][dname]:.3f} GiB; top: " + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))

    # val, fp32: write_val_set's images, labelled from the card's own detections (class biases at 0)
    root = Path(tempfile.mkdtemp(prefix=".val_set_", dir=Path(__file__).resolve().parent))
    try:
        yaml_path = write_val_set(root, val_images)

        def facade(where):
            y = YOLO(name, device=where).load_state_dict(state)
            with torch.no_grad():
                for branch in (*y.model.head.cv3, *y.model.head.one2one_cv3):
                    branch[-1].bias.zero_()
            return y.fuse()

        gpu_v, cpu_v = facade(dev), facade("cpu")
        label_from_detections(gpu_v.model, yaml_path)
        val_kw = dict(data=str(yaml_path), imgsz=IMGSZ, batch=VAL_BATCH)
        reset_launches()
        m = gpu_v.val(**val_kw)
        torch.cuda.synchronize()
        launches = out["launches"]["val"] = read_launches()
        n_batches = math.ceil(val_images / VAL_BATCH)
        m_cpu = cpu_v.val(**val_kw)
        diff = {k: abs(m[k] - m_cpu[k]) for k in VAL_METRICS}
        log(f"[{tag}] val fp32: launches {launches}; {m['images']} images, P {m['precision']:.6f} R "
            f"{m['recall']:.6f} mAP50 {m['mAP50']:.6f} mAP50-95 {m['mAP50-95']:.6f}; |card - CPU| "
            f"{json.dumps(diff)}; speed {json.dumps(m['speed'])} ms/img")
        require(launches["stem"] == n_batches and launches["nms"] == 0,
                f"the {name} val: the stem kernel once a batch and no NMS")
        # real matches, not 0 against 0 (yolo26-master-n's NMS-free head keeps its near-duplicates, which on
        # random weights outrank most matches: mAP50-95 0.0465 on the CPU, where v0_10-n's exceeds 0.05)
        require(m["images"] == val_images and max(diff.values()) <= VAL_METRIC_TOL and m_cpu["mAP50"] > min_map50,
                f"{name} val: the card's metrics differ from the CPU validator's beyond {VAL_METRIC_TOL}, or mAP50 "
                f"{m_cpu['mAP50']} is not above {min_map50}")
        out["val"] = dict(metrics={k: m[k] for k in VAL_METRICS}, diff=diff, speed=m["speed"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, state, preds


VARIANTS = ("yolo26-master-latent-n", "yolo26-master-moa-mot-n")
VARIANT_VAL_IMAGES = 16  # the phase's val set: one batch (phases 16 and 28 wrap a last batch)


def phase_yolo26_variants(dev, y26_preds, imgs):
    """yolo26-master-latent-n (a LatentMixture before each scale of the head,
    over two or three inputs) and yolo26-master-moa-mot-n (C2fMoA at P3,
    C2fMoT at P4 and P5; plain C3k2 in the backbone), their zero-initialised
    mixture parts set non-zero (utils/weights.py:wake_mixtures): phase_end2end_path for each,
    beside yolo26-master-n's fp32 and bf16 predictors in turns, val on
    VARIANT_VAL_IMAGES images. Returns the numbers and the weights."""
    bases = {f"{Y26} fp32": y26_preds["fp32"].run, f"{Y26} bf16": y26_preds["bf16"].run}
    out, states = {}, {}
    for name, blocks, mot in ((VARIANTS[0], 6, 0), (VARIANTS[1], 0, 3)):
        out[name], states[name], _ = phase_end2end_path(dev, name, bases, imgs, blocks=blocks, mot_routers=mot,
                                                        wake=True, val_images=VARIANT_VAL_IMAGES)
    return out, states


def train_batch(b: int, m: int, dev, seed: int, max_boxes: int = 8):
    """A seeded synthetic train batch at IMGSZ in the train step's layout: uniform-noise
    images [b, IMGSZ, IMGSZ, 3] in 0..1, up to ``max_boxes`` boxes an image (xyxy px,
    sides 24-320 px) in ``m`` padded slots, classes, mask. The host draws each
    (b, m, seed, max_boxes) once a process (a bs-64 batch takes ~0.8 s to draw;
    the steps only read it) and copies it to ``dev`` on every call."""
    return {k: v.to(dev) for k, v in _host_train_batch(b, m, seed, max_boxes).items()}


@functools.lru_cache(maxsize=None)
def _host_train_batch(b: int, m: int, seed: int, max_boxes: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, m, 2, generator=g) * (IMGSZ - 48)
    wh = 24 + torch.rand(b, m, 2, generator=g) * 296
    boxes = torch.cat([xy, (xy + wh).clamp(max=IMGSZ - 1)], -1)
    n = torch.randint(1, max_boxes + 1, (b, 1), generator=g)
    return {"images": torch.rand(b, IMGSZ, IMGSZ, 3, generator=g), "boxes": boxes,
            "classes": torch.randint(0, 80, (b, m), generator=g), "mask": torch.arange(m)[None] < n}


def train_model(state, where, head_bias_zero: bool = True, name: str = "yolo-master-n", schedule=None,
                noise: float = 0.0):
    """``name`` (unfused; yolo-master-n with phase 9's calibrated weights, v0_1-n
    with phase 12's) with the class biases at 0 as in the val phase, on ``where``;
    ``schedule`` (warmup_steps, dropout_interval) set on every routed block;
    ``noise`` the latent routers' noise_std (0 in the YAML)."""
    import torch

    from yolo_master_tpu_torch.nn.latent_mixture import LatentRouter

    from yolo_master_tpu_torch import YOLO

    y = YOLO(name, device=where).load_state_dict(state)
    if head_bias_zero:
        head = y.model.head
        with torch.no_grad():
            for branch in (*head.cv3, *(head.one2one_cv3 if head.end2end else ())):
                branch[-1].bias.zero_()
    if schedule is not None:
        for m in routed_blocks(y.model):
            m.warmup_steps, m.dropout_interval = schedule
    for m in y.model.modules():
        if isinstance(m, LatentRouter) and noise:
            m.noise_std = noise
    return y


def routed_blocks(model):
    from yolo_master_tpu_torch.nn.moe import OptimizedMOEImproved

    return [m for m in model.modules() if isinstance(m, OptimizedMOEImproved)]


def train_step_bench(dev, state, dtype, name: str = "yolo-master-n", schedule=None, noise: float = 0.0):
    """BENCH_STEPS timed optimizer steps of ``name`` at 640, bs 16 x accumulate 4 (nbs 64),
    max_gt 128, in ``dtype``, from ``state`` (class biases at 0; ``schedule`` on
    the routed blocks, train_model): finite
    losses, the EMA counted, BN statistics moved, ms per optimizer step and per
    micro-batch (CUDA events), peak memory; one bs-16 step without accumulation;
    one bs-16 micro-batch by layer (forward, loss + TAL, backward, optimizer +
    EMA); one profiled optimizer step (busy share, top kernels and host ops,
    profile_sums). Returns the model, the state and the numbers."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from yolo_master_tpu_torch.engine import train_step as ts

    metrics = ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss")
    tag = ("train b" if dtype == torch.float32 else "train bf16 b") + ("" if name == "yolo-master-n" else f" {name}")
    what = str(dtype).removeprefix("torch.")
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=16)
    require(pol.accumulate == 4, f"{tag}: nbs 64 at bs 16 should accumulate 4")
    y = train_model(state, dev, name=name, schedule=schedule, noise=noise)
    tx = pol.build_optimizer(y.model)
    st = ts.make_train_state(y.model, tx)
    step = ts.make_train_step(y.model, tx, accumulate=pol.accumulate, compute_dtype=dtype)
    batches = [train_batch(16 * pol.accumulate, 128, dev, seed=20 + i) for i in range(BENCH_STEPS + 1)]
    bn_before = {k: v.clone() for k, v in y.model.state_dict().items() if k.endswith("running_mean")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for i in range(BENCH_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st, met = step(st, batches[i])
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append({k: float(met[k]) for k in (*metrics, "finite")})
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(v, bn_before[k]) for k, v in y.model.state_dict().items() if k in bn_before)
    log(f"[{tag}] {name}, 640, {what}, bs 16 x accumulate 4, max_gt 128, {BENCH_STEPS} steps: losses {losses}; ms per "
        f"optimizer step {[round(t, 3) for t in step_ms]} (CUDA events), per micro-batch "
        f"{[round(t / pol.accumulate, 3) for t in step_ms]}; peak memory {peak / 2**30:.2f} GiB; "
        f"{moved} of {len(bn_before)} BN running means moved")
    require(all(math.isfinite(r[k]) for r in losses for k in metrics) and all(r["finite"] == 1.0 for r in losses),
            f"{tag}: a non-finite loss")
    require(st.ema_updates == st.step == st.opt_state.count == BENCH_STEPS, f"{tag}: the counters")
    require(moved == len(bn_before), f"{tag}: BN statistics did not move")
    # one micro-batch alone (forward, loss, backward) and the optimizer + EMA alone
    mb = {k: v[:16] for k, v in batches[-1].items()}
    micro = ts.make_train_step(y.model, tx, compute_dtype=dtype)  # accumulate 1: a micro-batch, its step
    micro_ms = cuda_ms(lambda: micro(st, mb), reps=2, warmup=1)
    log(f"[{tag}] one bs-16 step without accumulation (forward, loss, backward, optimizer, EMA): "
        f"{micro_ms:.3f} ms (CUDA events, median of 2)")
    # the step's layers on one bs-16 micro-batch, CUDA events between them: the train-mode forward,
    # the loss (TAL included), backward, and the optimizer with the EMA (median of 2 after one untimed)
    hyp = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "moe": 0.01}
    names = ("forward", "loss + TAL", "backward", "optimizer + EMA")
    split = {k: [] for k in names}
    y.model.train()
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        preds, aux = y.model.forward_train(mb["images"].to(dtype), st.step)
        ev[1].record()
        total, _ = y.model.compute_loss(preds, mb, sum(rec.value for rec in aux.values()), hyp)
        ev[2].record()
        total.backward()
        ev[3].record()
        tx.apply(y.model, st.opt_state)
        ts.ema_blend(st.ema_params, y.model, ts.ema_decay(st.ema_updates))
        ev[4].record()
        ev[4].synchronize()
        for p in y.model.parameters():
            p.grad = None
        for i, k in enumerate(names):
            split[k].append(ev[i].elapsed_time(ev[i + 1]))
    split = {k: statistics.median(v[1:]) for k, v in split.items()}
    log(f"[{tag}] one bs-16 micro-batch by layer (CUDA events, ms): " + json.dumps(split))
    # one profiled optimizer step: busy share and top kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, _ = step(st, batches[-1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device, host = profile_sums(prof)
    busy_ms = sum(us for us, _ in device.values()) / 1e3
    count = sum(n for _, n in device.values())
    copies = sum(n for k, (_, n) in device.items() if "Memcpy HtoD" in k)
    top = sorted(device.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[{tag}] one profiled optimizer step: wall {wall_ms:.3f} ms under the profiler, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {count} kernels and copies, {copies} host-to-device "
        f"copies; top: "
        + "; ".join(f"{k[:60]} {us / 1e3:.3f} ms" for k, (us, _) in top))
    require(busy_ms > 0, f"{tag}: the profile shows no device time")
    host = sorted(host.items(), key=lambda kv: -kv[1][0])[:8]
    host_ms = {k: round(us / 1e3, 3) for k, (us, _) in host}
    log(f"[{tag}] the profiled step's host: top ops by self CPU ms (calls): "
        + "; ".join(f"{k} {us / 1e3:.3f} ({n})" for k, (us, n) in host))
    return y, st, dict(host_top_ms=host_ms, losses=losses, step_ms=step_ms,
                       micro_ms=[t / pol.accumulate for t in step_ms], step_no_accumulation_ms=micro_ms,
                       layers_ms=split, peak_bytes=peak, busy_ms=busy_ms, wall_ms=wall_ms,
                       busy_share=busy_ms / wall_ms, kernels=count, copies_htod=copies)


def card_vs_cpu_step(dev, make_model, tag, pin=None, flips=None, families=()):
    """One optimizer step at bs 2 of ``make_model(where)`` on the card against the
    same step on the CPU, from a state at step 50 of the trainer's warmup (every
    group's lr non-zero, momentum traces seeded): the loss components within
    1e-4 relative, the parameters, BN statistics and EMA after the step within
    1e-4 of each tensor's scale plus 1e-2 of its move, the updates within 5e-2
    of their size. With ``pin`` (a routing context: gated_routing, moe_routing)
    the CPU's step runs first and the card's routed blocks route by its picks
    (and kept counts; a pick may flip between the two fp32 programs), and the
    routings that differ unpinned are counted by ``flips``. ``families``: the
    mixture families whose composed aux (``aux_<family>``) must agree within
    1e-5 relative. Returns the numbers and the two models."""
    import contextlib
    import math

    import torch

    from yolo_master_tpu_torch.engine import train_step as ts

    metrics = ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss")
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    runs, seen, own = {}, [], []
    g = torch.Generator().manual_seed(3)
    for where in (("cpu", dev) if pin else (dev, "cpu")):
        y = make_model(where)  # built before the routing is patched: the facade's stride probe routes too
        tx = pol.build_optimizer(y.model)
        st = ts.make_train_state(y.model, tx)
        st.step = st.opt_state.count = 50
        st.ema_updates = 50.0
        g.manual_seed(3)
        with torch.no_grad():
            for name, t in sorted(st.opt_state.buffers["trace"].items()):
                t.copy_(torch.randn(t.shape, generator=g) * 1e-3)
        before = {k: v.detach().clone() for k, v in y.model.state_dict().items() if v.is_floating_point()}
        bn_names = {id(m): n for n, m in y.model.named_modules()}
        step = ts.make_train_step(y.model, tx)
        batch = train_batch(2, 8, where, seed=11)
        if pin and where != "cpu":
            with torch.no_grad(), pin(seen=own):  # the card's own routing of the step's batch
                y.model.train().forward_train(batch["images"], st.step)
            for bn in (m for m in y.model.modules() if isinstance(m, torch.nn.BatchNorm2d)):
                bn.running_mean.copy_(before[f"{bn_names[id(bn)]}.running_mean"].to(where))
                bn.running_var.copy_(before[f"{bn_names[id(bn)]}.running_var"].to(where))
        routing = (pin(seen=seen) if where == "cpu" else pin(picks=seen)) if pin else contextlib.nullcontext()
        with routing:
            st, met = step(st, batch)
        runs[str(where)] = (y.model, st, {k: float(met[k]) for k in (*metrics, *(f"aux_{f}" for f in families))},
                            before)
    (mg, sg, lg, bg), (mc, sc, lc, bc) = runs[str(dev)], runs["cpu"]
    aux_err = {f: abs(lg[f"aux_{f}"] - lc[f"aux_{f}"]) / max(abs(lc[f"aux_{f}"]), 1e-30) for f in families}
    if families:
        log(f"[{tag}] each family's composed aux, card {[lg[f'aux_{f}'] for f in families]}, CPU "
            f"{[lc[f'aux_{f}'] for f in families]}; relative deviation {aux_err}")
        require(all(lc[f"aux_{f}"] > 0 for f in families) and max(aux_err.values()) <= 1e-5,
                f"{tag}: a family's aux differs between the card and the CPU beyond 1e-5 relative, or is 0")
    lg, lc = ({k: r[k] for k in metrics} for r in (lg, lc))
    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in metrics}
    log(f"[{tag}] one step at bs 2 from step 50 (lr {pol.lr_schedule(50):.3e}, bias lr "
        f"{pol.bias_lr_schedule(50):.4f}, momentum {pol.momentum_schedule(50):.4f}): card {lg}, CPU {lc}; "
        f"relative deviation {loss_err}")
    require(all(math.isfinite(v) for v in lg.values()) and max(loss_err.values()) <= 1e-4,
            f"{tag}: the card's loss components differ from the CPU's beyond 1e-4 relative")
    # the step's updates, card against CPU, where a tensor moved by >= 1e-2 of the largest move:
    # within 5e-2 of the tensor's own move (cuDNN's backward sums in another order than the CPU's)
    sd_g, sd_c = mg.state_dict(), mc.state_dict()
    moves = {k: ((sd_g[k].cpu() - bg[k].cpu()), (sd_c[k] - bc[k])) for k in bc}
    top = max(d.abs().max().item() for _, d in moves.values())
    rel = {k: (a - b).abs().max().item() / b.abs().max().item() for k, (a, b) in moves.items()
           if b.abs().max().item() >= 1e-2 * top}
    k_rel = max(rel, key=rel.get)
    # the state after the step: within 1e-4 of each tensor's scale plus 1e-2 of its move in this step (a BN
    # bias drawn at 0 is all move after one step at the bias lr)
    worst = {}
    for what, a, b in (("params and BN statistics", sd_g, sd_c), ("EMA", sg.ema_params, sc.ema_params)):
        errs = {k: ((a[k].cpu() - b[k]).abs().max().item(),
                    1e-4 * b[k].abs().max().item() + 1e-2 * moves[k][1].abs().max().item() + 1e-7)
                for k in sc.ema_params}
        k_worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
        worst[what] = (k_worst, *errs[k_worst])
        require(all(e <= lim for e, lim in errs.values()),
                f"{tag}: {what} after the step differ beyond their limit (worst {worst[what]})")
    log(f"[{tag}] largest deviations, card vs CPU (tensor, |diff|, limit): {worst}; updates: worst {k_rel} "
        f"{rel[k_rel]:.3e} of its largest move ({len(rel)} tensors moved by >= 1e-2 of the largest move, {top:.3e})")
    require(rel[k_rel] <= 5e-2, f"{tag}: the card's updates differ from the CPU's beyond 5e-2 of their size")
    out = dict(loss_rel_err=loss_err, worst=worst, update_rel_err=rel[k_rel], aux_rel_err=aux_err)
    if pin:
        out["routing_flips"] = flips(own, seen)
        log(f"[{tag}] the card pinned to the CPU step's routing; unpinned, {out['routing_flips']} routings differ "
            f"({len(seen)} routed calls)")
    return out, {"card": mg, "cpu": mc}


def phase_train(dev, state):
    """The train step (engine/train_step.py) on yolo-master-n at 640, fp32:
    (a) one optimizer step at bs 2 on the card against the same step on the CPU,
    from a state at step 50 of the warmup (every group's lr non-zero, momentum
    traces seeded); (b) two timed optimizer steps of bs 16 x accumulate 4 (nbs 64),
    max_gt 128: finite losses, the EMA counted, BN statistics moved, times, peak
    memory and one profiled step; (c) the EMA weights loaded into a model,
    fused, and validated on a synthetic set: the stem and NMS kernels launch."""
    import math
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    out = {}

    # (a) card against CPU, one optimizer step
    out["a"], _ = card_vs_cpu_step(dev, lambda where: train_model(state, where), "train a")

    # (b) the slice at full width: bs 16 x accumulate 4, two timed optimizer steps and a profiled one
    y, st, out["b"] = train_step_bench(dev, state, torch.float32)

    # (c) the EMA weights to the kernels: a fused model of them through val()
    from yolo_master_tpu_torch import YOLO

    ema = YOLO("yolo-master-n", device=dev).load_state_dict(
        {k: st.ema_params.get(k, v) for k, v in y.model.state_dict().items()}).fuse()
    root = Path(tempfile.mkdtemp(prefix=".val_set_", dir=Path(__file__).resolve().parent))
    try:
        yaml_path = write_val_set(root, VAL_IMAGES, seed=5)
        label_from_detections(ema.model, yaml_path)
        reset_launches()
        m = ema.val(data=str(yaml_path), imgsz=IMGSZ, batch=VAL_BATCH, save_json=str(root / "ema.json"))
        torch.cuda.synchronize()
        launches = read_launches()
        rows = json.loads((root / "ema.json").read_text())
        counts = [sum(r["image_id"] == i + 1 for r in rows) for i in range(VAL_IMAGES)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_batches = math.ceil(VAL_IMAGES / VAL_BATCH)
    log(f"[train c] val of the EMA model after {st.step} steps (fused): launches {launches}; {m['images']} images, "
        f"P {m['precision']:.6f} R {m['recall']:.6f} mAP50 {m['mAP50']:.6f} mAP50-95 {m['mAP50-95']:.6f}; "
        f"detections per image {counts}")
    require(launches["stem"] == n_batches and launches["nms"] == n_batches,
            "train (c): val of the EMA model did not launch the stem and NMS kernels once a batch")
    require(m["images"] == VAL_IMAGES and all(c > 0 for c in counts)
            and all(math.isfinite(m[k]) for k in VAL_METRICS), "train (c): an image without detections, or metrics")
    out["c"] = dict(launches=launches, metrics={k: m[k] for k in VAL_METRICS})
    return out


def step_gradients(model, tx, batch, dtype, step: int = 0):
    """The gradient tree (fp32 on the CPU, by parameter name) that one optimizer
    step of ``model`` in ``dtype``, at train step ``step``, hands its optimizer on
    ``batch``, and the step's metrics."""
    import torch

    from yolo_master_tpu_torch.engine import train_step as ts

    grads, apply = {}, tx.apply

    def capture(m, opt_state):
        grads.update({n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().float().cpu().clone()
                      for n, p in m.named_parameters()})  # the gated blocks' complexity_estimator has none
        apply(m, opt_state)

    tx.apply = capture
    try:
        st = ts.make_train_state(model, tx)
        st.step = step
        _, met = ts.make_train_step(model, tx, compute_dtype=dtype)(st, batch)
    finally:
        del tx.apply
    return grads, met


def phase_train_bf16(dev, state, fp32):
    """bf16 training's step (engine/train_step.py, compute_dtype=torch.bfloat16, the
    trainer's default): (a) one step at bs 2 on the card in bf16 against the port's
    CPU steps in fp32 and bf16 from the same weights and batch, on two batches:
    the gradient trees' rel-RMS(card bf16 - CPU fp32) within 1.5x rel-RMS(CPU
    bf16 - CPU fp32), the squared distances summed over the batches (the
    whole-model bf16 statistic: deep in the backbone a bf16 gradient is mostly
    rounding noise, so two bf16 programs are held by their distance from fp32
    and one batch's statistic spreads); (b) train_step_bench in bf16 beside
    phase 17's fp32 numbers of the same call (``fp32``)."""
    import math

    import torch

    from yolo_master_tpu_torch.engine import train_step as ts

    out = {}
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    sums, losses = [0.0, 0.0, 0.0], {}  # |card16 - cpu32|^2, |cpu16 - cpu32|^2, |cpu32|^2 over the batches
    for seed in (11, 12):
        grads = {}
        for where, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32), ("cpu", torch.bfloat16)):
            y = train_model(state, where)
            t0 = time.perf_counter()
            g, met = step_gradients(y.model, pol.build_optimizer(y.model), train_batch(2, 8, where, seed=seed),
                                    dtype)
            key = f"{torch.device(where).type} {str(dtype).removeprefix('torch.')}"
            grads[key] = torch.cat([g[n].flatten() for n in sorted(g)]).double()
            losses[f"{key}, batch {seed}"] = {k: float(met[k]) for k in ("loss", "box_loss", "cls_loss", "dfl_loss",
                                                                          "aux_loss")}
            log(f"[train bf16 a] one step at 640, bs 2, batch {seed}, {key}: losses {losses[f'{key}, batch {seed}']} "
                f"({time.perf_counter() - t0:.1f} s)")
        ref = grads["cpu float32"]
        for i, key in enumerate(("cuda bfloat16", "cpu bfloat16")):
            sums[i] += float(((grads[key] - ref) ** 2).sum())
        sums[2] += float((ref ** 2).sum())
    card, own = math.sqrt(sums[0] / sums[2]), math.sqrt(sums[1] / sums[2])
    log(f"[train bf16 a] gradient trees ({ref.numel()} values a step, two steps), rel-RMS from the CPU fp32: card "
        f"bf16 {card:.4e}, CPU bf16 {own:.4e} (ratio {card / own:.3f}, limit 1.5)")
    require(all(math.isfinite(v) for r in losses.values() for v in r.values()), "train bf16 (a): a non-finite loss")
    require(0 < own < 2 and card <= 1.5 * own,
            "train bf16 (a): the card's bf16 gradients are further from the CPU fp32 than 1.5x the CPU bf16's")
    out["a"] = dict(grad_rel_rms_card=card, grad_rel_rms_cpu_bf16=own, losses=losses)
    _, _, out["b"] = train_step_bench(dev, state, torch.bfloat16)
    b16, b32 = out["b"], fp32
    log("[train bf16 a] bf16 beside fp32 (this call): ms per optimizer step "
        f"{[round(t, 3) for t in b16['step_ms']]} vs {[round(t, 3) for t in b32['step_ms']]}; per micro-batch by "
        f"layer {json.dumps(b16['layers_ms'])} vs {json.dumps(b32['layers_ms'])}; peak "
        f"{b16['peak_bytes'] / 2**30:.2f} vs {b32['peak_bytes'] / 2**30:.2f} GiB; busy {b16['busy_ms']:.3f} ms "
        f"({100 * b16['busy_share']:.1f}%, {b16['kernels']} kernels) vs {b32['busy_ms']:.3f} ms "
        f"({100 * b32['busy_share']:.1f}%, {b32['kernels']} kernels)")
    return out


def routing_recorder(plain, seen):
    """process_logits (``plain``) that records each routed block's [B, E] rank mask, on the CPU, in forward order."""
    def routing(logits, top_k, noise=None):
        out = plain(logits, top_k, noise)
        seen.append((out[0] > 0).cpu())
        return out

    return routing


def routing_pinned(masks):
    """process_logits that keeps, block by block in forward order, the experts of
    ``masks`` over the block's own noisy probabilities, renormalised."""
    import torch

    from yolo_master_tpu_torch.nn.moe.routers import LOGIT_CLAMP

    it = iter(masks)

    def routing(logits, top_k, noise=None):
        logits = logits.float() + noise if noise is not None else logits.float()
        probs = torch.softmax(logits.clamp(-LOGIT_CLAMP, LOGIT_CLAMP), dim=-1)
        w = probs * next(it).to(probs.device)
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), probs, logits

    return routing


def phase_v0_1_train(dev, state, n32, n16):
    """yolo-master-v0_1-n's train step at 640 with phase 12's weights (class
    biases at 0), warmup_steps 2 and dropout_interval 2 on its three routed
    blocks (V01_STEP_SCHEDULE): (a) fp32, one step at bs 2 from step 50 (k = 2,
    a dropout step) on the card against the CPU, phase 17's gate, and the
    router noise and keep masks the card's step used equal to the CPU's bit
    for bit; (b) bf16, one step at bs 2 at step 2 (k = 2, a dropout step) on two
    batches: the card's routing pinned to the CPU bf16 step's picks, the
    gradient trees' rel-RMS from the CPU fp32 within 1.5x the CPU bf16's (phase
    19's statistic); unpinned, the (sample, block) pairs whose picks differ
    between the card's bf16 and the CPU's, counted; (c) train_step_bench in fp32
    and bf16 (steps 0-2: k anneals, step 2 drops experts) beside yolo-master-n's
    numbers of the same call (``n32``, ``n16``: phases 17 and 19)."""
    import math

    import torch

    from yolo_master_tpu_torch.engine import train_step as ts
    from yolo_master_tpu_torch.nn.moe import mixtures as tmix

    def make(where):
        return train_model(state, where, name=V01, schedule=V01_STEP_SCHEDULE)

    log(f"[v0_1 train] warmup_steps, dropout_interval = {V01_STEP_SCHEDULE} on layers 5, 8 and 11")
    out = {}
    out["a"], models = card_vs_cpu_step(dev, make, "v0_1 train a")
    dropped = {}
    for mg, mc in zip(routed_blocks(models["card"]), routed_blocks(models["cpu"])):
        require(mg.step == mc.step == 50 and mg.dropped_experts().size > 0,
                "v0_1 train (a): step 50 should drop experts")
        require(torch.equal(mg._draws[1].cpu(), mc._draws[1]),
                f"v0_1 train (a): {mg.jax_path}'s noise or keep mask differs between the card and the CPU")
        dropped[mg.jax_path] = mg.dropped_experts().tolist()
    log(f"[v0_1 train a] the router noise [2, E] and keep mask [E] of each block's step on the card equal the "
        f"CPU's bit for bit; dropped experts at step 50: {dropped}")
    out["a"]["dropped"] = dropped

    # (b) bf16 against the CPU's fp32 and bf16, the card's routing pinned to the CPU bf16's picks
    plain = tmix.process_logits
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    sums, flips, pairs = [0.0, 0.0, 0.0], 0, 0
    runs = (("cpu bfloat16", "cpu", torch.bfloat16), ("cpu float32", "cpu", torch.float32),
            ("cuda bfloat16 unpinned", dev, torch.bfloat16), ("cuda bfloat16", dev, torch.bfloat16))
    for seed in (11, 12):
        grads, masks = {}, {}
        for key, where, dtype in runs:
            seen = []
            y = make(where)  # built before the routing is patched: the facade's stride probe routes too
            tmix.process_logits = (routing_pinned(masks["cpu bfloat16"]) if key == "cuda bfloat16"
                                   else routing_recorder(plain, seen))
            try:
                g, met = step_gradients(y.model, pol.build_optimizer(y.model), train_batch(2, 8, where, seed=seed),
                                        dtype, step=2)
            finally:
                tmix.process_logits = plain
            masks[key] = seen
            grads[key] = torch.cat([g[n].flatten() for n in sorted(g)]).double()
            require(all(math.isfinite(float(met[k])) for k in ("loss", "aux_loss")), f"v0_1 train (b): {key} loss")
        flips += sum(int((a != b).any(-1).sum()) for a, b in zip(masks["cuda bfloat16 unpinned"],
                                                                  masks["cpu bfloat16"]))
        pairs += sum(m.shape[0] for m in masks["cpu bfloat16"])
        ref = grads["cpu float32"]
        for i, key in enumerate(("cuda bfloat16", "cpu bfloat16")):
            sums[i] += float(((grads[key] - ref) ** 2).sum())
        sums[2] += float((ref ** 2).sum())
    card, own = math.sqrt(sums[0] / sums[2]), math.sqrt(sums[1] / sums[2])
    log(f"[v0_1 train b] bf16 at step 2, two batches of 2: gradient trees' rel-RMS from the CPU fp32, the card's "
        f"routing pinned to the CPU bf16's picks: card {card:.4e}, CPU bf16 {own:.4e} (ratio {card / own:.3f}, "
        f"limit 1.5); unpinned, the card's bf16 and the CPU's bf16 pick a different top-2 set for {flips} of "
        f"{pairs} (sample, block) pairs")
    require(0 < own < 2 and card <= 1.5 * own,
            "v0_1 train (b): the card's bf16 gradients are further from the CPU fp32 than 1.5x the CPU bf16's")
    out["b"] = dict(grad_rel_rms_card=card, grad_rel_rms_cpu_bf16=own, flips=flips, pairs=pairs)

    # (c) bs 16 x accumulate 4, two timed steps, in both dtypes, beside yolo-master-n's
    for what, dtype, ref in (("fp32", torch.float32, n32), ("bf16", torch.bfloat16, n16)):
        _, _, r = train_step_bench(dev, state, dtype, name=V01, schedule=V01_STEP_SCHEDULE)
        out[f"c_{what}"] = r
        log(f"[v0_1 train c] {what}, v0_1-n beside yolo-master-n (this call): ms per optimizer step "
            f"{[round(t, 3) for t in r['step_ms']]} vs {[round(t, 3) for t in ref['step_ms']]}; per micro-batch by "
            f"layer {json.dumps(r['layers_ms'])} vs {json.dumps(ref['layers_ms'])}; peak "
            f"{r['peak_bytes'] / 2**30:.2f} vs {ref['peak_bytes'] / 2**30:.2f} GiB; busy {r['busy_ms']:.3f} ms "
            f"({100 * r['busy_share']:.1f}%, {r['kernels']} kernels) vs {ref['busy_ms']:.3f} ms "
            f"({100 * ref['busy_share']:.1f}%, {ref['kernels']} kernels)")
    return out


def phase_v0_10_train(dev, state, main_state, imgs, benches):
    """yolo-master-v0_10-n's training (the gated blocks' temperature anneal,
    complexity gate and aux loss) with phase 26's weights (class biases at 0):
    (a) one fp32 step at bs 2 from step 50 on the card against the CPU, phase
    17's gate, the card routed by the CPU step's picks and kept counts (the
    unpinned flips counted); (b) one bf16 step at bs 2 on two batches, the
    card's routing pinned to the CPU bf16 step's, the gradient trees' rel-RMS
    from the CPU fp32 within 1.5x the CPU bf16's (phase 19's statistic);
    (c) one step at bs 2 of yolo-master-v0_13-n (MultiHeadRouterV3: noise and
    soft expert dropout) and of v0_15-n (V2 noise and drop-path), seeded
    weights, expert_dropout and drop_prob at 0.5 so that both fire: the draws
    the card's step used equal to the CPU step's bit for bit; (d)
    train_step_bench in fp32 and bf16 beside yolo-master-n's and v0_1-n's of
    the same call (``benches``: phases 17, 19 and 22); (e) the training loop
    with amp at its default (phase 20's run, resume and predict of
    last.npz); (f) the MoE tools: diagnose_model and prune_moe_model (each
    ES_MOE cut to its two most used experts) on yolo-master-n with the main
    path's weights (``main_state``), the pruned model's BN calibrated anew,
    fused through predict (stem and NMS kernels) and its decode against the
    CPU's pruned model on the same weights; the
    quantization_report of v0_10-n and its dequantized weights through
    predict."""
    import math

    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine import train_step as ts
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.nn.moe import ES_MOE, AdaptiveGateMoE
    from yolo_master_tpu_torch.nn.moe.analysis import diagnose_model
    from yolo_master_tpu_torch.nn.moe.pruning import prune_moe_model
    from yolo_master_tpu_torch.nn.moe.quantize import dequantize_state_dict, quantization_report, quantize_state_dict
    from yolo_master_tpu_torch.nn.tasks import DetectionModel
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    def make(where):
        return train_model(state, where, name=V10)

    out = {}
    out["a"], _ = card_vs_cpu_step(dev, make, "v0_10 train a", pin=gated_routing, flips=routing_flips)

    # (b) bf16 against the CPU's fp32 and bf16, the card pinned to the CPU bf16's routing
    pol = ts.TrainPolicy(nc=80, epochs=100, nb=1000, batch=2, nbs=2, optimizer="SGD")
    sums, flips = [0.0, 0.0, 0.0], 0
    for seed in (11, 12):
        grads, seen = {}, {}
        for key, where, dtype in (("cpu bfloat16", "cpu", torch.bfloat16), ("cpu float32", "cpu", torch.float32),
                                  ("cuda bfloat16 unpinned", dev, torch.bfloat16), ("cuda bfloat16", dev, torch.bfloat16)):
            y = make(where)
            seen[key] = []
            pin = gated_routing(picks=seen["cpu bfloat16"]) if key == "cuda bfloat16" else gated_routing(seen=seen[key])
            with pin:
                g, met = step_gradients(y.model, pol.build_optimizer(y.model), train_batch(2, 8, where, seed=seed),
                                        dtype, step=50)
            grads[key] = torch.cat([g[n].flatten() for n in sorted(g)]).double()
            require(all(math.isfinite(float(met[k])) for k in ("loss", "aux_loss")), f"v0_10 train (b): {key} loss")
        flips += routing_flips(seen["cuda bfloat16 unpinned"], seen["cpu bfloat16"])
        ref = grads["cpu float32"]
        for i, key in enumerate(("cuda bfloat16", "cpu bfloat16")):
            sums[i] += float(((grads[key] - ref) ** 2).sum())
        sums[2] += float((ref ** 2).sum())
    card, own = math.sqrt(sums[0] / sums[2]), math.sqrt(sums[1] / sums[2])
    log(f"[v0_10 train b] bf16 at step 50, two batches of 2: gradient trees' rel-RMS from the CPU fp32, the card's "
        f"routing pinned to the CPU bf16's: card {card:.4e}, CPU bf16 {own:.4e} (ratio {card / own:.3f}, limit 1.5); "
        f"unpinned, {flips} of 12 picks and 6 kept counts differ between the card's bf16 and the CPU's")
    require(0 < own < 2 and card <= 1.5 * own,
            "v0_10 train (b): the card's bf16 gradients are further from the CPU fp32 than 1.5x the CPU bf16's")
    out["b"] = dict(grad_rel_rms_card=card, grad_rel_rms_cpu_bf16=own, flips=flips)

    # (c) the draws of v0_13-n's and v0_15-n's step on the card equal the CPU's
    out["c"] = {}
    for name, owner, attr in (("yolo-master-v0_13-n", "routing", "expert_dropout"),
                              ("yolo-master-v0_15-n", "cross_gate", "drop_prob")):
        used = {}
        for where in (dev, "cpu"):
            model = DetectionModel(name).to(where)
            blocks = [m for m in model.modules() if isinstance(m, AdaptiveGateMoE)]
            for m in blocks:
                setattr(getattr(m, owner), attr, 0.5)
            tx = pol.build_optimizer(model)
            st = ts.make_train_state(model, tx)
            st.step = 3
            _, met = ts.make_train_step(model, tx)(st, train_batch(2, 8, where, seed=13))
            require(float(met["finite"]) == 1.0, f"{name}: a non-finite step")
            used[str(where)] = [torch.cat(m._draws[1], 1).cpu() for m in blocks]
        same = all(torch.equal(a, b) for a, b in zip(used[str(dev)], used["cpu"]))
        k = blocks[0].num_experts if owner == "routing" else None
        fired = [bool(((d[:, k:] == 0.5).any(1) if k else (d[:, -1] == 0)).any()) for d in used["cpu"]]
        log(f"[v0_10 train c] {name} at step 3, bs 2, {attr} 0.5: the draws of the card's step (router noise"
            f"{', dropout factors' if k else ', drop-path scale'}, [2, columns] a block) equal the CPU's bit for bit: "
            f"{same}; fired in blocks {fired}")
        require(same and any(fired), f"{name}: the card's draws differ from the CPU's, or the dropout never fired")
        out["c"][name] = dict(equal=same, fired=fired)

    # (d) bs 16 x accumulate 4, two timed steps, in both dtypes, beside yolo-master-n's and v0_1-n's
    for what, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        _, _, r = train_step_bench(dev, state, dtype, name=V10)
        out[f"d_{what}"] = r
        n, v01 = benches[f"n_{what}"], benches[f"v01_{what}"]
        log(f"[v0_10 train d] {what}, ms per optimizer step (bs 16 x 4): v0_10-n {[round(t, 3) for t in r['step_ms']]}, "
            f"yolo-master-n {[round(t, 3) for t in n['step_ms']]}, v0_1-n {[round(t, 3) for t in v01['step_ms']]}; "
            f"by layer {json.dumps(r['layers_ms'])}; peak {r['peak_bytes'] / 2**30:.2f} GiB (n "
            f"{n['peak_bytes'] / 2**30:.2f}, v0_1 {v01['peak_bytes'] / 2**30:.2f}); busy "
            f"{100 * r['busy_share']:.1f}% (n {100 * n['busy_share']:.1f}%, v0_1 {100 * v01['busy_share']:.1f}%); "
            f"{r['kernels']} kernels and copies, {r['copies_htod']} host-to-device copies (n {n['kernels']}, "
            f"{n['copies_htod']}; v0_1 {v01['kernels']}, {v01['copies_htod']})")

    # (e) the loop, amp at its default
    out["e"] = phase_train_loop(dev, state, imgs, amp=True, name=V10)

    # (f) the MoE tools
    y = YOLO("yolo-master-n", device=dev).load_state_dict(main_state)
    x4, _ = DetectionPredictor(y.model, imgsz=IMGSZ).preprocess(imgs[:4])  # NHWC, /255 (unfused)
    before = {k: v.clone() for k, v in y.model.state_dict().items()}
    t0 = time.perf_counter()
    report = diagnose_model(y.model, [{"images": x4}])
    diag_s = time.perf_counter() - t0
    usage = {k: np.asarray(v["usage"]) for k, v in report["blocks"].items()}
    require(set(usage) == {f"layers.{i}" for i in (3, 6, 9, 12)} and not y.model.training
            and all(torch.equal(v, before[k]) for k, v in y.model.state_dict().items()),
            "diagnose_model: the ES_MOE blocks' usage, or the model changed")
    cpu = YOLO("yolo-master-n", device="cpu")
    for yy in (y, cpu):
        prune_moe_model(yy.model, usage, threshold=1.0, keep_top_m=2)
        require([m.num_experts for m in yy.model.model if isinstance(m, ES_MOE)] == [2, 2, 2, 2],
                "prune_moe_model: each ES_MOE should keep its two most used experts")
    # random weights: cutting an expert that took a third of the mix moves every later BN's input, and the
    # statistics calibrated for the full graph then amplify rounding without bound; the pruned graph gets its own
    calibrate_bn(y.model, x4)
    cpu.load_state_dict(y.model.state_dict())
    pruned = {str(dev): y.fuse(), "cpu": cpu.fuse()}
    reset_launches()
    r16 = pruned[str(dev)].predict(imgs, batch=16, **KW)
    torch.cuda.synchronize()
    prune_launches = read_launches()
    require(prune_launches["stem"] == 1 and prune_launches["nms"] == 1 and len(r16) == 16,
            "the pruned model's predict did not launch the stem and NMS kernels")
    check_detections(r16)
    xp, _ = pruned[str(dev)]._predictor.preprocess(imgs[:2])
    with torch.inference_mode():
        dg = pruned[str(dev)].model.head.decode(pruned[str(dev)].model(xp), raw_scores=True).cpu()
        dc = pruned["cpu"].model.head.decode(pruned["cpu"].model(xp.cpu()), raw_scores=True)
    box_err, logit_err = decode_err(dg, dc)
    log(f"[v0_10 tools] diagnose_model on yolo-master-n, 4 frames ({diag_s:.2f} s): "
        + json.dumps({k: {"usage": [round(u, 4) for u in v['usage']], "gini": round(v['gini'], 4)}
                      for k, v in report['blocks'].items()}) + f", collapsed {len(report['collapsed'])}; pruned to "
        f"two experts a block, fused, predict bs 16 launches {prune_launches}; GPU vs CPU decode of the pruned model: "
        f"box {box_err:.3e} px, logit {logit_err:.3e}")
    require(box_err <= 5e-2 and logit_err <= 1e-3, "the pruned model's GPU and CPU decode disagree")
    v10 = YOLO(V10, device=dev).load_state_dict(state)
    t0 = time.perf_counter()
    qsd = quantize_state_dict(v10.model.state_dict())
    q_s = time.perf_counter() - t0
    rep = quantization_report(v10.model.state_dict(), qsd)
    v10.load_state_dict(dequantize_state_dict(qsd))
    reset_launches()
    rq = v10.fuse().predict(imgs, batch=16, **KW)
    torch.cuda.synchronize()
    q_launches = read_launches()
    require(rep["quantized_tensors"] > 0 and rep["ratio"] < 0.5 and q_launches["nms"] == 1 and len(rq) == 16,
            "v0_10-n's quantization report, or its dequantized predict")
    check_detections(rq)
    log(f"[v0_10 tools] quantization_report of v0_10-n ({q_s:.2f} s on the host): {json.dumps(rep)}; its dequantized "
        f"weights fused through predict bs 16: launches {q_launches}")
    out["f"] = dict(diagnose=report, diagnose_s=diag_s, prune_launches=prune_launches,
                    prune_decode_err=(box_err, logit_err), quantization=rep, quantize_s=q_s,
                    quantized_predict_launches=q_launches)
    return out


def layer4_share(model, mb, dtype, reps: int = 3):
    """CUDA-event ms (median of ``reps`` after one untimed) of one micro-batch's
    forward + backward through yolo26-master's layer 4 alone (A2C2fMoE: full
    attention over P3's pixels, two ABlockMoE) and through its two AAttn
    modules alone, on their inputs from the layers before (made under
    no_grad), in train mode at the model's step."""
    import torch

    model.train()
    with torch.no_grad():
        x = mb["images"].to(dtype).permute(0, 3, 1, 2)
        for m in model.model[:4]:
            x = m(x)
        layer = model.model[4]
        a = layer.m[0][0]
        xa = layer.cv1(x)

    def timed(fn, inp):
        inp = inp.detach().requires_grad_()
        ms = []
        for _ in range(reps + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(inp).float().sum().backward()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            model.zero_grad(set_to_none=True)
            inp.grad = None
        return statistics.median(ms[1:])

    return {"layer 4": timed(layer, x), "its two AAttn": 2 * timed(a.attn, xa)}


Y26_STEP_SCHEDULE = (2, 2)  # phase 29's warmup_steps, dropout_interval: step 50 drops experts


def phase_yolo26_train(dev, state, imgs, benches):
    """yolo26-master-n's training at 640 (the end2end dual-assignment loss,
    L1 at reg_max 1, the six routed blocks of layers 4, 6 and 8 with their
    router noise, progressive sparsity, expert dropout and aux loss) with
    phase 28's weights (class biases of both branches at 0), warmup_steps 2
    and dropout_interval 2 on the routed blocks (Y26_STEP_SCHEDULE):
    (a) fp32, one step at bs 2 from step 50 (k = 2, a dropout step) on the
    card against the CPU, phase 17's gate, the card routed by the CPU step's
    picks (a pick may flip between the two fp32 programs; counted), the router
    noise and keep masks of the card's step equal to the CPU's bit for bit;
    (b) train_step_bench in fp32 and bf16 (bs 16 x accumulate 4: times by
    layer, busy share, launches and copies, peak memory, a profiled step)
    beside yolo-master-n's and v0_1-n's of the same call (``benches``), with
    layer 4's share of a bs-16 micro-batch's forward + backward and its two
    AAttn modules' share; (c) the loop with amp at its default (phase 20's
    run: two epochs, resume, last.npz through predict; the EMA's val through
    the end2end validator, no NMS); (d) MultiTrainer (phase 21's run)."""
    import torch

    def make(where):
        return train_model(state, where, name=Y26, schedule=Y26_STEP_SCHEDULE)

    log(f"[yolo26 train] warmup_steps, dropout_interval = {Y26_STEP_SCHEDULE} on the six routed blocks "
        "(layers.{4,6,8}.m.0.{0,1}.mlp)")
    out = {}
    out["a"], models = card_vs_cpu_step(dev, make, "yolo26 train a", pin=moe_routing, flips=mask_flips)
    dropped = {}
    for mg, mc in zip(routed_blocks(models["card"]), routed_blocks(models["cpu"])):
        require(mg.step == mc.step == 50 and mg.dropped_experts().size > 0,
                "yolo26 train (a): step 50 should drop experts")
        require(torch.equal(mg._draws[1].cpu(), mc._draws[1]),
                f"yolo26 train (a): {mg.jax_path}'s noise or keep mask differs between the card and the CPU")
        dropped[mg.jax_path] = mg.dropped_experts().tolist()
    log(f"[yolo26 train a] the router noise [2, E] and keep mask [E] of each block's step on the card equal the "
        f"CPU's bit for bit; dropped experts at step 50: {dropped}")
    out["a"]["dropped"] = dropped

    # (b) bs 16 x accumulate 4, two timed steps, in both dtypes, beside yolo-master-n's and v0_1-n's
    for what, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        y, st, r = train_step_bench(dev, state, dtype, name=Y26, schedule=Y26_STEP_SCHEDULE)
        mb = {k: v[:16] for k, v in train_batch(16, 128, dev, seed=29).items()}
        share = layer4_share(y.model, mb, dtype)
        micro = r["layers_ms"]["forward"] + r["layers_ms"]["loss + TAL"] + r["layers_ms"]["backward"]
        r["layer4_ms"] = share
        r["layer4_share"] = {k: v / micro for k, v in share.items()}
        out[f"b_{what}"] = r
        n, v01 = benches[f"n_{what}"], benches[f"v01_{what}"]
        log(f"[yolo26 train b] {what}, ms per optimizer step (bs 16 x 4): yolo26-master-n "
            f"{[round(t, 3) for t in r['step_ms']]}, yolo-master-n {[round(t, 3) for t in n['step_ms']]}, v0_1-n "
            f"{[round(t, 3) for t in v01['step_ms']]}; by layer {json.dumps(r['layers_ms'])}; layer 4 alone "
            f"(forward + backward of a bs-16 micro-batch) {share['layer 4']:.3f} ms, its two AAttn "
            f"{share['its two AAttn']:.3f} ms: {100 * r['layer4_share']['layer 4']:.1f}% and "
            f"{100 * r['layer4_share']['its two AAttn']:.1f}% of the micro-batch's forward + loss + backward "
            f"({micro:.3f} ms); peak {r['peak_bytes'] / 2**30:.2f} GiB (n {n['peak_bytes'] / 2**30:.2f}, v0_1 "
            f"{v01['peak_bytes'] / 2**30:.2f}); busy {r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%; n "
            f"{100 * n['busy_share']:.1f}%, v0_1 {100 * v01['busy_share']:.1f}%); {r['kernels']} kernels and "
            f"copies, {r['copies_htod']} host-to-device copies (n {n['kernels']}, {n['copies_htod']})")
        del y, st

    # (c) the loop, amp at its default; (d) MultiTrainer
    out["c"] = phase_train_loop(dev, state, imgs, amp=True, name=Y26, schedule=Y26_STEP_SCHEDULE)
    out["d"] = phase_multitrainer(dev, state, name=Y26)
    return out


MIXTURE_NOISE = 0.5  # phase 32: noise_std on yolo26-master-latent-n's three latent routers (0 in the YAML)


def phase_mixture_train(dev, states, imgs, y26_train):
    """yolo26-master-latent-n and -moa-mot-n in training at 640, phase 30's
    weights (the mixtures woken, BN calibrated; class biases at 0), the three
    latent routers at noise_std MIXTURE_NOISE: the moa, mot and latent aux
    losses, MoT's exploration floor, the latent router's noise, MoA's global
    head on P3's 6,400 tokens (the linear path) under autograd.
    (a) fp32, one step at bs 2 from step 50 on the card against the CPU
    (phase 17's gate), the card routed by the CPU step's picks (MoT's kept
    sets, the routed blocks' top-k; flips counted), each family's composed aux
    within 1e-5 relative, the latent noise of the card's step the CPU's bit
    for bit, ``_rf_matrix`` unchanged on both; (b) train_step_bench in fp32
    and bf16 (bs 16 x accumulate 4: ms per step and by layer, busy share,
    launches, copies, peak memory) beside yolo26-master-n's of phase 29; (c)
    the loop with amp at its default (phase 20's run, the end2end validator,
    last.npz through predict); (d) MultiTrainer on -moa-mot-n."""
    import torch

    from yolo_master_tpu_torch.nn.latent_mixture import LatentRouter

    out = {}
    for name in VARIANTS:
        short = name.removesuffix("-n").removeprefix("yolo26-master-").replace("-", "_")  # latent, moa_mot
        fams = ("moe", "latent") if short == "latent" else ("moa", "mot")

        def make(where, name=name):
            return train_model(states[name], where, name=name, noise=MIXTURE_NOISE)

        r = out[short] = {}
        r["a"], models = card_vs_cpu_step(dev, make, f"{short} train a", pin=e2e_pin, flips=e2e_pin_flips,
                                          families=fams)
        routers = [[m for m in models[w].modules() if isinstance(m, LatentRouter)] for w in ("card", "cpu")]
        for mg, mc in zip(*routers):
            require(mg.step == mc.step == 50 and torch.equal(mg._draws[1].cpu(), mc._draws[1]),
                    f"{short} train (a): {mg.jax_path}'s noise differs between the card and the CPU")
        if routers[0]:
            log(f"[{short} train a] the noise [2, 4] of each latent router's step ({[m.jax_path for m in routers[0]]},"
                f" noise_std {MIXTURE_NOISE}) on the card equals the CPU's bit for bit")
        rf = [k for k in states[name] if k.endswith("_rf_matrix")]
        for k in rf:
            after = {w: models[w].state_dict()[k].cpu() for w in ("card", "cpu")}
            same = {w: torch.equal(v, states[name][k].cpu()) for w, v in after.items()}
            head = {w: t.flatten()[:4].tolist() for w, t in (("before", states[name][k]), *after.items())}
            sums = {w: f"{float(t.sum()):.9g}" for w, t in (("before", states[name][k]), *after.items())}
            log(f"[{short} train a] {k} {tuple(after['card'].shape)}, first four and sum: before the step "
                f"{head['before']} ({sums['before']}); after it, card {head['card']} ({sums['card']}), CPU "
                f"{head['cpu']} ({sums['cpu']}); unchanged {same}")
            require(all(same.values()), f"{short} train (a): {k} moved in a step (a fixed buffer)")
        for what, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            y, st, b = train_step_bench(dev, states[name], dtype, name=name, noise=MIXTURE_NOISE)
            r[f"b_{what}"] = b
            n = y26_train[f"b_{what}"]
            log(f"[{short} train b] {what}, ms per optimizer step (bs 16 x 4): {name} "
                f"{[round(t, 3) for t in b['step_ms']]}, yolo26-master-n {[round(t, 3) for t in n['step_ms']]}; by "
                f"layer {json.dumps(b['layers_ms'])} (yolo26-master-n {json.dumps(n['layers_ms'])}); peak "
                f"{b['peak_bytes'] / 2**30:.2f} GiB (yolo26-master-n {n['peak_bytes'] / 2**30:.2f}); busy "
                f"{b['busy_ms']:.3f} ms ({100 * b['busy_share']:.1f}%; yolo26-master-n {100 * n['busy_share']:.1f}%); "
                f"{b['kernels']} kernels and copies, {b['copies_htod']} host-to-device copies (yolo26-master-n "
                f"{n['kernels']}, {n['copies_htod']})")
            del y, st
        r["c"] = phase_train_loop(dev, states[name], imgs, amp=True, name=name)
    out["moa_mot"]["d"] = phase_multitrainer(dev, states[VARIANTS[1]], name=VARIANTS[1])
    return out


def phase_multitrainer(dev, state, name: str = "yolo-master-n"):
    """MultiTrainer: YOLO(name).train(data=[a, b], epochs=1, batch=16,
    imgsz=640, workers=4) with amp at its default (bf16), on two synthetic sets
    of phase 18's form (shared_train_set, seeds 10 and 11), both yamls named
    data.yaml: two runs,
    "data" and "data-2", each from the base weights, finite val metrics, the NMS
    kernel once a val batch of each run's EMA (none for an end2end head),
    multitrain_results.json with the runs and their mean, and the facade's
    model the base again, bitwise."""
    import math
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    root = Path(tempfile.mkdtemp(prefix=".val_set_multi_", dir=Path(__file__).resolve().parent))
    try:
        yamls = [str(shared_train_set(seed=10 + i)) for i in range(2)]
        y = train_model(state, dev, name=name)
        base = {k: v.clone() for k, v in y.model.state_dict().items()}
        reset_launches()
        t0 = time.perf_counter()
        res = y.train(data=yamls, epochs=1, batch=16, imgsz=IMGSZ, workers=4, save_dir=str(root / "multi"))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        payload = json.loads((root / "multi" / "multitrain_results.json").read_text())
        files = sorted(p.name for p in (root / "multi").iterdir())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    restored = all(torch.equal(v, base[k]) for k, v in y.model.state_dict().items())
    val_batches = math.ceil(TRAIN_VAL_IMAGES / min(16, 8))
    shown = {n: {k: round(m[k], 6) for k in (*VAL_METRICS, "best_fitness") if k in m} for n, m in res.items()}
    tag = "multitrainer" + ("" if name == "yolo-master-n" else f" {name}")
    log(f"[{tag}] two runs of 1 epoch in {wall_s:.2f} s: {json.dumps(shown)}"
        f"; mean {json.dumps({k: round(v, 6) for k, v in payload['mean'].items() if k in VAL_METRICS})}; launches "
        f"{launches}; files {files}; base restored bitwise: {restored}")
    require(list(res) == ["data", "data-2"] and all("error" not in m for m in res.values()),
            f"multitrainer: runs {list(res)}")
    require(all(math.isfinite(m[k]) for m in res.values() for k in VAL_METRICS), "multitrainer: val metrics")
    require(set(payload) == {"runs", "mean"} and payload["runs"] == res, "multitrainer: multitrain_results.json")
    require(restored and not y.model.training, "multitrainer: the facade's model is not the base after the sweep")
    nms_per_batch = 0 if y.model.head.end2end else 1
    require(launches["nms"] == 2 * val_batches * nms_per_batch, f"multitrainer: {launches['nms']} NMS launches, "
            f"expected {val_batches} val batches x 2 runs x {nms_per_batch}")
    return dict(runs=res, mean=payload["mean"], wall_s=wall_s, launches=launches)


TRAIN_SETS = {}  # seed -> the yaml of write_train_set's set, shared by the loop phases (they only read it)


def shared_train_set(seed: int = 0):
    """write_train_set's set for ``seed``, written once a run (~4 s each) into
    a directory under the checkout that is removed at exit."""
    import atexit
    import shutil
    import tempfile
    from pathlib import Path

    if seed not in TRAIN_SETS:
        root = Path(tempfile.mkdtemp(prefix=".val_set_shared_", dir=Path(__file__).resolve().parent))
        atexit.register(shutil.rmtree, root, True)
        TRAIN_SETS[seed] = write_train_set(root, seed=seed)
    return TRAIN_SETS[seed]


def write_train_set(root, seed: int = 0):
    """TRAIN_IMAGES train and TRAIN_VAL_IMAGES val PNGs, long side 640 (the train
    images of varied aspect ratios, so that the rect path resizes), uniform noise
    as phase 9's frames, with 1-4 filled rectangles each, labelled. Returns the yaml."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    shorts = (360, 427, 480, 512, 640)
    for split, n in (("train", TRAIN_IMAGES), ("val", TRAIN_VAL_IMAGES)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            s = shorts[i % len(shorts)]
            h, w = (s, IMGSZ) if i % 2 == 0 else (IMGSZ, s)
            im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 5))):
                bw, bh = int(rng.integers(40, w // 2)), int(rng.integers(40, h // 2))
                x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                cv2.rectangle(im, (x1, y1), (x1 + bw, y1 + bh), tuple(int(c) for c in rng.integers(0, 256, 3)), -1)
                rows.append(f"{int(rng.integers(0, 80))} {(x1 + bw / 2) / w:.6f} {(y1 + bh / 2) / h:.6f} "
                            f"{bw / w:.6f} {bh / h:.6f}")
            cv2.imwrite(str(root / "images" / split / f"{i:06d}.png"), im, [cv2.IMWRITE_PNG_COMPRESSION, 1])
            (root / "labels" / split / f"{i:06d}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n"
                         + "".join(f"  {i}: c{i}\n" for i in range(80)))
    return yaml_path


def phase_train_loop(dev, state, imgs, amp: bool = False, name: str = "yolo-master-n", schedule=None):
    """The training loop, YOLO(name).train(..., amp=amp), on shared_train_set's
    set, its runs written under the checkout and removed after (``schedule``:
    train_model's)."""
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix=".val_set_train_", dir=Path(__file__).resolve().parent))
    try:
        return _phase_train_loop(dev, state, imgs, root, amp, name, schedule)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_train_loop(dev, state, imgs, root, amp, name, schedule):
    """(a) shared_train_set's TRAIN_IMAGES train and TRAIN_VAL_IMAGES val images; ``name`` at 640
    with ``state`` (class biases at 0; phase 9's weights for yolo-master-n) trained by
    .train(epochs=2, batch=16, amp=amp, workers=4, save_period=1,
    close_mosaic=1, moe_schedule="gini"): bs 16 x accumulate 4, mosaic in epoch
    1 and off in epoch 2, the EMA validated every epoch at batch 8; (b) finite
    losses and val metrics, the run's files, the Gini rule moving the MoE gain,
    the NMS kernel launched once a val batch; (c) each epoch's time split, the
    loader's images/s with 4 workers, peak memory, the NMS kernel at the val's
    shape (B=8, N=4096); (d) resume=True from epoch 1's checkpoint: starts at
    epoch 1 at the saved step, its epoch-2 losses those of the run within 1e-4
    relative (the card's backward is not bitwise repeatable; the train phase's card-vs-CPU
    limit; the resumed run starts from the configured MoE gain, as the JAX
    package's does, so its aux loss is compared per unit of gain); (e) last.npz
    in a new YOLO, fused, through predict() at bs 1 and 16. With ``amp`` (phase
    20: the default, bf16 training) the same run in bf16: last.npz holds fp32
    weights, the resumed epoch 2 is held to RESUME_REL_TOL_BF16, and the NMS
    kernel's B=8 check (c), the fp32 run's, is not repeated."""
    import math
    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.data.dataset import PrefetchLoader, YOLODataset
    from yolo_master_tpu_torch.engine.trainer import DetectionTrainer

    yaml_path = shared_train_set()
    metrics = ("loss", "box_loss", "cls_loss", "dfl_loss", "aux_loss")
    run_kw = dict(data=str(yaml_path), epochs=2, batch=16, imgsz=IMGSZ, amp=amp, workers=4, save_period=1,
                  close_mosaic=1, moe_schedule="gini")
    tag = ("train loop bf16" if amp else "train loop") + ("" if name == "yolo-master-n" else f" {name}")
    out = {}

    # (c) the loader alone: one epoch of 64 mosaic samples with 4 workers
    ds = YOLODataset(str(yaml_path), split="train", imgsz=IMGSZ, augment=True)
    loader = PrefetchLoader(ds, 16, shuffle=True, workers=4, images=np.float32)
    t0 = time.perf_counter()
    n = sum(b["images"].shape[0] for b in loader.epoch(0))
    loader_ips = n / (time.perf_counter() - t0)

    # (a)-(b) the run
    y = train_model(state, dev, name=name, schedule=schedule)
    trainer = DetectionTrainer(y, save_dir=str(root / "run"), **run_kw)
    log_rows, vals = [], []
    trainer.callbacks.add("on_fit_epoch_end", lambda e, agg: log_rows.append((e, dict(agg), trainer.moe_gain)))
    inner = trainer.validator
    trainer.validator = lambda: vals.append(inner()) or vals[-1]

    def keep_epoch1_state(e, agg):  # before epoch 2's save, state/ holds epoch 1's
        if e == 1:
            shutil_copy(root / "run", root / "resume", ("state", "state_meta.json"))

    trainer.callbacks.add("on_fit_epoch_end", keep_epoch1_state)
    gain0 = trainer.moe_gain
    require(trainer.compute_dtype == (torch.bfloat16 if amp else torch.float32), f"{tag}: the compute dtype")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    val_batches = math.ceil(TRAIN_VAL_IMAGES / min(16, 8))
    nms_per_batch = 0 if y.model.head.end2end else 1  # an end2end head takes no NMS
    files = sorted(p.name for p in (root / "run").iterdir())
    gains = [g for _, _, g in log_rows]
    log(f"[{tag}] {name}, 640, bs 16 x accumulate {trainer.accumulate} ({trainer.nb_opt} optimizer "
        f"step an epoch), 2 epochs in {wall_s:.2f} s: epoch losses "
        f"{[{k: round(agg[k], 4) for k in metrics} for _, agg, _ in log_rows]}; moe_gain {gain0} -> {gains}; "
        f"val {[{k: round(m[k], 6) for k in VAL_METRICS} for m in vals]}; launches {launches}; files {files}")
    for e, t in enumerate(trainer.timings):
        log(f"[{tag}] epoch {e + 1} wall {t['epoch_s']:.3f} s = loader wait {t['loader_s']:.3f} + optimizer "
            f"steps {t['step_s']:.3f} + val {t['val_s']:.3f} + checkpoint writes {t['save_s']:.3f} (+ the rest "
            f"{t['epoch_s'] - t['loader_s'] - t['step_s'] - t['val_s'] - t['save_s']:.3f})")
    log(f"[{tag}] the loader alone, 4 workers, mosaic on: {loader_ips:.1f} images/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    require(len(log_rows) == 2 and all(math.isfinite(agg[k]) and agg["finite"] == 1.0
                                       for _, agg, _ in log_rows for k in metrics), f"{tag}: a non-finite loss")
    require({"results.csv", "best.npz", "last.npz", "state", "state_meta.json", "routing_history.csv"} <= set(files),
            f"{tag}: the run's files {files}")
    require(trainer.routing_history.rows and gains[0] != gain0, f"{tag}: the Gini rule did not move the MoE gain")
    require(launches["nms"] == val_batches * 2 * nms_per_batch, f"{tag}: {launches['nms']} NMS launches, expected "
            f"{val_batches} val batches x 2 epochs x {nms_per_batch}")
    require(len(vals) == 2 and all(math.isfinite(m[k]) for m in vals for k in VAL_METRICS),
            f"{tag}: val metrics")
    require(not trainer.train_set.mosaic_enabled, f"{tag}: close_mosaic did not close mosaic")

    with np.load(root / "run" / "last.npz") as f:
        weight_dtypes = sorted({str(f[k].dtype) for k in f.files if not k.startswith("__meta__")})
    log(f"[{tag}] last.npz holds {weight_dtypes}")
    require(weight_dtypes == ["float32", "int64"], f"{tag}: last.npz holds {weight_dtypes}, not fp32 weights")
    out.update(compute_dtype=str(trainer.compute_dtype), last_npz_dtypes=weight_dtypes)
    if not amp:
        out["nms_b8"] = nms_b8_check(y, yaml_path)

    # (d) resume on the card from epoch 1's checkpoint
    meta = json.loads((root / "resume" / "state_meta.json").read_text())
    resumed = DetectionTrainer(train_model(state, dev, name=name, schedule=schedule), save_dir=str(root / "resume"),
                               resume=True, **run_kw)
    require(resumed.start_epoch == 1 and resumed.state.step == meta["step"] == trainer.nb_opt,
            f"{tag}: resume starts at epoch {resumed.start_epoch}, step {resumed.state.step}; saved {meta}")
    resumed_rows = []
    resumed.callbacks.add("on_fit_epoch_end", lambda e, agg: resumed_rows.append((e, dict(agg))))
    resumed.train()
    (e2, agg2), ref = resumed_rows[0], log_rows[1][1]
    # the resumed run starts from the configured MoE gain, as the JAX package's resume does (the gain is not
    # in its checkpoint): the aux loss is compared per unit of gain, and the total without it
    gain_run, gain_resumed = log_rows[0][2], gain0
    pairs = {k: (agg2[k], ref[k]) for k in ("box_loss", "cls_loss", "dfl_loss")}
    pairs["loss - aux_loss"] = (agg2["loss"] - agg2["aux_loss"], ref["loss"] - ref["aux_loss"])
    pairs["aux_loss / moe_gain"] = (agg2["aux_loss"] / gain_resumed, ref["aux_loss"] / gain_run)
    rel = {k: abs(a - b) / max(abs(b), 1e-12) for k, (a, b) in pairs.items()}
    log(f"[{tag}] resumed at epoch 1, step {meta['step']} (moe_gain {gain_resumed}, the run's epoch 2 "
        f"{gain_run}): epoch 2, resumed against the run: {json.dumps(pairs)}; relative deviation "
        f"{max(rel.values()):.3e}")
    tol = RESUME_REL_TOL_BF16 if amp else 1e-4
    require(len(resumed_rows) == 1 and e2 == 1 and max(rel.values()) <= tol,
            f"{tag}: the resumed epoch 2 differs from the run's beyond {tol} relative")
    require(resumed.state.step == trainer.state.step, f"{tag}: the resumed run's step count")

    # (e) the trained weights through the predict path: stem and NMS kernels
    trained = YOLO(str(root / "run" / "last.npz"), device=dev).fuse()
    reset_launches()
    r1 = trained.predict(imgs[0], batch=1, **KW)
    r16 = trained.predict(imgs, batch=16, **KW)
    torch.cuda.synchronize()
    predict_launches = read_launches()
    log(f"[{tag}] last.npz, fused, predict bs 1 + bs 16: launches {predict_launches}")
    require(predict_launches["stem"] == 2 and predict_launches["nms"] == 2 * nms_per_batch and len(r1) == 1
            and len(r16) == 16, f"{tag}: predict of last.npz did not launch the stem (and NMS) kernels")
    check_detections(r1 + r16)
    out.update(epochs=[{k: agg[k] for k in metrics} for _, agg, _ in log_rows], gains=[gain0, *gains],
               val=[{k: m[k] for k in VAL_METRICS} for m in vals], launches=launches, timings=trainer.timings,
               wall_s=wall_s, loader_images_per_s=loader_ips, peak_bytes=peak, resume_rel_err=max(rel.values()),
               predict_launches=predict_launches)
    return out


def nms_b8_check(y, yaml_path):
    """The NMS kernel at the EMA val's shape: one val batch of 8 of the trained
    model, multi-label, N=4096, against its plain loop; times and bound."""
    import torch

    from yolo_master_tpu_torch.data.dataset import DataLoader, YOLODataset
    from yolo_master_tpu_torch.engine.validator import DetectionValidator
    from yolo_master_tpu_torch.ops import cuda_nms, nms

    vds = YOLODataset(str(yaml_path), split="val", imgsz=IMGSZ)
    batch = next(DataLoader(vds, 8).epoch())
    v = DetectionValidator(y.model, imgsz=IMGSZ)  # the facade's model: the EMA weights after train()
    with torch.inference_mode():
        decoded = y.model.forward_predict(v.preprocess(batch["images"]))
        cboxes, scores, cls_idx, _ = nms._prep_candidates(decoded, 80, VAL_NMS["conf_thres"], VAL_NMS["max_nms"],
                                                          True, None, False)
    cand = (cboxes + cls_idx[..., None] * nms.MAX_WH).float().contiguous()
    scores = scores.contiguous()
    iou, max_det = VAL_NMS["iou_thres"], VAL_NMS["max_det"]
    ki, kv = cuda_nms.batched_greedy_nms(cand, scores, iou, max_det)
    ki_p, kv_p = cuda_nms.batched_greedy_nms_plain(cand, scores, iou, max_det)
    torch.cuda.synchronize()
    require(torch.equal(ki, ki_p) and torch.equal(kv, kv_p), "train loop: NMS kernel vs plain on the EMA's candidates")
    steps = (kv.sum(1) + (kv.sum(1) < max_det).long()).sum().item()
    bound_ms, bound_by, _ = bound(nbytes(cand, scores, ki, kv), steps * cand.shape[1] * 15)
    nms_ms = cuda_ms(lambda: cuda_nms.batched_greedy_nms(cand, scores, iou, max_det), inner=10)
    plain_ms = cuda_ms(lambda: cuda_nms.batched_greedy_nms_plain(cand, scores, iou, max_det), reps=3, warmup=1)
    log(f"[train loop] NMS kernel == plain on the EMA model's val candidates, B=8 N={cand.shape[1]} iou {iou}: "
        f"{int(kv.sum())} kept; kernel {nms_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    return dict(max_abs_err=(ki.long() - ki_p.long()).abs().max().item(), ms=nms_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, n=cand.shape[1])


def shutil_copy(src, dst, names):
    import shutil

    dst.mkdir(parents=True, exist_ok=True)
    for name in names:
        (shutil.copytree if (src / name).is_dir() else shutil.copy2)(src / name, dst / name)


def profile_kernels(run, xb, iters: int = 3):
    """(wall ms per iteration, {kernel name: device us per iteration}, kernels per iteration)
    of ``run(xb)`` under torch.profiler, after one untimed call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(xb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run(xb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    device, _ = profile_sums(prof)
    return wall_ms, {k: us / iters for k, (us, _) in device.items()}, sum(n for _, n in device.values()) / iters


PROFILER_SKIPS = frozenset({"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                             "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                             "aten::is_leaf", "aten::output_nr", "aten::_version"})  # key_averages() leaves them out


def profile_sums(prof):
    """({device event name: [us, count]}, {host event name: [self CPU us, count]})
    of a finished torch.profiler run, the sums key_averages() gives as self
    device and self CPU time, read from the raw Kineto events: key_averages()
    first builds an event object for each of them, which took 10-26 s a
    profiled train step (16,000-34,000 kernels and their host events). A host
    event's self time is its time less that of the host events nested in it
    on its thread; a runtime call (cudaLaunchKernel) counts on the thread of
    the operator that made it, as torch.profiler nests them."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    device, host, spans, frontend = {}, {}, [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in PROFILER_SKIPS or getattr(e, "is_hidden_event", lambda: False)():
            continue
        sync = not e.is_async() and e.start_thread_id() == e.end_thread_id()
        if e.device_type() == cuda:
            row = device.setdefault(name, [0.0, 0])
            row[0] += (e.end_ns() - e.start_ns()) / 1e3 if sync else 0.0
            row[1] += 1
        elif e.device_type() == cpu:
            host.setdefault(name, [0.0, 0])[1] += 1
            if sync:
                spans.append([e.start_thread_id(), e.start_ns(), e.end_ns(), name, e.linked_correlation_id()])
                if e.linked_correlation_id() == 0:
                    frontend.setdefault(e.correlation_id(), e.start_thread_id())
    threads = {}
    for thread, start, end, name, linked in spans:
        threads.setdefault(frontend.get(linked, thread) if linked > 0 else thread, []).append((start, end, name))

    def close(end, name, self_ns, children, child):
        host[name][0] += self_ns / 1e3
        if children == 1 and child == name:  # key_averages() counts an only child of its own name with its parent
            host[name][1] -= 1

    for evs in threads.values():
        evs.sort(key=lambda ev: (ev[0], -ev[1]))
        stack = []  # [end, name, self ns, children, last child's name] of the open events
        for start, end, name in evs:
            while stack and (start >= stack[-1][0] or end > stack[-1][0]):
                close(*stack.pop())
            if stack:
                stack[-1][2] -= end - start
                stack[-1][3] += 1
                stack[-1][4] = name
            stack.append([end, name, end - start, 0, None])
        while stack:
            close(*stack.pop())
    return device, host


def ports_kernels(dev_us: dict) -> dict:
    """Device us of each of the port's kernels (PORT_KERNEL_NAMES; no name is a
    substring of another's), the stem's two kernels and two bank kernels summed
    under "stem_kernel" and "stem_bank_kernel"."""
    ours = {part: sum(v for k, v in dev_us.items() if part in k) for part in PORT_KERNEL_NAMES}
    ours["stem_kernel"] += ours.pop("stem_bf16_kernel")
    ours["stem_bank_kernel"] += ours.pop("stem_bank_bf16_kernel")
    return ours


def device_time_by_kernel(run, xb):
    """(device busy ms per iteration, {port kernel: ms per iteration}) under torch.profiler."""
    _, dev_us, _ = profile_kernels(run, xb)
    return sum(dev_us.values()) / 1e3, {k: v / 1e3 for k, v in ports_kernels(dev_us).items()}


def check_profile_sums(run, xb):
    """profile_sums against key_averages() on one profiled ``run(xb)``: the
    same names and counts, and times within 1e-6 relative (or 1e-3 us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(xb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(xb)
        torch.cuda.synchronize()
    sums = dict(zip((torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU), profile_sums(prof)))
    worst = 0.0
    for kind, ours in sums.items():
        theirs = {e.key: (e.self_device_time_total if kind == torch.autograd.DeviceType.CUDA else e.self_cpu_time_total,
                          e.count) for e in prof.key_averages() if e.device_type == kind}
        require(set(ours) == set(theirs) and all(ours[k][1] == theirs[k][1] for k in ours),
                f"profile_sums: {kind} names or counts differ from key_averages()")
        for k, (us, _) in ours.items():
            worst = max(worst, abs(us - theirs[k][0]))
            require(abs(us - theirs[k][0]) <= max(1e-6 * abs(theirs[k][0]), 1e-3),
                    f"profile_sums: {kind} {k} {us} us, key_averages() {theirs[k][0]}")
    n_kernels, n_host = (len(sums[kind]) for kind in (torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU))
    log(f"[profile] profile_sums equals key_averages() on one profiled batch: {n_kernels} kernel names, {n_host} host "
        f"names, largest difference {worst:.3e} us")


def phase_profile(paths, xb):
    """Device time by kernel over 3 iterations of each path's device graph
    (uint8 batch on the card -> detections), under torch.profiler; returns each
    path's busy time and the stem kernel's share of it. First, profile_sums
    against key_averages() on one batch of the first path."""
    check_profile_sums(next(iter(paths.values())), xb)
    shares = {}
    for name, run in paths.items():
        wall_ms, dev_us, count = profile_kernels(run, xb)
        busy_ms = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
        log(f"[profile] {name}, B={xb.shape[0]}: wall {wall_ms:.3f} ms/batch under the profiler, device busy "
            f"{busy_ms:.3f} ms/batch ({100 * busy_ms / wall_ms:.1f}%), {count:.0f} kernels/batch; top: "
            + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))
        ours = ports_kernels(dev_us)
        stem_ms = (ours["stem_kernel"] + ours["stem_bank_kernel"]) / 1e3
        shares[name] = {"busy_ms": busy_ms, "stem_ms": stem_ms, "stem_share": stem_ms / busy_ms}
        log(f"[profile] {name}, B={xb.shape[0]}: the port's kernels, ms/batch: "
            + "; ".join(f"{k} {v / 1e3:.4f}" for k, v in ours.items() if v)
            + f"; NMS (sort + mask + scan) {sum(ours[k] for k in NMS_PHASES) / 1e3:.4f}; the stem "
            f"{100 * stem_ms / busy_ms:.2f}% of the busy time")
    return shares


TASK_GRAPHS = (("segment", "yolo-master-seg-n", IMGSZ), ("pose", "yolo-master-pose-n", IMGSZ),
               ("obb", "yolo-master-obb-n", IMGSZ), ("classify", "yolo-master-cls-n", 224))
TASK_NMS = {"segment": 1, "pose": 1, "obb": 0, "classify": 0}  # batched greedy NMS launches a forward
TASK_METRICS = {"segment": ("mAP50", "mAP50-95", "mask_mAP50", "mask_mAP50-95"),
                "pose": ("mAP50", "mAP50-95", "pose_mAP50", "pose_mAP50-95"), "obb": ("mAP50", "mAP50-95"),
                "classify": ("top1", "top5")}
TASK_VAL_IMAGES = 8  # one batch a task
MASK_PIXEL_SHARE = 1e-3  # card vs CPU: the share of the shared detections' mask pixels that may differ


def task_yolo(name, where, imgs, imgsz):
    """YOLO(name) on ``where``, seeded, BN calibrated on four frames as the task's
    predictor feeds them, the class biases at 0 (so that val's conf 0.001 keeps
    detections on random weights)."""
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictors_task import TASK_PREDICTORS
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    y = YOLO(name, device=where)
    x_cal, _ = TASK_PREDICTORS[y.task](y.model, imgsz=imgsz).preprocess(imgs[:4])
    calibrate_bn(y.model, x_cal)
    if y.task != "classify":
        with torch.no_grad():
            for branch in y.model.head.cv3:
                branch[-1].bias.zero_()
    return y


def check_task_results(task, results, nc):
    """Finite results of the task's kind, boxes and keypoints inside the frame, scores in (0, 1]."""
    import math

    import numpy as np

    h, w = FRAME_HW
    for r in results:
        if task == "classify":
            require(len(r.probs) == nc and abs(float(r.probs.data.sum()) - 1) < 1e-4, "classify: probabilities")
            continue
        d = r.obb.data if task == "obb" else r.boxes.data
        require(bool(np.isfinite(d).all()) and bool(((d[:, -2] > 0) & (d[:, -2] <= 1)).all()), f"{task}: results")
        if task == "obb":
            require(bool(((d[:, 4] >= -math.pi / 4 - 1e-6) & (d[:, 4] <= 3 * math.pi / 4 + 1e-6)).all()), "obb angle")
            continue
        require(bool((d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all() and (d[:, [1, 3]] >= 0).all()
                     and (d[:, [1, 3]] <= h).all()), f"{task}: boxes outside the image")
        if task == "segment" and len(d):
            require(r.masks.data.shape == (len(d), h, w) and r.masks.data.dtype == bool, "segment: masks")
        if task == "pose" and len(d):
            k = r.keypoints.data
            require(k.shape == (len(d), 17, 3) and bool(np.isfinite(k).all()) and bool((k[..., 0] <= w).all())
                    and bool((k[..., 1] <= h).all()) and bool(((k[..., 2] >= 0) & (k[..., 2] <= 1)).all()),
                    "pose: keypoints")
    if task != "classify":
        require(sum(len(r) for r in results) > len(results), f"{task}: too few detections to check")


def write_task_set(root, task, y, imgs, imgsz):
    """A val set of TASK_VAL_IMAGES frames labelled from the card's own predictions
    (each image's 3 best, jittered and unclipped, as the task validators match
    in letterboxed pixels without clipping: the box or the mask's contour as a
    polygon, the box and its keypoints, the rotated box's corners); for classify
    a folder per class of the 1000 (named to sort by index), each frame in the
    top-1 class or the 3rd of the square resize the dataset feeds. Returns what
    val() takes as data."""
    import cv2
    import numpy as np
    from PIL import Image

    frames = imgs[:TASK_VAL_IMAGES]
    rng = np.random.default_rng(8)
    if task == "classify":
        square = [cv2.resize(im, (imgsz, imgsz)) for im in frames]
        val = root / "val"
        for c in range(y.model.nc):
            (val / f"{c:04d}").mkdir(parents=True)
        for i, (r, im) in enumerate(zip(y.predict(square, imgsz=imgsz, batch=TASK_VAL_IMAGES), frames)):
            c = int(np.argsort(-r.probs.data)[0 if i % 2 == 0 else 2])
            Image.fromarray(np.ascontiguousarray(im[..., ::-1])).save(val / f"{c:04d}" / f"{i:03d}.png",
                                                                      compress_level=1)
        return root
    pred = y._predictor  # the phase's bs-16 predictor
    x, meta = pred.preprocess(frames)
    det = {k: v.cpu().numpy() for k, v in pred.run(x).items()}
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i, im in enumerate(frames):
        Image.fromarray(np.ascontiguousarray(im[..., ::-1])).save(root / "images" / f"{i:06d}.png", compress_level=1)
        (h0, w0), ratio, pad = meta[i]
        wh = np.array([w0, h0], np.float64)
        one = {k: v[i] for k, v in det.items()}
        one["valid"] = one["valid"] & (np.arange(len(one["valid"])) < 3)  # the masks of the 3 best only
        r = pred._build_result("array", im, meta[i], one)
        rows = []
        for j in range(min(3, len(r))):
            if task == "obb":
                pts = r.obb.xyxyxyxy[j] + rng.uniform(-0.08, 0.08, (4, 2)) * r.obb.data[j, 2:4].max()
                rows.append(f"{int(r.obb.cls[j])} " + " ".join(f"{v:.6f}" for v in (pts / wh).ravel()))
                continue
            box = (det["boxes"][i, j].astype(np.float64) - np.tile(pad, 2)) / np.tile(ratio, 2)
            size = box[2:] - box[:2]
            box = box + rng.uniform(-0.08, 0.08, 4) * np.tile(size, 2)
            c = int(det["classes"][i, j])
            if task == "segment":  # the box, or the mask's contour
                seg = r.masks.xy[j] if j % 2 else np.zeros((0, 2))
                if len(seg) < 3:
                    seg = np.array([box[[0, 1]], box[[2, 1]], box[[2, 3]], box[[0, 3]]])
                rows.append(f"{c} " + " ".join(f"{v:.6f}" for v in (seg / wh).ravel()))
            else:
                k = det["extra"][i, j].reshape(-1, 3).astype(np.float64)
                k[:, :2] = ((k[:, :2] - pad) / ratio + rng.uniform(-0.08, 0.08, (len(k), 2)) * size.max() / 4) / wh
                k[:, 2] = np.where(rng.random(len(k)) < 0.8, 2, 0)
                (xc, yc), (bw, bh) = (box[:2] + box[2:]) / 2 / wh, (box[2:] - box[:2]) / wh
                rows.append(f"{c} {xc:.6f} {yc:.6f} {bw:.6f} {bh:.6f} " + " ".join(f"{v:.6f}" for v in k.ravel()))
        (root / "labels" / f"{i:06d}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\nval: images\nnames:\n" + "".join(f"  {c}: c{c}\n" for c in range(y.model.nc)))
    return yaml_path


def phase_task_heads(dev, base_run, base_x16, imgs):
    """The task heads in eval (nn/heads.py Segment, Pose, OBB, Classify), each
    with seeded weights, BN calibrated on four frames and the class biases at
    0: yolo-master-seg-n, -pose-n and -obb-n at 640 and -cls-n at 224 (the stem
    kernel writes 56x56 there), fuse().predict() at batch 1 and 16 in fp32
    (the stem kernel on all four, the NMS kernel on seg and pose, none on obb
    and cls); card vs CPU: decode within 5e-2 px and 1e-3 logit, keypoints
    within 5e-2 px, angles within 1e-3 rad, cls log-probabilities within 1e-3,
    the masks of shared detections within MASK_PIXEL_SHARE of their pixels; the
    NMS kernel equal to its plain version with 32 (seg) and 51 (pose) extra
    columns on a bs-16 batch's candidates; device ms/img beside yolo-master-n's
    in turns, the host's ms/img of each result (seg: the masks), busy share,
    kernels and peak memory of a bs-16 batch; val() on TASK_VAL_IMAGES frames
    labelled from the card's predictions (a set under the checkout, removed
    after): launches a batch, metrics within VAL_METRIC_TOL of the CPU
    validator's."""
    out = {}
    for task, name, imgsz in TASK_GRAPHS:
        out[task] = _task_path(dev, task, name, imgsz, base_run, base_x16, imgs)
    return out


def _task_path(dev, task, name, imgsz, base_run, base_x16, imgs):
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictors_task import assemble_masks
    from yolo_master_tpu_torch.ops import cuda_nms
    from yolo_master_tpu_torch.ops import nms as tnms

    y = task_yolo(name, dev, imgs, imgsz)
    state = {k: v.detach().clone() for k, v in y.model.state_dict().items()}
    cpu = YOLO(name, device="cpu").load_state_dict(state)
    y.fuse()
    cpu.fuse()
    res = {"launches": {}}
    reset_launches()
    r1 = y.predict(imgs[0], batch=1, imgsz=imgsz)
    r16 = y.predict(imgs, batch=16, imgsz=imgsz)
    torch.cuda.synchronize()
    launches = res["launches"]["predict"] = read_launches()
    want = {"stem": 2, "stem_bank": 1, "nms": 2 * TASK_NMS[task], "esmoe": 0, "cw_nms": 0, "moe": 0, "c3k2": 0}
    log(f"[{name}] predict bs1 + bs16 launches: {launches}")
    require(launches == want, f"{name}: launches {launches}, expected {want}")
    require(len(r1) == 1 and len(r16) == 16, f"{name}: result counts")
    check_task_results(task, r1 + r16, y.model.nc)
    res["detections"] = [len(r) for r in r16]
    pred = y._predictor

    # card vs CPU, two frames: the head's outputs and decode
    x, meta = pred.preprocess(imgs[:2])
    with torch.inference_mode():
        pg, pc = y.model(x), cpu.model(x.cpu())
    if task == "classify":
        lg, lc = pg.log().cpu(), pc.log()
        err = ((lg - lg.mean(-1, keepdim=True)) - (lc - lc.mean(-1, keepdim=True))).abs().max().item()
        res["card_vs_cpu"] = {"log_prob": err}
        require(err <= 1e-3, f"{name}: card and CPU log-probabilities {err:.3e} apart (limit 1e-3)")
    else:
        nc = y.model.nc
        with torch.inference_mode():
            dg = y.model.head.decode(pg, raw_scores=True).cpu()
            dc = cpu.model.head.decode(pc, raw_scores=True)
        d64 = exact_decode(name, state, x, dev)
        e, noise = (dg - dc).abs(), (dc - d64).abs()
        errs = {"box_px": e[..., :4].max().item(), "logit": e[..., 4:4 + nc].max().item()}
        res["cpu_fp32_vs_fp64"] = {"box_px": noise[..., :4].max().item(), "logit": noise[..., 4:4 + nc].max().item()}
        limits = {"box_px": 5e-2, "logit": 1e-3}
        if task == "segment":
            errs["mask_coefficient"] = e[..., 4 + nc:].max().item()
            errs["proto"] = (pg["proto"].cpu() - pc["proto"]).abs().max().item()
            # shared detections: the CPU decode's boxes and scores through NMS, with each
            # package's own coefficients, each package's prototypes
            kw = dict(nc=nc, conf_thres=pred.conf, iou_thres=pred.iou, max_det=pred.max_det, max_nms=pred.max_nms)
            with torch.inference_mode():
                d_c = tnms.non_max_suppression(torch.cat([dc[..., :4], dc[..., 4:4 + nc].sigmoid(), dc[..., 4 + nc:]], -1),
                                               **kw)
                d_g = tnms.non_max_suppression(torch.cat([dc[..., :4], dc[..., 4:4 + nc].sigmoid(), dg[..., 4 + nc:]], -1),
                                               **kw)
            require(torch.equal(d_c["valid"], d_g["valid"]) and torch.equal(d_c["boxes"], d_g["boxes"]),
                    "segment: the shared detections differ")
            apart = total = 0
            for i in range(2):
                n = int(d_c["valid"][i].sum())
                masks = [assemble_masks(d["extra"][i, :n].numpy(), p["proto"][i].permute(1, 2, 0).cpu().numpy(),
                                        d_c["boxes"][i, :n].numpy(), pred.imgsz, *meta[i])
                         for d, p in ((d_g, pg), (d_c, pc))]
                apart += int((masks[0] != masks[1]).sum())
                total += masks[0].size
            errs["mask_pixels_apart"], errs["mask_pixels"] = apart, total
            require(total > 0 and apart <= MASK_PIXEL_SHARE * total,
                    f"segment: {apart} of {total} mask pixels apart between the card and the CPU")
        elif task == "pose":
            k = e[..., 4 + nc:].reshape(*e.shape[:2], 17, 3)
            errs["kpt_px"], errs["kpt_visibility"] = k[..., :2].max().item(), k[..., 2].max().item()
            limits.update(kpt_px=5e-2, kpt_visibility=1e-3)
        else:
            errs["angle_rad"] = e[..., -1].max().item()
            limits["angle_rad"] = 1e-3
        res["card_vs_cpu"] = errs
        log(f"[{name}] card vs CPU, 2 frames, all {dg.shape[1]} anchors: {json.dumps(errs)}; the CPU's own fp32 vs "
            f"fp64: {json.dumps(res['cpu_fp32_vs_fp64'])}")
        for k, lim in limits.items():
            require(errs[k] <= lim, f"{name}: card vs CPU {k} {errs[k]:.3e} beyond {lim:.1e}")

    # the NMS kernel against its plain loop, the extra columns gathered by both (bs 16)
    x16, _ = pred.preprocess(imgs)
    if TASK_NMS[task]:
        with torch.inference_mode():
            dec16 = y.model.head.decode(y.model(x16))
        kw = dict(nc=y.model.nc, conf_thres=pred.conf, iou_thres=pred.iou, max_det=pred.max_det, max_nms=pred.max_nms)
        kernel = tnms.batched_greedy_nms
        got = tnms.non_max_suppression(dec16, **kw)
        tnms.batched_greedy_nms = cuda_nms.batched_greedy_nms_plain
        try:
            plain = tnms.non_max_suppression(dec16, **kw)
        finally:
            tnms.batched_greedy_nms = kernel
        require(all(torch.equal(got[k], plain[k]) for k in got), f"{name}: NMS kernel vs plain differ")
        res["nms_extra_columns"] = got["extra"].shape[-1]
        log(f"[{name}] NMS kernel == plain on a bs-16 batch's candidates, {got['extra'].shape[-1]} extra columns, "
            f"{int(got['valid'].sum())} kept")

    # device ms/img beside yolo-master-n's, in turns; the host's result assembly; a profiled bs-16 batch
    res["e2e"] = {}
    for bs in (1, 16):
        xb = x16[:bs]
        runs = {"yolo-master-n": [], name: []}
        for nm in ("yolo-master-n", name, name, "yolo-master-n"):
            run, xr = (base_run, base_x16[:bs]) if nm == "yolo-master-n" else (pred.run, xb)
            runs[nm].append(cuda_ms(lambda: run(xr), reps=5, warmup=2) / bs)
        res["e2e"][bs] = {k: statistics.median(v) for k, v in runs.items()}
        log(f"[e2e] bs={bs}: device ms/img, yolo-master-n {[round(t, 4) for t in runs['yolo-master-n']]}, "
            f"{name} {[round(t, 4) for t in runs[name]]}")
    res["host_ms_per_img"] = r16[0].speed["postprocess"]  # the bs-16 predict's result assembly, ms an image
    wall_ms, dev_us, count = profile_kernels(pred.run, x16)
    busy_ms = sum(dev_us.values()) / 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    pred.run(x16)
    torch.cuda.synchronize()
    res["profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms, kernels=count,
                          peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"[{name}] bs=16: host result assembly {res['host_ms_per_img']:.3f} ms/img; under torch.profiler wall "
        f"{wall_ms:.3f} ms/batch, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {count:.0f} "
        f"kernels/batch, peak memory {res['profile']['peak_gib']:.3f} GiB")

    # val on frames labelled from the card's predictions, card against CPU
    root = Path(tempfile.mkdtemp(prefix=".val_set_", dir=Path(__file__).resolve().parent))
    try:
        data = write_task_set(root, task, y, imgs, imgsz)
        kw = dict(data=str(data), imgsz=imgsz, batch=TASK_VAL_IMAGES)
        reset_launches()
        m = y.val(**kw)
        torch.cuda.synchronize()
        launches = res["launches"]["val"] = read_launches()
        m_cpu = cpu.val(**kw)
        diff = {k: abs(m[k] - m_cpu[k]) for k in TASK_METRICS[task]}
        res["val"] = dict(metrics={k: m[k] for k in TASK_METRICS[task]}, diff=diff, speed=m["speed"])
        log(f"[{name}] val: launches {launches}; {m['images']} images, "
            + " ".join(f"{k} {m[k]:.6f}" for k in TASK_METRICS[task])
            + f"; |card - CPU| {json.dumps(diff)}; speed {json.dumps(m['speed'])} ms/img")
        require(launches["stem"] == 1 and launches["nms"] == TASK_NMS[task],
                f"{name} val: the stem kernel once and the NMS kernel {TASK_NMS[task]} times expected")
        require(m["images"] == TASK_VAL_IMAGES and max(diff.values()) <= VAL_METRIC_TOL,
                f"{name} val: the card's metrics differ from the CPU validator's beyond {VAL_METRIC_TOL}")
        require(m_cpu["top5"] == 1.0 if task == "classify" else m_cpu["mAP50"] > 0.05,
                f"{name} val: the labels are not matched")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def phase_imports():
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "yolo_master_tpu"))
    require(not bad, f"the port imported {bad[:5]}")
    log("[imports] no jax, jaxlib or yolo_master_tpu module was imported")


def kernel_entry(name, source, replaces, launches, res, shape, library_ms=None, **extra):
    return {"name": name, "route": "cuda", "source": f"yolo_master_tpu_torch/csrc/{source}",
            "replaces": f"yolo_master_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": library_ms, "shape": shape,
            **extra}


def main():
    phase_environment()
    import torch

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()

    def done(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s")

    sass = phase_build()
    done("build")
    phase_split_tf32(dev)
    bf16_rounding = phase_split_bf16(dev)
    stem_res = phase_stem(dev)
    stem16_res = phase_stem_bf16(dev)
    done("stem")
    nms_res = phase_nms(dev)
    esmoe_res = phase_esmoe(dev)
    esmoe16_res = phase_esmoe_bf16(dev)
    cw_res = phase_cw_nms(dev)
    gm_res, gm_launches = phase_moe(dev)
    phase_sparse_esmoe(dev)
    done("kernel checks")
    model, state, imgs, main_launches = phase_main_path(dev)
    scale_m, _ = phase_scale_m(dev, imgs)
    done("main path and scale m")
    c3k2_res, c3k2_launches = phase_c3k2(dev, model, imgs)
    moe, moe_launches, _ = phase_fused_esmoe_path(dev, model, state, imgs)
    v01, _, _, v01_state = phase_v0_1_path(dev, model, imgs)
    sahi_launches = phase_sahi(dev, moe)
    done("fp32 paths")
    x16, _ = model._predictor.preprocess(imgs)
    v01_fp32 = v01._predictor
    fp32_runs = {"predict path": model._predictor.run, "with fused_esmoe_fuse": moe._predictor.run,
                 "yolo-master-v0_1-n predict path": v01_fp32.run, "yolo-master-m predict path": scale_m._predictor.run}
    bf16_res = phase_bf16_paths(dev, {"yolo-master-n": model, "with fused_esmoe_fuse": moe, "yolo-master-v0_1-n": v01,
                                      "yolo-master-m": scale_m}, imgs)
    done("bf16 paths")
    val = phase_val(dev, state)
    done("val path")
    _, v10, v10_state = phase_v0_10_path(dev, fp32_runs["predict path"], imgs)
    done("v0_10 paths")
    y26, y26_state, y26_preds = phase_yolo26_path(dev, fp32_runs["predict path"], imgs)
    done("yolo26 paths")
    y26v, y26v_states = phase_yolo26_variants(dev, y26_preds, imgs)
    done("yolo26-master-latent and -moa-mot paths")
    tasks = phase_task_heads(dev, fp32_runs["predict path"], x16, imgs)
    done("task heads")
    train = phase_train(dev, state)
    done("train step")
    loop = phase_train_loop(dev, state, imgs)
    done("train loop")
    train16 = phase_train_bf16(dev, state, train["b"])
    done("bf16 train step")
    loop16 = phase_train_loop(dev, state, imgs, amp=True)
    done("bf16 train loop")
    multi = phase_multitrainer(dev, state)
    done("MultiTrainer")
    v01_train = phase_v0_1_train(dev, v01_state, train["b"], train16["b"])
    done("v0_1 train step")
    log(f"[train loop bf16 {V01}] warmup_steps, dropout_interval = {V01_LOOP_SCHEDULE} on layers 5, 8 and 11")
    v01_loop = phase_train_loop(dev, v01_state, imgs, amp=True, name=V01, schedule=V01_LOOP_SCHEDULE)
    done("v0_1 train loop")
    v10_train = phase_v0_10_train(dev, v10_state, state, imgs,
                                  {"n_fp32": train["b"], "n_bf16": train16["b"], "v01_fp32": v01_train["c_fp32"],
                                   "v01_bf16": v01_train["c_bf16"]})
    done("v0_10 training and the MoE tools")
    y26_train = phase_yolo26_train(dev, y26_state, imgs,
                                   {"n_fp32": train["b"], "n_bf16": train16["b"], "v01_fp32": v01_train["c_fp32"],
                                    "v01_bf16": v01_train["c_bf16"]})
    done("yolo26 training")
    mix_train = phase_mixture_train(dev, y26v_states, imgs, y26_train)
    done("yolo26-master-latent and -moa-mot training")

    def v01_dense(xb):
        v01.model.sparse_inference = False
        try:
            return v01_fp32.run(xb)
        finally:
            v01.model.sparse_inference = True

    shares = phase_profile({**fp32_runs, "yolo-master-v0_1-n, dense eval": v01_dense,
                            "predict path, bf16": bf16_res["yolo-master-n"]["run"],
                            "with fused_esmoe_fuse, bf16": bf16_res["with fused_esmoe_fuse"]["run"],
                            "yolo-master-v0_1-n predict path, bf16": bf16_res["yolo-master-v0_1-n"]["run"],
                            "yolo-master-m predict path, bf16": bf16_res["yolo-master-m"]["run"]}, x16)
    require(shares["yolo-master-m predict path, bf16"]["stem_ms"] > 0, "the scale-m bf16 profile shows no stem kernel")
    phase_imports()
    done("profile")

    # ES_MOE: the four placements of one bs-16 forward, summed
    es16 = [esmoe_res[(16, layer)] for layer, _, _ in ESMOE_PLACEMENTS]
    es_sum = {k: sum(r[k] for r in es16) for k in ("ms", "plain_ms", "module_ms", "bound_ms")}
    es_top = max(es16, key=lambda r: r["bound_ms"])  # the sum is named after its largest term
    es_sum.update(max_abs_err=max(r["max_abs_err"] for r in es16), bound_by=es_top["bound_by"],
                  bound_peak=es_top["bound_peak"])
    # C3k2: layers 2 and 5 of one bs-16 forward, summed
    c16 = [c3k2_res[(16, i, 1)] for i in C3K2_LAYERS]
    c_sum = {k: sum(r[k] for r in c16) for k in ("ms", "plain_ms", "module_ms", "bound_ms")}
    c_top = max(c16, key=lambda r: r["bound_ms"])  # the sum is named after its largest term
    c_sum.update(max_abs_err=max(r["max_abs_err"] for r in c16), bound_by=c_top["bound_by"],
                 bound_peak=c_top["bound_peak"])
    es16_bf16 = [esmoe16_res[(16, layer)] for layer, _, _ in ESMOE_PLACEMENTS]
    es_bf16 = {k: sum(r[k] for r in es16_bf16) for k in ("ms", "plain_ms", "module_ms", "bound_ms")}
    es_bf16_top = max(es16_bf16, key=lambda r: r["bound_ms"])
    es_bf16.update(max_abs_err=max(r["max_abs_err"] for r in es16_bf16), bound_by=es_bf16_top["bound_by"],
                   bound_peak=es_bf16_top["bound_peak"])
    stem_bf16 = stem16_res[("n", 16, "uint8")]
    gm = gm_res[(16, MOE_BANKS[0][0])]
    kernels = [
        kernel_entry("fused_stem", "stem.cu", "pallas_stem.py:177", main_launches["stem"], stem_res[("n", 16)],
                     "uint8 [16,640,640,3] -> [16,160,160,32]", bound_peak=stem_res[("n", 16)]["bound_peak"],
                     bank_launches=main_launches["stem_bank"], val_launches=val["fp32"]["launches"]["stem"],
                     train_ema_val_launches=train["c"]["launches"]["stem"],
                     train_loop_predict_launches=loop["predict_launches"]["stem"],
                     train_loop_bf16_predict_launches=loop16["predict_launches"]["stem"],
                     v0_1_train_loop_predict_launches=v01_loop["predict_launches"]["stem"],
                     v0_10_predict_launches=v10["launches"]["fp32"]["stem"],
                     v0_10_val_launches=v10["launches"]["val"]["stem"],
                     yolo26_predict_launches=y26["launches"]["fp32"]["stem"],
                     yolo26_bank_launches=y26["launches"]["fp32"]["stem_bank"],
                     yolo26_val_launches=y26["launches"]["val"]["stem"],
                     **{f"{v.removesuffix('-n').replace('-', '_')}_{k}_launches": y26v[v]["launches"][p][key]
                        for v in VARIANTS for k, p, key in (("predict", "fp32", "stem"), ("bank", "fp32", "stem_bank"),
                                                            ("val", "val", "stem"))},
                     yolo26_train_loop_predict_launches=y26_train["c"]["predict_launches"]["stem"],
                     **{f"{v}_train_loop_predict_launches": mix_train[v]["c"]["predict_launches"]["stem"]
                        for v in ("latent", "moa_mot")},
                     task_predict_launches={t: r["launches"]["predict"]["stem"] for t, r in tasks.items()},
                     task_bank_launches={t: r["launches"]["predict"]["stem_bank"] for t, r in tasks.items()},
                     task_val_launches={t: r["launches"]["val"]["stem"] for t, r in tasks.items()},
                     v0_10_train_loop_predict_launches=v10_train["e"]["predict_launches"]["stem"],
                     pruned_n_predict_launches=v10_train["f"]["prune_launches"]["stem"],
                     widths={scale: {k: stem_res[(scale, 16)][k]
                                     for k in ("ms", "plain_ms", "bound_ms", "bound_peak", "max_abs_err")}
                             for scale in STEM_WIDTHS}),
        kernel_entry("batched_greedy_nms", "nms.cu", "pallas_nms.py:120", main_launches["nms"],
                     nms_res[(16, 2048, False)], "B=16 N=2048 max_det=300",
                     val_launches={k: val[k]["launches"]["nms"] for k in ("fp32", "bf16")},
                     train_ema_val_launches=train["c"]["launches"]["nms"],
                     train_loop_ema_val_launches=loop["launches"]["nms"],
                     train_loop_predict_launches=loop["predict_launches"]["nms"],
                     train_loop_bf16_ema_val_launches=loop16["launches"]["nms"],
                     train_loop_bf16_predict_launches=loop16["predict_launches"]["nms"],
                     multitrainer_ema_val_launches=multi["launches"]["nms"],
                     v0_1_train_loop_ema_val_launches=v01_loop["launches"]["nms"],
                     v0_1_train_loop_predict_launches=v01_loop["predict_launches"]["nms"],
                     v0_10_predict_launches={k: v10["launches"][k]["nms"] for k in ("fp32", "bf16")},
                     v0_10_val_launches=v10["launches"]["val"]["nms"],
                     yolo26_predict_launches={k: y26["launches"][k]["nms"] for k in ("fp32", "bf16")},
                     yolo26_val_launches=y26["launches"]["val"]["nms"],
                     **{f"{v.removesuffix('-n').replace('-', '_')}_{k}_launches": (
                         {d: y26v[v]["launches"][d]["nms"] for d in ("fp32", "bf16")} if k == "predict"
                         else y26v[v]["launches"]["val"]["nms"]) for v in VARIANTS for k in ("predict", "val")},
                     yolo26_train_loop_ema_val_launches=y26_train["c"]["launches"]["nms"],
                     yolo26_train_loop_predict_launches=y26_train["c"]["predict_launches"]["nms"],
                     yolo26_multitrainer_ema_val_launches=y26_train["d"]["launches"]["nms"],
                     **{f"{v}_train_loop_{k}_launches": mix_train[v]["c"][key]["nms"]
                        for v in ("latent", "moa_mot") for k, key in (("ema_val", "launches"),
                                                                     ("predict", "predict_launches"))},
                     moa_mot_multitrainer_ema_val_launches=mix_train["moa_mot"]["d"]["launches"]["nms"],
                     task_predict_launches={t: r["launches"]["predict"]["nms"] for t, r in tasks.items()},
                     task_val_launches={t: r["launches"]["val"]["nms"] for t, r in tasks.items()},
                     task_extra_columns={t: r["nms_extra_columns"] for t, r in tasks.items() if "nms_extra_columns" in r},
                     v0_10_train_loop_ema_val_launches=v10_train["e"]["launches"]["nms"],
                     v0_10_train_loop_predict_launches=v10_train["e"]["predict_launches"]["nms"],
                     pruned_n_predict_launches=v10_train["f"]["prune_launches"]["nms"],
                     v0_10_quantized_predict_launches=v10_train["f"]["quantized_predict_launches"]["nms"],
                     train_loop_ema_val_b8={"shape": f"B=8 N={loop['nms_b8']['n']} max_det=300 iou=0.7, the trained "
                                                     "EMA model's val candidates", **loop["nms_b8"]},
                     val_multilabel_4096={"shape": "B=16 N=4096 max_det=300 iou=0.7, one val batch's multi-label "
                                                   "candidates", **val["nms_4096"]}),
        kernel_entry("fused_esmoe", "esmoe.cu", "pallas_esmoe.py:81", moe_launches["esmoe"], es_sum,
                     "B=16, the four placements [16,160,160,64], [16,80,80,128], [16,40,40,128], "
                     "[16,20,20,256] summed", module_ms=es_sum["module_ms"], bound_peak=es_sum["bound_peak"]),
        kernel_entry("batched_cw_nms", "cw_nms.cu", "pallas_nms.py:215", sahi_launches["cw_nms"],
                     cw_res[(1, 4096, True, False)], "B=1 N=4096 max_det=300 weighted_iou"),
        kernel_entry("gathered_expert_matmul", "moe.cu", "pallas_moe.py:45", gm_launches, gm,
                     "[16,6400,128] x [4,128,256], K=2 (v0_1-n layer 5's expert bank)", library_ms=gm["library_ms"],
                     library_tf32_ms=gm["library_tf32_ms"], bound_peak=gm["bound_peak"]),
        kernel_entry("fused_c3k2", "c3k2.cu", "pallas_c3k2.py:152", c3k2_launches, c_sum,
                     "B=16, yolo-master-n layers 2 [16,160,160,32]->64 and 5 [16,80,80,64]->128 summed "
                     "(also replaces pallas_c3k2_cf, pallas_c3k2.py:239)", module_ms=c_sum["module_ms"],
                     bound_peak=c_sum["bound_peak"], n2_block={k: c3k2_res[(16, 2, 2)][k] for k in
                                                                ("ms", "plain_ms", "module_ms", "bound_ms")},
                     b1={k: sum(c3k2_res[(1, i, 1)][k] for i in C3K2_LAYERS) for k in ("ms", "plain_ms", "module_ms")},
                     resources=sass["c3k2"]),
        kernel_entry("fused_stem_bf16", "stem.cu", "pallas_stem.py:177", bf16_res["yolo-master-n"]["launches"]["stem"],
                     stem_bf16, "uint8 [16,640,640,3] -> bf16 [16,160,160,32] (the bf16 predict path's form)",
                     bound_peak=stem_bf16["bound_peak"], cudnn_bf16_pair_ms=stem_bf16["cudnn_bf16_pair_ms"],
                     bank_launches=bf16_res["yolo-master-n"]["launches"]["stem_bank"],
                     val_launches=val["bf16"]["launches"]["stem"],
                     val_bank_launches=val["bf16"]["launches"]["stem_bank"],
                     launches_scale_m=bf16_res["yolo-master-m"]["launches"]["stem"],
                     v0_10_launches=v10["launches"]["bf16"]["stem"],
                     v0_10_bank_launches=v10["launches"]["bf16"]["stem_bank"],
                     yolo26_launches=y26["launches"]["bf16"]["stem"],
                     yolo26_bank_launches=y26["launches"]["bf16"]["stem_bank"],
                     **{f"{v.removesuffix('-n').replace('-', '_')}_{k}_launches": y26v[v]["launches"]["bf16"][key]
                        for v in VARIANTS for k, key in (("predict", "stem"), ("bank", "stem_bank"))},
                     accumulation_rounding=bf16_rounding,
                     stem_share_scale_m_bs16=shares["yolo-master-m predict path, bf16"]["stem_share"],
                     widths={scale: {f"{form}_in": {k: stem16_res[(scale, 16, form)][k] for k in
                                                    ("ms", "plain_ms", "cudnn_bf16_pair_ms", "bound_ms", "bound_peak",
                                                     "max_abs_err", "rounding_apart")}
                                     for form in ("uint8", "bf16")}
                             for scale in STEM_WIDTHS},
                     resources={name.split("stem_bf16_kernel", 1)[1][:40]: r for name, r in sass["stem_bf16"].items()}),
        kernel_entry("fused_esmoe_bf16", "esmoe.cu", "pallas_esmoe.py:81",
                     bf16_res["with fused_esmoe_fuse"]["launches"]["esmoe"], es_bf16,
                     "bf16 in and out, B=16, the four placements summed", module_ms=es_bf16["module_ms"],
                     bound_peak=es_bf16["bound_peak"]),
    ]
    log("[val] ms/img at 640, bs 16, warm (load, device, match): " + json.dumps(
        {k: {"all": val[k]["ms_per_img"], "split": val[k]["speed"]} for k in ("fp32", "bf16")})
        + f"; candidate sort {val['sort_ms']:.4f} ms a batch")
    log("[train] " + json.dumps({"a": train["a"], "b": {k: v for k, v in train["b"].items() if k != "losses"}}))
    log("[train loop] " + json.dumps({k: v for k, v in loop.items() if k != "predict_launches"}))
    log("[train bf16] " + json.dumps({"a": train16["a"],
                                      "b": {k: v for k, v in train16["b"].items() if k != "losses"}}))
    log("[train loop bf16] " + json.dumps({k: v for k, v in loop16.items() if k != "predict_launches"}))
    log("[multitrainer] " + json.dumps(multi))
    log("[v0_1 train] " + json.dumps({"a": v01_train["a"], "b": v01_train["b"],
                                      **{k: {n: v for n, v in v01_train[k].items() if n != "losses"}
                                         for k in ("c_fp32", "c_bf16")}}))
    log(f"[train loop bf16 {V01}] " + json.dumps({k: v for k, v in v01_loop.items() if k != "predict_launches"}))
    log(f"[{V10}] " + json.dumps(v10))
    log(f"[{Y26}] " + json.dumps(y26))
    for v in VARIANTS:
        log(f"[{v}] " + json.dumps(y26v[v]))
    for task, name, _ in TASK_GRAPHS:
        log(f"[{name}] " + json.dumps(tasks[task]))
    log(f"[{Y26} train] " + json.dumps({k: ({n: x for n, x in r.items() if n not in ("losses", "predict_launches")}
                                            if isinstance(r, dict) else r) for k, r in y26_train.items()},
                                       default=str))
    for v, r in mix_train.items():
        log(f"[{v} train] " + json.dumps({k: ({n: x for n, x in q.items() if n not in ("losses", "predict_launches")}
                                              if isinstance(q, dict) else q) for k, q in r.items()}, default=str))
    log(f"[{V10} train] " + json.dumps({k: ({n: v for n, v in r.items() if n not in ("losses", "predict_launches")}
                                            if isinstance(r, dict) else r) for k, r in v10_train.items()},
                                       default=str))
    log("[e2e] device ms/img, fp32 and bf16 paths in turns: " + json.dumps(
        {name: {f"bs{bs}": r["e2e"][bs] for bs in (1, 16)} for name, r in bf16_res.items()}))
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
