"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives yolo_master_tpu_torch's main path, YOLO("yolo-master-n", device="cuda")
.fuse().predict(...), at 640x640 with seeded random weights, after building
both hand-written CUDA kernels (csrc/stem.cu, csrc/nms.cu) from the checkout
and holding each against its plain PyTorch version on the card. Phases:

  1. environment (versions, card name and power limit); fails without CUDA
  2. build both kernels
  3. stem kernel vs F.conv2d x2 (uint8 640x640 input)
  4. NMS kernel vs the plain greedy loop (exact keep sets, ties included)
  5. the main path at batch 1 and 16: launch counts, max_det detections per
     image, GPU vs CPU decode, kernel vs plain NMS on the GPU's candidates,
     end-to-end device time per image

fp32 throughout: TF32 is off for convs and matmuls. Any failing check raises
and the script exits non-zero. The second-to-last stdout line is a JSON
object of per-kernel results; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import importlib
import json
import platform
import statistics
import subprocess
import sys
import time

IMGSZ = 640  # letterbox size of the main path
FRAME_HW = (480, 640)  # synthetic frames: letterboxed to IMGSZ by padding alone


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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
    from yolo_master_tpu_torch.ops import cuda_nms, stem

    t0 = time.perf_counter()
    stem._lib()
    t1 = time.perf_counter()
    cuda_nms._lib()
    t2 = time.perf_counter()
    log(f"[build] stem.cu {t1 - t0:.1f} s, nms.cu {t2 - t1:.1f} s")


def phase_stem(dev):
    """Kernel vs plain at the main path's shapes (B=1, 16) and B=2, 640x640, c0=16, c1=32."""
    import torch

    from yolo_master_tpu_torch.ops.stem import fused_stem, fused_stem_plain, stem_weight_layout

    g = torch.Generator().manual_seed(0)
    w0 = stem_weight_layout(((torch.rand(16, 3, 3, 3, generator=g) - 0.5) * 0.6 / 255.0).to(dev))
    b0 = (torch.rand(16, generator=g) - 0.5).to(dev)
    w1 = stem_weight_layout(((torch.rand(32, 16, 3, 3, generator=g) - 0.5) * 0.3).to(dev))
    b1 = (torch.rand(32, generator=g) - 0.5).to(dev)
    result = {}
    for b in (2, 1, 16):
        x = torch.randint(0, 256, (b, 640, 640, 3), generator=g, dtype=torch.uint8).to(dev)
        out = fused_stem(x, w0, b0, w1, b1)
        ref = fused_stem_plain(x, w0, b0, w1, b1)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        require(out.shape == (b, 160, 160, 32) and bool(torch.isfinite(out).all()), "stem output shape/finite")
        require(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()), f"stem kernel disagrees: max abs err {err.max().item()}")
        ms = cuda_ms(lambda: fused_stem(x, w0, b0, w1, b1))
        plain_ms = cuda_ms(lambda: fused_stem_plain(x, w0, b0, w1, b1))
        log(f"[stem] B={b} 640x640 u8 -> [{b},160,160,32]: max abs err {err.max().item():.3e}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        result[b] = (err.max().item(), ms, plain_ms)
    return result


def nms_inputs(b: int, n: int, dev, seed: int = 0):
    """Class-offset boxes and scores: exact ties in every row, row 1 all invalid,
    row 2 with 5 valid candidates (exhausts long before max_det)."""
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
    return boxes.to(dev).contiguous(), scores.to(dev).contiguous()


def phase_nms(dev):
    import torch

    from yolo_master_tpu_torch.ops.cuda_nms import batched_greedy_nms, batched_greedy_nms_plain, greedy_nms

    result = {}
    for b, n in ((16, 1024), (16, 2048), (1, 2048)):
        boxes, scores = nms_inputs(b, n, dev)
        ki, kv = batched_greedy_nms(boxes, scores, 0.45, 300)
        ki_p, kv_p = batched_greedy_nms_plain(boxes, scores, 0.45, 300)
        torch.cuda.synchronize()
        require(torch.equal(ki, ki_p) and torch.equal(kv, kv_p), f"NMS kernel keep sets differ at B={b} N={n}")
        if b > 2:
            require(not bool(kv[1].any()) and int(kv[2].sum()) <= 5, "NMS all-invalid / early-exit rows")
        k1, v1 = greedy_nms(boxes[0], scores[0], 0.45, 300)
        require(torch.equal(k1, ki_p[0]) and torch.equal(v1, kv_p[0]), "NMS B=1 entry point differs")
        ms = cuda_ms(lambda: batched_greedy_nms(boxes, scores, 0.45, 300))
        plain_ms = cuda_ms(lambda: batched_greedy_nms_plain(boxes, scores, 0.45, 300), reps=5, warmup=1)
        idx_err = (ki.long() - ki_p.long()).abs().max().item()
        log(f"[nms] B={b} N={n} max_det=300: keep sets equal ({int(kv.sum())} kept), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        result[(b, n)] = (idx_err, ms, plain_ms)
    return result


def phase_main_path(dev):
    import numpy as np
    import torch

    from yolo_master_tpu_torch import YOLO
    from yolo_master_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_master_tpu_torch.ops import cuda_nms, nms, stem
    from yolo_master_tpu_torch.utils.weights import calibrate_bn

    rng = np.random.default_rng(0)
    # 480x640 BGR frames letterbox to 640x640 by padding alone (no resize library needed)
    imgs = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(16)]
    kw = dict(imgsz=IMGSZ, conf=0.0, iou=0.45, max_det=300)

    # seeded random weights; BN statistics calibrated on four frames so that
    # activations keep unit scale through the depth and detections depend on
    # the image (at the bare init they vanish by the neck)
    model = YOLO("yolo-master-n", device=dev)
    x_cal, _ = DetectionPredictor(model.model, imgsz=IMGSZ).preprocess(imgs[:4])  # float /255 before fuse()
    calibrate_bn(model.model, x_cal)
    cpu = YOLO("yolo-master-n", device="cpu").load_state_dict(model.model.state_dict())
    model.fuse()
    cpu.fuse()

    stem.fused_stem.launches = 0
    cuda_nms.batched_greedy_nms.launches = 0
    r1 = model.predict(imgs[0], batch=1, **kw)
    r16 = model.predict(imgs, batch=16, **kw)
    torch.cuda.synchronize()
    launches = {"stem": stem.fused_stem.launches, "nms": cuda_nms.batched_greedy_nms.launches}
    log(f"[main] predict bs1 + bs16 launches: {launches}")
    require(launches["stem"] > 0 and launches["nms"] > 0, "main path did not launch both kernels")
    require(len(r1) == 1 and len(r16) == 16, "result counts")
    for r in r1 + r16:
        d = r.boxes.data
        require(len(d) == kw["max_det"], f"expected {kw['max_det']} detections, got {len(d)}")
        require(bool(np.isfinite(d).all()), "non-finite detections")
        require(bool((d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= FRAME_HW[1]).all()
                     and (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= FRAME_HW[0]).all()), "boxes outside the image")
        require(bool((d[:, 4] > 0).all() and (d[:, 4] <= 1).all()), "scores outside (0, 1]")
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
        full_cpu64 = cpu.model.head.decode(copy.deepcopy(cpu.model).double()(x.cpu()), raw_scores=True)
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

    # end-to-end device time, uint8 batch on the card -> fixed-shape detections
    e2e = {}
    for bs in (1, 16):
        xb, _ = pred.preprocess(imgs[:bs])
        ms = cuda_ms(lambda: pred.run(xb), reps=20, warmup=3)
        t0 = time.perf_counter()
        for _ in range(5):
            model.predict(imgs[:bs], batch=bs, **kw)
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        e2e[bs] = ms / bs
        log(f"[main] bs={bs}: device {ms:.3f} ms/batch = {ms / bs:.3f} ms/img (uint8 on card -> detections); "
            f"predict() with letterbox and Results {host_ms / bs:.3f} ms/img (host clock)")
    require("jax" not in sys.modules, "the port imported jax")
    return launches, e2e


def main():
    phase_environment()
    import torch

    dev = torch.device("cuda", 0)
    phase_build()
    stem_res = phase_stem(dev)
    nms_res = phase_nms(dev)
    launches, _ = phase_main_path(dev)
    kernels = [
        {"name": "fused_stem", "route": "cuda", "source": "yolo_master_tpu_torch/csrc/stem.cu",
         "replaces": "yolo_master_tpu/ops/pallas_stem.py:177", "launches": launches["stem"],
         "max_abs_err": stem_res[16][0], "ms": stem_res[16][1], "plain_ms": stem_res[16][2],
         "shape": "uint8 [16,640,640,3] -> [16,160,160,32]"},
        {"name": "batched_greedy_nms", "route": "cuda", "source": "yolo_master_tpu_torch/csrc/nms.cu",
         "replaces": "yolo_master_tpu/ops/pallas_nms.py:120", "launches": launches["nms"],
         "max_abs_err": nms_res[(16, 2048)][0], "ms": nms_res[(16, 2048)][1], "plain_ms": nms_res[(16, 2048)][2],
         "shape": "B=16 N=2048 max_det=300"},
    ]
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
