"""Where the stem kernel's time goes, on one CUDA card.

    python scripts/ablate_stem.py        # from the root of a checkout; needs nvcc and a card

Builds ``yolo_master_tpu_torch/csrc/stem.cu`` again with one phase cut out, or
SiLU's division made approximate (VARIANTS: the ``-DSTEM_CUT`` bits of
stem.cu's ``StemCut`` each sets), one nvcc each, in parallel, and times each at the four stem widths of the port's
YAMLs (B=16, 640x640 uint8, two rounds, each the median of 10 readings of 5
launches). A cut kernel computes wrong numbers; only its time is read, and the
difference from "full" is what the cut phase costs where it does not overlap
the others. Also prints what ptxas reports (registers, spills) for every
instantiation of the real kernel, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# variant -> STEM_CUT (stem.cu's StemCut bits)
VARIANTS = {
    "full": 0,
    "no conv1 products": 1,
    "no conv0": 2,
    "no weight-ring copies": 4,
    "conv0 without SiLU": 8,
    "SiLU by __fdividef": 16,  # not a cut: SiLU's division by the fast approximate one (2 ulp), what it would save
}
WIDTHS = ((16, 32), (32, 64), (64, 128), (96, 192))  # c0/c1 at scales n, s, m/l, x


def build(name: str, out_dir: Path):
    """nvcc one variant; (shared library, ptxas lines of the stem kernels)."""
    from yolo_master_tpu_torch.ops import _build

    stem = re.sub(r"\W+", "_", name)
    lib = out_dir / f"libstem_{stem}.so"
    cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS, f"-DSTEM_CUT={VARIANTS[name]}",
           "-I", str(_build.CSRC_DIR), "-Xptxas", "-v", "-o", str(lib), str(_build.CSRC_DIR / "stem.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for variant {name!r}:\n{proc.stderr}")
    report, kernel = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:  # the stem kernels' instantiations, not the bank kernel
            m = re.search(r"(stem_kernelI\w+?)EEEv", line)
            kernel = m.group(1) if m else None
        elif kernel and ("spill" in line or "Used" in line):
            report.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return lib, report


def main() -> None:
    import torch

    from yolo_master_tpu_torch.ops import _build
    from yolo_master_tpu_torch.ops.stem import bind, stem_plan, stem_weight_layout

    if not torch.cuda.is_available():
        sys.exit("ablate_stem: needs a CUDA card")
    out_dir = _build.BUILD_DIR / "ablate_stem"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(lambda n: build(n, out_dir), VARIANTS)))
    print("\n".join(f"[ptxas] {line}" for line in built["full"][1]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {name: bind(ctypes.CDLL(str(path))) for name, (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for c0, c1 in WIDTHS:
        g = torch.Generator().manual_seed(0)
        w0 = stem_weight_layout(((torch.rand(c0, 3, 3, 3, generator=g) - 0.5) * 0.6 / 255).to(dev))
        b0 = (torch.rand(c0, generator=g) - 0.5).to(dev)
        w1 = stem_weight_layout(((torch.rand(c1, c0, 3, 3, generator=g) - 0.5) * 1.2 / c0 ** 0.5).to(dev))
        b1 = (torch.rand(c1, generator=g) - 0.5).to(dev)
        x = torch.randint(0, 256, (16, 640, 640, 3), generator=g, dtype=torch.uint8).to(dev)
        out = torch.empty(16, 160, 160, c1, device=dev)
        bank = torch.empty(stem_plan(c0, c1)["bank_floats"], device=dev)
        times = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                if lib.ymt_stem_bank(w1.data_ptr(), bank.data_ptr(), c0, c1, stream):
                    raise RuntimeError(f"variant {name!r}: the bank kernel failed to launch")

                def run(lib=lib):
                    if lib.ymt_stem_u8(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), bank.data_ptr(), b1.data_ptr(),
                                       out.data_ptr(), 16, 640, 640, c0, c1, stream):
                        raise RuntimeError(f"variant {name!r}: the stem kernel failed to launch")

                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                readings = []
                for _ in range(10):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(5):
                        run()
                    end.record()
                    end.synchronize()
                    readings.append(start.elapsed_time(end) / 5)
                times[name].append(statistics.median(readings))
        print(f"[{c0}/{c1}] B=16 640x640 uint8, ms (two rounds): "
              + "; ".join(f"{name} {t[0]:.4f}, {t[1]:.4f}" for name, t in times.items()))


if __name__ == "__main__":
    main()
