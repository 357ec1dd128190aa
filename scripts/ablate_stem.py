"""Where the stem kernel's time goes, on one CUDA card.

    python scripts/ablate_stem.py                       # from the root of a checkout; needs nvcc and a card
    python scripts/ablate_stem.py --forms "uint8 -> bfloat16" --widths m/l x
    python scripts/ablate_stem.py --csrc OTHER/yolo_master_tpu_torch/csrc   # another checkout's kernel

Builds ``yolo_master_tpu_torch/csrc/stem.cu`` again with one phase cut out, or
SiLU's division made approximate (VARIANTS: the ``-DSTEM_CUT`` bits of
stem.cu's ``StemCut`` each sets; the last two cut phases of the bf16 forms'
kernel only, whose SiLU divides fast already), one nvcc each, in parallel, and times each
form of the kernel (FORMS: uint8 -> float32, uint8 -> bfloat16, bfloat16 ->
bfloat16) at the four stem widths of the port's YAMLs (B=16, 640x640, two
rounds, each the median of 10 readings of 5 launches). A cut kernel computes
wrong numbers; only its time is read, and the difference from "full" is what
the cut phase costs where it does not overlap the others. Also prints what
ptxas reports (registers, spills) for every instantiation of the real kernel,
fp32 and bf16 forms alike, and the card's name and power limit.

``--csrc`` builds the kernel of another checkout (its ``csrc`` directory), so
that two versions can be timed in one call: the bf16 forms then read the bf16
bank where that source has one (``ymt_stem_bank_bf16``), else the fp32 bank.
"""

from __future__ import annotations

import argparse
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
    "no conv1 joins": 32,  # the bf16 forms only: the fp32 adds that join each tap's chain to the sum
    "no conv1 A loads": 64,  # the bf16 forms only: conv1's A fragment loads from the conv0 tile
}
# form -> (entry point, input dtype name, output dtype name)
FORMS = {
    "uint8 -> float32": ("ymt_stem_u8", "uint8", "float32"),
    "uint8 -> bfloat16": ("ymt_stem_u8_bf16", "uint8", "bfloat16"),
    "bfloat16 -> bfloat16": ("ymt_stem_bf16", "bfloat16", "bfloat16"),
}
WIDTHS = {"n": (16, 32), "s": (32, 64), "m/l": (64, 128), "x": (96, 192)}  # c0/c1 of the YAMLs' scales


def build(name: str, csrc: Path, out_dir: Path):
    """nvcc one variant; (shared library, ptxas lines of the stem kernels)."""
    from yolo_master_tpu_torch.ops import _build

    stem = re.sub(r"\W+", "_", name)
    lib = out_dir / f"libstem_{stem}.so"
    cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS, f"-DSTEM_CUT={VARIANTS[name]}",
           "-I", str(csrc), "-Xptxas", "-v", "-o", str(lib), str(csrc / "stem.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for variant {name!r}:\n{proc.stderr}")
    report, kernel = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:  # the stem kernels' instantiations, not the bank kernels
            m = re.search(r"(stem\w*?_kernelI\w+?)EEEv", line)
            kernel = m.group(1) if m else None
        elif kernel and ("spill" in line or "Used" in line or "Performance Loss" in line):
            report.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return lib, report


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of the entry points this script calls; the bf16 bank's only where the source has it."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for entry, _, _ in FORMS.values():
        getattr(lib, entry).argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    banks = [("ymt_stem_bank", "stem_bank_floats", 4)]
    if hasattr(lib, "ymt_stem_bank_bf16"):
        banks.append(("ymt_stem_bank_bf16", "stem_bank_bf16_bytes", 1))
    for entry, size, _ in banks:
        getattr(lib, entry).argtypes = [ptr, ptr, i32, i32, ptr]
        getattr(lib, size).argtypes = [i32, i32]
        getattr(lib, size).restype = ctypes.c_longlong
    lib.banks = {"float32": banks[0], "bfloat16": banks[-1]}
    return lib


def main() -> None:
    import torch

    from yolo_master_tpu_torch.ops import _build
    from yolo_master_tpu_torch.ops.stem import stem_weight_layout

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forms", nargs="+", choices=list(FORMS), default=list(FORMS))
    ap.add_argument("--widths", nargs="+", choices=list(WIDTHS), default=list(WIDTHS))
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS), default=list(VARIANTS))
    ap.add_argument("--csrc", type=Path, default=_build.CSRC_DIR, help="the csrc directory to build stem.cu from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ablate_stem: needs a CUDA card")
    csrc = args.csrc.resolve()
    out_dir = _build.BUILD_DIR / "ablate_stem" / re.sub(r"\W+", "_", str(csrc))
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(args.variants)) as ex:
        built = dict(zip(args.variants, ex.map(lambda n: build(n, csrc, out_dir), args.variants)))
    print(f"[source] {csrc / 'stem.cu'}")
    for name, (_, report) in built.items():  # the real kernel's registers and spills; every variant's warnings
        for line in report:
            if name == "full" or "Performance Loss" in line:
                print(f"[ptxas] {line}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {name: bind(ctypes.CDLL(str(path))) for name, (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for scale in args.widths:
        c0, c1 = WIDTHS[scale]
        g = torch.Generator().manual_seed(0)
        w0 = stem_weight_layout(((torch.rand(c0, 3, 3, 3, generator=g) - 0.5) * 0.6 / 255).to(dev))
        b0 = (torch.rand(c0, generator=g) - 0.5).to(dev)
        w1 = stem_weight_layout(((torch.rand(c1, c0, 3, 3, generator=g) - 0.5) * 1.2 / c0 ** 0.5).to(dev))
        b1 = (torch.rand(c1, generator=g) - 0.5).to(dev)
        img = torch.randint(0, 256, (16, 640, 640, 3), generator=g, dtype=torch.uint8).to(dev)
        inputs = {"uint8": (img, w0), "bfloat16": ((img.float() / 255).bfloat16(), stem_weight_layout(w0 * 255))}
        for form in args.forms:
            entry, in_dtype, out_dtype = FORMS[form]
            x, w0x = inputs[in_dtype]
            out = torch.empty(16, 160, 160, c1, device=dev, dtype=getattr(torch, out_dtype))
            times = {name: [] for name in libs}
            for _ in range(2):
                for name, lib in libs.items():
                    bank_entry, bank_size, unit = lib.banks[out_dtype]
                    bank = torch.empty(getattr(lib, bank_size)(c0, c1) * unit, dtype=torch.uint8, device=dev)
                    if getattr(lib, bank_entry)(w1.data_ptr(), bank.data_ptr(), c0, c1, stream):
                        raise RuntimeError(f"variant {name!r}: the bank kernel failed to launch")

                    def run(lib=lib, bank=bank):
                        if getattr(lib, entry)(x.data_ptr(), w0x.data_ptr(), b0.data_ptr(), bank.data_ptr(),
                                               b1.data_ptr(), out.data_ptr(), 16, 640, 640, c0, c1, stream):
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
            print(f"[{c0}/{c1}] {form}, B=16 640x640, ms (two rounds): "
                  + "; ".join(f"{name} {t[0]:.4f}, {t[1]:.4f}" for name, t in times.items()), flush=True)


if __name__ == "__main__":
    main()
