#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``scenedepthestimation_tpu_torch``)
on one NVIDIA GPU: builds the hand-written kernels, holds each against
its plain PyTorch version, drives mono and stereo inference and the
server end to end, and checks the results against the same weights run
on the CPU.

    python3 chip_smoke.py

Phases, one line each (more for the per-shape kernel checks):
  1. device: name and power limit from nvidia-smi, the TF32 flags;
  2. build: nvcc time (one nvcc per source, in parallel) and the library;
  3. kernels: conv3x3 at the 11 decoder shapes of mono_kitti_192x640_fp32
     in fp32 and bf16 (the calls with their weight slab made beforehand)
     and at off-path shapes in both (the zero border, 1-pixel H and W
     under every border, Cin 3, 20 and 96, Cout 1, 12, 32 and 256, odd W,
     inputs smaller than one tile, which split their channels),
     upsample_concat at its 4 shapes, each against its plain version on
     the card, with both times (CUDA events, median of 30 runs, L2 warm as
     in the decoder); at the fp32 shapes also the device time of a call
     (CUDA events queued behind a spin kernel, so the launch from Python
     lies outside them; the card's own launch latency lies inside), the
     kernel time and launches (torch.profiler: one a call), cuDNN's conv
     with bias, the
     bound and the share of it; two split fp32 calls in a row equal bit for
     bit, and a split call that grows the kept workspace; ptxas's lines for
     the conv3x3 kernels (the bf16 kernel's held to its registers and
     spills before its wgmma helpers moved to common.cuh, every fp32
     instantiation to 0 bytes of spill stores), and the tensor-core (HGMMA)
     instructions in its bf16 kernel's SASS; the fp32 calls' device times
     are taken after phase 4 (lines "[3 conv3x3 fp32 device]"), since a
     profiler session can slow later host launches and phase 4 times
     host-bound b1 frames;
  4. end to end: load_weights(None, seed 0) + predict_mono on 375x1242
     frames, plain and with post_process: launch counts, shapes, finite
     values, agreement with the CPU run of the same weights, ms/frame of
     the kernel path (median, p90 and mean over 100 frames, twice; before
     any profiler session of the process) and of the all-plain path on the
     card, and a profile of mono_forward (kernel
     launches a forward, 11 of them conv3x3 kernels, none conv3x3_reduce;
     device time; busy share);
  5. serving: 4 PNG frames through serve.serve_requests (depth=3);
  6. stereo kernels: correlation at stereo_256x512_b4's (4, 64, 128, 64)
     D=48 in fp32 and bf16 on the tower's interleaved halves (as
     split_pair hands them over: views, batch stride 2*H*W*C), with its
     tile plan, its ptxas lines (0 bytes of spill stores) and, in fp32,
     its device time (CUDA events queued behind a spin kernel), kernel
     time and launches (torch.profiler: one a call) and the share of its
     bound; plus off-path shapes (D = 1, W below one segment, two D tiles,
     C = 5, views off 16 bytes, contiguous tensors), soft_argmin at its
     (4, 64, 128, 48) x4 (with its device time and bound) plus other D
     (1, 7, 12, 24, 200, 512), a bf16 cost, costs spread over +-1e3, a
     temperature and the depth epilogue, upsample_concat at the
     aggregation's 3 joins; each against its plain version, with both
     times;
  7. stereo end to end: load_weights(None, "stereo_256x512_b4", seed 0) +
     predict_stereo on a batch of 4 uint8 375x1242 pairs: launch counts,
     shapes, finite values, agreement with the CPU run of the same
     weights, and ms/batch of the kernel path and the all-plain path;
     then one forward's copy kernels and its aten::copy_ calls on a view's
     feature shape, which must be none (split_pair copies nothing);
  8. stereo serving: 2 PNG pairs through serve.serve_requests;
  9. bf16 stereo kernels: correlation_gram (the banded-Gram tensor-core
     kernel) at stereo_kitti2015_b16_bf16_v5e8's (16, 96, 288, 64) D=48,
     _c128's C=128 and latency_d96's (2, 96, 288, 64) D=24 on the tower's
     interleaved halves, with the tile plan, each against its plain
     version, timed in turns with its plain version and with the
     correlation kernel on the same bf16 inputs, with the device time,
     kernel time and launches and the share of the bound; ragged shapes
     (D = 1, W below one tile, D > 64, C = 5, views off 16 bytes,
     contiguous tensors); its ptxas lines; upsample_concat at config 5's three bf16 joins and soft_argmin
     at its (16, 96, 288, 48) x4 (with its device time and bound), against
     their plain versions;
 10. bf16 stereo end to end: load_weights(None, config 5, seed 0) +
     predict_stereo on 16 uint8 375x1242 pairs on one card: launch counts
     (1 correlation_gram, no correlation), device ms per forward (CUDA
     events), host ms per batch, peak memory, a profile of the device
     time by kernel, the forward's copy kernels and its aten::copy_ calls
     on a view's feature shape (none), agreement with a CPU bf16 run of the same weights at
     b2, the depth abs-rel of bf16 against the card's fp32 run of the same
     weights (seeded, and with the cost head x20 so the readout is
     peaked); latency_d96 at b2 once;
 11. bf16 stereo serving: 2 PNG pairs through serve.serve_requests;
 12. fused tail kernel: fused_tail at mono_kitti_384x1152_bench's level 0
     (128, 192, 576, 32) -> (128, 384, 1152, 16) in bf16, config 1's
     (1, 96, 320, 32) in fp32 and bf16, ragged shapes (h = 2, odd w, C
     not a multiple of 8) and wide C1 in bf16 (96 and 160: 8-row tiles,
     y0 staged and unstaged), each against its plain version, and the
     refusal of a C1 too wide for shared memory; at the first three, its
     time (bf16: with the weights arranged beforehand, the arrangement
     timed apart) beside the plain version's, the port's
     unfused chain's (conv3x3, upsample2x, conv3x3) and a three-stage cuDNN
     chain's, its bound and share of it, and its ptxas lines;
 13. the judged bench path: benchmark.run_bench("mono_kitti_384x1152_bench")
     (b128, bf16, 384x1152) with the fused tail on, off, on: frames/s,
     launches per forward (on: 1 fused_tail, 9 conv3x3, 4 upsample_concat;
     off: 11 conv3x3), peak memory, a profile of one b128 forward by kernel,
     each kernel call of one b128 forward (9 conv3x3, 4 upsample_concat,
     the fused tail; and the unfused level 0's 2 conv3x3) on the inputs
     that forward gave it against its plain version, with the kernel's,
     the plain version's and cuDNN's times, the bound and the share of it
     (conv3x3 with the slab its module made, the fused tail with the slab
     its decoder keeps; the arrangements timed apart),
     agreement with a CPU bf16 run at b2, and the depth abs-rel of bf16
     against the card's fp32 run (seeded weights at b128, the reference's
     seed-0 weights at b8);
 14. bench.py's line for the port: frames/s with parity_abs_rel in fp32
     (<= 1e-4) and bf16 (<= 1e-3);
 15. Winograd kernel (kernel 5): winograd_conv3x3_phases on each of the 13
     stride-1 BasicBlock convs of one b128 bf16 folded bench forward, on the
     inputs that forward gave it (captured as in phase 13) with each
     weight's kept U, at config 1's four stage shapes in fp32 with and
     without the residual, and at off-path shapes (C, Co off 16 and below
     8, odd Co, ragged tile counts) in both dtypes, each against its plain
     version; the kernel's time beside the earlier design's, the plain
     version's, cuDNN's conv with bias and cuDNN's three-call chain (conv
     with bias, residual add, ReLU), the bound and the share of it, the
     time to make U, the ptxas lines and the tensor-core (HMMA) count in
     the bf16 kernel's SASS;
 16. the folded path: run_bench with fold_bn off and on at b128 (frames/s,
     launches); on seeded weights with random BatchNorm terms, the folded
     fp32 encoder against the unfolded one, the bf16 folded encoder on cuDNN
     and on kernel 5 (its 13 stride-1 convs swapped onto the kernel, here
     only, each weight's U kept: no weight transform after the first
     forward) against the fp32 folded encoder, and each one's depth
     abs-rel against the card's fp32 folded run at b128 (<= 2.5e-3), with
     each route's device ms per forward; a profile of a folded b128
     forward; parity_abs_rel with fold_bn in fp32 (<= 1e-4) and bf16
     (<= 1e-3);
 17. repairs: mono_kitti_192x640_fp32 with mono.fast_borders (every
     decoder conv zero-bordered, fused tail off) on 375x1242 frames
     against a CPU run of the same weights; run_bench with fast_borders and
     the fused tail on, beside the reflect run, in turns (fast, reflect,
     fast); load_weights of one .pth file against the directory form of
     the same weights (the reference's seed-0 weights), equal on the card.
Then one JSON line of per-kernel results (with each kernel's bound on
this card and, where one PyTorch call computes the same function, that
call's time) and, last, the ok line.

Fails (non-zero exit, no ok line) when CUDA is absent, the package is
not beside this script, a kernel does not build, launch or agree, or any
check fails. Nothing is caught.

    python3 chip_smoke.py --measure [ROOT] [FRAMES]

times the package under ROOT (default: beside this script), so that a
change and its parent (a ``git archive`` of it) are measured by the same
code in turns in one session: mono_kitti_192x640_fp32's b1 ms/frame over
FRAMES (default 200) synced predict_mono calls (median, p90, mean; before
any profiler session of the process), then conv3x3 at its 11 fp32 shapes
(the kernel against its plain version, the call time, the device time by
queued events and the launches of a call, as phase 3 takes them), the
correlation kernel at config 4's shape and correlation_gram at config
5's, _c128's and latency_d96's, on contiguous tensors (call, device and
kernel ms), and config 4's b4 and
config 5's b16 stereo forwards (device ms by CUDA events, three times,
before any profiler session; the copy kernels of a forward and its
aten::copy_ calls on a view's feature shape); one JSON line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONFIG = "mono_kitti_192x640_fp32"
SRC_HW = (375, 1242)
RUNS = 30

# (layer, H, W, Cin, Cout, activation, out_dtype) of mono_kitti_192x640_fp32
# at batch 1: the 10 decoder ConvBlocks and the scale-0 head.
CONV_SHAPES = [
    ("upconv_4_0", 6, 20, 512, 256, "elu", None),
    ("upconv_4_1", 12, 40, 512, 256, "elu", None),
    ("upconv_3_0", 12, 40, 256, 128, "elu", None),
    ("upconv_3_1", 24, 80, 256, 128, "elu", None),
    ("upconv_2_0", 24, 80, 128, 64, "elu", None),
    ("upconv_2_1", 48, 160, 128, 64, "elu", None),
    ("upconv_1_0", 48, 160, 64, 32, "elu", None),
    ("upconv_1_1", 96, 320, 96, 32, "elu", None),
    ("upconv_0_0", 96, 320, 32, 16, "elu", None),
    ("upconv_0_1", 192, 640, 16, 16, "elu", None),
    ("dispconv_0", 192, 640, 16, 1, "sigmoid", torch.float32),
]
# (level, H, W, C1, C2): x (1, H, W, C1) joined with skip (1, 2H, 2W, C2).
UPCAT_SHAPES = [
    ("level_4", 6, 20, 256, 256),
    ("level_3", 12, 40, 128, 128),
    ("level_2", 24, 80, 64, 64),
    ("level_1", 48, 160, 32, 64),
]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke FAILED: {msg}")


def time_ms(fn, runs: int = RUNS, warmup: int = 3) -> float:
    """Median time of one call between CUDA events recorded around it on
    the stream; for a small kernel the launch from Python is inside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s and operations/s
# by type. The fp32 kernels run on the CUDA cores, the bf16 Gram on the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12}


def bound_ms(nbytes: float, ops: float, kind: str):
    """The least time the card could take, ms: the larger of the bytes over
    the memory rate and the operations over the peak rate of ``kind``;
    with the name of the one that binds."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def add_bound(r: dict, nbytes: float, ops: float, kind: str) -> None:
    """Adds one call's bound to a kernel's running sums."""
    t, by = bound_ms(nbytes, ops, kind)
    r["bound_ms"] = r.get("bound_ms", 0.0) + t
    r.setdefault("bound_parts", {}).setdefault(by, 0.0)
    r["bound_parts"][by] += t


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    # fp32 comparisons need full fp32 in cuDNN and matmuls (no TF32).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi)
    print(f"[1 device] nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()} | "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def phase_build(_build) -> None:
    path = _build.build()
    _build.lib()
    log = os.path.join(os.path.dirname(path), "nvcc.log")
    ptxas = ""
    if os.path.exists(log):
        with open(log) as f:
            text = f.read()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
        ptxas = (f" | ptxas: {len(regs)} kernels, max {max(regs, default=0)} "
                 f"registers, {sum(spills)} bytes of spill stores")
        ptxas += " | " + ptxas_report(text, "correlation_gram_kernel", static_smem=False)
    print(f"[2 build] {_build.build_seconds:.1f} s -> {path}{ptxas}")


def ptxas_report(text: str, kernel: str, static_smem: bool = True) -> str:
    """What ptxas reported in nvcc.log for the first entry function whose
    name holds ``kernel``: registers, static shared memory, spill stores.
    A kernel with ``static_smem`` must report its shared memory; one that
    takes only dynamic shared memory may report none."""
    at = text.find(kernel)
    report = text[at:at + 600]
    regs, smem, spills = (re.search(pat, report) for pat in (
        r"Used (\d+) registers", r"(\d+) bytes smem", r"(\d+) bytes spill stores"))
    check(at >= 0 and regs is not None and spills is not None
          and (smem is not None or not static_smem),
          f"no ptxas report for {kernel} in nvcc.log")
    return (f"{kernel}: {regs.group(1)} registers, {smem.group(1) if smem else 0} bytes of "
            f"static shared memory, {spills.group(1)} bytes of spill stores")


def _rand(rng, shape, scale, dtype):
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return t.to("cuda").to(dtype)


def _conv_case(conv_block, rng, shape, act, border, dtype, out_dtype):
    """One conv3x3 kernel call against its plain version on the card."""
    b, h, w, cin, cout = shape
    x = _rand(rng, (b, h, w, cin), 1.0, dtype)
    wt = _rand(rng, (cout, cin, 3, 3), (9 * cin) ** -0.5, dtype)
    bias = _rand(rng, (cout,), 0.1, dtype)
    args = (x, wt, bias, act, border, out_dtype)
    got = conv_block.conv3x3(*args)
    ref = conv_block.conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        # fp32 accumulation in another order than cuDNN's.
        tol = "atol 1e-4 + rtol 1e-4"
        ok = bool((err <= 1e-4 + 1e-4 * ref.float().abs()).all())
    else:
        # One bf16 rounding of the output: 2^-8 relative.
        ref_max = ref.float().abs().max().item()
        tol = f"1e-2 x max|ref| = {1e-2 * ref_max:.3g}"
        ok = err.max().item() <= 1e-2 * ref_max
    return args, err.max().item(), tol, ok


def _conv_library_ms(x, wt, bias, runs: int = RUNS) -> float:
    """cuDNN's conv with bias (F.conv2d, channels-last) on the same input
    with its reflect border padded beforehand: the convolution of the
    conv3x3 kernel without its activation."""
    import torch.nn.functional as F

    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    xp = xp.contiguous(memory_format=torch.channels_last)
    wc = wt.contiguous(memory_format=torch.channels_last)
    return time_ms(lambda: F.conv2d(xp, wc, bias), runs=runs)


def _upcat_bytes(x, skip) -> int:
    """upsample_concat reads x and skip once and writes 4|x| + |skip|."""
    return 5 * nbytes(x) + 2 * nbytes(skip)


def _upcat_case(upcat, rng, shape, dtype):
    b, h, w, c1, c2 = shape
    x = _rand(rng, (b, h, w, c1), 1.0, dtype)
    skip = _rand(rng, (b, 2 * h, 2 * w, c2), 1.0, dtype)
    got = upcat.upsample_concat(x, skip)
    ref = upcat.upsample_concat_plain(x, skip)
    torch.cuda.synchronize()
    return (x, skip), (got.float() - ref.float()).abs().max().item()


# Shapes off the main path: ragged tiles, Cin off the 16-channel chunk,
# split input channels with a short last slice, the edge border, other
# activations, batch > 1, and the scalar (unaligned) upsample_concat path.
EXTRA_CONV = [
    ((2, 7, 13, 3, 5), "relu", "edge", None),
    ((1, 9, 33, 24, 48), "none", "reflect", None),
    ((1, 5, 6, 200, 96), "elu", "reflect", None),
    ((3, 17, 31, 40, 17), "elu", "edge", None),
    ((1, 2, 2, 64, 1), "sigmoid", "reflect", torch.float32),
    # The zero border (Cin 96 -> Cout 256 and Cin 20 -> Cout 12 at odd W,
    # the Cout = 1 head kernel), 1-pixel H and W under every border, and
    # inputs smaller than one tile, which split their input channels.
    ((2, 11, 37, 96, 256), "elu", "zero", None),
    ((1, 9, 33, 20, 12), "none", "zero", None),
    ((2, 13, 19, 16, 1), "sigmoid", "zero", torch.float32),
    *[((2, h, w, 20, 32), "elu", border, None)
      for border in ("reflect", "edge", "zero") for h, w in ((1, 9), (9, 1), (1, 1))],
    ((1, 1, 7, 16, 1), "sigmoid", "reflect", torch.float32),
    ((1, 3, 5, 256, 32), "elu", "reflect", None),
    ((2, 4, 4, 96, 256), "relu", "zero", None),
]
EXTRA_UPCAT = [(2, 3, 5, 3, 5), (1, 4, 6, 8, 4), (2, 5, 3, 16, 24)]

STEREO_CONFIG = "stereo_256x512_b4"
STEREO_B = 4
# Card vs CPU on the same weights, stereo disparity in px at 375x1242:
# measured 1.07e-4 px on an NVIDIA H100 80GB HBM3 at 700 W (fp32 sums in
# other orders, on disparities near 228 px whose fp32 spacing is 1.5e-5).
STEREO_DISP_ATOL = 5e-4
# stereo_256x512_b4 at batch 4: the feature grid, its channels and D; the
# main path hands the kernel the tower's interleaved halves.
CORR_MAIN = (4, 64, 128, 64, 48)
# (shape, layout): ragged W segment, D > W, the c128 preset's C = 128 at
# W = 288, odd B*H; D = 1; W below one segment; D = 100 (two D tiles) and
# C = 5 with D = 70; views off 16 bytes (the scalar staging path); the
# main shape as two contiguous tensors and ragged interleaved halves.
CORR_EXTRA = [((2, 3, 37, 24, 12), "contiguous"), ((1, 2, 8, 16, 12), "contiguous"),
              ((1, 2, 288, 128, 48), "contiguous"), ((1, 3, 70, 64, 48), "contiguous"),
              ((1, 3, 37, 16, 1), "contiguous"), ((1, 2, 40, 64, 48), "contiguous"),
              ((1, 3, 130, 16, 100), "contiguous"), ((1, 2, 37, 5, 70), "contiguous"),
              ((2, 3, 37, 24, 12), "misaligned"), ((1, 3, 70, 64, 48), "misaligned"),
              ((4, 64, 128, 64, 48), "contiguous"), ((3, 5, 70, 64, 48), "interleaved")]
SOFT_ARGMIN_MAIN = ((4, 64, 128, 48), 4.0)
# (shape, scale, temperature, epilogue, cost dtype, cost spread): the d96
# preset's D = 24, D = 12, a temperature of 0.5, the depth epilogue at
# KITTI's f*B; D = 1 and 7 (rows off 16 bytes: the looped path, in bf16
# too), D = 200 (16 lanes a pixel) and 512 (32); costs spread over +-1e3,
# where exp underflows without the max subtracted.
SOFT_ARGMIN_EXTRA = [
    ((2, 96, 288, 24), 4.0, 1.0, "none", torch.float32, 2.0),
    ((1, 3, 37, 12), 1.0, 1.0, "none", torch.float32, 2.0),
    ((4, 64, 128, 48), 4.0, 0.5, "none", torch.float32, 2.0),
    ((4, 64, 128, 48), 4.0, 1.0, "depth", torch.float32, 2.0),
    ((2, 9, 17, 1), 4.0, 1.0, "none", torch.float32, 2.0),
    ((2, 9, 17, 7), 4.0, 1.0, "none", torch.float32, 2.0),
    ((2, 9, 17, 7), 4.0, 1.0, "none", torch.bfloat16, 2.0),
    ((1, 8, 33, 200), 4.0, 1.0, "none", torch.float32, 2.0),
    ((3, 5, 7, 512), 4.0, 1.0, "none", torch.float32, 2.0),
    ((4, 64, 128, 48), 4.0, 1.0, "none", torch.float32, 1e3),
    ((1, 8, 33, 200), 4.0, 1.0, "none", torch.float32, 1e3),
]
FB = 721.5377 * 0.54
# soft_argmin's operations per cost element: subtract the max, exp, and
# two multiply-adds (the sum and the weighted sum).
SOFT_ARGMIN_OPS = 4
# (join, H, W, C1, C2) of the aggregation at batch 4: x (4, H, W, C1)
# joined with skip (4, 2H, 2W, C2).
STEREO_UPCAT_SHAPES = [
    ("dec2", 8, 16, 160, 128),
    ("dec1", 16, 32, 128, 96),
    ("dec0", 32, 64, 96, 64),
]


def ptxas_lines(text: str, kernel: str) -> list:
    """ptxas's registers and spill stores for every instantiation of the
    entry functions whose name holds ``kernel``: [(template arguments as
    mangled, registers, spill bytes)]."""
    out = []
    for m in re.finditer(rf"Compiling entry function '(\S*{kernel}\S*)'", text):
        report = text[m.end():m.end() + 600]
        regs = re.search(r"Used (\d+) registers", report)
        spills = re.search(r"(\d+) bytes spill stores", report)
        check(regs is not None and spills is not None, f"no ptxas report for {m.group(1)}")
        args = m.group(1).split(kernel, 1)[1]
        out.append((args, int(regs.group(1)), int(spills.group(1))))
    check(bool(out), f"no ptxas report for {kernel} in nvcc.log")
    return out


def sass_counts(_build, kernel: str, op: str) -> dict:
    """How many ``op`` instructions the SASS of each entry function whose
    name holds ``kernel`` has, as cuobjdump (beside nvcc) disassembles the
    built library."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.library_path()], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if kernel in name:
            counts[name] = block.count(op)
    return counts


# ptxas's (registers, spill bytes) for the 16 conv3x3_tc_kernel instantiations
# in build order, as built with its wgmma helpers in conv_block.cu, before
# they moved to common.cuh (nvcc 12.9 for sm_90a): the move must leave them
# as they were.
CONV_TC_PTXAS = [(128, 0), (128, 0), (128, 0), (120, 0), (128, 44), (128, 12), (110, 0), (98, 0)] * 2


def _workspace_elems(conv_block) -> int:
    """Elements of the fp32 workspace the conv3x3 wrapper keeps for this
    device and stream (0 before any split call)."""
    key = (0, conv_block._build.stream_of(torch.empty(0, device="cuda")))
    store = conv_block._SCRATCH.get(key, [None, None])
    return 0 if store[0] is None else store[0].numel()


def phase_kernels(conv_block, upcat) -> dict:
    rng = np.random.default_rng(0)
    with open(os.path.join(os.path.dirname(conv_block._build.library_path()), "nvcc.log")) as f:
        text = f.read()
    for kernel in ("conv3x3_tc_kernel", "conv3x3_head_kernel", "conv3x3_f32_kernel"):
        print(f"[3 conv3x3 ptxas] {kernel}: " + "; ".join(
            f"{a} {r} registers, {sp} bytes of spill stores" for a, r, sp in ptxas_lines(text, kernel)))
    tc_ptxas = [(r, sp) for _, r, sp in ptxas_lines(text, "conv3x3_tc_kernel")]
    check(tc_ptxas == CONV_TC_PTXAS,
          f"conv3x3_tc_kernel ptxas lines {tc_ptxas} differ from {CONV_TC_PTXAS}")
    print("[3 conv3x3 ptxas] conv3x3_tc_kernel: registers and spill stores of all 16 "
          "instantiations as before the wgmma helpers moved to common.cuh")
    # Every fp32 instantiation: the body's four tiles and the head's two
    # (mangled template arguments "Iff": fp32 in, fp32 out).
    f32 = ptxas_lines(text, "conv3x3_f32_kernel") + [
        line for line in ptxas_lines(text, "conv3x3_head_kernel") if line[0].startswith("Iff")]
    check(len(f32) == 6 and all(sp == 0 for _, _, sp in f32),
          f"fp32 conv3x3 instantiations with spill stores (or missing): {f32}")
    print(f"[3 conv3x3 ptxas] fp32: {len(f32)} instantiations, 0 bytes of spill stores each")
    # The bf16 path's products are tensor-core instructions in the SASS.
    hgmma = sass_counts(conv_block._build, "conv3x3_tc_kernel", "HGMMA")
    check(len(hgmma) == 16 and min(hgmma.values()) > 0,
          f"conv3x3_tc_kernel instantiations without HGMMA in their SASS: {hgmma}")
    print(f"[3 conv3x3 sass] conv3x3_tc_kernel: {len(hgmma)} instantiations, "
          f"{min(hgmma.values())}-{max(hgmma.values())} HGMMA instructions each")
    res = {"conv3x3": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0},
           "upsample_concat": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}}
    f32_calls = []  # (shape, args, slab, bound ms): timed by phase_conv_device
    grown = []  # (shape, workspace elements before, after) where a call grew it
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        for name, h, w, cin, cout, act, out_dtype in CONV_SHAPES:
            before = _workspace_elems(conv_block)
            args, err, tol, ok = _conv_case(
                conv_block, rng, (1, h, w, cin, cout), act, "reflect", dtype, out_dtype)
            if 0 < before < _workspace_elems(conv_block) and dtype == torch.float32:
                grown.append((name, before, _workspace_elems(conv_block)))
            x, wt = args[:2]
            slab = conv_block.arrange_slab(wt) if conv_block.uses_slab(x, cout) else None
            ms = time_ms(lambda: conv_block.conv3x3(*args, slab=slab))
            plain_ms = time_ms(lambda: conv_block.conv3x3_plain(*args))
            splits = conv_block.split_plan(1, h, w, cin, cout, dtype, 0)[0]
            line = (f"[3 conv3x3 {dt}] {name} {h}x{w} {cin}->{cout} {act} "
                    f"(splits {splits}): max|err| {err:.3g} ({tol}) kernel "
                    f"{ms:.4f} ms plain {plain_ms:.4f} ms")
            if dtype == torch.float32:
                r = res["conv3x3"]
                r["err"] = max(r["err"], err)
                r["ms"] += ms
                r["plain_ms"] += plain_ms
                x, wt, bias = args[:3]
                out_bytes = h * w * cout * 4  # fp32 out, the head's too
                one = {}
                add_bound(one, nbytes(x, wt, bias) + out_bytes, 2 * 9 * h * w * cin * cout, "fp32")
                add_bound(r, nbytes(x, wt, bias) + out_bytes, 2 * 9 * h * w * cin * cout, "fp32")
                lib_ms = _conv_library_ms(x, wt, bias)
                r["library_ms"] += lib_ms
                line += (f" | cuDNN conv + bias {lib_ms:.4f} ms, bound {one['bound_ms']:.5f} ms "
                         f"({max(one['bound_parts'], key=one['bound_parts'].get)})")
                f32_calls.append((name, args, slab, one["bound_ms"]))
            print(line)
            check(ok, f"conv3x3 {dt} {name} disagrees with its plain version")
        if dtype == torch.float32:
            r = res["conv3x3"]
            r["f32_calls"] = f32_calls
            print(f"[3 conv3x3 fp32] the {len(CONV_SHAPES)} shapes: kernel {r['ms']:.4f} ms by "
                  f"call; plain {r['plain_ms']:.4f} ms; cuDNN conv + bias "
                  f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms")
            # Two split calls in a row give the same bits: the tile counters
            # are back at 0 after each.
            name, h, w, cin, cout, act, out_dtype = CONV_SHAPES[0]
            args, _, _, _ = _conv_case(
                conv_block, rng, (1, h, w, cin, cout), act, "reflect", dtype, out_dtype)
            slab = conv_block.arrange_slab(args[1])
            first = conv_block.conv3x3(*args, slab=slab)
            again = conv_block.conv3x3(*args, slab=slab)
            check(torch.equal(first, again), f"two split calls at {name} differ")
            print(f"[3 conv3x3 fp32] {name}: two calls in a row with "
                  f"{conv_block.split_plan(1, h, w, cin, cout, dtype, 0)[0]} slices give the same bits")
            # A split call that needs more slices than the kept workspace
            # holds grows it (the store is made by the first split call).
            check(bool(grown), "no fp32 call grew the kept workspace")
            print("[3 conv3x3 fp32] calls that grew the kept workspace (elements before -> "
                  "after): " + ", ".join(f"{n} {b_} -> {a_}" for n, b_, a_ in grown))
        for shape, act, border, out_dtype in EXTRA_CONV:
            _, err, tol, ok = _conv_case(
                conv_block, rng, shape, act, border, dtype, out_dtype)
            splits = conv_block.split_plan(*shape, dtype, 0)[0]
            print(f"[3 conv3x3 {dt} extra] {shape} {act} {border} (splits "
                  f"{splits}): max|err| {err:.3g} ({tol})")
            check(ok, f"conv3x3 {dt} {shape} disagrees with its plain version")
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        for name, h, w, c1, c2 in UPCAT_SHAPES:
            args, err = _upcat_case(upcat, rng, (1, h, w, c1, c2), dtype)
            ms = time_ms(lambda: upcat.upsample_concat(*args))
            plain_ms = time_ms(lambda: upcat.upsample_concat_plain(*args))
            print(f"[3 upsample_concat {dt}] {name} {h}x{w} {c1}+{c2}: "
                  f"max|err| {err:.3g} (exact) kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} ms")
            check(err == 0.0, f"upsample_concat {dt} {name} is not exact")
            if dtype == torch.float32:
                r = res["upsample_concat"]
                r["err"] = max(r["err"], err)
                r["ms"] += ms
                r["plain_ms"] += plain_ms
                add_bound(r, _upcat_bytes(*args), 0, "fp32")
        for shape in EXTRA_UPCAT:
            _, err = _upcat_case(upcat, rng, shape, dtype)
            print(f"[3 upsample_concat {dt} extra] {shape}: max|err| {err:.3g} (exact)")
            check(err == 0.0, f"upsample_concat {dt} {shape} is not exact")
    return res


def phase_conv_device(conv_block, r: dict) -> None:
    """Phase 3's fp32 calls again, for their device time (CUDA events queued
    behind a spin kernel) and, over all of them in one torch.profiler
    window, their launches: one a call. It runs after phase 4: a profiler
    session can leave later launches slower on the host, and phase 4 times
    host-bound b1 frames."""
    calls = r.pop("f32_calls")
    total = 0.0
    for name, args, slab, bound in calls:
        dev_ms = _queued_ms(lambda: conv_block.conv3x3(*args, slab=slab))
        total += dev_ms
        print(f"[3 conv3x3 fp32 device] {name}: {dev_ms:.4f} ms (the card's launch latency "
              f"included), {100 * bound / dev_ms:.1f}% of the bound {bound:.5f} ms")
    kernel_ms, launches = _kernel_time(
        lambda: [conv_block.conv3x3(*args, slab=slab) for _, args, slab, _ in calls])
    check(launches == len(calls), f"the {len(calls)} fp32 calls launched {launches} kernels")
    r["device_ms"] = total
    print(f"[3 conv3x3 fp32 device] the {len(calls)} shapes: {total:.4f} ms by events queued "
          f"behind a spin kernel, {100 * r['bound_ms'] / total:.1f}% of the bound "
          f"{r['bound_ms']:.4f} ms; by torch.profiler {kernel_ms:.4f} ms of kernel time in "
          f"{launches} launches ({100 * r['bound_ms'] / kernel_ms:.1f}%)")


def on_plain_path(_build, measure, *wrappers):
    """measure() with each (module, name) kernel wrapper swapped for its
    plain version, which must launch no kernel; the wrappers come back
    afterwards."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in wrappers]
    for mod, name, _ in saved:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        _build.LAUNCHES.clear()
        out = measure()
        check(not _build.LAUNCHES, "plain path launched a kernel")
        return out
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _host_ms(predict, n: int) -> float:
    """Host-clock ms per call of ``predict``, which ends in a device->host
    copy and so is synced."""
    predict()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        predict()
    return (time.perf_counter() - t0) * 1e3 / n


def _ms_per_frame(sdt, p, frame) -> float:
    return _host_ms(lambda: sdt.predict_mono(p, frame), 20)


# b1 frames timed one by one on the host clock for the latency percentiles.
LATENCY_FRAMES = 100


def _frame_ms(sdt, p, frame, n: int = LATENCY_FRAMES) -> list:
    """Host-clock ms of each of n predict_mono calls (each ends in a
    device->host copy, so it is synced), after one to warm up."""
    sdt.predict_mono(p, frame)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        sdt.predict_mono(p, frame)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_end_to_end(sdt, _build, conv_block, upcat) -> dict:
    frame = np.random.default_rng(0).integers(0, 256, SRC_HW + (3,), dtype=np.uint8)
    p = sdt.load_weights(None, CONFIG, seed=0, device="cuda")
    check(not torch.backends.cudnn.allow_tf32, "TF32 still on for an fp32 preset")
    sdt.predict_mono(p, frame)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    _build.LAUNCHES.clear()
    out = sdt.predict_mono(p, frame)
    launches = dict(_build.LAUNCHES)
    check(launches == {"conv3x3": 11, "upsample_concat": 4},
          f"expected 11 conv3x3 + 4 upsample_concat launches, got {launches}")
    _build.LAUNCHES.clear()
    out_pp = sdt.predict_mono(p, frame, post_process=True)
    launches_pp = dict(_build.LAUNCHES)
    check(launches_pp == launches, f"post_process launches {launches_pp}")

    # Against the same weights through the plain versions on the CPU. The
    # disp tolerance is in the network's sigmoid units: the API's 'disp' is
    # 1/max_depth + (1/min_depth - 1/max_depth) * sigmoid, 9.99x larger,
    # and an fp32 CPU run of this net already departs from an fp64 run by
    # 6.8e-5 in those units (6.8e-6 in sigmoid units).
    p_cpu = sdt.load_weights(None, CONFIG, seed=0, device="cpu")
    mono = p_cpu.cfg.mono
    lo, hi = 1.0 / mono.max_depth, 1.0 / mono.min_depth
    errs = []
    for tag, got, ref in (
        ("plain", out, sdt.predict_mono(p_cpu, frame)),
        ("post_process", out_pp, sdt.predict_mono(p_cpu, frame, post_process=True)),
    ):
        for k in ("disp", "depth"):
            check(got[k].shape == SRC_HW, f"{tag} {k} shape {got[k].shape}")
            check(bool(np.isfinite(got[k]).all()), f"{tag} {k} not finite")
        d_err = float(np.abs(got["disp"] - ref["disp"]).max())
        s_err = d_err / (hi - lo)
        z_rel = float((np.abs(got["depth"] - ref["depth"]) / np.abs(ref["depth"])).max())
        errs.append((tag, d_err, s_err, z_rel))
        check(s_err <= 1e-5, f"{tag} sigmoid disp vs CPU max|err| {s_err:.3g} > 1e-5")
        check(z_rel <= 1e-4, f"{tag} depth vs CPU max rel err {z_rel:.3g} > 1e-4")

    # Kernel path vs all-plain path on the card, in turns (ABBA); the kernel
    # path frame by frame for its median and p90.
    def plain_ms() -> float:
        return on_plain_path(_build, lambda: _ms_per_frame(sdt, p, frame),
                             (conv_block, "conv3x3"), (upcat, "upsample_concat"))

    k1 = _frame_ms(sdt, p, frame)
    p1 = plain_ms()
    p2 = plain_ms()
    k2 = _frame_ms(sdt, p, frame)
    lat = "; ".join(f"median {np.median(k):.3f}, p90 {np.percentile(k, 90):.3f}, mean "
                    f"{np.mean(k):.3f}" for k in (k1, k2))

    # One forward on the card's own input, by torch.profiler: its launches,
    # the conv3x3 kernels among them (one a call: no conv3x3_reduce), and
    # the device's busy share.
    img = torch.from_numpy(frame[None]).cuda()
    st = _profile_stats(lambda: p.mono_forward(img), n=5)
    per_fwd = {name: k / 5 for name, (_, k) in st["by_name"].items()}
    # Rounded: the profiler now and then drops an event.
    conv_kernels = round(sum(k for name, k in per_fwd.items() if "conv3x3" in name))
    check(conv_kernels == 11 and not any("conv3x3_reduce" in name for name in per_fwd),
          f"config 1 forward: {conv_kernels} conv3x3 kernel launches (want 11, one a call): "
          f"{ {n: k for n, k in per_fwd.items() if 'conv3x3' in n} }")
    device_ms = sum(t for t, _ in st["by_name"].values()) / 5 / 1e3
    conv_ms = sum(t for name, (t, _) in st["by_name"].items() if "conv3x3" in name) / 5 / 1e3
    print(f"[4 end to end] {CONFIG} b1 {SRC_HW[0]}x{SRC_HW[1]} uint8 -> depth: "
          f"launches {launches} (post_process {launches_pp}); "
          + "; ".join(f"{t} vs CPU: disp max|err| {d:.3g} = sigmoid {s:.3g} "
                      f"(atol 1e-5), depth max rel {z:.3g} (rtol 1e-4)"
                      for t, d, s, z in errs)
          + f"; ms/frame kernel path over {LATENCY_FRAMES} frames, twice: {lat} | plain path "
          f"(mean of 20) {p1:.3f}, {p2:.3f} (host clock, H2D + D2H included); profiler of "
          f"mono_forward: {st['launches'] / 5:g} kernel launches a forward, {conv_kernels:g} of "
          f"them conv3x3 kernels ({conv_ms:.4f} ms), device time {device_ms:.3f} ms, busy "
          f"{st['busy']:.3f} of the kernels' span")
    return launches


def _pair(make, shape, layout):
    """Left and right (B, H, W, C) features from ``make(shape)`` in one of
    the layouts the kernels read: "interleaved", the two halves of a
    (2B, H, W, C) stack as split_pair gives them (the main path's layout);
    "contiguous", two tensors; "misaligned", views one element past a
    16-byte boundary (the kernels' scalar staging path)."""
    b, h, w, c = shape
    if layout == "interleaved":
        pair = make((2 * b, h, w, c)).view(b, 2, h, w, c)
        return pair[:, 0], pair[:, 1]
    if layout == "contiguous":
        return make(shape), make(shape)
    n = b * h * w * c
    flat = make((2 * n + 1,))
    return flat[1:n + 1].view(shape), flat[n + 1:].view(shape)


def _corr_case(corr, rng, shape, dtype, layout):
    """One correlation kernel call against its plain version on the card.
    fp32: atol 1e-5 + rtol 1e-5 (sums of C products in another order).
    bf16: one bf16 rounding of either side, 2^-7 x |ref| + 1e-6."""
    b, h, w, c, d = shape
    fl, fr = _pair(lambda sh: _rand(rng, sh, 1.0, dtype), (b, h, w, c), layout)
    got = corr.correlation(fl, fr, d)
    ref = corr.correlation_plain(fl, fr, d)
    torch.cuda.synchronize()
    check(got.dtype == dtype and tuple(got.shape) == (b, h, w, d), f"correlation {shape} {got.dtype}")
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        tol, bound = "atol 1e-5 + rtol 1e-5", 1e-5 + 1e-5 * ref.float().abs()
    else:
        tol, bound = "2^-7 x |ref| + 1e-6", 2.0 ** -7 * ref.float().abs() + 1e-6
    return (fl, fr, d), err.max().item(), tol, bool((err <= bound).all())


def _soft_argmin_case(sa_ops, sa, rng, shape, scale, temperature, epilogue, dtype=torch.float32,
                      spread=2.0):
    """One soft_argmin kernel call against its plain version on the card.
    Disparity: atol 1e-5 x scale + rtol 1e-5 (the kernel divides sums, the
    plain version sums a normalised softmax); depth: rtol 1e-5."""
    cost = _rand(rng, shape, spread, dtype)
    if epilogue == "depth":
        got = sa.soft_argmin(cost, scale=scale, epilogue="depth", fb=FB)
    else:
        got = sa_ops.soft_argmin(cost, temperature, scale=scale)
    ref = sa.soft_argmin_plain(cost / temperature, scale, epilogue, FB)
    torch.cuda.synchronize()
    check(got.dtype == torch.float32 and got.shape == ref.shape, f"soft_argmin {shape}")
    err = (got - ref).abs()
    atol = 0.0 if epilogue == "depth" else 1e-5 * scale
    ok = bool((err <= atol + 1e-5 * ref.abs()).all())
    return cost, err.max().item(), ok


def _stereo_joins(upcat, rng, tag, b, shapes, dtype) -> dict:
    """upsample_concat at an aggregation's three joins, each against its
    plain version (exact), with both times summed."""
    dt = "fp32" if dtype == torch.float32 else "bf16"
    r = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for name, h, w, c1, c2 in shapes:
        args, err = _upcat_case(upcat, rng, (b, h, w, c1, c2), dtype)
        ms = time_ms(lambda: upcat.upsample_concat(*args))
        plain_ms = time_ms(lambda: upcat.upsample_concat_plain(*args))
        print(f"[{tag} upsample_concat {dt}] {name} b{b} {h}x{w} {c1}+{c2}: "
              f"max|err| {err:.3g} (exact) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        check(err == 0.0, f"upsample_concat {dt} {name} is not exact")
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        add_bound(r, _upcat_bytes(*args), 0, dt)
    return r


def _soft_argmin_main(sa_ops, sa, rng, tag, shape, scale) -> dict:
    """soft_argmin at a stereo path's readout shape against its plain
    version, with both times, the kernel's device time and its bound."""
    cost, err, ok = _soft_argmin_case(sa_ops, sa, rng, shape, scale, 1.0, "none")
    ms = time_ms(lambda: sa.soft_argmin(cost, scale=scale))
    plain_ms = time_ms(lambda: sa.soft_argmin_plain(cost, scale=scale))
    dev_ms = _queued_ms(lambda: sa.soft_argmin(cost, scale=scale))
    kernel_ms, launches = _kernel_time(lambda: sa.soft_argmin(cost, scale=scale), n=RUNS)
    r = {"err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms}
    add_bound(r, nbytes(cost) + cost[..., 0].numel() * 4, SOFT_ARGMIN_OPS * cost.numel(), "fp32")
    kernel = (f"{kernel_ms:.4f} ms of kernel time in {launches} launch(es) by torch.profiler "
              f"({100 * r['bound_ms'] / kernel_ms:.1f}% of the bound)" if launches else
              "kernel time not measured (the profiler recorded no event)")
    print(f"[{tag} soft_argmin fp32] {shape} x{scale:g} (lanes, vectors a lane: "
          f"{sa.lane_plan(shape[-1], cost.dtype)}): max|err| {err:.3g} (atol 1e-5 x scale + rtol "
          f"1e-5) kernel {ms:.4f} ms by call, {dev_ms:.4f} ms device (events queued behind a "
          f"spin kernel, the card's launch latency included), {kernel}; plain {plain_ms:.4f} "
          f"ms; bound {r['bound_ms']:.4f} ms (bytes)")
    check(ok, f"soft_argmin {shape} disagrees with its plain version")
    return r


def _nvcc_log(_build) -> str:
    with open(os.path.join(os.path.dirname(_build.library_path()), "nvcc.log")) as f:
        return f.read()


def _device_and_kernel(fn, r: dict, tag: str) -> str:
    """Adds one call's device time (CUDA events queued behind a spin
    kernel) and kernel time (torch.profiler) to r; returns them as text,
    with the share of r's bound."""
    r["device_ms"] = _queued_ms(fn)
    kernel_ms, launches = _kernel_time(fn, n=RUNS)
    r["kernel_ms"] = kernel_ms if launches else None
    check(launches == 1, f"{tag}: {launches} kernel launches a call (want 1)")
    return (f"{r['device_ms']:.4f} ms device (events queued behind a spin kernel, the card's "
            f"launch latency included; {100 * r['bound_ms'] / r['device_ms']:.1f}% of the "
            f"bound), {kernel_ms:.4f} ms of kernel time in {launches} launch by torch.profiler "
            f"({100 * r['bound_ms'] / kernel_ms:.1f}% of the bound)")


def phase_stereo_kernels(corr, sa_ops, sa, upcat) -> dict:
    rng = np.random.default_rng(2)
    res = {}
    lines = ptxas_lines(_nvcc_log(corr._build), "correlation_kernel")
    print("[6 correlation ptxas] " + "; ".join(
        f"{a} {r} registers, {sp} bytes of spill stores" for a, r, sp in lines))
    check(all(sp == 0 for _, _, sp in lines), "correlation_kernel spills registers")
    b, h, w, c, d = CORR_MAIN
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        args, err, tol, ok = _corr_case(corr, rng, CORR_MAIN, dtype, "interleaved")
        ms = time_ms(lambda: corr.correlation(*args))
        plain_ms = time_ms(lambda: corr.correlation_plain(*args))
        timing = f"kernel {ms:.4f} ms by call, plain {plain_ms:.4f} ms"
        check(ok, f"correlation {dt} {CORR_MAIN} disagrees with its plain version")
        if dtype == torch.float32:
            r = res["correlation"] = {"err": err, "ms": ms, "plain_ms": plain_ms}
            add_bound(r, nbytes(*args[:2]) + b * h * w * d * 4, 2 * b * h * w * d * c, "fp32")
            timing += "; " + _device_and_kernel(lambda: corr.correlation(*args), r, "correlation")
            timing += f"; bound {r['bound_ms']:.4f} ms (bytes)"
        print(f"[6 correlation {dt}] {CORR_MAIN[:4]} D={d}, the tower's interleaved halves "
              f"(plan {corr.tile_plan(w, c, d)}): max|err| {err:.3g} ({tol}) {timing}")
        for shape, layout in CORR_EXTRA:
            _, err, tol, ok = _corr_case(corr, rng, shape, dtype, layout)
            print(f"[6 correlation {dt} extra] {shape[:4]} D={shape[4]} {layout}: max|err| "
                  f"{err:.3g} ({tol})")
            check(ok, f"correlation {dt} {shape} {layout} disagrees with its plain version")

    res["soft_argmin"] = _soft_argmin_main(sa_ops, sa, rng, 6, *SOFT_ARGMIN_MAIN)
    for shape, scale, temperature, epilogue, dtype, spread in SOFT_ARGMIN_EXTRA:
        _, err, ok = _soft_argmin_case(sa_ops, sa, rng, shape, scale, temperature, epilogue,
                                       dtype, spread)
        dt = "fp32" if dtype == torch.float32 else "bf16 cost"
        print(f"[6 soft_argmin {dt} extra] {shape} x{scale:g} temperature {temperature:g} "
              f"epilogue {epilogue} spread {spread:g} (lanes, vectors a lane: "
              f"{sa.lane_plan(shape[-1], dtype)}): max|err| {err:.3g}")
        check(ok, f"soft_argmin {dt} {shape} t={temperature} {epilogue} spread {spread:g} disagrees")
    shape, scale = SOFT_ARGMIN_MAIN
    _, err, ok = _soft_argmin_case(sa_ops, sa, rng, shape, scale, 1.0, "none", torch.bfloat16)
    print(f"[6 soft_argmin bf16 cost extra] {shape} x{scale:g}: max|err| {err:.3g}")
    check(ok, f"soft_argmin bf16 {shape} disagrees")

    res["upsample_concat"] = _stereo_joins(
        upcat, rng, 6, STEREO_B, STEREO_UPCAT_SHAPES, torch.float32)
    return res


def _stereo_pairs(n: int, seed: int):
    """uint8 pairs whose right view is the left shifted 6 px plus noise,
    so that the cost volume is not flat."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (n,) + SRC_HW + (3,), dtype=np.uint8)
    noise = rng.integers(-10, 11, left.shape)
    right = np.clip(np.roll(left, -6, axis=2).astype(np.int64) + noise, 0, 255)
    return left, right.astype(np.uint8)


def _ms_per_batch(sdt, p, left, right) -> float:
    return _host_ms(lambda: sdt.predict_stereo(p, left, right), 10)


def phase_stereo_end_to_end(sdt, _build, corr, sa, upcat) -> dict:
    left, right = _stereo_pairs(STEREO_B, 0)
    p = sdt.load_weights(None, STEREO_CONFIG, seed=0, device="cuda")
    check(not torch.backends.cudnn.allow_tf32, "TF32 still on for an fp32 preset")
    sdt.predict_stereo(p, left, right)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    _build.LAUNCHES.clear()
    out = sdt.predict_stereo(p, left, right)
    launches = dict(_build.LAUNCHES)
    want = {"correlation": 1, "soft_argmin": 1, "upsample_concat": 3}
    check(launches == want, f"expected {want} launches per forward, got {launches}")

    ref = sdt.predict_stereo(sdt.load_weights(None, STEREO_CONFIG, seed=0, device="cpu"), left, right)
    for k in ("disp", "depth"):
        check(out[k].shape == (STEREO_B,) + SRC_HW, f"stereo {k} shape {out[k].shape}")
        check(bool(np.isfinite(out[k]).all()), f"stereo {k} not finite")
    d_err = float(np.abs(out["disp"] - ref["disp"]).max())
    z_rel = float((np.abs(out["depth"] - ref["depth"]) / np.abs(ref["depth"])).max())
    check(d_err <= STEREO_DISP_ATOL, f"stereo disp vs CPU max|err| {d_err:.3g} px > {STEREO_DISP_ATOL}")
    check(z_rel <= 1e-4, f"stereo depth vs CPU max rel err {z_rel:.3g} > 1e-4")

    def plain_ms() -> float:
        return on_plain_path(_build, lambda: _ms_per_batch(sdt, p, left, right),
                             (corr, "correlation"), (sa, "soft_argmin"),
                             (upcat, "upsample_concat"))

    k1 = _ms_per_batch(sdt, p, left, right)
    p1 = plain_ms()
    p2 = plain_ms()
    k2 = _ms_per_batch(sdt, p, left, right)
    # After the host timings: a profiler session slows later launches.
    lt, rt = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    copies, split = _copy_report(lambda: p.stereo_forward(lt, rt), CORR_MAIN[:4])
    check(split == 0, f"{STEREO_CONFIG}: {split:g} copies of the split views a forward")
    print(f"[7 stereo copies] {STEREO_CONFIG} b{STEREO_B} forward: {_copy_text(copies, split)}")
    print(f"[7 stereo end to end] {STEREO_CONFIG} b{STEREO_B} {SRC_HW[0]}x{SRC_HW[1]} "
          f"uint8 pairs -> disparity, depth: launches {launches}; vs CPU: disp "
          f"max|err| {d_err:.3g} px (atol {STEREO_DISP_ATOL:g}), depth max rel "
          f"{z_rel:.3g} (rtol 1e-4); disp range [{out['disp'].min():.2f}, "
          f"{out['disp'].max():.2f}] px; ms/batch kernel path {k1:.3f}, {k2:.3f} | "
          f"plain path {p1:.3f}, {p2:.3f} (host clock, H2D + D2H included)")
    return launches


def phase_stereo_serve(sdt, serve, tag, config, seed) -> None:
    from PIL import Image

    left, right = _stereo_pairs(2, seed)
    p = sdt.load_weights(None, config, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        reqs = []
        for i in range(2):
            paths = {}
            for side, views in (("left", left), ("right", right)):
                paths[side] = os.path.join(tmp, f"{side}{i}.png")
                Image.fromarray(views[i]).save(paths[side])
            reqs.append({"id": i, **paths})
        resps = list(serve.serve_requests(p, reqs, os.path.join(tmp, "out"), depth=3))
        check([r.get("id") for r in resps] == [0, 1], f"order {resps}")
        for r in resps:
            check("error" not in r, f"serve error {r}")
            check(r["shape"] == list(SRC_HW), f"serve shape {r}")
            check(os.path.exists(r["output"]), f"missing artifact {r}")
    print(f"[{tag} stereo serve] {config}: {len(resps)}/2 in-order responses of "
          f"shape {resps[0]['shape']}, ms {[r['ms'] for r in resps]}")


BF16_CONFIG = "stereo_kitti2015_b16_bf16_v5e8"
BF16_B = 16
D96_CONFIG = "stereo_kitti2015_latency_d96"
D96_B = 2
# (name, (B, H, W, C, D)) of the banded-Gram correlation on the bf16
# presets' /4 feature grids: config 5, its C = 128 variant, latency_d96.
GRAM_MAIN = [
    ("config5", (16, 96, 288, 64, 48)),
    ("c128", (16, 96, 288, 128, 48)),
    ("d96", (2, 96, 288, 64, 24)),
]
# (shape, layout): a ragged W tile with C = 24 (not a multiple of 16),
# D > W, D = 100 (two D tiles), C = 5 (the scalar staging path) with
# D = 70, D = 64 at W = 64, odd B*H; D = 1; W below one tile; D = 128 (two
# D tiles of 64); views off 16 bytes (the scalar
# staging path); config 5's shape as two contiguous tensors and ragged
# interleaved halves.
GRAM_EXTRA = [((2, 3, 37, 24, 12), "contiguous"), ((1, 2, 8, 16, 12), "contiguous"),
              ((1, 3, 130, 16, 100), "contiguous"), ((1, 2, 37, 5, 70), "contiguous"),
              ((2, 4, 64, 64, 64), "contiguous"), ((1, 3, 70, 64, 48), "contiguous"),
              ((1, 3, 37, 16, 1), "contiguous"), ((1, 2, 40, 64, 48), "contiguous"),
              ((1, 2, 288, 64, 128), "contiguous"), ((2, 3, 37, 24, 12), "misaligned"),
              ((1, 3, 70, 64, 48), "misaligned"), ((16, 96, 288, 64, 48), "contiguous"),
              ((3, 5, 130, 64, 48), "interleaved")]
# (join, H, W, C1, C2) of config 5's aggregation at b16, bf16.
BF16_UPCAT_SHAPES = [
    ("dec2", 12, 36, 160, 128),
    ("dec1", 24, 72, 128, 96),
    ("dec0", 48, 144, 96, 64),
]
BF16_SOFT_ARGMIN = ((BF16_B, 96, 288, 48), 4.0)
# Card vs a CPU run of the same bf16 weights at 375x1242, about twice the
# errors measured on an NVIDIA H100 80GB HBM3 at 700 W: disparity 3.24e-3
# px, depth 3.21e-5 relative. The bf16 convs round at other places in
# cuDNN and in oneDNN; the random-weight readout sits near 101 px.
BF16_DISP_ATOL = 7e-3
BF16_DEPTH_RTOL = 7e-5
# Depth abs-rel of bf16 against fp32 on the same weights (BASELINE.json:5).
ABS_REL_BUDGET = 1e-3


def _bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The gap between neighbouring bf16 values at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -120))) - 7)


def _gram_case(gram, gen, shape, layout):
    """One correlation_gram call against its plain version on the card. Both
    round an fp32 sum, taken in another order, to bf16 once, so they may
    sit one bf16 spacing apart; atol 1e-6 for sums that cancel."""
    b, h, w, c, d = shape
    fl, fr = _pair(lambda sh: torch.randn(sh, generator=gen, device="cuda").bfloat16(),
                   (b, h, w, c), layout)
    got = gram.correlation_gram(fl, fr, d)
    ref = gram.correlation_gram_plain(fl, fr, d)
    torch.cuda.synchronize()
    check(got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, d),
          f"correlation_gram {shape} {got.dtype} {tuple(got.shape)}")
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= _bf16_spacing(ref.float()) + 1e-6).all())
    return (fl, fr, d), err.max().item(), ok


def phase_bf16_kernels(gram, corr, sa_ops, sa, upcat) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    lines = ptxas_lines(_nvcc_log(gram._build), "correlation_gram_kernel")
    print("[9 correlation_gram ptxas] " + "; ".join(
        f"{a} {r} registers, {sp} bytes of spill stores" for a, r, sp in lines))
    for name, shape in GRAM_MAIN:
        args, err, ok = _gram_case(gram, gen, shape, "interleaved")
        fns = {"kernel": gram.correlation_gram, "correlation kernel": corr.correlation,
               "plain": gram.correlation_gram_plain}
        times = {k: [] for k in fns}
        for k in ("kernel", "correlation kernel", "plain", "plain", "correlation kernel", "kernel"):
            times[k].append(time_ms(lambda: fns[k](*args)))
        b, h, w, c, d = shape
        r = {"err": err, "ms": float(np.mean(times["kernel"])),
             "plain_ms": float(np.mean(times["plain"]))}
        add_bound(r, nbytes(*args[:2]) + b * h * w * d * 2, 2 * b * h * w * d * c, "bf16")
        by = max(r["bound_parts"], key=r["bound_parts"].get)
        dev = _device_and_kernel(lambda: gram.correlation_gram(*args), r, f"correlation_gram {name}")
        print(f"[9 correlation_gram bf16] {name} {shape[:4]} D={d}, the tower's interleaved "
              f"halves (plan {gram.tile_plan(w, c, d)}): max|err| {err:.3g} (one bf16 spacing + "
              "1e-6); ms in turns: kernel "
              + ", ".join(f"{t:.4f}" for t in times["kernel"])
              + " | correlation kernel " + ", ".join(f"{t:.4f}" for t in times["correlation kernel"])
              + " | plain " + ", ".join(f"{t:.4f}" for t in times["plain"])
              + f"; {dev}; bound {r['bound_ms']:.4f} ms ({by})")
        check(ok, f"correlation_gram {name} {shape} disagrees with its plain version")
        if name == "config5":
            res["correlation_gram"] = r
    for shape, layout in GRAM_EXTRA:
        _, err, ok = _gram_case(gram, gen, shape, layout)
        print(f"[9 correlation_gram bf16 extra] {shape[:4]} D={shape[4]} {layout}: max|err| "
              f"{err:.3g}")
        check(ok, f"correlation_gram {shape} {layout} disagrees with its plain version")

    rng = np.random.default_rng(4)
    res["upsample_concat"] = _stereo_joins(
        upcat, rng, 9, BF16_B, BF16_UPCAT_SHAPES, torch.bfloat16)
    res["soft_argmin"] = _soft_argmin_main(sa_ops, sa, rng, 9, *BF16_SOFT_ARGMIN)
    return res


def _abs_rel(depth: np.ndarray, ref: np.ndarray) -> float:
    return float(np.mean(np.abs(depth - ref) / ref))


def _device_ms(p, lt, rt, n: int = 10) -> float:
    """Device ms per stereo_forward: CUDA events around n forwards on the
    card's own inputs, after one to warm up."""
    p.stereo_forward(lt, rt)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        p.stereo_forward(lt, rt)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _profile_stats(forward, n: int = 3, record_shapes: bool = False) -> dict:
    """Device time by kernel over n calls of ``forward`` (torch.profiler),
    after one call to warm up: {"by_name": {kernel: (us, launches)},
    "launches": all launches, "busy": the busy share of the span from the
    first kernel's start to the last one's end, "prof": the profiler}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    # Now and then a window comes back without device events (seen in probe
    # calls on an NVIDIA H100); it is measured again, up to three times.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=record_shapes) as prof:
            for _ in range(n):
                forward()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
    by_name: dict = {}
    busy = 0.0
    if spans:
        cur_s, cur_e = spans[0][0], spans[0][1]
        for s_, e_, name in spans:
            t, k = by_name.get(name, (0.0, 0))
            by_name[name] = (t + (e_ - s_), k + 1)
            if s_ > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s_, e_
            else:
                cur_e = max(cur_e, e_)
        busy += cur_e - cur_s
        busy /= max(e_ for _, e_, _ in spans) - spans[0][0]
    return {"by_name": by_name, "launches": len(spans), "busy": busy, "prof": prof}


# Spin cycles (about 1 ms) that hold the stream while a call is launched,
# longer than any call's launch from Python.
SPIN_CYCLES = 2_000_000


def _queued_ms(fn, runs: int = RUNS) -> float:
    """Median device time of one call of fn: CUDA events recorded around it
    while the stream waits behind a spin kernel (torch.cuda._sleep), so the
    call's launch from Python lies outside them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _kernel_time(fn, n: int = 10):
    """(kernel ms, kernel launches) of one call of fn by torch.profiler over
    n calls. The profiler now and then drops an event (seen in probe calls
    on an NVIDIA H100): the launches are rounded to a whole number a call,
    and the kernel time is the mean of the recorded launches times that
    number."""
    st = _profile_stats(fn, n)
    launches = round(st["launches"] / n)
    mean_us = sum(t for t, _ in st["by_name"].values()) / max(st["launches"], 1)
    return mean_us * launches / 1e3, launches


def _copy_report(forward, feat_shape, n: int = 3):
    """The copies of one stereo forward (torch.profiler, shapes recorded):
    the device kernels whose name holds "copy", {name: (ms, launches) per
    forward}, and the aten::copy_ calls per forward on a tensor of one
    view's feature shape (B, H/4, W/4, C): the copies that split_pair
    made of the tower's interleaved halves before the kernels read them in
    place."""
    st = _profile_stats(forward, n, record_shapes=True)
    kernels = {name: (t / n / 1e3, k / n) for name, (t, k) in st["by_name"].items()
               if "copy" in name.lower()}
    split = sum(1 for e in st["prof"].events() if e.name == "aten::copy_" and e.input_shapes
                and list(e.input_shapes[0]) == list(feat_shape)) / n
    return kernels, split


def _copy_text(kernels: dict, split: float) -> str:
    return (f"{split:g} aten::copy_ a forward on one view's feature shape; copy kernels (ms, "
            "launches a forward): " + ("; ".join(
                f"{name[:100]} {t:.4f} ({k:g})" for name, (t, k) in
                sorted(kernels.items(), key=lambda kv: -kv[1][0])) or "none"))


def _profile(forward, n: int = 3) -> str:
    """Device time by kernel over n calls of ``forward`` (torch.profiler):
    the kernel time per forward, its busy share of the span from the first
    kernel's start to the last one's end, and the largest kernels."""
    st = _profile_stats(forward, n)
    by_name = st["by_name"]
    if not by_name:
        return "profiler: no device time recorded (not measured)"
    total = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]

    def self_device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    ops = sorted((e for e in st["prof"].key_averages() if e.key.startswith("aten::")),
                 key=lambda e: -self_device_us(e))[:10]
    return (f"profiler over {n} forwards: kernel time {total / n / 1e3:.3f} ms per forward in "
            f"{st['launches'] / n:.0f} launches, busy {st['busy']:.3f} of the kernels' span; "
            "largest kernels (ms per forward, launches per forward): "
            + "; ".join(f"{name[:90]} {t / n / 1e3:.4f} ({k / n:g})" for name, (t, k) in top)
            + " || by op (self device ms per forward, calls per forward): "
            + "; ".join(f"{e.key} {self_device_us(e) / n / 1e3:.4f} ({e.count / n:g})"
                        for e in ops))


def phase_bf16_end_to_end(sdt, _build, gram, sa, upcat) -> dict:
    import dataclasses

    from scenedepthestimation_tpu_torch.models import stereo as stereo_net
    from scenedepthestimation_tpu_torch.utils import weights as weights_io

    left, right = _stereo_pairs(BF16_B, 0)
    p = sdt.load_weights(None, BF16_CONFIG, seed=0, device="cuda")
    check(p.dtype == torch.bfloat16, f"{BF16_CONFIG} predictor runs {p.dtype}")
    sdt.predict_stereo(p, left, right)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    _build.LAUNCHES.clear()
    out = sdt.predict_stereo(p, left, right)
    launches = dict(_build.LAUNCHES)
    want = {"correlation_gram": 1, "soft_argmin": 1, "upsample_concat": 3}
    check(launches == want, f"expected {want} launches per forward (no correlation), got {launches}")
    for k in ("disp", "depth"):
        check(out[k].shape == (BF16_B,) + SRC_HW, f"bf16 stereo {k} shape {out[k].shape}")
        check(bool(np.isfinite(out[k]).all()), f"bf16 stereo {k} not finite")

    lt, rt = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    def plain_device_ms() -> float:
        return on_plain_path(_build, lambda: _device_ms(p, lt, rt),
                             (gram, "correlation_gram"), (sa, "soft_argmin"),
                             (upcat, "upsample_concat"))

    dk1 = _device_ms(p, lt, rt)
    dp1 = plain_device_ms()
    dp2 = plain_device_ms()
    dk2 = _device_ms(p, lt, rt)
    hk1 = _host_ms(lambda: sdt.predict_stereo(p, left, right), 5)
    hk2 = _host_ms(lambda: sdt.predict_stereo(p, left, right), 5)
    torch.cuda.reset_peak_memory_stats()
    p.stereo_forward(lt, rt)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    prof = _profile(lambda: p.stereo_forward(lt, rt))
    copies, split = _copy_report(lambda: p.stereo_forward(lt, rt), GRAM_MAIN[0][1][:4])
    check(split == 0, f"{BF16_CONFIG}: {split:g} copies of the split views a forward")

    # The same bf16 weights through the plain versions on the CPU, at b2.
    t0 = time.perf_counter()
    ref = sdt.predict_stereo(sdt.load_weights(None, BF16_CONFIG, seed=0, device="cpu"),
                             left[:2], right[:2])
    cpu_s = time.perf_counter() - t0
    d_err = float(np.abs(out["disp"][:2] - ref["disp"]).max())
    z_rel = float((np.abs(out["depth"][:2] - ref["depth"]) / np.abs(ref["depth"])).max())
    check(d_err <= BF16_DISP_ATOL, f"bf16 disp vs CPU max|err| {d_err:.3g} px > {BF16_DISP_ATOL}")
    check(z_rel <= BF16_DEPTH_RTOL, f"bf16 depth vs CPU max rel {z_rel:.3g} > {BF16_DEPTH_RTOL}")

    # bf16 against the card's fp32 run of the same weights; then with the
    # cost head x20 (in fp32, before either cast) so the readout is peaked.
    cfg32 = dataclasses.replace(sdt.configs.get(BF16_CONFIG), dtype="float32")
    p32 = sdt.load_weights(None, cfg32, seed=0, device="cuda")
    out32 = sdt.predict_stereo(p32, left, right)
    rel = _abs_rel(out["depth"], out32["depth"])
    check(rel <= ABS_REL_BUDGET, f"bf16 vs fp32 depth abs-rel {rel:.3g} > {ABS_REL_BUDGET}")
    state = {k: v.detach().float().cpu().contiguous() for k, v in p32.model.state_dict().items()}
    for k in ("aggregation.cost_head.weight", "aggregation.cost_head.bias"):
        state[k] = state[k] * 20
    peaked = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg32, dtype=dtype)
        model = stereo_net.StereoNet(cfg.stereo)
        weights_io.load_state(model, state)
        peaked[dtype] = sdt.predict_stereo(sdt.Predictor(cfg, model, "cuda"), left, right)
    rel_peaked = _abs_rel(peaked["bfloat16"]["depth"], peaked["float32"]["depth"])
    del p32, peaked
    torch.cuda.empty_cache()

    print(f"[10 bf16 stereo end to end] {BF16_CONFIG} b{BF16_B} {SRC_HW[0]}x{SRC_HW[1]} uint8 "
          f"pairs -> disparity, depth on one card: launches {launches}; device ms/forward "
          f"kernel path {dk1:.3f}, {dk2:.3f} | plain path {dp1:.3f}, {dp2:.3f} (CUDA events, "
          f"inputs on the card); host ms/batch {hk1:.3f}, {hk2:.3f} (H2D + D2H included); "
          f"peak memory {peak_mib:.0f} MiB; vs CPU bf16 b2 ({cpu_s:.1f} s): disp max|err| "
          f"{d_err:.3g} px (atol {BF16_DISP_ATOL:g}), depth max rel {z_rel:.3g} (rtol "
          f"{BF16_DEPTH_RTOL:g}); depth abs-rel bf16 vs fp32 {rel:.3g} (<= {ABS_REL_BUDGET:g}), "
          f"cost head x20 {rel_peaked:.3g}; disp range [{out['disp'].min():.2f}, "
          f"{out['disp'].max():.2f}] px")
    print(f"[10 bf16 stereo profile] {prof}")
    print(f"[10 bf16 stereo copies] {BF16_CONFIG} b{BF16_B} forward: {_copy_text(copies, split)}")

    p96 = sdt.load_weights(None, D96_CONFIG, seed=0, device="cuda")
    sdt.predict_stereo(p96, left[:D96_B], right[:D96_B])
    _build.LAUNCHES.clear()
    out96 = sdt.predict_stereo(p96, left[:D96_B], right[:D96_B])
    launches96 = dict(_build.LAUNCHES)
    check(launches96 == want, f"{D96_CONFIG}: expected {want} launches, got {launches96}")
    for k in ("disp", "depth"):
        check(out96[k].shape == (D96_B,) + SRC_HW, f"d96 {k} shape {out96[k].shape}")
        check(bool(np.isfinite(out96[k]).all()), f"d96 {k} not finite")
    d96_ms = _device_ms(p96, lt[:D96_B], rt[:D96_B])
    print(f"[10 bf16 stereo end to end] {D96_CONFIG} b{D96_B}: launches {launches96}; device "
          f"ms/forward {d96_ms:.3f}; disp range [{out96['disp'].min():.2f}, "
          f"{out96['disp'].max():.2f}] px")
    return launches


def phase_serve(sdt, serve) -> None:
    from PIL import Image

    rng = np.random.default_rng(1)
    p = sdt.load_weights(None, CONFIG, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        reqs = []
        for i in range(4):
            path = os.path.join(tmp, f"frame{i}.png")
            Image.fromarray(rng.integers(0, 256, SRC_HW + (3,), dtype=np.uint8)).save(path)
            reqs.append({"id": i, "image": path})
        resps = list(serve.serve_requests(p, reqs, os.path.join(tmp, "out"), depth=3))
        check([r.get("id") for r in resps] == [0, 1, 2, 3], f"order {resps}")
        for r in resps:
            check("error" not in r, f"serve error {r}")
            check(r["shape"] == list(SRC_HW), f"serve shape {r}")
            check(os.path.exists(r["output"]), f"missing artifact {r}")
    print(f"[5 serve] {len(resps)}/4 in-order responses of shape "
          f"{resps[0]['shape']}, ms {[r['ms'] for r in resps]}")


BENCH_CONFIG = "mono_kitti_384x1152_bench"
BENCH_B = 128
# conv3x3 weight slabs a bf16 mono predictor on the card arranges once: the
# decoder's ten Conv3x3 with Cout > 1 (the heads have Cout = 1).
BENCH_SLABS = 10


def _once(tail_on) -> dict:
    """Launches a bf16 mono predictor on the card makes once, not per
    forward: the conv3x3 slabs, and with the fused tail on its weight slab
    (made at the first forward and kept by the decoder)."""
    return {"conv3x3_slab": BENCH_SLABS, **({"fused_tail_weights": 1} if tail_on else {})}


BENCH_ITERS = 10
BENCH_WARMUP = 2
# (name, (B, h, w, C1, C0, C0o), dtype) of the fused tail: the bench preset's
# level 0, config 1's level 0, and ragged shapes (h = 2, odd w, C not a
# multiple of 8, more than one channel chunk in every stage).
TAIL_MAIN = ("bench", (BENCH_B, 192, 576, 32, 16, 16), torch.bfloat16)
TAIL_EXTRA = [
    ("config1", (1, 96, 320, 32, 16, 16), torch.float32),
    ("config1", (1, 96, 320, 32, 16, 16), torch.bfloat16),
    ("ragged", (2, 2, 7, 12, 5, 6), torch.float32),
    ("ragged", (2, 2, 7, 12, 5, 6), torch.bfloat16),
    ("ragged", (3, 17, 33, 40, 17, 19), torch.float32),
    ("ragged", (3, 17, 33, 40, 17, 19), torch.bfloat16),
    # Wide C1: the bf16 kernel's 8-row tiles, with y0 staged (96) and, where
    # the staging does not fit, written from the fragments (160, the widest
    # it takes at C0 = C0o = 16).
    ("wide", (2, 9, 40, 96, 16, 16), torch.bfloat16),
    ("wide", (2, 9, 40, 160, 16, 16), torch.bfloat16),
]
# The narrowest C1 the bf16 tail refuses at C0 = C0o = 16 (its tiles do not
# fit the card's shared memory).
TAIL_REFUSED_C1 = 176
# Seeded LeCun-init weights put bf16 and fp32 depth further apart than the
# 1e-3 budget of BASELINE.json, in the JAX package too (1.76e-3 at 64x128
# in tests/test_torch_port_api.py); measured 1.14e-3 here at b128 on an
# NVIDIA H100 80GB HBM3 at 700 W. The budget is held on the reference's
# seed-0 weights.
SEEDED_ABS_REL = 2.5e-3
# Card vs a CPU run of the same bf16 weights at b2 on 384x1152 frames, in
# sigmoid units and depth relative: the bf16 convs round at other places
# in cuDNN and in oneDNN. Measured 3.09e-3 and 7.35e-3 on an NVIDIA H100
# 80GB HBM3 at 700 W.
BENCH_SIG_ATOL = 1e-2
BENCH_DEPTH_RTOL = 5e-2


def _tail_case(ft, gen, shape, dtype):
    """One fused_tail kernel call against its plain version on the card:
    fp32 atol 1e-4 + rtol 1e-4, bf16 1e-2 x max|ref| (conv3x3's rules)."""
    b, h, w, c1, c0, c0o = shape

    def rand(shape_, scale):
        return (torch.randn(shape_, generator=gen, device="cuda") * scale).to(dtype)

    args = (rand((b, h, w, c1), 1.0), rand((c0, c1, 3, 3), (9 * c1) ** -0.5),
            rand((c0,), 0.1), rand((c0o, c0, 3, 3), (9 * c0) ** -0.5), rand((c0o,), 0.1))
    got = ft.fused_tail(*args)
    ref = ft.fused_tail_plain(*args)
    torch.cuda.synchronize()
    check(got.dtype == dtype and got.shape == ref.shape == (b, 2 * h, 2 * w, c0o),
          f"fused_tail {shape} {got.dtype} {tuple(got.shape)}")
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        tol, ok = "atol 1e-4 + rtol 1e-4", bool((err <= 1e-4 + 1e-4 * ref.float().abs()).all())
    else:
        ref_max = ref.float().abs().max().item()
        tol, ok = f"1e-2 x max|ref| = {1e-2 * ref_max:.3g}", err.max().item() <= 1e-2 * ref_max
    return args, err.max().item(), tol, ok


def _unfused_chain(conv_block, y1, w00, b00, w01, b01):
    """The port's decoder without the fused tail: conv3x3 kernel, nearest
    2x, conv3x3 kernel."""
    from scenedepthestimation_tpu_torch.ops.upsample import upsample2x

    return conv_block.conv3x3(upsample2x(conv_block.conv3x3(y1, w00, b00)), w01, b01)


def _cudnn_chain(y1, w00, b00, w01, b01):
    """The same function in three stages of PyTorch calls (no one call
    computes it): reflect pad + cuDNN conv + ELU, nearest 2x, reflect pad
    + cuDNN conv + ELU, channels-last."""
    import torch.nn.functional as F

    x = y1.permute(0, 3, 1, 2)
    z = F.elu(F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w00, b00))
    z = F.interpolate(z, scale_factor=2, mode="nearest")
    return F.elu(F.conv2d(F.pad(z, (1, 1, 1, 1), mode="reflect"), w01, b01))


def phase_tail_kernels(ft, conv_block, _build) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)
    with open(os.path.join(os.path.dirname(_build.library_path()), "nvcc.log")) as f:
        text = f.read()
    # fused_tail_tc_kernel<ZH, STAGED>: its mangled template arguments read back.
    tc = [(re.match(r"ILi(\d+)ELb([01])E", a), r, sp) for a, r, sp in ptxas_lines(text, "fused_tail_tc_kernel")]
    ptxas = ptxas_report(text, "fused_tail_kernel", static_smem=False) + "; fused_tail_tc_kernel: " + \
        ", ".join(f"<{m.group(1)}, {'staged' if m.group(2) == '1' else 'unstaged'}> {r} registers, "
                  f"{sp} bytes of spill stores" for m, r, sp in tc)
    smem = {dt: _build.lib().sde_fused_tail_smem(32, 16, 16, code)
            for dt, code in (("fp32", 0), ("bf16", 1))}
    res = None
    for name, shape, dtype in [TAIL_MAIN] + TAIL_EXTRA:
        dt = "fp32" if dtype == torch.float32 else "bf16"
        args, err, tol, ok = _tail_case(ft, gen, shape, dtype)
        line = f"[12 fused_tail {dt}] {name} {shape[:4]} -> C0 {shape[4]} -> C0o {shape[5]}: max|err| {err:.3g} ({tol})"
        if name not in ("ragged", "wide"):
            wc = [w.contiguous(memory_format=torch.channels_last) for w in (args[1], args[3])]
            # bf16: the weights arranged beforehand, as the decoder keeps them.
            ws = ft.arrange_tail_weights(args[1], args[3]) if dtype == torch.bfloat16 else None
            fns = {"kernel": lambda: ft.fused_tail(*args, wslab=ws),
                   "plain": lambda: ft.fused_tail_plain(*args),
                   "unfused chain": lambda: _unfused_chain(conv_block, *args),
                   "cudnn chain": lambda: _cudnn_chain(args[0], wc[0], args[2], wc[1], args[4])}
            runs = 10 if name == "bench" else RUNS
            t = {k: time_ms(fn, runs=runs) for k, fn in fns.items()}
            b, h, w, c1, c0, c0o = shape
            y0_bytes = b * 4 * h * w * c0o * args[0].element_size()
            ops = 2 * b * (h * w * 9 * c1 * c0 + 4 * h * w * 9 * c0 * c0o)
            arrange_ms = (time_ms(lambda: ft.arrange_tail_weights(args[1], args[3]), runs=runs)
                          if ws is not None else 0.0)
            r = {"err": err, "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["cudnn chain"],
                 "chain_ms": t["unfused chain"], "arrange_ms": arrange_ms}
            add_bound(r, nbytes(*args) + y0_bytes, ops, dt)
            by = max(r["bound_parts"], key=r["bound_parts"].get)
            line += (f"; ms: kernel {t['kernel']:.4f} ({100 * r['bound_ms'] / t['kernel']:.1f}% of "
                     f"the bound), plain {t['plain']:.4f}, port's unfused chain "
                     f"(conv3x3, upsample2x, conv3x3) {t['unfused chain']:.4f}, cuDNN chain (three "
                     f"stages: pad+conv2d+elu, interpolate, pad+conv2d+elu) {t['cudnn chain']:.4f}; "
                     f"bound {r['bound_ms']:.4f} ms ({by}); weight arrangement {arrange_ms:.4f} ms "
                     "(once per decoder)")
            if name == "bench":
                res = r
        print(line)
        check(ok, f"fused_tail {dt} {shape} disagrees with its plain version")
    y1 = torch.zeros((1, 4, 4, TAIL_REFUSED_C1), dtype=torch.bfloat16, device="cuda")
    w00 = torch.zeros((16, TAIL_REFUSED_C1, 3, 3), dtype=torch.bfloat16, device="cuda")
    w01 = torch.zeros((16, 16, 3, 3), dtype=torch.bfloat16, device="cuda")
    b0 = torch.zeros((16,), dtype=torch.bfloat16, device="cuda")
    try:
        ft.fused_tail(y1, w00, b0, w01, b0)
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"[12 fused_tail bf16] C1 {TAIL_REFUSED_C1} -> 16 -> 16 refused: {refused!r}")
    check("shared memory" in refused, f"fused_tail bf16 at C1 = {TAIL_REFUSED_C1} was not refused")
    print(f"[12 fused_tail build] {ptxas} (fp32 on the CUDA cores, bf16 on the tensor cores); "
          f"dynamic shared memory a block at 32 -> 16 -> 16: {smem} bytes")
    return res


def _capture(forward, *wrappers) -> dict:
    """Runs forward() with each (module, name) kernel wrapper also keeping
    the arguments of each call: {name: [(args, kwargs), ...]}."""
    calls = {name: [] for _, name in wrappers}
    saved = [(mod, name, getattr(mod, name)) for mod, name in wrappers]

    def keeping(name, fn):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, keeping(name, fn))
    try:
        forward()
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls


# The bench decoder's kernel calls in launch order with the fused tail on.
BENCH_CONV_NAMES = ["upconv_4_0", "upconv_4_1", "upconv_3_0", "upconv_3_1", "upconv_2_0",
                    "upconv_2_1", "upconv_1_0", "upconv_1_1", "dispconv_0"]
BENCH_UPCAT_NAMES = ["level_4", "level_3", "level_2", "level_1"]
BENCH_KERNEL_RUNS = 5


def _bench_conv(conv_block, tag, args, kwargs, r=None) -> None:
    """One conv3x3 call of the bench against its plain version on the same
    inputs (bf16: 1e-2 x max|ref|), with the kernel's, the plain version's
    and cuDNN's times; summed into r when given."""
    got = conv_block.conv3x3(*args, **kwargs)
    ref = conv_block.conv3x3_plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    out_bytes = nbytes(got)
    del got, ref
    x, wt, bias = args
    b, h, w, cin = x.shape
    cout = wt.shape[0]
    if conv_block.uses_slab(x, cout) and kwargs.get("slab") is None:
        kwargs = dict(kwargs, slab=conv_block.arrange_slab(wt))
    ms = time_ms(lambda: conv_block.conv3x3(*args, **kwargs), runs=BENCH_KERNEL_RUNS)
    plain_ms = time_ms(lambda: conv_block.conv3x3_plain(*args, **kwargs), runs=BENCH_KERNEL_RUNS)
    lib_ms = _conv_library_ms(x, wt, bias, runs=BENCH_KERNEL_RUNS)
    slab_ms = (time_ms(lambda: conv_block.arrange_slab(wt), runs=BENCH_KERNEL_RUNS)
               if kwargs.get("slab") is not None else 0.0)
    t, by = bound_ms(nbytes(x, wt, bias) + out_bytes, 2 * 9 * b * h * w * cin * cout, "bf16")
    print(f"[13 bench conv3x3 bf16] {tag} {tuple(x.shape)} -> {cout} "
          f"{kwargs.get('activation', 'elu')}: max|err| {err:.3g} (1e-2 x max|ref| = "
          f"{1e-2 * ref_max:.3g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms cuDNN "
          f"{lib_ms:.4f} ms bound {t:.4f} ms ({by}), {100 * t / ms:.1f}% of the bound; "
          f"slab arrangement {slab_ms:.4f} ms (once per module)")
    check(err <= 1e-2 * ref_max, f"conv3x3 bench {tag} disagrees with its plain version")
    if r is not None:
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += lib_ms
        r["slab_ms"] = r.get("slab_ms", 0.0) + slab_ms
        add_bound(r, nbytes(x, wt, bias) + out_bytes, 2 * 9 * b * h * w * cin * cout, "bf16")


def _bench_kernels(conv_block, upcat, fts, forward) -> dict:
    """Each kernel call of one bench forward (b128, bf16, fused tail on) on
    the inputs that forward gave it, against its plain version: 9 conv3x3,
    4 upsample_concat and the fused tail; then the two conv3x3 calls of
    the unfused level 0 on the same level-0 input. Times: median of
    BENCH_KERNEL_RUNS CUDA-event pairs."""
    from scenedepthestimation_tpu_torch.ops.cuda import fused_tail as ft
    from scenedepthestimation_tpu_torch.ops.upsample import upsample2x

    calls = _capture(forward, (conv_block, "conv3x3"), (upcat, "upsample_concat"),
                     (fts, "fused_tail"))
    counts = {k: len(v) for k, v in calls.items()}
    check(counts == {"conv3x3": 9, "upsample_concat": 4, "fused_tail": 1},
          f"bench forward kernel calls {counts}")
    conv = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for name, (args, kwargs) in zip(BENCH_CONV_NAMES, calls["conv3x3"]):
        _bench_conv(conv_block, name, args, kwargs, conv)
    print(f"[13 bench conv3x3 bf16] the 9 calls: kernel {conv['ms']:.4f} ms, cuDNN "
          f"{conv['library_ms']:.4f} ms, bound {conv['bound_ms']:.4f} ms "
          f"({100 * conv['bound_ms'] / conv['ms']:.1f}% of the bound); slab arrangements "
          f"{conv['slab_ms']:.4f} ms, made once per predictor")
    cat = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for name, (args, _) in zip(BENCH_UPCAT_NAMES, calls["upsample_concat"]):
        err = (upcat.upsample_concat(*args).float()
               - upcat.upsample_concat_plain(*args).float()).abs().max().item()
        ms = time_ms(lambda: upcat.upsample_concat(*args), runs=BENCH_KERNEL_RUNS)
        plain_ms = time_ms(lambda: upcat.upsample_concat_plain(*args), runs=BENCH_KERNEL_RUNS)
        t, _ = bound_ms(_upcat_bytes(*args), 0, "bf16")
        print(f"[13 bench upsample_concat bf16] {name} {tuple(args[0].shape)} + "
              f"{tuple(args[1].shape)}: max|err| {err:.3g} (exact) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {t:.4f} ms (bytes)")
        check(err == 0.0, f"upsample_concat bench {name} is not exact")
        cat["ms"] += ms
        cat["plain_ms"] += plain_ms
        add_bound(cat, _upcat_bytes(*args), 0, "bf16")
    (y1, w00, b00, w01, b01), tail_kw = calls["fused_tail"][0]
    ws = tail_kw["wslab"]  # the decoder's kept slab
    check(ws is not None and torch.equal(ws, ft.arrange_tail_weights(w00, w01)),
          "the decoder's kept fused-tail slab differs from its weights' arrangement")
    got = fts.fused_tail(y1, w00, b00, w01, b01, wslab=ws)
    ref = fts.fused_tail_plain(y1, w00, b00, w01, b01)
    err = (got.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    y0_bytes = nbytes(got)
    del got, ref
    tail_ms = time_ms(lambda: fts.fused_tail(y1, w00, b00, w01, b01, wslab=ws), runs=BENCH_KERNEL_RUNS)
    arrange_ms = time_ms(lambda: ft.arrange_tail_weights(w00, w01), runs=BENCH_KERNEL_RUNS)
    b, h, w, c1 = y1.shape
    c0, c0o = w00.shape[0], w01.shape[0]
    t, by = bound_ms(nbytes(y1, w00, b00, w01, b01) + y0_bytes,
                     2 * b * (h * w * 9 * c1 * c0 + 4 * h * w * 9 * c0 * c0o), "bf16")
    print(f"[13 bench fused_tail bf16] level 0 {tuple(y1.shape)} on the forward's input: "
          f"max|err| {err:.3g} (1e-2 x max|ref| = {1e-2 * ref_max:.3g}) kernel {tail_ms:.4f} ms, "
          f"bound {t:.4f} ms ({by}), {100 * t / tail_ms:.1f}% of the bound; weight arrangement "
          f"{arrange_ms:.4f} ms (once per decoder)")
    check(err <= 1e-2 * ref_max, "fused_tail on the bench forward's input disagrees")
    # The fused tail off: upconv_0_0 and upconv_0_1 as two conv3x3 calls.
    _bench_conv(conv_block, "upconv_0_0 (off)", (y1, w00, b00), {})
    z = upsample2x(conv_block.conv3x3(y1, w00, b00))
    _bench_conv(conv_block, "upconv_0_1 (off)", (z, w01, b01), {})
    return {"conv3x3": conv, "upsample_concat": cat}


def phase_bench(sdt, benchmark, fts, _build, conv_block, upcat) -> dict:
    """The judged bench path: run_bench with the fused tail on, off, on."""
    import dataclasses

    from scenedepthestimation_tpu_torch.models.monodepth import MonoDepthNet
    from scenedepthestimation_tpu_torch.utils import weights as weights_io

    forwards = BENCH_WARMUP + BENCH_ITERS
    runs, per_forward = [], {}
    for flag in (True, None, True):
        fts.set_use_fused_tail(flag)
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        r = benchmark.run_bench(BENCH_CONFIG, iters=BENCH_ITERS, warmup=BENCH_WARMUP)
        launches = dict(_build.LAUNCHES)
        want = ({"fused_tail": 1, "conv3x3": 9, "upsample_concat": 4} if flag
                else {"conv3x3": 11, "upsample_concat": 4})
        once = _once(flag)
        check(launches == {**{k: v * forwards for k, v in want.items()}, **once},
              f"fused tail {flag}: {launches} launches over {forwards} forwards, want {want} each "
              f"and {once} once")
        check(np.isfinite(r["checksum"]) and r["checksum"] > 0, f"bench checksum {r['checksum']}")
        per_forward["on" if flag else "off"] = want
        runs.append((flag, r, torch.cuda.max_memory_allocated() / 2**30))
    fts.set_use_fused_tail(True)

    cfg = sdt.configs.get(BENCH_CONFIG)
    frames = np.random.default_rng(0).integers(0, 256, (BENCH_B, cfg.height, cfg.width, 3), dtype=np.uint8)
    img = torch.from_numpy(frames).cuda()
    p = sdt.load_weights(None, cfg, seed=0, device="cuda")
    prof = _profile(lambda: p.mono_forward(img), n=2)
    depth = p.mono_forward(img)["depth"]
    check(depth.shape == (BENCH_B, cfg.height, cfg.width) and bool(torch.isfinite(depth).all()),
          f"bench depth {tuple(depth.shape)} not finite")
    kernels = _bench_kernels(conv_block, upcat, fts, lambda: p.mono_forward(img))
    torch.cuda.empty_cache()

    # The same bf16 weights through the plain versions on the CPU, at b2.
    t0 = time.perf_counter()
    ref = sdt.predict_mono(sdt.load_weights(None, cfg, seed=0, device="cpu"), frames[:2])
    cpu_s = time.perf_counter() - t0
    lo, hi = 1.0 / cfg.mono.max_depth, 1.0 / cfg.mono.min_depth
    out2 = {k: v[:2].cpu().numpy() for k, v in p.mono_forward(img[:2]).items()}
    s_err = float(np.abs(out2["disp"] - ref["disp"]).max()) / (hi - lo)
    z_rel = float((np.abs(out2["depth"] - ref["depth"]) / ref["depth"]).max())
    check(s_err <= BENCH_SIG_ATOL, f"bench bf16 sigmoid disp vs CPU {s_err:.3g} > {BENCH_SIG_ATOL}")
    check(z_rel <= BENCH_DEPTH_RTOL, f"bench bf16 depth vs CPU max rel {z_rel:.3g} > {BENCH_DEPTH_RTOL}")

    # bf16 against the card's fp32 run: the seeded weights at b128, and the
    # reference's seed-0 weights (tools/torch_ref) at b8.
    def abs_rel(a, b):
        return float(torch.mean(torch.abs(a - b) / b))

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = sdt.load_weights(None, cfg32, seed=0, device="cuda")
    rel_seeded = abs_rel(depth, p32.mono_forward(img)["depth"])
    del p32
    torch.manual_seed(0)
    state = {k: v for k, v in benchmark._torch_ref().MonoDepthNet().state_dict().items()
             if not k.endswith("num_batches_tracked")}
    ref_depth = {}
    for c in (cfg, cfg32):
        model = MonoDepthNet(c.mono)
        weights_io.load_state(model, state)
        ref_depth[c.dtype] = sdt.Predictor(c, model, "cuda").mono_forward(img[:8])["depth"]
    rel_ref = abs_rel(ref_depth["bfloat16"], ref_depth["float32"])
    check(rel_seeded <= SEEDED_ABS_REL, f"bench bf16 vs fp32 abs-rel (seeded) {rel_seeded:.3g}")
    check(rel_ref <= ABS_REL_BUDGET, f"bench bf16 vs fp32 abs-rel (reference weights) {rel_ref:.3g}")
    del p, img, depth, ref_depth
    torch.cuda.empty_cache()

    print(f"[13 bench] {BENCH_CONFIG} b{BENCH_B} bf16 {cfg.height}x{cfg.width}, run_bench "
          f"({BENCH_WARMUP} warmup + {BENCH_ITERS} timed forwards, host clock, one sync) with the "
          "fused tail on, off, on: frames/s "
          + ", ".join(f"{'on' if f else 'off'} {r['value']}" for f, r, _ in runs)
          + f"; launches per forward on {per_forward['on']}, off {per_forward['off']}; peak "
          "memory GiB " + ", ".join(f"{m:.3f}" for _, _, m in runs)
          + f"; device {runs[0][1]['device']}")
    print(f"[13 bench] vs CPU bf16 b2 ({cpu_s:.1f} s): sigmoid disp max|err| {s_err:.3g} (atol "
          f"{BENCH_SIG_ATOL:g}), depth max rel {z_rel:.3g} (rtol {BENCH_DEPTH_RTOL:g}); depth "
          f"abs-rel bf16 vs the card's fp32: seeded weights b{BENCH_B} {rel_seeded:.3g} (<= "
          f"{SEEDED_ABS_REL:g}), reference seed-0 weights b8 {rel_ref:.3g} (<= {ABS_REL_BUDGET:g})")
    print(f"[13 bench profile] one forward, fused tail on: {prof}")
    return {"fps": runs[-1][1], "launches": per_forward["on"], "kernels": kernels}


def phase_parity(benchmark, fts, bench: dict) -> None:
    """bench.py's line for the port: the last fused-tail-on frames/s and
    parity_abs_rel in fp32 and bf16 on the card."""
    fts.set_use_fused_tail(True)
    fp32 = benchmark.parity_abs_rel("float32")
    bf16 = benchmark.parity_abs_rel("bfloat16")
    check(fp32 <= 1e-4, f"parity_abs_rel fp32 {fp32:.3g} > 1e-4")
    check(bf16 <= ABS_REL_BUDGET, f"parity_abs_rel bf16 {bf16:.3g} > {ABS_REL_BUDGET}")
    r = bench["fps"]
    line = {"metric": r["metric"], "value": r["value"], "unit": r["unit"],
            "vs_baseline": r["vs_baseline"], "abs_rel_delta_fp32": fp32,
            "abs_rel_delta_bf16": bf16}
    print(f"[14 bench line] {json.dumps(line)}")


# Kernel 5. (stage, H, W, C) of the ResNet-18 encoder's stride-1 3x3 convs
# in mono_kitti_192x640_fp32 at b1, each with and without the residual.
WINO_FP32_SHAPES = [("layer1", 48, 160, 64), ("layer2", 24, 80, 128),
                    ("layer3", 12, 40, 256), ("layer4", 6, 20, 512)]
# (B, H, W, C, Co, residual) off the main path: C and Co below 8 (scalar
# loads, staging and stores), C and Co off 16, one tile, odd Co with Hp = 5,
# Wp = 17, a tile count (15 x 23) that no block size divides.
WINO_EXTRA = [(2, 6, 10, 5, 7, True), (3, 14, 22, 24, 40, False), (1, 2, 2, 16, 16, True),
              (2, 10, 34, 40, 17, True), (1, 30, 46, 64, 96, True)]
# The stage of each of the 13 stride-1 convs of the folded ResNet-18, in
# call order: each block's conv1 where it has stride 1, then its conv2.
WINO_BENCH_NAMES = ["layer1_0.conv1", "layer1_0.conv2", "layer1_1.conv1", "layer1_1.conv2",
                    "layer2_0.conv2", "layer2_1.conv1", "layer2_1.conv2",
                    "layer3_0.conv2", "layer3_1.conv1", "layer3_1.conv2",
                    "layer4_0.conv2", "layer4_1.conv1", "layer4_1.conv2"]
# Each bench call's time with the earlier design of the bf16 kernel
# (mma.sync products, the output transform on the CUDA cores every 16
# channels, V built once per 64 output channels), measured on an NVIDIA H100
# 80GB HBM3 at 700 W, in WINO_BENCH_NAMES order: the yardstick of the
# redesign.
WINO_EARLIER_MS = [1.6716, 2.0815, 1.7173, 2.0353, 1.7300, 1.5386, 1.7782, 1.5853, 1.5011, 1.5524,
                   1.5089, 1.4921, 1.4560]
# Card vs card, the kernel-routed folded encoder against the cuDNN one: each
# level's max|err| against the fp32 folded encoder on the same input within
# twice the cuDNN bf16 encoder's (the kernel rounds each conv once, after
# bias and residual; cuDNN rounds the conv, the residual add and the ReLU).
WINO_ROUTE_FACTOR = 2.0


def _wino_inputs(wino_ops, x, weight, bias, residual, dtype):
    """The kernel's operands for one conv: phases of NHWC x (and of the
    residual), U in the compute dtype, the bias in fp32."""
    ph = wino_ops.space_to_phases(x)
    rph = None if residual is None else wino_ops.space_to_phases(residual)
    u = wino_ops.transform_weights(weight).to(dtype)
    return ph, u, bias.float(), rph


def _wino_case(wino, args, tol_kind):
    """One winograd kernel call against its plain version on the card. fp32:
    atol 1e-4 + rtol 1e-4 (sums in another order); bf16: 1e-2 x max|ref|
    (both round the same bf16 input transform; one output rounding)."""
    got = wino.winograd_conv3x3_phases(*args)
    ref = wino.winograd_conv3x3_phases_plain(*args)
    torch.cuda.synchronize()
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    if tol_kind == "fp32":
        ok = all(bool(((g.float() - r.float()).abs() <= 1e-4 + 1e-4 * r.float().abs()).all())
                 for g, r in zip(got, ref))
        tol = "atol 1e-4 + rtol 1e-4"
    else:
        ref_max = max(r.float().abs().max().item() for r in ref)
        ok, tol = err <= 1e-2 * ref_max, f"1e-2 x max|ref| = {1e-2 * ref_max:.3g}"
    return err, tol, ok


def _wino_bound(args):
    """Bound of one call: phases (+ residual) in, U and bias in, phases out,
    each once; the 16 Winograd products 2 B Hp Wp 16 C Co. Also the direct
    conv's operations (36/16 of them)."""
    ph, u, bias, rph = args[:4]
    b, hp, wp, c = ph[0].shape
    co = u.shape[2]
    nb = nbytes(*ph, u, bias) + (0 if rph is None else nbytes(*rph)) + 4 * b * hp * wp * co * ph[0].element_size()
    ops = 2 * b * hp * wp * 16 * c * co
    return nb, ops, ops * 36 / 16


def _wino_library_ms(x_nchw, weight, bias, runs, residual=None):
    """cuDNN's conv with bias (F.conv2d, zero pad 1, channels-last) on the
    same input, without residual or ReLU (row 1's convention); and, with a
    residual, the served folded path's three-call chain: conv with bias,
    residual add, ReLU."""
    import torch.nn.functional as F

    wc = weight.contiguous(memory_format=torch.channels_last)
    bb = bias.to(x_nchw.dtype)

    def chain():
        y = F.conv2d(x_nchw, wc, bb, 1, 1)
        if residual is not None:
            y += residual
        return F.relu_(y)

    return (time_ms(lambda: F.conv2d(x_nchw, wc, bb, 1, 1), runs=runs),
            time_ms(chain, runs=runs))


def _wino_timed(wino, tag, args, x_nchw, weight, kind, runs, r=None, res_nchw=None,
                earlier_ms=None, make_u=None):
    """Kernel, plain and cuDNN times and the bound of one call, printed; and
    summed into r when given. ``make_u``, when given, is how the call's U
    was made and kept (timed apart), ``earlier_ms`` the earlier design's
    time for the call."""
    err, tol, ok = _wino_case(wino, args, kind)
    ms = time_ms(lambda: wino.winograd_conv3x3_phases(*args), runs=runs)
    plain_ms = time_ms(lambda: wino.winograd_conv3x3_phases_plain(*args), runs=max(3, runs // 2))
    lib_ms, chain_ms = _wino_library_ms(x_nchw, weight, args[2], runs, res_nchw)
    nb, ops, direct = _wino_bound(args)
    t, by = bound_ms(nb, ops, kind)
    b, hp, wp, c = args[0][0].shape
    co = args[1].shape[2]
    extra = ""
    if make_u is not None:
        arrange_ms = time_ms(make_u, runs=runs)
        extra = (f"; earlier design {earlier_ms:.4f} ms; making U {arrange_ms:.4f} ms (once per "
                 "weight)")
        if r is not None:
            r["arrange_ms"] = r.get("arrange_ms", 0.0) + arrange_ms
            r["earlier_ms"] = r.get("earlier_ms", 0.0) + earlier_ms
    print(f"[15 winograd {kind}] {tag} (B, H, W, C) {(b, 2 * hp, 2 * wp, c)} -> {co}"
          f"{' + residual' if args[3] is not None else ''}: max|err| {err:.3g} ({tol}) kernel "
          f"{ms:.4f} ms ({100 * t / ms:.1f}% of the bound) plain {plain_ms:.4f} ms cuDNN conv+bias "
          f"{lib_ms:.4f} ms, cuDNN chain (conv+bias, + residual, ReLU) {chain_ms:.4f} ms; bound "
          f"{t:.4f} ms ({by}: {nb / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP of Winograd products; the "
          f"direct conv {direct / 1e9:.1f}){extra}")
    check(ok, f"winograd {kind} {tag} disagrees with its plain version")
    if r is not None:
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += lib_ms
        r["chain_ms"] = r.get("chain_ms", 0.0) + chain_ms
        add_bound(r, nb, ops, kind)


def _winograd_route(wino_ops):
    """The folded encoder's conv3x3_bias_relu on the winograd kernel: NCHW
    views of channels-last memory in and out, NHWC to the kernel, each
    weight's U made at its first call and kept (kept_u_slab)."""
    def nhwc(t):
        return None if t is None else t.permute(0, 2, 3, 1)

    def conv(x, weight, bias, residual=None):
        return wino_ops.winograd_conv3x3(nhwc(x), weight, bias, nhwc(residual),
                                         u_slab=wino_ops.kept_u_slab(weight)).permute(0, 3, 1, 2)

    return conv


def _randomize_bn(model, seed: int) -> None:
    """BatchNorm terms far from the seeded init's identity (scale U(0.5,
    1.5), shift N(0, 0.3), mean N(0, 0.5), var U(0.2, 2), as the JAX
    package's tests/test_folded.py draws them), so a fold that mixes them
    up shows."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, draw in ((m.weight, lambda s: rng.uniform(0.5, 1.5, s)),
                                (m.bias, lambda s: rng.normal(0.0, 0.3, s)),
                                (m.running_mean, lambda s: rng.normal(0.0, 0.5, s)),
                                (m.running_var, lambda s: rng.uniform(0.2, 2.0, s))):
                    t.copy_(torch.from_numpy(draw(tuple(t.shape)).astype(np.float32)))


def _seeded_folded(sdt, cfg, dtype: str, fold: bool = True):
    """A predictor of cfg in dtype on the card: seed-0 weights with random
    BatchNorm terms, the encoder folded when ``fold``."""
    import dataclasses

    from scenedepthestimation_tpu_torch.models.monodepth import MonoDepthNet, init_parameters

    c = dataclasses.replace(cfg, dtype=dtype, mono=dataclasses.replace(cfg.mono, fold_bn=fold))
    model = MonoDepthNet(c.mono)
    init_parameters(model, torch.Generator().manual_seed(0))
    _randomize_bn(model, 6)
    return sdt.Predictor(c, model, "cuda")


@torch.inference_mode()  # the captured weights are parameters, the activations inference tensors
def phase_winograd_kernels(sdt, wino_ops, wino, folded_mod, _build) -> dict:
    """Kernel 5: the 13 stride-1 conv calls of one b128 bf16 folded bench
    forward on that forward's inputs, config 1's stage shapes in fp32 and
    off-path shapes, each against its plain version."""
    with open(os.path.join(os.path.dirname(_build.library_path()), "nvcc.log")) as f:
        text = f.read()
    # The bf16 products are tensor-core instructions (mma.sync: HMMA) in the SASS.
    hmma = sass_counts(_build, "winograd_tc_kernel", "HMMA")
    check(len(hmma) == 1 and min(hmma.values()) > 0,
          f"winograd_tc_kernel without HMMA in its SASS: {hmma}")
    ptxas = ("; ".join(ptxas_report(text, k, static_smem=False)
                       for k in ("winograd_tc_kernel", "winograd_fp32_kernel"))
             + f"; HMMA instructions in winograd_tc_kernel's SASS: {max(hmma.values())}")
    cfg = sdt.configs.get(BENCH_CONFIG)
    p = _seeded_folded(sdt, cfg, "bfloat16")
    frames = np.random.default_rng(0).integers(0, 256, (BENCH_B, cfg.height, cfg.width, 3), dtype=np.uint8)
    img = torch.from_numpy(frames).cuda()
    calls = _capture(lambda: p.mono_forward(img), (folded_mod, "conv3x3_bias_relu"))["conv3x3_bias_relu"]
    check(len(calls) == 13, f"folded bench forward: {len(calls)} stride-1 conv calls, want 13")
    del img
    res = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for name, earlier, (args, _) in zip(WINO_BENCH_NAMES, WINO_EARLIER_MS, calls):
        x, weight, bias = args[:3]
        residual = args[3] if len(args) > 3 else None
        nhwc = (lambda t: None if t is None else t.permute(0, 2, 3, 1))
        # As the kernel route passes them: the weight's kept U, the bias as it is.
        ph, _, _, rph = _wino_inputs(wino_ops, nhwc(x), weight, bias, nhwc(residual), torch.bfloat16)
        kargs = (ph, wino_ops.kept_u_slab(weight), bias, rph)
        _wino_timed(wino, f"bench {name}", kargs + (True,), x, weight, "bf16",
                    BENCH_KERNEL_RUNS, res, res_nchw=residual, earlier_ms=earlier,
                    make_u=lambda: wino_ops.transform_weights(weight).to(weight.dtype))
        del kargs
    del calls, p
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    for stage, h, w, c in WINO_FP32_SHAPES:
        for with_res in (False, True):
            x = rand((1, h, w, c), 1.0, torch.float32)
            weight = rand((c, c, 3, 3), (9 * c) ** -0.5, torch.float32)
            r = rand((1, h, w, c), 1.0, torch.float32) if with_res else None
            kargs = _wino_inputs(wino_ops, x, weight, rand((c,), 0.1, torch.float32), r, torch.float32)
            _wino_timed(wino, f"config1 {stage}", kargs + (True,), x.permute(0, 3, 1, 2),
                        weight, "fp32", RUNS)
    for b, h, w, c, co, with_res in WINO_EXTRA:
        for dtype, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            x = rand((b, h, w, c), 1.0, dtype)
            r = rand((b, h, w, co), 1.0, dtype) if with_res else None
            kargs = _wino_inputs(wino_ops, x, rand((co, c, 3, 3), (9 * c) ** -0.5, dtype),
                                 rand((co,), 0.1, torch.float32), r, dtype)
            for relu in (False, True):
                err, tol, ok = _wino_case(wino, kargs + (relu,), kind)
                print(f"[15 winograd {kind} extra] {(b, h, w, c)} -> {co} residual {with_res} "
                      f"relu {relu}: max|err| {err:.3g} ({tol})")
                check(ok, f"winograd {kind} {(b, h, w, c, co)} disagrees with its plain version")
    # The NHWC wrapper writes the output phases in place; vs the direct conv.
    x = rand((2, 10, 34, 40), 1.0, torch.float32)
    weight = rand((17, 40, 3, 3), 40 ** -0.5, torch.float32)
    bias = rand((17,), 0.1, torch.float32)
    r = rand((2, 10, 34, 17), 1.0, torch.float32)
    err = (wino_ops.winograd_conv3x3(x, weight, bias, r)
           - wino_ops.conv3x3_reference(x, weight, bias, r)).abs().max().item()
    print(f"[15 winograd fp32] winograd_conv3x3 (NHWC, in place) vs conv3x3_reference (cuDNN, "
          f"no TF32): max|err| {err:.3g} (atol 1e-4)")
    check(err <= 1e-4, "winograd_conv3x3 disagrees with the direct conv")
    by = max(res["bound_parts"], key=res["bound_parts"].get)
    print(f"[15 winograd] the bench forward's 13 calls: kernel {res['ms']:.4f} ms "
          f"({100 * res['bound_ms'] / res['ms']:.1f}% of the bound), earlier design "
          f"{res['earlier_ms']:.4f}, plain {res['plain_ms']:.4f}, cuDNN conv+bias "
          f"{res['library_ms']:.4f}, cuDNN chain (conv+bias, + residual, ReLU) "
          f"{res['chain_ms']:.4f}, bound {res['bound_ms']:.4f} ({by}); making the 13 U "
          f"{res['arrange_ms']:.4f} ms, once per weight; {ptxas}")
    return res


def _enc_errs(feats, refs):
    return [(f.float() - r.float()).abs().max().item() for f, r in zip(feats, refs)]


def phase_folded(sdt, benchmark, wino_ops, folded_mod, _build) -> dict:
    """The folded path: run_bench with fold_bn off and on, the folded
    encoder against the unfolded one, the folded encoder on kernel 5 against
    the cuDNN one, the profile of a folded forward, parity_abs_rel."""
    from scenedepthestimation_tpu_torch.ops.preprocess import preprocess

    forwards = BENCH_WARMUP + BENCH_ITERS
    fps = {}
    for fold in (False, True):
        _build.LAUNCHES.clear()
        r = benchmark.run_bench(BENCH_CONFIG, iters=BENCH_ITERS, warmup=BENCH_WARMUP,
                                overrides={"mono.fold_bn": fold})
        launches = dict(_build.LAUNCHES)
        want = {"fused_tail": 1, "conv3x3": 9, "upsample_concat": 4}
        check(launches == {**{k: v * forwards for k, v in want.items()}, **_once(True)},
              f"fold_bn {fold}: {launches} launches over {forwards} forwards, want {want} each "
              f"and {_once(True)} once")
        check(np.isfinite(r["checksum"]) and r["checksum"] > 0, f"bench checksum {r['checksum']}")
        fps[fold] = r["value"]

    cfg = sdt.configs.get(BENCH_CONFIG)
    frames = np.random.default_rng(0).integers(0, 256, (BENCH_B, cfg.height, cfg.width, 3), dtype=np.uint8)
    img = torch.from_numpy(frames).cuda()
    net_hw = (cfg.height, cfg.width)
    nf = 16  # frames for the feature comparisons
    x32 = preprocess(img[:nf], net_hw, cfg.pre, compute_dtype=torch.float32)
    x16 = x32.bfloat16()

    # fp32: the folded encoder against the unfolded one on the same weights.
    p32 = _seeded_folded(sdt, cfg, "float32")
    with torch.inference_mode():
        f32 = p32.model.encoder(x32)
        unf = _seeded_folded(sdt, cfg, "float32", fold=False)
        u32 = unf.model.encoder(x32)
    del unf
    fold_errs = _enc_errs(f32, u32)
    ref_max = [r.abs().max().item() for r in u32]
    del u32
    check(all(e <= 1e-4 * m for e, m in zip(fold_errs, ref_max)),
          f"folded vs unfolded fp32 features {fold_errs} (max|ref| {ref_max})")
    depth32 = p32.mono_forward(img)["depth"]
    del p32
    torch.cuda.empty_cache()

    # bf16: the cuDNN folded encoder and the same on kernel 5, each against
    # the fp32 folded features and depth.
    p16 = _seeded_folded(sdt, cfg, "bfloat16")

    def abs_rel(a, b):
        return float(torch.mean(torch.abs(a - b) / b))

    out = {}
    saved = folded_mod.conv3x3_bias_relu, wino_ops.transform_weights
    transforms = [0]  # weight transforms (kept_u_slab's einsum) in the measured forward

    def counting_transform(w):
        transforms[0] += 1
        return saved[1](w)

    for route in ("cudnn", "winograd"):
        if route == "winograd":
            folded_mod.conv3x3_bias_relu = _winograd_route(wino_ops)
            wino_ops.transform_weights = counting_transform
        try:
            with torch.inference_mode():
                feats = p16.model.encoder(x16)
            p16.mono_forward(img)  # warm-up
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            transforms[0] = 0
            depth = p16.mono_forward(img)["depth"]
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            n_transforms = transforms[0]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                p16.mono_forward(img)
            end.record()
            end.synchronize()
            if route == "winograd":
                prof_route = _profile(lambda: p16.mono_forward(img), n=1)
        finally:
            folded_mod.conv3x3_bias_relu, wino_ops.transform_weights = saved
        out[route] = {"errs": _enc_errs(feats, f32), "launches": launches, "transforms": n_transforms,
                      "abs_rel": abs_rel(depth, depth32), "ms": start.elapsed_time(end) / 3,
                      "feats": feats}
        check(depth.shape == (BENCH_B, cfg.height, cfg.width) and bool(torch.isfinite(depth).all()),
              f"{route} folded bf16 depth not finite")
        check(out[route]["abs_rel"] <= SEEDED_ABS_REL,
              f"{route} folded bf16 vs fp32 depth abs-rel {out[route]['abs_rel']:.3g} > {SEEDED_ABS_REL}")
    check(out["winograd"]["launches"].get("winograd") == 13 and out["winograd"]["transforms"] == 0,
          f"kernel-routed folded forward: launches {out['winograd']['launches']}, "
          f"{out['winograd']['transforms']} weight transforms; want 13 winograd and no weight "
          "transform after the first forward")
    check(out["cudnn"]["launches"].get("winograd", 0) == 0, "the served folded path launched winograd")
    route_errs = _enc_errs(out["winograd"]["feats"], out["cudnn"]["feats"])
    for lvl, (ew, ec) in enumerate(zip(out["winograd"]["errs"], out["cudnn"]["errs"])):
        check(ew <= WINO_ROUTE_FACTOR * ec,
              f"level {lvl}: kernel-routed bf16 features {ew:.3g} from fp32, cuDNN's {ec:.3g}")
    for r in out.values():
        del r["feats"]
    del f32, x16, x32
    torch.cuda.empty_cache()
    prof = _profile(lambda: p16.mono_forward(img), n=2)
    del p16, img
    torch.cuda.empty_cache()

    fp32 = benchmark.parity_abs_rel("float32", overrides={"mono.fold_bn": True})
    bf16 = benchmark.parity_abs_rel("bfloat16", overrides={"mono.fold_bn": True})
    check(fp32 <= 1e-4, f"parity_abs_rel fp32 fold_bn {fp32:.3g} > 1e-4")
    check(bf16 <= ABS_REL_BUDGET, f"parity_abs_rel bf16 fold_bn {bf16:.3g} > {ABS_REL_BUDGET}")

    print(f"[16 folded] {BENCH_CONFIG} b{BENCH_B} bf16, run_bench ({BENCH_WARMUP} warmup + "
          f"{BENCH_ITERS} timed forwards, fused tail on): frames/s fold_bn off {fps[False]}, on "
          f"{fps[True]} (no claim); launches per forward either way {want}, 0 winograd")
    print(f"[16 folded] seeded weights with random BN terms: folded vs unfolded fp32 encoder "
          f"features b{nf}, max|err| per level "
          + ", ".join(f"{e:.3g}" for e in fold_errs)
          + " (<= 1e-4 x max|ref| = " + ", ".join(f"{1e-4 * m:.3g}" for m in ref_max) + ")")
    for route, r in out.items():
        print(f"[16 folded] bf16 folded encoder on {route}: features vs the fp32 folded encoder "
              f"max|err| per level " + ", ".join(f"{e:.3g}" for e in r["errs"])
              + f"; depth abs-rel vs the card's fp32 folded run b{BENCH_B} {r['abs_rel']:.3g} "
              f"(<= {SEEDED_ABS_REL:g}); launches {r['launches']}, weight transforms "
              f"{r['transforms']}; device ms per forward "
              f"{r['ms']:.3f} (CUDA events, 3 forwards)")
    print(f"[16 folded] winograd route vs cuDNN route, bf16 features max|err| per level "
          + ", ".join(f"{e:.3g}" for e in route_errs)
          + f" (each route's error vs fp32: the kernel's within {WINO_ROUTE_FACTOR:g}x cuDNN's)")
    print(f"[16 folded] parity_abs_rel with fold_bn: fp32 {fp32:.3g} (<= 1e-4), bf16 "
          f"{bf16:.3g} (<= {ABS_REL_BUDGET:g})")
    print(f"[16 folded profile] one b{BENCH_B} bf16 forward, fold_bn on, fused tail on: {prof}")
    print(f"[16 folded profile] the same with the 13 stride-1 convs on kernel 5: {prof_route}")
    return {"launches": out["winograd"]["launches"]["winograd"]}


def phase_repairs(sdt, benchmark, fts, _build) -> None:
    """mono.fast_borders on config 1 (card vs CPU) and on the bench (beside
    the reflect run), and single-file weights on the card."""
    import dataclasses

    # Config 1 with fast borders, fused tail off: every decoder conv and the
    # head zero-bordered; the card against the CPU on the same weights, at
    # phase 4's tolerances.
    fts.set_use_fused_tail(None)
    cfg = sdt.configs.get(CONFIG)
    cfg_fast = dataclasses.replace(cfg, mono=dataclasses.replace(cfg.mono, fast_borders=True))
    frame = np.random.default_rng(3).integers(0, 256, SRC_HW + (3,), dtype=np.uint8)
    p = sdt.load_weights(None, cfg_fast, seed=0, device="cuda")
    check(p.model.decoder.border_mode == "fast", f"border mode {p.model.decoder.border_mode}")
    sdt.predict_mono(p, frame)  # warm-up
    _build.LAUNCHES.clear()
    out = sdt.predict_mono(p, frame)
    c1_launches = dict(_build.LAUNCHES)
    check(c1_launches == {"conv3x3": 11, "upsample_concat": 4}, f"fast borders launches {c1_launches}")
    ref = sdt.predict_mono(sdt.load_weights(None, cfg_fast, seed=0, device="cpu"), frame)
    exact = sdt.predict_mono(sdt.load_weights(None, cfg, seed=0, device="cuda"), frame)
    lo, hi = 1.0 / cfg.mono.max_depth, 1.0 / cfg.mono.min_depth
    for k in ("disp", "depth"):
        check(out[k].shape == SRC_HW and bool(np.isfinite(out[k]).all()), f"fast {k} {out[k].shape}")
    s_err = float(np.abs(out["disp"] - ref["disp"]).max()) / (hi - lo)
    z_rel = float((np.abs(out["depth"] - ref["depth"]) / ref["depth"]).max())
    moved = float((np.abs(out["depth"] - exact["depth"]) / exact["depth"]).max())
    check(s_err <= 1e-5, f"fast borders sigmoid disp vs CPU {s_err:.3g} > 1e-5")
    check(z_rel <= 1e-4, f"fast borders depth vs CPU max rel {z_rel:.3g} > 1e-4")
    check(moved > 1e-3, f"fast borders moved the depth by only {moved:.3g} from reflect")

    # The bench with fast borders and the fused tail on, beside the reflect
    # run, in turns.
    fts.set_use_fused_tail(True)
    forwards = BENCH_WARMUP + BENCH_ITERS
    fps = []
    for fast in (True, False, True):
        _build.LAUNCHES.clear()
        r = benchmark.run_bench(BENCH_CONFIG, iters=BENCH_ITERS, warmup=BENCH_WARMUP,
                                overrides={"mono.fast_borders": fast})
        launches = dict(_build.LAUNCHES)
        want = {"fused_tail": 1, "conv3x3": 9, "upsample_concat": 4}
        check(launches == {**{k: v * forwards for k, v in want.items()}, **_once(True)},
              f"fast_borders {fast}: {launches} launches over {forwards} forwards")
        check(np.isfinite(r["checksum"]) and r["checksum"] > 0, f"bench checksum {r['checksum']}")
        fps.append(("fast" if fast else "reflect", r["value"]))

    # One .pth file and the family's directory form of the same weights (the
    # reference's seed-0 state_dict) give the same depth on the card.
    torch.manual_seed(0)
    state = {k: v for k, v in benchmark._torch_ref().MonoDepthNet().state_dict().items()
             if not k.endswith("num_batches_tracked")}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(state, os.path.join(tmp, "model.pth"))
        os.makedirs(os.path.join(tmp, "family"))
        for name, prefix in (("encoder.pth", "encoder."), ("depth.pth", "decoder.")):
            torch.save({k: v for k, v in state.items() if k.startswith(prefix)},
                       os.path.join(tmp, "family", name))
        by_file = sdt.predict_mono(sdt.load_weights(os.path.join(tmp, "model.pth"), CONFIG), frame)
        by_dir = sdt.predict_mono(sdt.load_weights(os.path.join(tmp, "family"), CONFIG), frame)
    check(all(np.array_equal(by_file[k], by_dir[k]) for k in ("disp", "depth")),
          "single-file weights and the directory form give different depth")
    print(f"[17 repairs] {CONFIG} b1 {SRC_HW[0]}x{SRC_HW[1]} with mono.fast_borders (fused tail "
          f"off, every decoder conv and the head zero-bordered): launches {c1_launches}; "
          f"vs CPU: sigmoid disp max|err| {s_err:.3g} (atol 1e-5), depth max rel {z_rel:.3g} "
          f"(rtol 1e-4); depth moved from the reflect run by up to {moved:.3g} (relative)")
    print(f"[17 repairs] {BENCH_CONFIG} b{BENCH_B} bf16, run_bench ({BENCH_WARMUP} warmup + "
          f"{BENCH_ITERS} timed forwards, fused tail on) in turns: frames/s "
          + ", ".join(f"{k} {v}" for k, v in fps))
    print(f"[17 repairs] load_weights of one .pth file (the reference's seed-0 weights) and of "
          f"the encoder.pth + depth.pth directory: the same depth on the card (max "
          f"{float(by_file['depth'].max()):.4g} m)")


def measure(root: str, frames: int) -> int:
    """The --measure mode: the package under root, timed as the module
    docstring says."""
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.abspath(root))
    import scenedepthestimation_tpu_torch as sdt
    from scenedepthestimation_tpu_torch.ops.cuda import conv_block
    from scenedepthestimation_tpu_torch.ops.cuda import correlation as corr
    from scenedepthestimation_tpu_torch.ops.cuda import correlation_gram as gram

    frame = np.random.default_rng(0).integers(0, 256, SRC_HW + (3,), dtype=np.uint8)
    p = sdt.load_weights(None, CONFIG, seed=0, device="cuda")
    lat = _frame_ms(sdt, p, frame, frames)
    out = {"package": os.path.dirname(sdt.__file__), "device": torch.cuda.get_device_name(0),
           "b1_frames": frames, "b1_median_ms": float(np.median(lat)),
           "b1_p90_ms": float(np.percentile(lat, 90)), "b1_mean_ms": float(np.mean(lat)),
           "conv3x3_fp32": []}
    # The stereo forwards' device time (CUDA events around 10 forwards, three
    # times), before any profiler session of the process.
    stereo = {}
    for tag, config, b, feat in (("stereo_fp32", STEREO_CONFIG, STEREO_B, CORR_MAIN[:4]),
                                 ("stereo_bf16", BF16_CONFIG, BF16_B, GRAM_MAIN[0][1][:4])):
        left, right = _stereo_pairs(b, 0)
        ps = sdt.load_weights(None, config, seed=0, device="cuda")
        lt, rt = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
        stereo[tag] = (ps, lt, rt, feat, {"config": config, "batch": b, "device_ms": [
            _device_ms(ps, lt, rt) for _ in range(3)]})
    rng = np.random.default_rng(0)
    for name, h, w, cin, cout, act, out_dtype in CONV_SHAPES:
        args, err, tol, ok = _conv_case(
            conv_block, rng, (1, h, w, cin, cout), act, "reflect", torch.float32, out_dtype)
        check(ok, f"conv3x3 fp32 {name} disagrees with its plain version ({err:.3g}, {tol})")
        slab = conv_block.arrange_slab(args[1]) if conv_block.uses_slab(args[0], cout) else None
        out["conv3x3_fp32"].append({
            "name": name, "max_abs_err": err,
            "call_ms": time_ms(lambda: conv_block.conv3x3(*args, slab=slab)),
            "device_ms": _queued_ms(lambda: conv_block.conv3x3(*args, slab=slab)),
            "launches": _kernel_time(lambda: conv_block.conv3x3(*args, slab=slab))[1]})
    for k in ("call_ms", "device_ms", "launches"):
        out[f"conv3x3_fp32_{k}"] = sum(r[k] for r in out["conv3x3_fp32"])
    # The correlation kernels at their main shapes through the wrappers'
    # public names, on two contiguous tensors (both trees read those).
    gen = torch.Generator(device="cuda").manual_seed(3)
    for key, fn, shape, dtype in (
            [("correlation_fp32", corr.correlation, CORR_MAIN, torch.float32)]
            + [(f"correlation_gram_bf16_{tag}", gram.correlation_gram, shape, torch.bfloat16)
               for tag, shape in GRAM_MAIN]):
        fl, fr = _pair(lambda sh: torch.randn(sh, generator=gen, device="cuda").to(dtype),
                       shape[:4], "contiguous")
        call = lambda: fn(fl, fr, shape[4])  # noqa: E731
        r = {"shape": shape, "call_ms": time_ms(call), "device_ms": _queued_ms(call)}
        r["kernel_ms"], r["launches"] = _kernel_time(call, n=RUNS)
        out[key] = r
    # Each stereo forward's copies: split_pair's copies of the tower's
    # halves, where a tree makes them, and the copy kernels by name.
    for tag, (ps, lt, rt, feat, r) in stereo.items():
        copies, r["split_copies"] = _copy_report(lambda: ps.stereo_forward(lt, rt), feat)
        r["copy_kernels"] = {name: list(v) for name, v in copies.items()}
        out[tag] = r
    print(json.dumps(out))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        rest = sys.argv[2:]
        return measure(rest[0] if rest else os.path.dirname(os.path.abspath(__file__)),
                       int(rest[1]) if len(rest) > 1 else 200)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import scenedepthestimation_tpu_torch as sdt
    from scenedepthestimation_tpu_torch import benchmark, serve
    from scenedepthestimation_tpu_torch.models import folded as folded_mod
    from scenedepthestimation_tpu_torch.ops import winograd as wino_ops
    from scenedepthestimation_tpu_torch.ops import fused_tail as fts
    from scenedepthestimation_tpu_torch.ops import soft_argmin as sa_ops
    from scenedepthestimation_tpu_torch.ops.cuda import _build, conv_block
    from scenedepthestimation_tpu_torch.ops.cuda import correlation as corr
    from scenedepthestimation_tpu_torch.ops.cuda import correlation_gram as gram
    from scenedepthestimation_tpu_torch.ops.cuda import fused_tail as ft
    from scenedepthestimation_tpu_torch.ops.cuda import soft_argmin as sa
    from scenedepthestimation_tpu_torch.ops.cuda import upsample_concat as upcat
    from scenedepthestimation_tpu_torch.ops.cuda import winograd as wino

    phase_device()
    phase_build(_build)
    res = phase_kernels(conv_block, upcat)
    launches = phase_end_to_end(sdt, _build, conv_block, upcat)
    phase_conv_device(conv_block, res["conv3x3"])
    phase_serve(sdt, serve)
    stereo_res = phase_stereo_kernels(corr, sa_ops, sa, upcat)
    stereo_launches = phase_stereo_end_to_end(sdt, _build, corr, sa, upcat)
    phase_stereo_serve(sdt, serve, 8, STEREO_CONFIG, 1)
    bf16_res = phase_bf16_kernels(gram, corr, sa_ops, sa, upcat)
    bf16_launches = phase_bf16_end_to_end(sdt, _build, gram, sa, upcat)
    phase_stereo_serve(sdt, serve, 11, BF16_CONFIG, 2)
    tail_res = phase_tail_kernels(ft, conv_block, _build)
    bench = phase_bench(sdt, benchmark, fts, _build, conv_block, upcat)
    phase_parity(benchmark, fts, bench)
    wino_res = phase_winograd_kernels(sdt, wino_ops, wino, folded_mod, _build)
    folded_res = phase_folded(sdt, benchmark, wino_ops, folded_mod, _build)
    phase_repairs(sdt, benchmark, fts, _build)

    # Each entry covers the main paths that run the kernel: mono b1 (fp32),
    # stereo b4 (fp32), config-5 stereo b16 (bf16) and the mono bench b128
    # (bf16, fused tail on); conv3x3's fp32 body (mono b1) and bf16 body
    # (the bench) are entries of their own; winograd's is the folded bench
    # encoder's 13 stride-1 convs (bf16, phases 15-16). ms / plain_ms /
    # bound_ms / library_ms are summed over the kernel's calls on those
    # paths, each call timed from Python with its launch; device_ms, where
    # given, is the same calls' device time by CUDA events queued behind a
    # spin kernel (the card's launch latency inside, the host's outside);
    # kernel_ms, where given, their kernel time by torch.profiler; launches
    # are the counts per forward of those paths; max_abs_err is over the
    # same calls.
    def merged(*parts):
        out = {"err": max(r["err"] for r in parts), "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bound_parts": {}}
        keys = ("ms", "plain_ms", "bound_ms")
        for extra in ("library_ms", "device_ms"):
            if all(extra in r for r in parts):
                out[extra] = 0.0
                keys += (extra,)
        for r in parts:
            for k in keys:
                out[k] += r[k]
            for by, t in r["bound_parts"].items():
                out["bound_parts"][by] = out["bound_parts"].get(by, 0.0) + t
        return out

    # conv3x3's two bodies are rows of their own: fp32 (config 1) and bf16
    # (the bench).
    res["conv3x3_fp32"] = res.pop("conv3x3")
    res["conv3x3_bf16"] = bench["kernels"]["conv3x3"]
    res["upsample_concat"] = merged(res["upsample_concat"], stereo_res["upsample_concat"],
                                    bf16_res["upsample_concat"],
                                    bench["kernels"]["upsample_concat"])
    res["correlation"] = stereo_res["correlation"]
    res["correlation_gram"] = bf16_res["correlation_gram"]
    res["soft_argmin"] = merged(stereo_res["soft_argmin"], bf16_res["soft_argmin"])
    res["fused_tail"] = tail_res
    res["winograd"] = wino_res
    launches = {
        "conv3x3_fp32": launches["conv3x3"],
        "conv3x3_bf16": bench["launches"]["conv3x3"],
        "upsample_concat": launches["upsample_concat"] + stereo_launches["upsample_concat"]
        + bf16_launches["upsample_concat"] + bench["launches"]["upsample_concat"],
        "correlation": stereo_launches["correlation"] + bf16_launches.get("correlation", 0),
        "correlation_gram": bf16_launches["correlation_gram"],
        "soft_argmin": stereo_launches["soft_argmin"] + bf16_launches["soft_argmin"],
        "fused_tail": bench["launches"]["fused_tail"],
        "winograd": folded_res["launches"],
    }
    meta = {
        "conv3x3_fp32": ("scenedepthestimation_tpu_torch/csrc/conv_block.cu",
                         "scenedepthestimation_tpu/ops/pallas/conv_block.py:167",
                         f"{CONFIG} b1 decoder, 11 shapes, fp32 (conv3x3_f32_kernel and the "
                         "head kernel)"),
        "conv3x3_bf16": ("scenedepthestimation_tpu_torch/csrc/conv_block.cu",
                         "scenedepthestimation_tpu/ops/pallas/conv_block.py:167",
                         f"{BENCH_CONFIG} b128 decoder, 9 shapes, bf16 (conv3x3_tc_kernel and "
                         "the head kernel)"),
        "upsample_concat": ("scenedepthestimation_tpu_torch/csrc/upsample_concat.cu",
                            "scenedepthestimation_tpu/ops/pallas/upsample_concat.py:37",
                            f"{CONFIG} b1 decoder 4 joins fp32 + {STEREO_CONFIG} b4 "
                            f"aggregation 3 joins fp32 + {BF16_CONFIG} b16 aggregation "
                            f"3 joins bf16 + {BENCH_CONFIG} b128 decoder 4 joins bf16"),
        "correlation": ("scenedepthestimation_tpu_torch/csrc/correlation.cu",
                        "scenedepthestimation_tpu/ops/pallas/correlation.py:113",
                        f"{STEREO_CONFIG} b4 (4, 64, 128, 64) D=48 fp32"),
        "correlation_gram": ("scenedepthestimation_tpu_torch/csrc/correlation_gram.cu",
                             "scenedepthestimation_tpu/ops/pallas/correlation_v2.py:80 + "
                             "scenedepthestimation_tpu/ops/pallas/correlation_v3.py:69",
                             f"{BF16_CONFIG} b16 (16, 96, 288, 64) D=48 bf16"),
        "soft_argmin": ("scenedepthestimation_tpu_torch/csrc/soft_argmin.cu",
                        "scenedepthestimation_tpu/ops/pallas/soft_argmin.py:41",
                        f"{STEREO_CONFIG} b4 (4, 64, 128, 48) x4 + {BF16_CONFIG} b16 "
                        "(16, 96, 288, 48) x4, fp32 cost"),
        "fused_tail": ("scenedepthestimation_tpu_torch/csrc/fused_tail.cu",
                       "scenedepthestimation_tpu/ops/pallas/fused_tail.py:196 + "
                       "scenedepthestimation_tpu/ops/pallas/fused_tail_v2.py:219",
                       f"{BENCH_CONFIG} b128 level 0 (128, 192, 576, 32) -> (128, 384, 1152, "
                       "16) bf16; library_ms is the three-stage cuDNN chain (no one call)"),
        "winograd": ("scenedepthestimation_tpu_torch/csrc/winograd.cu",
                     "scenedepthestimation_tpu/ops/pallas/winograd.py:246",
                     f"{BENCH_CONFIG} b128 folded encoder (fold_bn), its 13 stride-1 BasicBlock "
                     "convs on one forward's inputs, bf16; launches counted on the folded "
                     "forward with those convs routed onto the kernel (phase 16); the served "
                     "paths launch it 0 times, as in the JAX package; library_ms is cuDNN's "
                     "F.conv2d with bias"),
    }
    kernels = []
    for name, (src, rep, shapes) in meta.items():
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["bound_parts"], key=r["bound_parts"].get),
            "library_ms": r.get("library_ms"), "device_ms": r.get("device_ms"),
            "kernel_ms": r.get("kernel_ms"),
            "shapes": shapes})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
