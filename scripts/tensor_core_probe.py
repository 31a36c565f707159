"""Where the tensor-core kernels (flash attention, the SSD scan) spend their
time on the card.

Four measurements, in one process on one CUDA card:

1. the rate of TF32 ``mma.sync.m16n8k8`` alone: a kernel that issues only
   that instruction, on 1 to 8 independent accumulators a warp, at several
   warp counts, the flash kernel's among them;
2. the static instruction mix of the flash kernel instance that the scoring
   path runs (float32, d 64), from ``cuobjdump -sass`` of its library;
3. the flash kernel at the scoring path's shape (b 4, h 32, s 2048, d 64,
   causal, float32, the model's strided views) beside variants that each
   take one part of its work out.  A variant computes a wrong result and is
   only timed;
4. the SSD scan at the scoring path's shape (b 4, s 2048, h 64, p 64, n 64,
   chunk 256, float32) beside the variants of the shared header, with the
   device time of each of its four CUDA kernels from torch.profiler.

The variants are built from copies of ``csrc/`` sources edited as text,
into ``src/repro_torch/kernels/_build/probe/`` (which git ignores), with
``-I`` to ``csrc/``, so the package's sources and the hash that names its
libraries are never touched.  An edit that no longer matches the source
fails the run.  Times are CUDA events over a CUDA-graph replay, as
``chip_smoke.py`` phase 5 takes them; each committed kernel is timed first
and last.

    PYTHONPATH=src python scripts/tensor_core_probe.py [--json PATH]

Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402  (the repo's timing and input helpers)
from repro_torch.kernels import build  # noqa: E402

PROBE_DIR = build.BUILD_DIR / "probe"
MMA_FLOP = 2 * 16 * 8 * 8  # one m16n8k8 product

MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "tf32_mma.cuh"

// Only mma.sync: C independent accumulators per warp, `iters` rounds.
template <int C>
__global__ void mma_rate_kernel(float* out, int iters) {
  const float x = 1.f + threadIdx.x * 1e-3f;
  uint32_t a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = tc::tf32(x + e);
  b[0] = tc::tf32(2.f * x);
  b[1] = tc::tf32(3.f * x);
  float c[C][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) tc::mma(c[j], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int probe_mma_rate(float* out, int blocks, int threads,
                              int chains, int iters, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chains) {
#define RATE(C) mma_rate_kernel<C><<<blocks, threads, 0, st>>>(out, iters)
    case 1: RATE(1); break;
    case 2: RATE(2); break;
    case 4: RATE(4); break;
    case 8: RATE(8); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""

# (warps a block, blocks an SM, accumulators a warp).  The flash kernel at
# d 64 holds 2 blocks of 4 warps an SM (its registers allow no more).
MMA_RATE_CONFIGS = [(4, 2, 1), (4, 2, 2), (4, 2, 4), (4, 2, 8), (4, 4, 8),
                    (8, 4, 8), (16, 2, 8), (32, 1, 8)]

# Each variant: (what it takes out, [(file, text, replacement), ...]).
_HDR = "tf32_mma.cuh"
_SRC = "flash_attention.cu"
ONE_PASS = [(_HDR, "  mma(c, a_lo, b_hi);\n  mma(c, a_hi, b_lo);\n"
             "  mma(c, a_hi, b_hi);\n}", "  mma(c, a_hi, b_hi);\n}"),
            (_HDR, "#pragma unroll\n"
             "  for (int i = 0; i < N; ++i) mma(c[i], a_lo, b_hi[i]);\n"
             "#pragma unroll\n"
             "  for (int i = 0; i < N; ++i) mma(c[i], a_hi, b_lo[i]);\n", "")]
NO_SPLIT = (_HDR, "  hi = tf32(x);\n  lo = tf32(x - __uint_as_float(hi));",
            "  hi = __float_as_uint(x);\n  lo = hi;")
NO_EXP2 = (_SRC, "exp2f(", "(")
NO_LOADS = [(_SRC, "    tc::stage(k_s, LD, k_bh", "    if (false) "
             "tc::stage(k_s, LD, k_bh"),
            (_SRC, "    tc::stage(k_s + kTile * LD, LD, v_bh",
             "    if (false) tc::stage(k_s + kTile * LD, LD, v_bh")]
NO_BARRIER = (_SRC, "    tc::cp_async_wait<0>();\n    // tile `it` is in; "
              "every warp is done with the buffer tile it + 1 fills\n"
              "    __syncthreads();\n", "")
VARIANTS = {"flash_attention": {
    "one_tf32_pass": ("two of the three mma passes (and the lo halves "
                      "that only they read)", ONE_PASS),
    "no_split": ("the hi/lo split: cvt.rna x2 and a subtraction per "
                 "operand element", [NO_SPLIT]),
    "no_exp2": ("exp2f of the softmax", [NO_EXP2]),
    "no_kv_loads": ("the cp.async K/V tile loads", NO_LOADS),
    "no_barrier": ("the wait and the barrier per key tile", [NO_BARRIER]),
    "no_qk": ("S = Q.K^T: its mma, K loads from shared memory and K "
              "splits", [(_SRC, "        tc::mma3(s[nt], ah, al, bh, bl);\n",
                          "")]),
    "no_pv": ("P.V: its mma, V loads from shared memory, V and P splits",
              [(_SRC, "        tc::mma3(pv[dn], ph, pl, bh, bl);\n", "")]),
    "mma_and_smem_only": ("the split, exp2f, the K/V loads and the barrier",
                          [NO_SPLIT, NO_EXP2, *NO_LOADS, NO_BARRIER]),
}, "ssd_scan": {
    "one_tf32_pass": ("two of the three mma passes (and the lo halves "
                      "that only they read)", ONE_PASS),
    "no_split": ("the hi/lo split: cvt.rna x2 and a subtraction per "
                 "operand element", [NO_SPLIT]),
}}


def variant_sources(kernel, name):
    """The edited copies of the variant's files: {file name: text}, the
    kernel's ``.cu`` among them."""
    edits = VARIANTS[kernel][name][1]
    texts = {}
    for file, old, new in edits:
        file = kernel + ".cu" if file == _SRC else file
        text = texts.get(file) or (build.CSRC / file).read_text()
        if old not in text:
            raise RuntimeError(f"variant {kernel} {name}: {file} no longer "
                               f"holds {old!r}")
        texts[file] = text.replace(old, new)
    main = kernel + ".cu"
    texts.setdefault(main, (build.CSRC / main).read_text())
    return texts


def build_all(sources):
    """One nvcc per library, started together: {name: {file: text}} ->
    {name: path of the library}."""
    compiler = build.nvcc()
    started = {}
    for name, texts in sources.items():
        directory = PROBE_DIR / name
        shutil.rmtree(directory, ignore_errors=True)
        directory.mkdir(parents=True)
        for file, text in texts.items():
            (directory / file).write_text(text)
        main = next(f for f in texts if f.endswith(".cu"))
        target = directory / "lib.so"
        command = [compiler, *build.NVCC_FLAGS, "-I", str(build.CSRC),
                   "-o", str(target), str(directory / main)]
        started[name] = (subprocess.Popen(command, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), target)
    built = {}
    for name, (process, target) in started.items():
        log, _ = process.communicate()
        if process.returncode != 0:
            raise RuntimeError(f"nvcc failed on probe {name}:\n{log}")
        built[name] = target
    return built


def mma_rates(torch, library):
    lib = ctypes.CDLL(str(library))
    fn = lib.probe_mma_rate
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for warps, per_sm, chains in MMA_RATE_CONFIGS:
        blocks, threads = sms * per_sm, 32 * warps
        iters = 160000 // chains
        out = torch.empty(blocks * threads, device="cuda")

        def run():
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(out.data_ptr(), blocks, threads, chains, iters, stream)
            if code != 0:
                raise RuntimeError(f"probe_mma_rate: CUDA error {code}")

        ms = chip_smoke.time_ms(run, warmup=2, launches=3, repeats=5,
                                graph=False)
        flop = blocks * warps * iters * chains * MMA_FLOP
        rows.append({"warps_per_block": warps, "blocks_per_sm": per_sm,
                     "accumulators_per_warp": chains, "ms": ms,
                     "tflops": flop / ms / 1e9})
        chip_smoke.log(f"  mma.sync tf32: {json.dumps(rows[-1])}")
    return rows


def sass_mix(library, pattern="flash_attention_kernelIfLi64E"):
    """Opcode counts of one kernel's SASS (static, the whole function)."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    functions = re.split(r"\n\s*Function : ", text)
    body = next(f for f in functions if f.startswith("_Z") and pattern in
                f.split("\n", 1)[0])
    counts = collections.Counter(
        match.group(1) for match in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)",
            body))
    return dict(counts.most_common())


def variant_wrapper(cls, library):
    """An instance of the wrapper class ``cls`` that calls ``library``."""
    lib = ctypes.CDLL(str(library))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    wrapper = cls()
    with mock.patch.object(build, "load", lambda _name: lib):
        wrapper._kernel()
    return wrapper


def flash_variants(torch, built):
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     flash_attention)
    b, h, s, d = chip_smoke.ZAMBA_BATCH, 32, chip_smoke.ZAMBA_SEQ, 64
    q, k, v = chip_smoke.flash_inputs(b, h, h, s, s, d, torch.float32,
                                      np.random.RandomState(chip_smoke.SEED))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]

    def timed(kernel):
        return chip_smoke.time_ms(lambda: kernel(*views, True, None),
                                  warmup=3, launches=20, graph=True)

    wrappers = {name: variant_wrapper(FlashAttention, library)
                for name, library in built.items()}
    rows = {"committed": timed(flash_attention)}
    chip_smoke.log(f"  flash committed: {rows['committed']:.4f} ms")
    for name, wrapper in wrappers.items():
        rows[name] = timed(wrapper)
        chip_smoke.log(f"  flash {name} (without "
                       f"{VARIANTS['flash_attention'][name][0]}): "
                       f"{rows[name]:.4f} ms")
    rows["committed_again"] = timed(flash_attention)
    chip_smoke.log(f"  flash committed again: "
                   f"{rows['committed_again']:.4f} ms")
    return rows


def ssd_variants(torch, built):
    from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan
    inputs = chip_smoke.ssd_inputs(
        chip_smoke.ZAMBA_BATCH, chip_smoke.ZAMBA_SEQ, 64, 64, 64,
        np.random.RandomState(chip_smoke.SEED), model_like=True)
    chunk = 256

    def timed(kernel):
        ms = chip_smoke.time_ms(lambda: kernel(*inputs, chunk), warmup=3,
                                launches=20, graph=True)
        launched = chip_smoke.device_kernels(torch,
                                             lambda: kernel(*inputs, chunk))
        by_kernel = {re.search(r"ssd_\w+_kernel", name).group(0): k_ms
                     for name, k_ms in launched or []}
        return {"ms": ms, "device_ms_by_kernel": by_kernel}

    rows = {"committed": timed(ssd_scan)}
    chip_smoke.log(f"  ssd committed: {json.dumps(rows['committed'])}")
    for name, library in built.items():
        rows[name] = timed(variant_wrapper(SSDScan, library))
        chip_smoke.log(f"  ssd {name} (without "
                       f"{VARIANTS['ssd_scan'][name][0]}): "
                       f"{json.dumps(rows[name])}")
    rows["committed_again"] = timed(ssd_scan)
    chip_smoke.log(f"  ssd committed again: "
                   f"{json.dumps(rows['committed_again'])}")
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", type=Path, help="write the results here")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tensor_core_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"card: {card}; torch {torch.__version__} cuda "
                   f"{torch.version.cuda}")
    build.build(list(VARIANTS))
    sources = {f"{kernel}-{name}": variant_sources(kernel, name)
               for kernel in VARIANTS for name in VARIANTS[kernel]}
    sources["mma_rate"] = {"mma_rate.cu": MMA_RATE_SOURCE}
    built = build_all(sources)
    mma_library = built.pop("mma_rate")
    by_kernel = {kernel: {name: built[f"{kernel}-{name}"]
                          for name in VARIANTS[kernel]}
                 for kernel in VARIANTS}

    chip_smoke.log("1. TF32 mma.sync m16n8k8 alone")
    rates = mma_rates(torch, mma_library)
    chip_smoke.log("2. SASS of flash_attention_kernel<float, 64> (static "
                   "counts, whole function)")
    mix = sass_mix(build.library_path("flash_attention"))
    chip_smoke.log(f"  {json.dumps(mix)}")
    chip_smoke.log("3. flash attention at the scoring path's shape, "
                   "committed and variants")
    flash = flash_variants(torch, by_kernel["flash_attention"])
    chip_smoke.log("4. SSD scan at the scoring path's shape, committed and "
                   "variants")
    ssd = ssd_variants(torch, by_kernel["ssd_scan"])
    result = {"card": card, "mma_rate": rates, "flash_sass_mix": mix,
              "flash_ms": flash, "ssd": ssd}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
