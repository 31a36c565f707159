"""Where decode attention and V-trace spend their time at their main paths'
shapes, which lie far below one launch's cost.

In one process on one CUDA card:

1. the launch floor: one ``add_(1)`` on a one-element tensor, timed as
   ``chip_smoke.py`` times every kernel (CUDA events over a CUDA-graph
   replay);
2. each committed kernel at its path's shape (decode attention: b 16, h 4,
   kv 2, s 8, d 64, float32, the serve step's; V-trace: T 20, B 16, the
   learner's batch-major views), beside variants that each take one part
   out, built from copies of ``csrc/`` sources edited as text (as
   ``scripts/tensor_core_probe.py`` builds its variants): graph ms, and the
   kernel's own device time (start to end on the card, the median of 50
   calls traced by torch.profiler, so without the launch gaps);
3. instrumented copies of each kernel that record ``clock64()`` at the
   boundaries of its phases in block 0, thread 0 (``phases``), or run one
   phase twice (``twice``), so the device time splits into loads, compute
   and stores, and a phase's second run shows whether the first paid for
   cold code or data (SM cycles; the SM clock nvidia-smi reads after the
   run is printed beside them).

    PYTHONPATH=src python scripts/latency_probe.py [--json PATH] [--sass DIR]

``--sass`` writes ``cuobjdump -sass`` of the committed libraries.
Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import chip_smoke  # noqa: E402  (the repo's timing and input helpers)
import tensor_core_probe as tcp  # noqa: E402  (variant build and binding)
from repro_torch.kernels import build  # noqa: E402

PROBE_HEADER = r"""
__device__ long long probe_t[8];
#define PROBE_MARK(i)                                                  \
  do {                                                                 \
    if (blockIdx.x + blockIdx.y + blockIdx.z + threadIdx.x == 0)      \
      probe_t[i] = clock64();                                          \
  } while (0)
extern "C" int probe_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, probe_t, sizeof(probe_t));
}
"""
_INCLUDE = '#include "cp_async.cuh"\n'

def _after(anchor, line):
    """An edit that puts ``line`` right after ``anchor``."""
    return anchor, anchor + line


def _before(anchor, line):
    return anchor, line + anchor


_DECODE_TOP = ("    __syncthreads();\n"
               "    if (t + 1 < n_tiles) issue(t + 1, end);\n")
_VTRACE_TOP = ("    __syncthreads();\n"
               "    if (c > 0) issue(c - 1, (k + 1) % kStages);\n")

# (label of the span that ends at each mark)
DECODE_MARKS = ["start", "K/V tile 0 and q in, barrier",
                "scores and online softmax (warp 0)", "P.V",
                "output stores (warp 0)"]
DECODE_PHASES = [
    _after(_INCLUDE, PROBE_HEADER),
    _after("  const int head0 = kvh * group + g_first;\n",
           "  PROBE_MARK(0);\n"),
    _before("    if (t + 1 < n_tiles) issue(t + 1, end);\n",
            "    if (t == 0) PROBE_MARK(1);\n"),
    _after("        alpha[g] = a;\n      }\n    }\n    __syncwarp();\n",
           "    if (t == 0) PROBE_MARK(2);\n"),
    _before("  T* out_row = out + ((size_t)row * h + head0) * D;\n",
            "  PROBE_MARK(3);\n"),
    _before("    return;\n  }\n\n  // merge the four warps",
            "    PROBE_MARK(4);\n"),
]
VTRACE_MARKS = ["start", "chunk 0 in, barrier", "A: deltas, barrier",
                "B: the chain (warp 0), barrier", "C: advantages, barrier",
                "D: stores"]
VTRACE_PHASES = [
    _after(_INCLUDE, PROBE_HEADER),
    _after("  const int n_chunks = (T + kRows - 1) / kRows;\n",
           "  PROBE_MARK(0);\n"),
    _before("    if (c > 0) issue(c - 1, (k + 1) % kStages);\n",
            "    if (k == 0) PROBE_MARK(1);\n"),
    _before("\n    // B: the serial chain",
            "    if (k == 0) PROBE_MARK(2);\n"),
    _before("\n    // C: four elements", "    if (k == 0) PROBE_MARK(3);\n"),
    _before("\n    // D: store", "    if (k == 0) PROBE_MARK(4);\n"),
    _before("  }\n}\n\ntemplate <bool kBatchMajor, bool kVec>\n",
            "  PROBE_MARK(5);\n"),
]


def _block(text, first, last):
    """The text from the line that starts with ``first`` through the first
    line after it that equals ``last``."""
    start = text.index(first)
    end = text.index(last, start) + len(last)
    return text[start:end]


def _decode_twice(text):
    """Tile 0 copied in again, then the scores and softmax run twice, with
    marks between: the second run finds the code and the data where the
    first left them."""
    soft = _block(text, "    // scores and online softmax",
                  "    __syncwarp();\n\n    // acc")[:-len("\n    // acc")]
    stage = ("      tc::stage(tiles + (size_t){i} * TK * LDS, LDS, {src} + "
             "begin * key_stride,\n                (long long)key_stride, "
             "rows, rows, D, D, vec);\n")
    reload = ("    if (t == 0) {\n      PROBE_MARK(0);\n"
              "      const int rows = min(TK, end - begin);\n" +
              stage.format(i=2, src="k_row") + stage.format(i=3, src="v_row") +
              "      tc::cp_async_commit();\n      tc::cp_async_wait<0>();\n"
              "      __syncthreads();\n      PROBE_MARK(1);\n    }\n")
    text = text.replace(_DECODE_TOP, _DECODE_TOP.replace(
        "    if (t + 1", reload + "    if (t + 1"))
    marked = "".join([
        "    {\n", soft, "    }\n    if (t == 0) PROBE_MARK(2);\n",
        "    {\n", soft, "    }\n    if (t == 0) PROBE_MARK(3);\n"])
    return text.replace(soft, marked)


def _vtrace_twice(text):
    """Chunk 0 copied in again, then the chain run twice, with marks
    between."""
    chain = _block(text, "    // B: the serial chain, one warp\n",
                   "    __syncthreads();\n\n    // C:")
    chain = chain[:-len("    __syncthreads();\n\n    // C:")]
    reload = ("    if (k == 0) {\n      PROBE_MARK(0);\n"
              "      issue(c, (k + 1) % kStages);\n"
              "      tc::cp_async_wait<0>();\n      __syncthreads();\n"
              "      PROBE_MARK(1);\n    }\n")
    text = text.replace(_VTRACE_TOP, _VTRACE_TOP.replace(
        "    if (c > 0)", reload + "    if (c > 0)"))
    marked = (chain + "    if (k == 0) PROBE_MARK(2);\n" + chain +
              "    if (k == 0) PROBE_MARK(3);\n")
    return text.replace(chain, marked, 1)


# kernel -> {variant: (what it takes out, edits)}: edits are (old, new)
# pairs, or a function of the source text
VARIANTS = {
    "decode_attention": {
        "phases": ("nothing: clock64() marks in block 0", DECODE_PHASES),
        "twice": ("nothing: tile 0, the scores and softmax done again",
                  [_after(_INCLUDE, PROBE_HEADER), _decode_twice]),
        "no_tile_compute": ("scores, softmax and P.V (loads, merge kept)", [
            ("    if (nw == 0) continue;  // warp-uniform; no barrier below\n",
             "    continue;\n")]),
        "empty": ("everything after the block's indices", [
            _after("  const int head0 = kvh * group + g_first;\n",
                   "  if (threadIdx.x < kThreads) return;\n")]),
    },
    "vtrace": {
        "phases": ("nothing: clock64() marks in block 0", VTRACE_PHASES),
        "twice": ("nothing: chunk 0 and the chain done again",
                  [_after(_INCLUDE, PROBE_HEADER), _vtrace_twice]),
        "no_chain": ("the serial chain (loads, A, C and stores kept)", [
            ("    if (tid < 32) {\n", "    if (tid < 0) {\n")]),
        "empty": ("everything", [
            _after("  const int tid = threadIdx.x;\n",
                   "  if (tid < kThreads) return;\n")]),
    },
}
MARKS = {
    ("decode_attention", "phases"): DECODE_MARKS,
    ("decode_attention", "twice"): [
        "start", "tile 0 again (warm): copy, wait, barrier",
        "scores and softmax (cold)", "scores and softmax again (warm)"],
    ("vtrace", "phases"): VTRACE_MARKS,
    ("vtrace", "twice"): ["start", "chunk 0 again (warm): copy, wait, "
                          "barrier", "chain (cold)", "chain again (warm)"],
}


def variant_sources(kernel, name):
    text = (build.CSRC / f"{kernel}.cu").read_text()
    for edit in VARIANTS[kernel][name][1]:
        if callable(edit):
            edited = edit(text)
        else:
            old, new = edit
            if text.count(old) != 1:
                raise RuntimeError(f"variant {kernel} {name}: {kernel}.cu "
                                   f"holds {text.count(old)} copies of "
                                   f"{old!r}")
            edited = text.replace(old, new)
        if edited == text:
            raise RuntimeError(f"variant {kernel} {name}: an edit changed "
                               f"nothing")
        text = edited
    return {f"{kernel}.cu": text}


def device_ms(torch, fn, calls=50):
    """Median start-to-end device time of each kernel ``fn`` launches, over
    ``calls`` calls traced in one torch.profiler session (the session's
    first calls warm it up and are dropped)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 10):
            fn()
            torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        name = re.search(r"\w+_kernel", e.name)
        if e.device_type == DeviceType.CUDA and name:
            times.setdefault(name.group(0), []).append(
                e.device_time_total / 1e3)
    return {name: statistics.median(ms[10:] or ms)
            for name, ms in times.items()}


def sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0])


def probe(torch, kernel_name, cls, committed, built, call_of):
    rows = {}
    for name, wrapper in [("committed", committed)] + [
            (name, tcp.variant_wrapper(cls, lib)) for name, lib in
            built.items()]:
        fn = call_of(wrapper)
        rows[name] = {"graph_ms": chip_smoke.time_ms(fn, graph=True),
                      "device_ms": device_ms(torch, fn)}
        if (kernel_name, name) in MARKS:
            marks = MARKS[(kernel_name, name)]
            lib = ctypes.CDLL(str(built[name]))
            lib.probe_read.argtypes = [ctypes.c_void_p]
            stamps = (ctypes.c_longlong * 8)()
            fn()
            torch.cuda.synchronize()
            if lib.probe_read(stamps) != 0:
                raise RuntimeError("probe_read failed")
            cycles = [stamps[i + 1] - stamps[i]
                      for i in range(len(marks) - 1)]
            rows[name]["phase_cycles"] = dict(zip(marks[1:], cycles))
        chip_smoke.log(f"  {kernel_name} {name}: {json.dumps(rows[name])}")
    rows["committed_again"] = {
        "graph_ms": chip_smoke.time_ms(call_of(committed), graph=True)}
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", type=Path, help="write the results here")
    parser.add_argument("--sass", type=Path,
                        help="write the committed kernels' SASS into this "
                             "directory (cuobjdump -sass)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("latency_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.decode_attention import (DecodeAttention,
                                                      decode_attention)
    from repro_torch.kernels.vtrace import VTrace, vtrace
    card = chip_smoke.card_line()
    chip_smoke.log(f"card: {card}; torch {torch.__version__}")
    build.build(list(VARIANTS))
    built = tcp.build_all({f"{k}-{n}": variant_sources(k, n)
                           for k in VARIANTS for n in VARIANTS[k]})
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
        for kernel in VARIANTS:
            (args.sass / f"{kernel}.sass").write_text(subprocess.run(
                [str(cuobjdump), "-sass", str(build.library_path(kernel))],
                capture_output=True, text=True, check=True).stdout)

    floor = chip_smoke.launch_floor(torch)
    chip_smoke.log(f"  launch floor {json.dumps(floor)}")
    rng = np.random.RandomState(chip_smoke.SEED)
    lengths = chip_smoke.serve_lengths(16, 8, rng)
    dec = chip_smoke.decode_inputs(16, 4, 2, 8, 64, lengths, torch.float32,
                                   rng)
    vt = chip_smoke.vtrace_inputs(20, 16, rng, batch_major=True)
    result = {"card": card, **floor}
    result["decode_attention"] = probe(
        torch, "decode_attention", DecodeAttention, decode_attention,
        {n: built[f"decode_attention-{n}"] for n in
         VARIANTS["decode_attention"]},
        lambda w: (lambda: w(*dec)))
    result["vtrace"] = probe(
        torch, "vtrace", VTrace, vtrace,
        {n: built[f"vtrace-{n}"] for n in VARIANTS["vtrace"]},
        lambda w: (lambda: w(*vt)))
    result["sm_clock_mhz"] = sm_clock_mhz()
    chip_smoke.log(f"  SM clock after the run: {result['sm_clock_mhz']} MHz")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
