"""Ablations of the decode kernel (``csrc/qmm_nf4_decode.cu``) on the card.

Run on a machine with an H100 and ``nvcc``, from the root of a checkout:

    python -m qlora_tpu_torch.ops.decode_sweep

Each variant is the kernel's source with one part taken out or one
constant changed, compiled into ``build/sweep/``; every variant runs the
real kernel's split plan on the LLaMA-7B block linears (and a tiny weight,
whose time is the launch's fixed cost) at M = 4 and 16, timed in a CUDA
graph with its inputs rotated past the 50 MB L2.  Variants that take
parts out compute wrong sums: they time what is left.  One line per
shape and row count; nothing here is used by the port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "qlora_tpu_torch" / "csrc" / "qmm_nf4_decode.cu"
OUT = ROOT / "build" / "sweep"

_DECODE = ("  const float lo = __fmul_rn(tab[b & 15], am_lo);\n"
           "  const float hi = __fmul_rn(tab[(b >> 4) & 15], am_hi);\n"
           "  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
           "  return *reinterpret_cast<const uint32_t*>(&v);",
           "  return b | (b << 16) | __float_as_uint(am_lo + am_hi);")
_MMA = ("for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][i], a, bx[mt][0], bx[mt][1]);",
        "for (int mt = 0; mt < MT; ++mt) acc[mt][i][0] += "
        "__uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ bx[mt][0] ^ bx[mt][1]) & 0x3fffffff);")
_DEPTH = lambda n: ("constexpr int DEPTH = 1;", f"constexpr int DEPTH = {n};")
VARIANTS = {
    "as built": [],
    "no decode": [_DECODE],                 # bytes go to the tensor cores undecoded
    "no mma": [_MMA],                       # decoded, not multiplied
    "loads only": [_DECODE, _MMA],          # the weight and absmax streamed, little else
    "depth 2": [_DEPTH(2)],
    "depth 4": [_DEPTH(4)],
}
SHAPES = ((256, 128), (4096, 4096), (4096, 11008), (11008, 4096))
ROWS = (4, 16)
L2_BYTES = 50 * 2 ** 20


def build(name: str, edits) -> ctypes._CFuncPtr:
    from qlora_tpu_torch.ops import _build

    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: the source no longer holds {old[:40]!r}")
        text = text.replace(old, new)
    stem = name.replace(" ", "_")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{stem}.cu").write_text(text)
    lib = OUT / f"lib{stem}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(OUT / f"{stem}.cu")],
                   check=True)
    fn = ctypes.CDLL(str(lib)).qmm_nf4_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def graph_ms(fn, iters: int = 100) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    from qlora_tpu_torch.quant import quantize

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    fns = {name: build(name, edits) for name, edits in VARIANTS.items()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(5)
    for K, N in SHAPES:
        qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
        copies = [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(), absmax=qt.absmax.clone())
                         for _ in range(max(1, -(-2 * L2_BYTES // qt.nbytes)) - 1)]
        _, _, scale, offset = qm._check_quantized(qt, qt.device)
        code = qm._code_on(qt.quant_type, dev)
        plan = qm.decode_plan(K, N, qt.block_size, sms)
        for M in ROWS:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
            line = []
            for name, fn in fns.items():
                def launch(i, fn=fn):
                    q = copies[i % len(copies)]
                    err = fn(x.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(),
                             scale.data_ptr(), offset.data_ptr(), code.data_ptr(), y.data_ptr(),
                             M, K, N, qt.block_size, 1, plan.splits, plan.unit,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                line.append(f"{name} {graph_ms(launch):.4f}")
            print(f"decode_sweep K={K} N={N} M={M} splits={plan.splits} (ms): "
                  + ", ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
