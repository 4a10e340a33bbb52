"""Ablations of the NF4 forward at training and prefill rows on the card:
the wgmma kernel (``csrc/qmm_nf4_wgmma.cu``) and, as the "before", the tile
kernel of ``csrc/qmm_nf4_fwd.cu``.

Run on a machine with an H100 and ``nvcc``, from the root of a checkout:

    python -m qlora_tpu_torch.ops.tile_sweep

Each variant is a kernel's source with one part taken out, compiled into
``build/sweep_tile/``, run on the LLaMA-7B block linears at M = 1024 (and 40)
with double-quantized absmax, its weights rotated past the 50 MB L2, timed
with CUDA events.  Variants that take parts out compute wrong sums: they
time what is left.  The cuts follow ``benchmarks/ablate_kernel.py``:

- ``no absmax multiply``: each weight is the code itself (no absmax read);
- ``no codebook lookup``: the nibble cast to float in place of its code;
- ``no unpack``: the first nibble of each packed word decoded for all its
  bytes;
- ``products only``: no weight loads and no decode (x still arrives by TMA
  in the wgmma kernel and is staged in the tile kernel);
- ``loads only``: the weight and x loaded (and the weight decoded in the
  tile kernel's staging loop), no products; the wgmma kernel's ``no
  products`` keeps its decode and drops only the products, and ``loads
  only`` drops both.

and, for the wgmma kernel only: ``no fence`` (the proxy fence taken out) and
``half rows`` (half of each thread's rows decoded, the rest stored as
zeros).

One line per shape and kernel; nothing here is used by the port.

``python -m qlora_tpu_torch.ops.tile_sweep --mutants`` instead copies the
checkout once per mutant of the wgmma kernel into ``build/mutants/`` (the
high plane reading the low plane's absmax row, the last k-step dropped, the
high plane's x box taken at kp instead of K/2 + kp, the proxy fence taken
out), runs the kernel's ``cuda`` tests in each copy and prints how many
fail: each mutant must fail at least one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "qlora_tpu_torch" / "csrc"
OUT = ROOT / "build" / "sweep_tile"
L2_BYTES = 50 * 2 ** 20
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
ROWS = (1024, 40)   # training rows; a verify chunk's

_DECODE2 = "__fmul_rn(code_at(tab, o0), a0), __fmul_rn(code_at(tab, o1), a1)"
_W_MUL = (_DECODE2, "code_at(tab, o0), code_at(tab, o1)")
_W_LOOKUP = (_DECODE2, "__fmul_rn((float)o0, a0), __fmul_rn((float)o1, a1)")
_W_UNPACK = [("return __byte_perm(o, 0, 0x4440 | e);", "return o & 0x3Cu;")]
_W_DECODE = ("      decode_step<DQ, ALIGNED>(st + 2 * A_BYTES,",
             "      if (false) decode_step<DQ, ALIGNED>(st + 2 * A_BYTES,")
_W_LOADS = ("        issue(s + 2);", "")
_W_MMA = ("wgmma_m64n128k16(acc[mt], gmma_desc(", "if (false) wgmma_m64n128k16(acc[mt], gmma_desc(")
_W_FENCE = ('      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");', "")
_W_HALF = ("    if (r + i < K2) {\n      float al[8]",
           "    if (r + i < K2 && i < ROWS / 2) {\n      float al[8]")
WGMMA = {
    "as built": [],
    "no absmax multiply": [_W_MUL],
    "no codebook lookup": [_W_LOOKUP],
    "no unpack": _W_UNPACK,
    "products only": [_W_DECODE, _W_LOADS],
    "no products": [_W_MMA],
    "no fence": [_W_FENCE],
    "half rows": [_W_HALF],
    "loads only": [_W_DECODE, _W_MMA],
}
_T_MUL = [("wl = __fmul_rn(tab[b & 15], aml);", "wl = tab[b & 15];"),
          ("wh = __fmul_rn(tab[b >> 4], amh);", "wh = tab[b >> 4];")]
_T_LOOKUP = [("wl = __fmul_rn(tab[b & 15], aml);", "wl = __fmul_rn((float)(b & 15), aml);"),
             ("wh = __fmul_rn(tab[b >> 4], amh);", "wh = __fmul_rn((float)(b >> 4), amh);")]
_T_DECODE = ("      if (row < K2 && n < N) {", "      if (false) {")
_T_MMA = ("for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);",
          "for (int j = 0; j < FN; ++j) {}")
TILE = {
    "as built": [],
    "no absmax multiply": _T_MUL,
    "no codebook lookup": _T_LOOKUP,
    "products only": [_T_DECODE],
    "loads only": [_T_MMA],
}


MUTANTS = {
    "high plane reads the low plane's absmax row": [
        ("  const int blk[2] = {blk_lo, blk_hi};", "  const int blk[2] = {blk_lo, blk_lo};")],
    "last k-step dropped": [
        ("  for (int s = 0; s < nsteps; ++s) {\n    const int stage = s % STAGES;\n    mbar_wait",
         "  for (int s = 0; s < nsteps - 1; ++s) {\n    const int stage = s % STAGES;\n    mbar_wait")],
    "high plane's x box at kp": [
        ("tma_load_2d(smem_u32(st + A_BYTES), &xmap, bar, K2 + kp, m0);",
         "tma_load_2d(smem_u32(st + A_BYTES), &xmap, bar, kp, m0);")],
    "no proxy fence": [('      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");', "")],
}
MUTANT_TESTS = "qmm_kernel_matches_plain or wgmma"


def mutants() -> int:
    """Each mutant in a copy of the checkout, its cuda tests run there."""
    import shutil

    base = ROOT / "build" / "mutants"
    survived = []
    for name, edits in MUTANTS.items():
        dst = base / name.replace(" ", "_").replace("'", "")
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
            "build", "chiprun_out", ".git", "__pycache__"))
        src = dst / "qlora_tpu_torch" / "csrc" / "qmm_nf4_wgmma.cu"
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"mutant {name!r}: the source no longer holds {old[:48]!r}")
            text = text.replace(old, new)
        src.write_text(text)
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m", "cuda", "-q",
             "--noconftest", "-p", "no:cacheprovider", "-k", MUTANT_TESTS],
            cwd=dst, capture_output=True, text=True, timeout=900)
        tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else run.stderr[-300:]
        print(f"tile_sweep mutant {name!r}: {tail}", flush=True)
        if run.returncode == 0:
            survived.append(name)
    print(f"tile_sweep mutants surviving: {survived}", flush=True)
    return 1 if survived else 0


def build(variants) -> dict:
    """Compile every (source, name, edits, entry, argtypes) at once, one
    nvcc each; {(source, name): typed C entry}."""
    from qlora_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for source, name, edits, entry, argtypes in variants:
        text = (CSRC / source).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{source} {name!r}: the source no longer holds {old[:48]!r}")
            text = text.replace(old, new)
        stem = f"{Path(source).stem}_{name.replace(' ', '_')}"
        (OUT / f"{stem}.cu").write_text(text)
        lib = OUT / f"lib{stem}.so"
        procs.append((source, name, entry, argtypes, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(OUT / f"{stem}.cu")])))
    fns = {}
    for source, name, entry, argtypes, lib, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"{source} {name!r}: nvcc failed")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[(source, name)] = fn
    return fns


def events_ms(fn, iters: int = 20) -> float:
    import torch

    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from qlora_tpu_torch.quant import quantize

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    built = build([("qmm_nf4_wgmma.cu", n, e, "qmm_nf4_wgmma", [P] * 7 + [I] * 8 + [P])
                   for n, e in WGMMA.items()]
                  + [("qmm_nf4_fwd.cu", n, e, "qmm_nf4_fwd", qm._ARGTYPES)
                     for n, e in TILE.items()])
    kernels = {"wgmma": {n: built[("qmm_nf4_wgmma.cu", n)] for n in WGMMA},
               "tile (before)": {n: built[("qmm_nf4_fwd.cu", n)] for n in TILE}}
    g = torch.Generator(device=dev).manual_seed(6)
    for K, N in SHAPES:
        qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
        copies = [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(), absmax=qt.absmax.clone())
                         for _ in range(max(1, -(-2 * L2_BYTES // qt.nbytes)) - 1)]
        _, _, scale, offset = qm._check_quantized(qt, qt.device)
        code = qm._code_on(qt.quant_type, dev)
        for M, kname in ((M, k) for M in ROWS for k in kernels):
            fns = kernels[kname]
            plan = qm.tile_plan(M, K, N, qt.block_size)
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
            line = []
            for name, fn in fns.items():
                def launch(i, fn=fn, wgmma=kname == "wgmma", M=M, plan=plan, x=x, y=y):
                    q = copies[i % len(copies)]
                    args = [x.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(),
                            scale.data_ptr(), offset.data_ptr(), code.data_ptr(), y.data_ptr(),
                            M, K, N, qt.block_size, 1]
                    if wgmma:
                        args += [plan.tm, plan.stages, plan.smem]
                    err = fn(*args, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{kname} {name}: cudaError_t {err}")
                line.append(f"{name} {events_ms(launch):.4f}")
            print(f"tile_sweep {kname} M={M} K={K} N={N} (ms): " + ", ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(mutants() if "--mutants" in sys.argv[1:] else main())
