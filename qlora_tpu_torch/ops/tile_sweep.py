"""Ablations of the wgmma kernels at training and prefill rows on the card:
the NF4 forward (``csrc/qmm_nf4_wgmma.cu``) with, as its "before", the tile
kernel of ``csrc/qmm_nf4_fwd.cu``; the int8 forward and dx
(``csrc/qmm_i8_wgmma.cu``) with, as theirs, the tile kernel of
``csrc/qmm_i8.cu``; the NF4 dx (``csrc/qmm_nf4_bwd_wgmma.cu``) with, as its,
``csrc/qmm_nf4_bwd.cu``.

Run on a machine with an H100 and ``nvcc``, from the root of a checkout:

    python -m qlora_tpu_torch.ops.tile_sweep [nf4 | int8 | nf4bwd]

Each variant is a kernel's source with one part taken out, compiled into
``build/sweep_tile/``, run on the LLaMA-7B block linears at M = 1024 (and,
for NF4, 40) with double-quantized absmax, its weights rotated past the 50
MB L2, timed with CUDA events.  Variants that take parts out compute wrong
sums: they time what is left.  The cuts follow
``benchmarks/ablate_kernel.py``:

- ``no absmax multiply``: each weight is the code itself (no absmax read);
- ``no codebook lookup``: the nibble cast to float in place of its code;
- ``no unpack``: the first nibble of each packed word decoded for all its
  bytes;
- ``products only``: no weight loads and no decode (x still arrives by TMA
  in the wgmma kernels and is staged in the tile kernel);
- ``loads only``: the weight and x loaded (and the weight decoded in the
  tile kernel's staging loop), no products; the wgmma kernels' ``no
  products`` keeps their decode and drops only the products, and ``loads
  only`` drops both.

and, for the NF4 wgmma kernel only: ``no fence`` (the proxy fence taken out)
and ``half rows`` (half of each thread's rows decoded, the rest stored as
zeros).  The int8 kernel is cut as built, products only, no products and
loads only, forward and backward, beside ``qmm_i8.cu`` as built, and run in
the designs it was chosen against: codes made floats by int-to-float
conversions, each ring stage released a k-step late (one k-step of wgmmas
left in flight), 128-row CTAs.

The NF4 dx kernel is cut as built, products only, no products and loads
only at M = 1024 with double-quantized absmax, and run with 128-row CTAs,
beside ``qmm_nf4_bwd.cu`` as built.

One line per shape, direction and kernel; nothing here is used by the port.

``python -m qlora_tpu_torch.ops.tile_sweep --mutants [nf4 | int8 | nf4bwd]`` instead
copies the checkout once per mutant of a wgmma kernel into
``build/mutants/``, runs that kernel's ``cuda`` tests in each copy and
prints how many fail: each mutant must fail at least one.  NF4: the high
plane reading the low plane's absmax row, the last k-step dropped, the high
plane's x box taken at kp instead of K/2 + kp, the proxy fence taken out.
int8: the backward's absmax row taken one block off, the last k-step
dropped, the proxy fence taken out.  NF4 dx: the high plane reading the low
plane's absmax row, the low run's mask at K/2 dropped, the last k-step
dropped, the proxy fence taken out.
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
MUTANT_TESTS = "qmm_kernel_matches_plain or (wgmma and not i8)"

_I8_DECODE = ("      decode_step<DQ, BWD, ALIGNED>(st + A_BYTES,",
              "      if (false) decode_step<DQ, BWD, ALIGNED>(st + A_BYTES,")
_I8_MMA = ("wgmma_m64n128k16<BWD ? 0 : 1>(acc[mt],", "if (false) wgmma_m64n128k16<BWD ? 0 : 1>(acc[mt],")
I8 = {
    "as built": [],
    "products only": [_I8_DECODE, _W_LOADS],
    "no products": [_I8_MMA],
    "loads only": [_I8_DECODE, _I8_MMA],
    # the designs the kernel chose against
    "int-to-float codes": [(
        "  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | e)) - 8388736.f;",
        "  return (float)(int8_t)(w >> (8 * e));")],
    "stage released a k-step late": [(
        "    wgmma_commit();\n    wgmma_wait_all();\n"
        "    if (lane == 0) mbar_arrive(smem_u32(empty + stage));\n  }\n",
        "    wgmma_commit();\n    asm volatile(\"wgmma.wait_group.sync.aligned 1;\" ::: \"memory\");\n"
        "    if (s > 0 && lane == 0) mbar_arrive(smem_u32(empty + (s + STAGES - 1) % STAGES));\n"
        "  }\n  wgmma_wait_all();\n")],
}
I8_MUTANTS = {
    "backward absmax row one block off": [
        ("        blk = row(0) / B;", "        blk = max(row(0) / B - 1, 0);")],
    "last k-step dropped": MUTANTS["last k-step dropped"],
    "no proxy fence": MUTANTS["no proxy fence"],
}
I8_MUTANT_TESTS = "i8_fwd_and_bwd or i8_kernels or i8_wgmma"

_NB_DECODE = ("      decode_step<DQ, ALIGNED>(st + A_BYTES,",
              "      if (false) decode_step<DQ, ALIGNED>(st + A_BYTES,")
_NB_LOADS = ("      issue(s + 2);\n", "")
NF4_BWD = {
    "as built": [],
    "products only": [_NB_DECODE, _NB_LOADS],
    "no products": [_W_MMA],
    "loads only": [_NB_DECODE, _W_MMA],
}
NF4_BWD_MUTANTS = {
    "high plane reads the low plane's absmax row": MUTANTS[
        "high plane reads the low plane's absmax row"],
    "low run's mask at K/2 dropped": [
        ("    if (m >= M || p >= K2) continue;",
         "    if (m >= M || (ch >= TP / 8 && p >= K2)) continue;")],
    "last k-step dropped": MUTANTS["last k-step dropped"],
    "no proxy fence": MUTANTS["no proxy fence"],
}
NF4_BWD_MUTANT_TESTS = "qmm_bwd or nf4_bwd_wgmma"
# which source each set of mutants edits, and the cuda tests run against them
MUTANT_SETS = {"nf4": ("qmm_nf4_wgmma.cu", MUTANTS, MUTANT_TESTS),
               "int8": ("qmm_i8_wgmma.cu", I8_MUTANTS, I8_MUTANT_TESTS),
               "nf4bwd": ("qmm_nf4_bwd_wgmma.cu", NF4_BWD_MUTANTS, NF4_BWD_MUTANT_TESTS)}
SETS = tuple(MUTANT_SETS)


def mutants(sets) -> int:
    """Each mutant in a copy of the checkout, its cuda tests run there."""
    import shutil

    base = ROOT / "build" / "mutants"
    survived = []
    todo = [(source, tests, name, edits) for source, table, tests in (MUTANT_SETS[k] for k in sets)
            for name, edits in table.items()]
    for source, tests, name, edits in todo:
        name = f"{Path(source).stem} {name}"
        dst = base / name.replace(" ", "_").replace("'", "")
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
            "build", "chiprun_out", ".git", "__pycache__"))
        src = dst / "qlora_tpu_torch" / "csrc" / source
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"mutant {name!r}: the source no longer holds {old[:48]!r}")
            text = text.replace(old, new)
        src.write_text(text)
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m", "cuda", "-q",
             "--noconftest", "-p", "no:cacheprovider", "-k", tests],
            cwd=dst, capture_output=True, text=True, timeout=900)
        tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else run.stderr[-300:]
        print(f"tile_sweep mutant {name!r}: {tail}", flush=True)
        if run.returncode == 0:
            survived.append(name)
    print(f"tile_sweep mutants surviving: {survived}", flush=True)
    return 1 if survived else 0


def build(variants) -> dict:
    """Compile every (source, name, edits, entries, argtypes) at once, one
    nvcc each; {(source, name, entry): typed C entry}."""
    from qlora_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for source, name, edits, entries, argtypes in variants:
        text = (CSRC / source).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{source} {name!r}: the source no longer holds {old[:48]!r}")
            text = text.replace(old, new)
        stem = f"{Path(source).stem}_{name.replace(' ', '_')}"
        (OUT / f"{stem}.cu").write_text(text)
        lib = OUT / f"lib{stem}.so"
        procs.append((source, name, entries, argtypes, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(OUT / f"{stem}.cu")])))
    fns = {}
    for source, name, entries, argtypes, lib, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"{source} {name!r}: nvcc failed")
        for entry in entries:
            fn = getattr(ctypes.CDLL(str(lib)), entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[(source, name, entry)] = fn
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


def copies_past_l2(qt) -> list:
    return [qt] + [dataclasses.replace(qt, packed=qt.packed.clone(), absmax=qt.absmax.clone())
                   for _ in range(max(1, -(-2 * L2_BYTES // qt.nbytes)) - 1)]


def main(sets) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from qlora_tpu_torch.quant import quantize

    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    wgmma_args = [P] * 7 + [I] * 8 + [P]
    variants = []
    if "nf4" in sets:
        variants += [("qmm_nf4_wgmma.cu", n, e, ["qmm_nf4_wgmma"], wgmma_args)
                     for n, e in WGMMA.items()]
        variants += [("qmm_nf4_fwd.cu", n, e, ["qmm_nf4_fwd"], qm._ARGTYPES) for n, e in TILE.items()]
    if "int8" in sets:
        variants += [("qmm_i8_wgmma.cu", n, e, ["qmm_i8_wgmma_fwd", "qmm_i8_wgmma_bwd"], wgmma_args)
                     for n, e in I8.items()]
        variants += [("qmm_i8.cu", "as built", [], ["qmm_i8_fwd", "qmm_i8_bwd"], qm._ARGTYPES)]
    if "nf4bwd" in sets:
        variants += [("qmm_nf4_bwd_wgmma.cu", n, e, ["qmm_nf4_bwd_wgmma"], wgmma_args)
                     for n, e in NF4_BWD.items()]
        variants += [("qmm_nf4_bwd.cu", "as built", [], ["qmm_nf4_bwd"], qm._ARGTYPES)]
    built = build(variants)
    g = torch.Generator(device=dev).manual_seed(6)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def run(fns, copies, a, out, M, K, N, plan, label):
        # each copy's arguments, made once: the loop times the launches alone
        argsets = []
        for q in copies:
            _, _, scale, offset = qm._check_quantized(q, dev)
            code = None if q.quant_type == "int8" else qm._code_on(q.quant_type, dev).data_ptr()
            argsets.append([a.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(),
                            scale.data_ptr(), offset.data_ptr(), code, out.data_ptr(), M, K, N,
                            q.block_size, 1] + ([] if plan is None else
                                                [plan.tm, plan.stages, plan.smem]))
        line = []
        for name, fn in fns.items():
            def launch(i, fn=fn):
                err = fn(*argsets[i % len(argsets)], stream())
                if err:
                    raise RuntimeError(f"{label} {name}: cudaError_t {err}")
            line.append(f"{name} {events_ms(launch):.4f}")
        print(f"tile_sweep {label} M={M} K={K} N={N} (ms): " + ", ".join(line), flush=True)

    for K, N in SHAPES:
        if "nf4" in sets:
            qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
            copies = copies_past_l2(qt)
            for M in ROWS:
                x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
                y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
                run({n: built[("qmm_nf4_wgmma.cu", n, "qmm_nf4_wgmma")] for n in WGMMA}, copies,
                    x, y, M, K, N, qm.tile_plan(M, K, N, qt.block_size), "wgmma")
                run({n: built[("qmm_nf4_fwd.cu", n, "qmm_nf4_fwd")] for n in TILE}, copies, x, y,
                    M, K, N, None, "tile (before)")
        if "int8" in sets:
            qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5,
                          quant_type="int8")
            copies = copies_past_l2(qt)
            M = ROWS[0]
            for bwd, d in ((False, "fwd"), (True, "bwd")):
                a = torch.randn(M, N if bwd else K, device=dev, generator=g).to(torch.bfloat16)
                out = torch.empty(M, K if bwd else N, dtype=torch.bfloat16, device=dev)
                plan = qm.i8_tile_plan(M, K, N, qt.block_size, bwd)
                run({n: built[("qmm_i8_wgmma.cu", n, f"qmm_i8_wgmma_{d}")] for n in I8}, copies, a,
                    out, M, K, N, plan, f"i8 wgmma {d}")
                tm128 = dataclasses.replace(plan, tm=128, stages=qm._I8_STAGES[128],
                                            smem=qm.i8_tile_smem(128))
                run({"as built": built[("qmm_i8_wgmma.cu", "as built", f"qmm_i8_wgmma_{d}")]},
                    copies, a, out, M, K, N, tm128, f"i8 wgmma {d} (128-row CTAs)")
                run({"as built": built[("qmm_i8.cu", "as built", f"qmm_i8_{d}")]}, copies, a, out,
                    M, K, N, None, f"i8 tile {d} (before)")
        if "nf4bwd" in sets:
            qt = quantize(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
            copies = copies_past_l2(qt)
            M = ROWS[0]
            a = torch.randn(M, N, device=dev, generator=g).to(torch.bfloat16)
            out = torch.empty(M, K, dtype=torch.bfloat16, device=dev)
            plan = qm.nf4_bwd_tile_plan(M, K, N, qt.block_size)
            run({n: built[("qmm_nf4_bwd_wgmma.cu", n, "qmm_nf4_bwd_wgmma")] for n in NF4_BWD},
                copies, a, out, M, K, N, plan, "nf4 wgmma bwd")
            tm128 = dataclasses.replace(plan, tm=128, stages=qm._I8_STAGES[128],
                                        smem=qm.nf4_bwd_tile_smem(128))
            run({"as built": built[("qmm_nf4_bwd_wgmma.cu", "as built", "qmm_nf4_bwd_wgmma")]},
                copies, a, out, M, K, N, tm128, "nf4 wgmma bwd (128-row CTAs)")
            run({"as built": built[("qmm_nf4_bwd.cu", "as built", "qmm_nf4_bwd")]}, copies, a,
                out, M, K, N, None, "nf4 bwd tile (before)")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    chosen = [k for k in SETS if k in args] or list(SETS)
    sys.exit(mutants(chosen) if "--mutants" in args else main(chosen))
