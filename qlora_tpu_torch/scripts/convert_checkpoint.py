"""Offline checkpoint conversion: an HF fp16 / bf16 checkpoint to the
quantized store.

The QLoRA reference quantizes the base model anew on every start.  This
quantizes it once, on the card unless ``--device`` says otherwise, and
writes the store that ``utils.quantized_store.load_quantized`` (or the JAX
package's loader) reads back byte for byte.

  python -m qlora_tpu_torch.scripts.convert_checkpoint --src /path/to/hf-llama-7b \\
      --dst /path/to/llama-7b-nf4 [--quant_type nf4] [--no-double-quant]
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser("qlora_tpu_torch.scripts.convert_checkpoint")
    ap.add_argument("--src", required=True, help="HF checkpoint directory")
    ap.add_argument("--dst", required=True, help="output directory")
    ap.add_argument("--quant_type", default="nf4", choices=["nf4", "fp4"])
    ap.add_argument("--no-double-quant", action="store_true")
    ap.add_argument("--device", default=None, help="CUDA unless given (cpu: the plain path)")
    return ap.parse_args(argv)


def main(argv=None):
    from qlora_tpu_torch import resolve_device
    from qlora_tpu_torch.utils.hf_import import load_hf_model
    from qlora_tpu_torch.utils.quantized_store import save_quantized

    args = parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    params, cfg = load_hf_model(
        args.src, quantize_base=True, quant_type=args.quant_type,
        double_quant=not args.no_double_quant, device=device,
    )
    print(f"quantized in {time.time()-t0:.1f}s")
    save_quantized(args.dst, params, cfg)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
