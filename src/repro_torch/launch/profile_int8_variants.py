"""The int8-cache decode kernel against two variants of itself, in one
process on one card.

    PYTHONPATH=src python -m repro_torch.launch.profile_int8_variants

Needs one CUDA card.  Builds `csrc/decode_attention_int8.cu` as it is
and two variants made from it by a text substitution, each into its own
library under `build/repro_torch/`:

  * `two blocks`: registers bounded for two blocks an SM at D 64 and 128
    instead of three (the ring then takes four stages instead of three);
  * `bf16 P`: P V from the bf16 high part of P alone, without the
    product of the rest.

Then times each, in the order as built, two blocks, bf16 P, bf16 P, two
blocks, as built, at llama3-8b's long-cache shape (B 8, 30,001 of 32,768
tokens), its serving shape with the appended token (B 4, 129 of 168) and
qwen3's (G 16) and gemma3's full D 256 ring with the appended token:
device µs from torch.profiler's kernel records (warm caches), the
largest error against the plain version, and ptxas's registers and
spill bytes of each library.  Prints the card's name and power limit,
then one JSON line.
"""
from __future__ import annotations

import json
import re
import subprocess

import torch

from ..kernels import _build, ref
from ..kernels import decode_attention as tdecode
from ..kernels import ops
from ..models.attention import quantize_kv
from .profile_attention import device_us

NAME = "decode_attention_int8"
# (B, H, KVH, D, S, valid_len, slot of the appended token or None)
SHAPES = ((8, 32, 8, 128, 32_768, 30_001, None),
          (4, 32, 8, 128, 168, 129, 128),
          (4, 64, 4, 128, 168, 129, 128),
          (4, 8, 4, 256, 1024, 1024, 1061 % 1024))
ORDER = ("as built", "two blocks", "bf16 P", "bf16 P", "two blocks",
         "as built")


def sources() -> dict:
    """{variant: (source text, blocks an SM at D 64 and 128)}."""
    src = (_build.CSRC / f"{NAME}.cu").read_text()
    two = src.replace("return DC > 128 ? 1 : exact ? 3 : 2;",
                      "return DC > 128 ? 1 : 2;")
    one_p = re.sub(r"\n\s*mma\(o\[2 \* jj(?: \+ 1)?\], plo, [^;]*;", "", src)
    if two == src or one_p == src:
        raise RuntimeError("profile_int8_variants: the source no longer has "
                           "the lines the variants change")
    return {"as built": (src, 3), "two blocks": (two, 2), "bf16 P": (one_p, 3)}


def use(variant: str, text: str, blocks: int, blocks_of) -> dict:
    """Points the build at `text` and the planner at `blocks` an SM at D
    64 and 128 (`blocks_of` elsewhere); -> ptxas's report of the
    variant's library."""
    d = _build.BUILD_DIR / "variants" / re.sub(r"\W", "_", variant)
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{NAME}.cu").write_text(text)
    _build.CSRC = d
    _build.load.cache_clear()
    tdecode._int8_slots.cache_clear()
    tdecode.int8_blocks = (lambda D: blocks if D in (64, 128)
                           else blocks_of(D))
    return {k.split("decode_int8_kernel")[-1]: (r.get("registers"),
                                                r.get("spill_stores"))
            for k, r in _build.ptxas_report(NAME).items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_int8_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    cases = []
    for B, H, KVH, D, S, valid, slot in SHAPES:
        q = torch.randn(B, H, D, generator=g, device=dev).to(bf16)
        k, ks = quantize_kv(torch.randn(B, KVH, S, D, generator=g,
                                        device=dev).to(bf16))
        v, vs = quantize_kv(torch.randn(B, KVH, S, D, generator=g,
                                        device=dev).to(bf16))
        new = [torch.randn(B, KVH, D, generator=g, device=dev).to(bf16)
               for _ in range(2)]
        cases.append((dict(B=B, H=H, KVH=KVH, D=D, valid_len=valid,
                           slot=slot), q, k, ks, v, vs, new))
    csrc, blocks_of = _build.CSRC, tdecode.int8_blocks
    texts = sources()
    rows, ptxas = {}, {}
    try:
        for variant in ORDER:
            report = use(variant, *texts[variant], blocks_of)
            ptxas.setdefault(variant, report)
            for shape, q, k, ks, v, vs, new in cases:
                caches = [t.clone() for t in (k, v, ks, vs)]
                slot, valid = shape["slot"], shape["valid_len"]
                if slot is None:
                    def fn():
                        return ops.decode_attention_head_major(
                            q, *caches[:2], valid, k_scale=caches[2],
                            v_scale=caches[3])
                else:
                    def fn():
                        return ops.decode_attention_int8_append(
                            q, *new, *caches, slot, valid)
                out = fn().float()
                want = ref.decode_attention_ref(
                    q, caches[0].transpose(1, 2), caches[1].transpose(1, 2),
                    valid, caches[2], caches[3]).float()
                rows.setdefault(variant, []).append(dict(
                    **shape, device_us=device_us(fn),
                    max_abs_err=float((out - want).abs().max())))
    finally:
        _build.CSRC, tdecode.int8_blocks = csrc, blocks_of
        _build.load.cache_clear()
        tdecode._int8_slots.cache_clear()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"profile_int8_variants": dict(
        order=ORDER, ptxas=ptxas, runs=rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
