"""Time ``torch._int_mm`` on 2l's head_gram share with B row-major and with B
column-major, beside ``cooc_gram``, on one card.

Run from the repo root on a machine with a CUDA card::

    python3 scripts/int_mm_layout.py

The share is ``chip_smoke.py`` 2l's: 16 products of (32,768, 4,096) 0/1
uint8 blocks at the head_gram density, drawn on the card from seed 0. The
left block is viewed as int8 and transposed row-major, as ``torch._int_mm``
takes it; B is each right block viewed as int8, once as it lies (row-major)
and once transposed to column-major (cuBLASLt's TN layout), both laid out
before the timed calls. Every product must equal the kernel's. Prints the
card's name and power limit, then one JSON line: per layout whether the
products are equal and the CUDA-event ms of the 16 products, twice, and the
kernel's ms, twice.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

sys.path.insert(0, cs.SRC)

import torch  # noqa: E402

from repro_torch.kernels import _build, ops  # noqa: E402


def main() -> int:
    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    _build.build_all(ops.KERNELS)
    g = torch.Generator(device="cuda").manual_seed(0)
    D, M = 32768, 4096
    blocks = [(torch.rand((D, M), generator=g, device="cuda") < cs.GRAM_DENSITY)
              .to(torch.uint8) for _ in range(cs.COOC_MODEL)]
    mine = blocks[0]
    mine8 = mine.view(torch.int8).t().contiguous()
    layouts = {"row": [b.view(torch.int8) for b in blocks],
               "col": [b.view(torch.int8).t().contiguous().t() for b in blocks]}
    want = [ops.cooc_gram(mine, b) for b in blocks]
    res = {}
    for name, bs in layouts.items():
        got = [torch._int_mm(mine8, b) for b in bs]
        res[name] = {"equal": all(torch.equal(a, b) for a, b in zip(got, want))}
        del got
        res[name]["ms"] = cs.cuda_ms(lambda: [torch._int_mm(mine8, b) for b in bs], 3)
    res["kernel_ms"] = cs.cuda_ms(lambda: [ops.cooc_gram(mine, b) for b in blocks], 3)
    for name, bs in layouts.items():
        res[name]["ms_again"] = cs.cuda_ms(
            lambda: [torch._int_mm(mine8, b) for b in bs], 3)
    res["kernel_ms_again"] = cs.cuda_ms(
        lambda: [ops.cooc_gram(mine, b) for b in blocks], 3)
    print(json.dumps(res), flush=True)
    return 0 if all(res[n]["equal"] for n in layouts) else 1


if __name__ == "__main__":
    sys.exit(main())
