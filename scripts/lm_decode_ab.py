"""Time LM serving (``chip_smoke.py``'s 2i-iii) of two checkouts of the port on one card.

Run from the repo root on a machine with a CUDA card, with an unpacked
checkout of another commit in a directory that ``.gitignore`` lists::

    mkdir -p .ab_other/parent && git archive <commit> | tar -x -C .ab_other/parent
    python3 scripts/lm_decode_ab.py --tree parent=.ab_other/parent \
        --order parent,this,this,parent --json lm_ab.json

One process per entry of ``--order`` imports the port from that
checkout's ``src/`` (``this`` is this checkout) and runs this checkout's
``chip_smoke.lm_serving`` for each ``--arch``: ``launch.serve.serve`` at
full width and 2i's cut depth, bf16, batch 8, prompt 1,024, 64 tokens,
after an untimed warm-up serve. Each process prints one JSON object with
prefill seconds, decode ms a step (host clock around a synchronised card)
and each step's CUDA-event ms, and peak memory; the parent process prints
them with the card's name and power limit, a summary line per run, and
writes them to ``--json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("olmoe-1b-7b", "minicpm3-4b")


def child(src: str, archs: list) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, HERE)
    import chip_smoke as cs

    import repro_torch

    out = {"src": os.path.dirname(os.path.abspath(repro_torch.__file__))}
    for arch in archs:
        r = cs.lm_serving(arch)
        cs.check(r["warm_tokens_equal"], f"{arch}: the timed serve's tokens differ from the warm-up's")
        out[arch] = {k: r[k] for k in ("prefill_s", "decode_s", "decode_step_ms",
                                       "decode_steps_ms", "decode_bound_ms",
                                       "peak_mem_bytes")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=ROOT of another checkout (repeatable)")
    ap.add_argument("--order", default="this")
    ap.add_argument("--arch", action="append", help=f"default: {', '.join(ARCHS)}")
    ap.add_argument("--json", help="write every process's results here")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    archs = args.arch or list(ARCHS)
    if args.child:
        print(json.dumps(child(args.child, archs)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("lm_decode_ab: no CUDA device available", file=sys.stderr)
        return 2
    trees = {"this": os.path.join(HERE, "src")}
    for t in args.tree:
        name, root = t.split("=", 1)
        trees[name] = os.path.join(os.path.abspath(root), "src")
    order = args.order.split(",")
    for entry in order:
        if not os.path.isdir(os.path.join(trees.get(entry, ""), "repro_torch")):
            print(f"lm_decode_ab: no checkout holding src/repro_torch for {entry}",
                  file=sys.stderr)
            return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = []
    for entry in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", trees[entry]]
        for a in archs:
            cmd += ["--arch", a]
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE, env=env,
                             timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            print(f"lm_decode_ab: entry {entry} failed ({res.returncode})", file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"entry": entry, **r})
        for a in archs:
            x = r[a]
            print(f"[ab] {entry} {a}: prefill {x['prefill_s']:.4f} s, decode "
                  f"{x['decode_step_ms']:.4f} ms a step (host clock; CUDA events median "
                  f"{statistics.median(x['decode_steps_ms']):.3f}, min "
                  f"{min(x['decode_steps_ms']):.3f}), peak "
                  f"{x['peak_mem_bytes'] / 2**30:.2f} GiB | {smi}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
