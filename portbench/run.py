"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload wt10g.build --seed 7 --seconds 30 --trace 0

The cell is an entry of ``BENCHMARK.json`` at the root of the checkout. The
run makes its inputs from ``--seed``, warms up, measures for ``--seconds``,
compares what the timed path produced with the plain reference, and prints
as its last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its limit.
The same numbers are the last lines of standard error. It needs the card:
without one it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup_env() -> None:
    """Build caches at fixed paths inside the checkout, the program on the
    path, and nothing that loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (os.path.join(ROOT, "src"), HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             clock=lambda: time.perf_counter() - T_START) -> dict:
    """Drive the cell's traffic on ``device`` and reduce it to the result
    line (without ``device`` details)."""
    from yardstick import cells, judge

    out = cells.kind_module(cell.mix["kind"]).run(cell, seed, seconds, trace, device, clock)
    out["correct"] = judge.verdict(out["numbers"])
    return out


def metrics_of(cell, out: dict, trace: bool) -> dict:
    from yardstick import cells

    if not trace:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end}
    res = {}
    for m in cell.per_layer:
        v = cells.metric_reader(m["name"])(out["ctx"])
        if v is not None:
            res[m["name"]] = {"value": v, "unit": m["unit"]}
    return res


def memory_peak(peak) -> int:
    """``memory_peak_bytes``: a kind's one number, or the fullest card's
    peak where it gives one a card (a list, or a dict by card)."""
    if isinstance(peak, dict):
        peak = list(peak.values())
    return int(max(peak)) if isinstance(peak, (list, tuple)) else int(peak)


def traced_device(cell, ctx: dict) -> dict:
    """``busy_s`` and ``window_s`` of a traced run. One card: the busy
    seconds of ``ctx["ops"]``. Several: each card's own busy seconds from
    ``ctx["ops_by_card"]`` (``busy_s_by_card``) and their mean over the
    cell's cards, so that the idle share is the cards' mean idle share."""
    from yardstick import trace as T

    t0, t1 = ctx["window"]
    if cell.chips == 1:
        return {"busy_s": T.busy_s(ctx["ops"]), "window_s": t1 - t0}
    by_card = T.busy_s_by_card(ctx["ops_by_card"], cell.chips)
    return {"busy_s": sum(by_card.values()) / len(by_card), "window_s": t1 - t0,
            "busy_s_by_card": {str(c): s for c, s in by_card.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env()
    from yardstick import cells, judge

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    io0 = _io()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    io1 = _io()
    print(f"portbench: {args.workload} seed {args.seed}: window {out['window_s']:.4f} s, "
          f"set-up {out['setup_s']:.4f} s, comparison {out['compare_s']:.4f} s, "
          f"bytes written {io1['wchar'] - io0['wchar']} "
          f"(to storage {io1['write_bytes'] - io0['write_bytes']})", flush=True)
    for line in out["log"]:
        print(f"portbench: {line}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the run must not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    device = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cell.chips, "memory_peak_bytes": memory_peak(out["memory_peak_bytes"]),
    }
    result = {
        "correct": bool(out["correct"]),
        "attempted": out["attempted"],
        "failed": out.get("failed", 0),
        "metrics": metrics_of(cell, out, bool(args.trace)),
        "device": device,
    }
    if args.trace:
        device.update(traced_device(cell, out["ctx"]))
        result["breakdown"] = cells.kind_module(cell.mix["kind"]).breakdown(out)
    result["checks"] = judge.report(out["numbers"])
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _io() -> dict:
    """This process's write counters: ``wchar``, the bytes it wrote, and
    ``write_bytes``, those that reached storage."""
    with open("/proc/self/io") as f:
        return {k: int(v) for k, v in (line.split(":") for line in f)}


if __name__ == "__main__":
    sys.exit(main())
