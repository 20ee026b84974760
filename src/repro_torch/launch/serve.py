"""Batched LM serving: prefill, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --batch 2 --prompt-len 8 --gen 4 --device cpu

The counterpart of the reference package's ``launch/serve.py``. With no
``cfg`` it serves the arch's reduced (smoke) config, as the reference does;
pass ``cfg=get_spec(arch).model`` for the full width. Weights are random,
drawn on the device from ``seed``, unless ``params`` (a
``TransformerLM``, e.g. from ``repro_torch.convert.lm_params_from_numpy``)
is given. Prompts are drawn exactly as the reference draws them, so both
packages serve the same tokens.

``--device`` is ``cuda`` by default and raises
``repro_torch.device.DeviceError`` without a card; ``cpu`` runs on the
host.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_spec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(
    arch: str,
    batch: int,
    prompt_len: int,
    gen: int,
    seed: int = 0,
    device="cuda",
    cfg: T.LMConfig | None = None,
    params: T.TransformerLM | None = None,
):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens greedily. Returns ``(out, stats)``: the generated tokens
    (numpy int32 ``(batch, gen)``) and the reference's stats keys, plus
    ``device``, ``logits_finite`` (every logit of prefill and decode), and
    on the card ``prefill_s``, ``decode_s`` and ``decode_step_ms`` (host
    clock, to a synchronised card), ``decode_steps_ms`` (each decode step
    by CUDA events) and ``peak_mem_bytes``."""
    dev = resolve_device(device)
    spec = get_spec(arch)
    cfg = spec.smoke() if cfg is None else cfg
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if params is None:
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    max_seq = prompt_len + gen
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    ).to(dev)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, pre_cache = T.prefill(params, prompts, cfg)
        # place the prefill cache into the padded decode cache
        cache = T.init_cache(cfg, batch, max_seq, dev)
        for name, full in cache.items():
            full[:, :, :prompt_len] = pre_cache[name].to(full.dtype)
        del pre_cache
        finite = torch.isfinite(logits).all()
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        generated = [tokens]
        # on the card, an event after each step times it without a sync
        events = [torch.cuda.Event(enable_timing=True) for _ in range(gen)] \
            if dev.type == "cuda" else []
        t0 = time.perf_counter()
        if events:
            events[0].record()
        for step in range(gen - 1):
            logits, cache = T.decode_step(params, cache, tokens, prompt_len + step, cfg)
            finite &= torch.isfinite(logits).all()
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            generated.append(tokens)
            if events:
                events[step + 1].record()
        _sync(dev)
        t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1).cpu().numpy()
    stats = {
        "arch": arch,
        "batch": batch,
        "prefill_tokens_per_s": round(batch * prompt_len / max(t_prefill, 1e-9)),
        "decode_tokens_per_s": round(batch * (gen - 1) / max(t_decode, 1e-9)),
        "generated_shape": list(out.shape),
        "device": str(dev),
        "logits_finite": bool(finite),
    }
    if dev.type == "cuda":
        stats.update(
            prefill_s=t_prefill,
            decode_s=t_decode,
            decode_step_ms=t_decode / max(gen - 1, 1) * 1e3,
            decode_steps_ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])],
            peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
        )
    print(stats)
    return out, stats


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-110b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    serve(args.arch, args.batch, args.prompt_len, args.gen, device=args.device)


if __name__ == "__main__":
    main()
