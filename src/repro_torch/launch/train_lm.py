"""End-to-end LM training: a small transformer for a few hundred steps on
a synthetic Zipf token stream, with warm-up cosine LR, gradient clipping,
async checkpointing and resume.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 200 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 250 --resume --device cpu

The counterpart of the reference package's ``examples/train_lm.py``, with
its flags plus ``--device`` (``cuda`` by default: it raises
``repro_torch.device.DeviceError`` without a card). The weights come from
``init_params`` with torch's generator, seeded 0; the token stream from
numpy's ``default_rng(1)``, drawn as the reference draws it, so both
packages train on the same batches.

A checkpoint holds ``(params, opt_state)`` in the reference's layout
(layers stacked; ``repro_torch.convert.train_state_tree``), numbered as
the reference numbers its own: after step ``s`` under ``s`` every 50
steps, and after the last under ``--steps``, with that number as
``extra["step"]``. ``--resume`` reads the newest and replays the stream
to its number. So a checkpoint of either package means the same state at
the same number; a mid-run one holds ``s + 1`` steps, and a resume from
it applies batch ``s`` a second time, as the reference's does.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, flatten, latest_step, restore_checkpoint
from repro_torch.convert import train_state_tree
from repro_torch.device import resolve_device
from repro_torch.launch.train import make_lm_train_step
from repro_torch.models.transformer import LMConfig, init_params
from repro_torch.optim import adamw, warmup_cosine

CKPT_EVERY = 50


def token_stream(vocab: int, batch: int, seq: int, seed: int):
    """Zipf-distributed synthetic corpus stream (WT10G-like marginals):
    int32 numpy batches, the reference's draws."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = ranks ** -1.07
    p /= p.sum()
    while True:
        yield rng.choice(vocab, size=(batch, seq), p=p).astype(np.int32)


def example_config(args) -> LMConfig:
    return LMConfig(
        name="example-lm",
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=8,
        n_kv_heads=2,
        d_head=args.d_model // 8,
        d_ff=4 * args.d_model,
        vocab_size=args.vocab,
        attn="gqa",
        ffn_kind="swiglu",
        dtype="float32",
        kv_chunk=128,
        remat=False,
    )


def _restore(directory: str, step: int, model, opt_state) -> dict:
    """Copy checkpoint ``step`` into the live model and optimizer state;
    returns its ``extra``."""
    like = train_state_tree(model, opt_state)
    got, extra = restore_checkpoint(directory, step, like)
    with torch.no_grad():
        for (_, dst), (_, src) in zip(flatten(like), flatten(got)):
            for d, s in zip(dst, src) if isinstance(dst, list) else ((dst, src),):
                d.copy_(s)
    return extra


def train(args, state=None, start: int = 0):
    """Train from ``start`` to ``args.steps`` and return ``(state,
    losses)``: ``state = (model, opt_state)``, a fresh one (or the
    checkpoint's, with ``args.resume``) unless given, and the loss of each
    step as a float. The checkpoint manager's writes finish before it
    returns, or before an error propagates."""
    dev = resolve_device(args.device)
    cfg = example_config(args)
    opt = adamw(warmup_cosine(3e-4, 20, args.steps), moment_dtype=torch.float32)
    if state is None:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        state = (model, opt.init(model.param_tree()))
        if args.resume and (s := latest_step(args.ckpt_dir)) is not None:
            start = _restore(args.ckpt_dir, s, *state)["step"]
            print(f"resumed from step {start}")
    print(f"model: {cfg.num_params() / 1e6:.1f}M params")
    mgr = CheckpointManager(args.ckpt_dir, keep_last=2)
    step_fn = make_lm_train_step(cfg, opt)
    stream = token_stream(args.vocab, args.batch, args.seq, seed=1)
    for _ in range(start):  # replay the stream for determinism
        next(stream)

    losses = []  # 0-dim tensors: read once at the end, no sync a step
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = {"tokens": torch.from_numpy(next(stream)).to(dev)}
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"])
            if step % 20 == 0 or step == args.steps - 1:
                tput = (step - start + 1) * args.batch * args.seq / (time.time() - t0)
                print(
                    f"step {step:4d}  loss {float(losses[-1]):.4f}  "
                    f"grad_norm {float(metrics['grad_norm']):.3f}  "
                    f"{tput:,.0f} tok/s"
                )
            if step and step % CKPT_EVERY == 0:
                mgr.save_async(step, train_state_tree(*state), extra={"step": step})
        mgr.save_async(args.steps, train_state_tree(*state), extra={"step": args.steps})
    finally:
        mgr.wait()
    print("done; checkpoints in", args.ckpt_dir)
    return state, [float(x) for x in losses]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "train_lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    return train(_parser().parse_args(argv))


if __name__ == "__main__":
    main()
