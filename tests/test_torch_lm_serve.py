"""The port's LM serving entry point against the JAX package's, on the CPU.

``repro_torch.launch.serve.serve`` with the reference's weights (carried
by ``lm_params_from_numpy``) and the same seed must generate exactly the
tokens ``repro.launch.serve.serve`` generates, for every LM arch's smoke
config, in float32.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_spec as ref_get_spec
from repro.launch import serve as ref_serve_mod
from repro.models import transformer as RT
from repro_torch.configs import get_spec
from repro_torch.convert import lm_params_from_numpy
from repro_torch.device import DeviceError
from repro_torch.launch import serve as serve_mod

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LM_ARCHS = [
    "deepseek-v3-671b",
    "olmoe-1b-7b",
    "qwen1.5-110b",
    "minicpm3-4b",
    "nemotron-4-340b",
]
REF_KEYS = {"arch", "batch", "prefill_tokens_per_s", "decode_tokens_per_s",
            "generated_shape"}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_generates_the_reference_tokens(arch):
    batch, prompt_len, gen, seed = 3, 12, 6, 4
    ref_out, ref_stats = ref_serve_mod.serve(arch, batch, prompt_len, gen, seed=seed)
    cfg = get_spec(arch).smoke()
    ref_cfg = ref_get_spec(arch).smoke()
    tree = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(seed), ref_cfg))
    out, stats = serve_mod.serve(
        arch, batch, prompt_len, gen, seed=seed, device="cpu",
        params=lm_params_from_numpy(tree, cfg, "cpu"),
    )
    assert out.dtype == np.int32 and out.shape == (batch, gen)
    np.testing.assert_array_equal(out, ref_out)
    assert REF_KEYS <= set(stats)
    assert stats["generated_shape"] == ref_stats["generated_shape"]
    assert stats["device"] == "cpu" and stats["logits_finite"] is True
    # the card's timing keys are not reported from the host
    assert not {"prefill_s", "decode_s", "decode_step_ms", "peak_mem_bytes"} & set(stats)


def test_serve_from_a_seed_is_deterministic():
    a, _ = serve_mod.serve("olmoe-1b-7b", 2, 8, 4, seed=1, device="cpu")
    b, _ = serve_mod.serve("olmoe-1b-7b", 2, 8, 4, seed=1, device="cpu")
    np.testing.assert_array_equal(a, b)


def test_serve_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(DeviceError):
        serve_mod.serve("minicpm3-4b", 1, 4, 2, device="cuda")


def test_cli_takes_the_reference_flags_and_device(capsys):
    with open(os.path.join(SRC, "repro", "launch", "serve.py")) as f:
        ref_flags = set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', f.read()))
    mine = {o for a in serve_mod._parser()._actions for o in a.option_strings}
    assert len(ref_flags) == 4 and ref_flags | {"--device"} <= mine
    assert serve_mod._parser().parse_args([]).device == "cuda"
    serve_mod.main(["--arch", "olmoe-1b-7b", "--batch", "2", "--prompt-len", "8",
                    "--gen", "4", "--device", "cpu"])
    assert "'generated_shape': [2, 4]" in capsys.readouterr().out
