"""The port's train, prefill and decode steps against JAX's for the last five archs of ``configs.ARCH_IDS``
(smoke configs, float32).  The checks and their tolerances are in
``tests/torch_train_parity.py``; the archs are split over two files so
that each runs on a worker of its own.

Mirrors ``tests/test_models.py::test_arch_smoke_train_step`` (one real
optimizer step, ``accum_steps`` 2, on a one-device mesh), held to JAX's
numbers where that test checks finiteness.
"""

import pytest

import torch_train_parity as parity

ARCHS = ["yi-9b", "qwen3-moe-235b-a22b", "mixtral-8x7b", "zamba2-2.7b",
         "whisper-large-v3"]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, accum):
    parity.check_train_step(arch, accum)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch):
    parity.check_specs(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_match_jax(arch):
    parity.check_served_tokens(arch)
