"""The port's CLI against the JAX package's numpy CLI path on the plain
arithmetic example programs (``tests/example_cases.py``); the others are
in ``test_torch_examples_lookup.py``, apart so that the two files run on
separate workers."""

import pytest
import torch

from tpu_acir_prover_torch.utils.circuits import ALL_SMALL

from example_cases import LOOKUP, check_example

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(set(ALL_SMALL) - set(LOOKUP)))
def test_cli_matches_jax_numpy_cli(name, tmp_path):
    check_example(name, tmp_path)
