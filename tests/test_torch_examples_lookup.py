"""The port's CLI against the JAX package's numpy CLI path on the example
programs with a lookup table or a memory block
(``tests/example_cases.py``)."""

import pytest
import torch

from example_cases import LOOKUP, check_example

torch.set_num_threads(1)


@pytest.mark.parametrize("name", LOOKUP)
def test_cli_matches_jax_numpy_cli(name, tmp_path):
    check_example(name, tmp_path)
