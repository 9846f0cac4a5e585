"""Generators of the benchmark's inputs, one module a program, found by the
``program`` key of a configuration file.  Each module gives:

- ``build(cfg) -> ir.Program``: the ACIR program, the same for every proof;
- ``draw(cfg, rng) -> dict``: the raw inputs of one proof (JSON-able),
  from a ``random.Random`` seeded by the run's ``--seed``;
- ``witness(cfg, inputs) -> {witness: value}``: the solved witness map, as
  ``nargo execute`` would write it;
- ``check(cfg, inputs, witness_map) -> int``: the plain reference of the
  program's outputs (``hashlib``): how many of the output witnesses in the
  map differ from it.  Set-up holds every witness file it writes to it.

They build on the frozen ACIR writer (``frozen/acir``), never on the
program under test.
"""

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
