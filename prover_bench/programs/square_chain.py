"""A chain of ``AssertZero`` opcodes, x_{i+1} = x_i^2 + c_i over the
Goldilocks field, with x_0 public and x_steps returned: a trace of a few
dozen rows for dry runs of the harness on the CPU.  Configuration keys:
``steps``.
"""

from __future__ import annotations

from ..frozen.acir import ir
from ..frozen.field.gl import P


def _c(i: int) -> int:
    return (i * 0x9E3779B97F4A7C15 + 1) % P


def build(cfg) -> ir.Program:
    steps = cfg["steps"]
    ops = [ir.AssertZero(ir.Expression(((1, i, i),), ((P - 1, i + 1),),
                                       _c(i)))
           for i in range(steps)]
    c = ir.Circuit(steps + 1, ops, None, (), (0,), (steps,))
    return ir.Program([c])


def _chain(x0: int, steps: int):
    xs = [x0 % P]
    for i in range(steps):
        xs.append((xs[-1] * xs[-1] + _c(i)) % P)
    return xs


def draw(cfg, rng) -> dict:
    return {"x0": rng.randrange(P)}


def witness(cfg, inputs) -> dict:
    return dict(enumerate(_chain(inputs["x0"], cfg["steps"])))


def check(cfg, inputs, witness_map) -> int:
    xs = _chain(inputs["x0"], cfg["steps"])
    return int(witness_map.get(cfg["steps"]) != xs[-1])
