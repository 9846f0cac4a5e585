"""ACIR -> circuit translator: the compiler front end.

TPU-native equivalent of the reference's CircuitBuilderFromAcirToPlonky2
(plonky2-backend/src/circuit_translation/mod.rs:61-330):
walks the opcode list, maintains the ACIR-witness -> circuit-variable map
(analog of witness_target_map, mod.rs:320-329) and the memory blocks map,
and lowers each opcode onto the universal-gate builder.

Behavioral parity notes (matching observable semantics, not code):
  * public_parameters registered as public inputs in ascending order,
    return values NOT registered (mod.rs:290-313);
  * BrilligCall / Directive / Call are no-ops (mod.rs:98-104);
  * RANGE is limited to 33 bits and panics above (mod.rs:131-137);
  * AND/XOR require equal operand widths (mod.rs:218-235);
  * memory blocks are padded to a power of two and indices are restricted
    to the initialized length (memory_translator.rs:55-83,128-151).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..circuit.builder import CircuitBuilder
from ..field.gl import P
from . import ir

MAX_RANGE_BITS = 33


class UnsupportedOpcodeError(NotImplementedError):
    pass


@dataclass
class MemoryBlock:
    slots: List[int]     # circuit vars, padded to a power of two
    real_len: int


class AcirTranslator:
    def __init__(self, lookup_bits: int = 0):
        self.builder = CircuitBuilder(lookup_bits=lookup_bits)
        self.witness_to_var: Dict[int, int] = {}
        self.external_witness_order: List[int] = []
        self.memory_blocks: Dict[int, MemoryBlock] = {}

    # -- witness mapping ----------------------------------------------------

    def var_for_witness(self, w: int) -> int:
        """get-or-create, analog of _get_or_create_target_for_witness
        (mod.rs:320-329).  Every ACIR witness is an external variable whose
        value comes from the solved witness file."""
        if w not in self.witness_to_var:
            self.witness_to_var[w] = self.builder.add_external()
            self.external_witness_order.append(w)
        return self.witness_to_var[w]

    def expr_to_var(self, e: ir.Expression) -> int:
        """Lower an ACIR Expression to a single variable."""
        if not e.mul_terms and not e.linear_combinations:
            return self.builder.constant(e.q_c)
        if (not e.mul_terms and len(e.linear_combinations) == 1
                and e.linear_combinations[0][0] == 1 and e.q_c == 0):
            return self.var_for_witness(e.linear_combinations[0][1])
        lin = [(c, self.var_for_witness(w)) for c, w in e.linear_combinations]
        for c, wl, wr in e.mul_terms:
            prod = self.builder.mul(self.var_for_witness(wl),
                                    self.var_for_witness(wr))
            lin.append((c, prod))
        return self.builder.lincomb(lin, e.q_c)

    def expr_const(self, e: ir.Expression):
        """Constant value of an expression, or None."""
        if not e.mul_terms and not e.linear_combinations:
            return e.q_c
        return None

    # -- opcode dispatch -------------------------------------------------------

    def translate(self, circuit: ir.Circuit) -> None:
        b = self.builder
        for w in sorted(circuit.public_parameters):
            v = self.var_for_witness(w)
            b.register_public_input(v)
        for w in sorted(circuit.private_parameters):
            self.var_for_witness(w)

        for op in circuit.opcodes:
            if isinstance(op, ir.AssertZero):
                self._assert_zero(op.expr)
            elif isinstance(op, (ir.BrilligCall, ir.Directive, ir.Call)):
                # deliberately ignored (mod.rs:98-104; witness values for
                # their outputs come pre-solved in the witness file)
                pass
            elif isinstance(op, ir.MemoryInit):
                self._memory_init(op)
            elif isinstance(op, ir.MemoryOp):
                self._memory_op(op)
            elif isinstance(op, ir.BlackBoxRange):
                self._range(op)
            elif isinstance(op, (ir.BlackBoxAnd, ir.BlackBoxXor)):
                self._bitwise(op)
            elif isinstance(op, ir.BlackBoxSha256Compression):
                self._sha256_compression(op)
            elif isinstance(op, ir.BlackBoxEcdsaSecp256k1):
                self._ecdsa(op)
            else:
                raise UnsupportedOpcodeError(
                    f"unsupported opcode: {type(op).__name__}")

    # -- AssertZero (assert_zero_translator.rs:25-38) ---------------------------

    def _assert_zero(self, e: ir.Expression):
        mul = [(c, self.var_for_witness(wl), self.var_for_witness(wr))
               for c, wl, wr in e.mul_terms]
        lin = [(c, self.var_for_witness(w)) for c, w in e.linear_combinations]
        self.builder.assert_zero_lincomb(mul, lin, e.q_c)

    # -- RANGE (mod.rs:131-137) --------------------------------------------------

    def _range(self, op: ir.BlackBoxRange):
        nb = op.input.num_bits
        assert nb <= MAX_RANGE_BITS, \
            "Range checks with more than 33 bits are not allowed"
        self.builder.range_check(self.var_for_witness(op.input.witness), nb)

    # -- AND / XOR (mod.rs:139-154, 218-235) ----------------------------------------

    def _bitwise(self, op):
        assert op.lhs.num_bits == op.rhs.num_bits, \
            "AND/XOR operands must have equal bit width"
        nb = op.lhs.num_bits
        b = self.builder
        lhs_bits = b.split_le(self.var_for_witness(op.lhs.witness), nb)
        rhs_bits = b.split_le(self.var_for_witness(op.rhs.witness), nb)
        fn = b.bit_and if isinstance(op, ir.BlackBoxAnd) else b.bit_xor
        out_bits = [fn(x, y) for x, y in zip(lhs_bits, rhs_bits)]
        out = b.le_sum_vars(out_bits)
        b.assert_equal(out, self.var_for_witness(op.output))

    # -- memory (memory_translator.rs) -----------------------------------------------

    def _memory_init(self, op: ir.MemoryInit):
        slots = [self.var_for_witness(w) for w in op.init]
        real_len = len(slots)
        size = max(2, 1 << (real_len - 1).bit_length())
        while len(slots) < size:
            slots.append(self.builder.zero)  # pad (memory_translator.rs:141-151)
        self.memory_blocks[op.block_id] = MemoryBlock(slots, real_len)

    def _index_bits(self, block: MemoryBlock, index_var: int) -> List[int]:
        b = self.builder
        nbits = max(1, len(block.slots).bit_length() - 1)
        bits = b.split_le(index_var, nbits)
        # restrict index <= real_len - 1 (memory_translator.rs:55-83):
        # (real_len - 1) - index must fit in nbits
        if block.real_len < len(block.slots):
            diff = b.lincomb([(P - 1, index_var)], block.real_len - 1)
            b.split_le(diff, nbits)
        return bits

    def _memory_op(self, op: ir.MemoryOp):
        block = self.memory_blocks[op.block_id]
        b = self.builder
        kind = self.expr_const(op.op.operation)
        assert kind in (0, 1), "memory operation must be const read(0)/write(1)"
        index_var = self.expr_to_var(op.op.index)
        value_var = self.expr_to_var(op.op.value)
        bits = self._index_bits(block, index_var)
        if kind == 0:
            # read: mux tree (role of the reference's random_access gate,
            # memory_translator.rs:115-125)
            level = block.slots
            for bit in bits:
                level = [b.select(bit, level[2 * i + 1], level[2 * i])
                         for i in range(len(level) // 2)]
            b.assert_equal(level[0], value_var)
        else:
            # write: rebuild the whole block, O(block_len) like the
            # reference (memory_translator.rs:89-112), via a one-hot mux
            # built LSB-first so onehot[j] selects slot j directly
            onehot = [b.one]
            for bit in bits:
                nb_ = b.bit_not(bit)
                onehot = ([b.mul(v, nb_) for v in onehot] +
                          [b.mul(v, bit) for v in onehot])
            block.slots = [b.select(oh, value_var, old)
                           for oh, old in zip(onehot, block.slots)]

    # -- heavy black boxes (separate gadget modules) ------------------------------------

    def _sha256_compression(self, op: ir.BlackBoxSha256Compression):
        from ..ops.sha256 import translate_sha256_compression
        translate_sha256_compression(self, op)

    def _ecdsa(self, op: ir.BlackBoxEcdsaSecp256k1):
        from ..ops.ecdsa import translate_ecdsa_secp256k1
        translate_ecdsa_secp256k1(self, op)

    # -- witness extraction (prove_action.rs:102-117) --------------------------------------

    def external_values(self, witness_map: Dict[int, int]) -> np.ndarray:
        out = np.zeros(len(self.external_witness_order), dtype=np.uint64)
        for i, w in enumerate(self.external_witness_order):
            out[i] = witness_map.get(w, 0) % P
        return out


def check_linked_outputs(tr: AcirTranslator, compiled,
                         circuit: ir.Circuit) -> None:
    """Structural anti-false-positive check (the reference's
    check_linked_output_targets_property, tests/factories/utils.rs:29-53):
    every ACIR return/public witness must map to a variable that occupies
    at least one wire slot on a row where a selector actually touches that
    slot — i.e. the output is CONSTRAINED, not a dangling variable whose
    value the prover may choose freely.  Raises AssertionError otherwise."""
    from ..circuit.builder import NUM_WIRES, SEL_Q0, SEL_QM0, SEL_QLK
    sel = compiled.selectors
    wv = compiled.wire_vars
    constrained = set()
    for col in range(NUM_WIRES):
        touched = (sel[SEL_Q0 + col] != 0) | (sel[SEL_QM0 + col // 2] != 0) \
            | (sel[SEL_QLK] != 0)
        constrained.update(np.unique(wv[col][touched]).tolist())
    outputs = sorted(set(circuit.return_values) | set(circuit.public_parameters))
    for w in outputs:
        assert w in tr.witness_to_var, \
            f"output witness {w} never reached the translator"
        v = tr.witness_to_var[w]
        assert v in constrained, \
            f"output witness {w} (var {v}) is not bound to any constrained " \
            f"wire slot — translation dropped its binding"


def translate_program(program: ir.Program) -> AcirTranslator:
    """Translate function 0, like the reference (prove_action.rs:33).

    Circuits containing a heavy black box (SHA-256 compression / ECDSA —
    the reference's gadget-library consumers, SURVEY.md C10-C11) get the
    16-bit LogUp range table; small circuits skip it so their traces stay
    below 2^16 rows."""
    heavy = any(isinstance(op, (ir.BlackBoxSha256Compression,
                                ir.BlackBoxEcdsaSecp256k1))
                for op in program.functions[0].opcodes)
    tr = AcirTranslator(lookup_bits=16 if heavy else 0)
    tr.translate(program.functions[0])
    return tr
