"""ACIR data model (acir 0.47 generation) as plain Python dataclasses.

This is our own implementation of the ACIR types the reference consumes via
the `acir` crate (type aliases at plonky2-backend/src/
circuit_translation/mod.rs:42-47).  Field values are canonical python ints
mod Goldilocks p; witnesses are ints.

Only the opcode payloads the backend acts on are modeled richly
(AssertZero, MemoryInit/Op, BlackBox RANGE/AND/XOR/Sha256Compression/
EcdsaSecp256k1); BrilligCall / Directive / Call are carried opaquely enough
to round-trip, since the reference deliberately ignores them in translation
(mod.rs:98-104).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Witness indices are plain ints.


@dataclass(frozen=True)
class Expression:
    """q_c + Σ q·w_l·w_r + Σ q·w  (acir native_types::Expression)."""
    mul_terms: Tuple[Tuple[int, int, int], ...] = ()  # (coeff, wl, wr)
    linear_combinations: Tuple[Tuple[int, int], ...] = ()  # (coeff, w)
    q_c: int = 0

    @staticmethod
    def constant(c: int) -> "Expression":
        return Expression((), (), c)

    @staticmethod
    def from_witness(w: int) -> "Expression":
        return Expression((), ((1, w),), 0)


@dataclass(frozen=True)
class FunctionInput:
    witness: int
    num_bits: int


@dataclass(frozen=True)
class MemOp:
    """operation: 0 = read, 1 = write (each an Expression, usually const)."""
    operation: Expression
    index: Expression
    value: Expression


# --- Opcodes -----------------------------------------------------------------


@dataclass(frozen=True)
class AssertZero:
    expr: Expression


@dataclass(frozen=True)
class BlackBoxRange:
    input: FunctionInput


@dataclass(frozen=True)
class BlackBoxAnd:
    lhs: FunctionInput
    rhs: FunctionInput
    output: int


@dataclass(frozen=True)
class BlackBoxXor:
    lhs: FunctionInput
    rhs: FunctionInput
    output: int


@dataclass(frozen=True)
class BlackBoxSha256Compression:
    inputs: Tuple[FunctionInput, ...]  # 16 message words (u32)
    hash_values: Tuple[FunctionInput, ...]  # 8 state words (u32)
    outputs: Tuple[int, ...]  # 8 output witnesses


@dataclass(frozen=True)
class BlackBoxEcdsaSecp256k1:
    public_key_x: Tuple[FunctionInput, ...]  # 32 bytes
    public_key_y: Tuple[FunctionInput, ...]  # 32 bytes
    signature: Tuple[FunctionInput, ...]  # 64 bytes (r || s)
    hashed_message: Tuple[FunctionInput, ...]  # 32 bytes
    output: int


@dataclass(frozen=True)
class BlackBoxOther:
    """Unsupported blackbox call carried as (variant index, raw payload)."""
    variant: int
    raw: bytes


@dataclass(frozen=True)
class Directive:
    """ToLeRadix — ignored by translation (reference mod.rs:104)."""
    a: Expression
    b: Tuple[int, ...]
    radix: int


@dataclass(frozen=True)
class MemoryOp:
    block_id: int
    op: MemOp
    predicate: Optional[Expression] = None


@dataclass(frozen=True)
class MemoryInit:
    block_id: int
    init: Tuple[int, ...]
    block_type: int = 0  # 0 Memory, 1 CallData(u32 stored aside), 2 ReturnData
    calldata_id: int = 0


@dataclass(frozen=True)
class BrilligCall:
    """Ignored by translation (reference mod.rs:98-103) but fully decoded.

    inputs items: ("single", Expression) | ("array", (Expression, ...)) |
    ("memory", block_id).  outputs items: ("simple", w) | ("array", (w, ...)).
    """
    id: int
    inputs: Tuple[Tuple, ...] = ()
    outputs: Tuple[Tuple, ...] = ()
    predicate: Optional[Expression] = None


@dataclass(frozen=True)
class Call:
    id: int
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    predicate: Optional[Expression] = None


# --- Circuit / Program / Witness ---------------------------------------------


@dataclass
class Circuit:
    current_witness_index: int = 0
    opcodes: List[object] = field(default_factory=list)
    expression_width: Optional[int] = None  # None = Unbounded, int = Bounded
    private_parameters: Tuple[int, ...] = ()
    public_parameters: Tuple[int, ...] = ()
    return_values: Tuple[int, ...] = ()
    assert_messages: Tuple[Tuple[object, object], ...] = ()
    recursive: bool = False


@dataclass
class Program:
    functions: List[Circuit] = field(default_factory=list)
    # Brillig bytecode of unconstrained functions: opaque tail (never used in
    # constrained translation; the reference ignores BrilligCall anyway).
    unconstrained_raw: bytes = b"\x00" * 8  # bincode: empty Vec (u64 len 0)


@dataclass
class StackItem:
    index: int
    witness: dict  # {witness_index: field_value}


@dataclass
class WitnessStack:
    stack: List[StackItem] = field(default_factory=list)

    def peek(self) -> StackItem:
        """Reference pops the top item (prove_action.rs:102-117)."""
        return self.stack[-1]
