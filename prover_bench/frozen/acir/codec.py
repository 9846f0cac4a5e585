"""ACIR wire-format codec: bincode (legacy fixint) + gzip + base64 JSON artifact.

Implements both directions of the format the reference consumes/produces at
its serialization boundary (plonky2-backend/src/
noir_and_plonky2_serialization.rs:42-64):

  program artifact:  JSON {"bytecode": base64( gzip( bincode(Program) ) ), ...}
  witness file:      gzip( bincode(WitnessStack) )

bincode legacy encoding rules used by the acir crates: little-endian
fixed-width ints, u64 sequence lengths, u32 enum discriminants, u8 Option
tags/bools; acir FieldElements serialize as lowercase big-endian hex strings.
Having our own serializer lets tests round-trip golden programs without the
Rust toolchain (the reference generates its fixtures by running the forked
nargo, which is unavailable here — SURVEY.md §4).
"""

from __future__ import annotations

import base64
import gzip
import io
import json
import struct

from ..field.gl import P
from . import ir


class AcirDecodeError(ValueError):
    pass


# --- primitive reader/writer --------------------------------------------------


class Reader:
    def __init__(self, data: bytes):
        self.b = data
        self.o = 0

    def take(self, n: int) -> bytes:
        if self.o + n > len(self.b):
            raise AcirDecodeError(
                f"unexpected end of stream (need {n} bytes at offset {self.o})")
        out = self.b[self.o:self.o + n]
        self.o += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def usize(self) -> int:
        return self.u64()

    def seq_len(self) -> int:
        n = self.u64()
        if n > 1 << 32:
            raise AcirDecodeError(f"implausible sequence length {n}")
        return n

    def string(self) -> str:
        return self.take(self.seq_len()).decode("utf-8")

    def boolean(self) -> bool:
        v = self.u8()
        if v > 1:
            raise AcirDecodeError(f"invalid bool byte {v}")
        return bool(v)

    def option(self, f):
        return f() if self.boolean() else None

    def field(self) -> int:
        """acir FieldElement: hex string, big-endian."""
        s = self.string()
        if s == "":
            return 0
        v = int(s, 16)
        return v % P

    def witness(self) -> int:
        return self.u32()

    def done(self) -> bool:
        return self.o == len(self.b)


class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def raw(self, b: bytes):
        self.buf.write(b)

    def u8(self, v: int):
        self.buf.write(bytes([v]))

    def u32(self, v: int):
        self.buf.write(struct.pack("<I", v))

    def u64(self, v: int):
        self.buf.write(struct.pack("<Q", v))

    usize = u64
    seq_len = u64

    def string(self, s: str):
        b = s.encode("utf-8")
        self.seq_len(len(b))
        self.raw(b)

    def boolean(self, v: bool):
        self.u8(1 if v else 0)

    def option(self, v, f):
        self.boolean(v is not None)
        if v is not None:
            f(v)

    def field(self, v: int):
        self.string(f"{v % P:016x}")

    witness = u32

    def bytes_out(self) -> bytes:
        return self.buf.getvalue()


# --- Expression ----------------------------------------------------------------


def read_expression(r: Reader) -> ir.Expression:
    mul = tuple((r.field(), r.witness(), r.witness()) for _ in range(r.seq_len()))
    lin = tuple((r.field(), r.witness()) for _ in range(r.seq_len()))
    q_c = r.field()
    return ir.Expression(mul, lin, q_c)


def write_expression(w: Writer, e: ir.Expression):
    w.seq_len(len(e.mul_terms))
    for c, wl, wr in e.mul_terms:
        w.field(c)
        w.witness(wl)
        w.witness(wr)
    w.seq_len(len(e.linear_combinations))
    for c, wi in e.linear_combinations:
        w.field(c)
        w.witness(wi)
    w.field(e.q_c)


def read_function_input(r: Reader) -> ir.FunctionInput:
    return ir.FunctionInput(r.witness(), r.u32())


def write_function_input(w: Writer, fi: ir.FunctionInput):
    w.witness(fi.witness)
    w.u32(fi.num_bits)


# --- BlackBoxFuncCall ------------------------------------------------------------
# Variant table for the acir 0.47 generation (order = enum discriminants).
# Payload mini-schema: fi FunctionInput, w Witness, u32, vec_*/arr_*:N, ww pair.

BLACKBOX_SCHEMAS = {
    0: ("AES128Encrypt", [("inputs", "vec_fi"), ("iv", "arr_fi:16"),
                          ("key", "arr_fi:16"), ("outputs", "vec_w")]),
    1: ("AND", [("lhs", "fi"), ("rhs", "fi"), ("output", "w")]),
    2: ("XOR", [("lhs", "fi"), ("rhs", "fi"), ("output", "w")]),
    3: ("RANGE", [("input", "fi")]),
    4: ("SHA256", [("inputs", "vec_fi"), ("outputs", "arr_w:32")]),
    5: ("Blake2s", [("inputs", "vec_fi"), ("outputs", "arr_w:32")]),
    6: ("Blake3", [("inputs", "vec_fi"), ("outputs", "arr_w:32")]),
    7: ("SchnorrVerify", [("public_key_x", "fi"), ("public_key_y", "fi"),
                          ("signature", "arr_fi:64"), ("message", "vec_fi"),
                          ("output", "w")]),
    8: ("PedersenCommitment", [("inputs", "vec_fi"), ("domain_separator", "u32"),
                               ("outputs", "ww")]),
    9: ("PedersenHash", [("inputs", "vec_fi"), ("domain_separator", "u32"),
                         ("output", "w")]),
    10: ("EcdsaSecp256k1", [("public_key_x", "arr_fi:32"),
                            ("public_key_y", "arr_fi:32"),
                            ("signature", "arr_fi:64"),
                            ("hashed_message", "arr_fi:32"), ("output", "w")]),
    11: ("EcdsaSecp256r1", [("public_key_x", "arr_fi:32"),
                            ("public_key_y", "arr_fi:32"),
                            ("signature", "arr_fi:64"),
                            ("hashed_message", "arr_fi:32"), ("output", "w")]),
    12: ("MultiScalarMul", [("points", "vec_fi"), ("scalars", "vec_fi"),
                            ("outputs", "www")]),
    13: ("EmbeddedCurveAdd", [("input1", "arr_fi:3"), ("input2", "arr_fi:3"),
                              ("outputs", "www")]),
    14: ("Keccak256", [("inputs", "vec_fi"), ("var_message_size", "fi"),
                       ("outputs", "arr_w:32")]),
    15: ("Keccakf1600", [("inputs", "arr_fi:25"), ("outputs", "arr_w:25")]),
    16: ("RecursiveAggregation", [("verification_key", "vec_fi"),
                                  ("proof", "vec_fi"),
                                  ("public_inputs", "vec_fi"),
                                  ("key_hash", "fi")]),
    17: ("BigIntAdd", [("lhs", "u32"), ("rhs", "u32"), ("output", "u32")]),
    18: ("BigIntSub", [("lhs", "u32"), ("rhs", "u32"), ("output", "u32")]),
    19: ("BigIntMul", [("lhs", "u32"), ("rhs", "u32"), ("output", "u32")]),
    20: ("BigIntDiv", [("lhs", "u32"), ("rhs", "u32"), ("output", "u32")]),
    21: ("BigIntFromLeBytes", [("inputs", "vec_fi"), ("modulus", "vec_u8"),
                               ("output", "u32")]),
    22: ("BigIntToLeBytes", [("input", "u32"), ("outputs", "vec_w")]),
    23: ("Poseidon2Permutation", [("inputs", "vec_fi"), ("outputs", "vec_w"),
                                  ("len", "u32")]),
    24: ("Sha256Compression", [("inputs", "arr_fi:16"), ("hash_values", "arr_fi:8"),
                               ("outputs", "arr_w:8")]),
}

BLACKBOX_VARIANT_BY_NAME = {name: k for k, (name, _) in BLACKBOX_SCHEMAS.items()}


def _read_schema_field(r: Reader, ty: str):
    if ty == "fi":
        return read_function_input(r)
    if ty == "w":
        return r.witness()
    if ty == "u32":
        return r.u32()
    if ty == "ww":
        return (r.witness(), r.witness())
    if ty == "www":
        return (r.witness(), r.witness(), r.witness())
    if ty == "vec_fi":
        return tuple(read_function_input(r) for _ in range(r.seq_len()))
    if ty == "vec_w":
        return tuple(r.witness() for _ in range(r.seq_len()))
    if ty == "vec_u8":
        return tuple(r.u8() for _ in range(r.seq_len()))
    if ty.startswith("arr_fi:"):
        return tuple(read_function_input(r) for _ in range(int(ty[7:])))
    if ty.startswith("arr_w:"):
        return tuple(r.witness() for _ in range(int(ty[6:])))
    raise AssertionError(ty)


def _write_schema_field(w: Writer, ty: str, v):
    if ty == "fi":
        write_function_input(w, v)
    elif ty == "w" or ty == "u32":
        w.u32(v)
    elif ty in ("ww", "www"):
        for x in v:
            w.witness(x)
    elif ty == "vec_fi":
        w.seq_len(len(v))
        for x in v:
            write_function_input(w, x)
    elif ty == "vec_w":
        w.seq_len(len(v))
        for x in v:
            w.witness(x)
    elif ty == "vec_u8":
        w.seq_len(len(v))
        for x in v:
            w.u8(x)
    elif ty.startswith("arr_fi:"):
        assert len(v) == int(ty[7:])
        for x in v:
            write_function_input(w, x)
    elif ty.startswith("arr_w:"):
        assert len(v) == int(ty[6:])
        for x in v:
            w.witness(x)
    else:
        raise AssertionError(ty)


def read_blackbox(r: Reader):
    variant = r.u32()
    if variant not in BLACKBOX_SCHEMAS:
        raise AcirDecodeError(f"unknown BlackBoxFuncCall variant {variant}")
    name, schema = BLACKBOX_SCHEMAS[variant]
    fields = {fname: _read_schema_field(r, fty) for fname, fty in schema}
    if name == "RANGE":
        return ir.BlackBoxRange(fields["input"])
    if name == "AND":
        return ir.BlackBoxAnd(fields["lhs"], fields["rhs"], fields["output"])
    if name == "XOR":
        return ir.BlackBoxXor(fields["lhs"], fields["rhs"], fields["output"])
    if name == "Sha256Compression":
        return ir.BlackBoxSha256Compression(
            fields["inputs"], fields["hash_values"], fields["outputs"])
    if name == "EcdsaSecp256k1":
        return ir.BlackBoxEcdsaSecp256k1(
            fields["public_key_x"], fields["public_key_y"],
            fields["signature"], fields["hashed_message"], fields["output"])
    # Decoded but unsupported by translation: re-encode payload for round-trip.
    pw = Writer()
    for fname, fty in schema:
        _write_schema_field(pw, fty, fields[fname])
    return ir.BlackBoxOther(variant, pw.bytes_out())


def write_blackbox(w: Writer, bb):
    if isinstance(bb, ir.BlackBoxRange):
        w.u32(BLACKBOX_VARIANT_BY_NAME["RANGE"])
        write_function_input(w, bb.input)
    elif isinstance(bb, ir.BlackBoxAnd) or isinstance(bb, ir.BlackBoxXor):
        w.u32(BLACKBOX_VARIANT_BY_NAME["AND" if isinstance(bb, ir.BlackBoxAnd) else "XOR"])
        write_function_input(w, bb.lhs)
        write_function_input(w, bb.rhs)
        w.witness(bb.output)
    elif isinstance(bb, ir.BlackBoxSha256Compression):
        w.u32(BLACKBOX_VARIANT_BY_NAME["Sha256Compression"])
        for fi in bb.inputs:
            write_function_input(w, fi)
        for fi in bb.hash_values:
            write_function_input(w, fi)
        for wit in bb.outputs:
            w.witness(wit)
    elif isinstance(bb, ir.BlackBoxEcdsaSecp256k1):
        w.u32(BLACKBOX_VARIANT_BY_NAME["EcdsaSecp256k1"])
        for group in (bb.public_key_x, bb.public_key_y, bb.signature,
                      bb.hashed_message):
            for fi in group:
                write_function_input(w, fi)
        w.witness(bb.output)
    elif isinstance(bb, ir.BlackBoxOther):
        w.u32(bb.variant)
        w.raw(bb.raw)
    else:
        raise TypeError(f"not a blackbox call: {bb!r}")


# --- Opcode ---------------------------------------------------------------------

OP_ASSERT_ZERO = 0
OP_BLACKBOX = 1
OP_DIRECTIVE = 2
OP_MEMORY_OP = 3
OP_MEMORY_INIT = 4
OP_BRILLIG_CALL = 5
OP_CALL = 6


def read_opcode(r: Reader):
    variant = r.u32()
    if variant == OP_ASSERT_ZERO:
        return ir.AssertZero(read_expression(r))
    if variant == OP_BLACKBOX:
        return read_blackbox(r)
    if variant == OP_DIRECTIVE:
        dv = r.u32()  # Directive enum: 0 = ToLeRadix
        if dv != 0:
            raise AcirDecodeError(f"unknown Directive variant {dv}")
        a = read_expression(r)
        b = tuple(r.witness() for _ in range(r.seq_len()))
        radix = r.u32()
        return ir.Directive(a, b, radix)
    if variant == OP_MEMORY_OP:
        block_id = r.u32()
        op = ir.MemOp(read_expression(r), read_expression(r), read_expression(r))
        predicate = r.option(lambda: read_expression(r))
        return ir.MemoryOp(block_id, op, predicate)
    if variant == OP_MEMORY_INIT:
        block_id = r.u32()
        init = tuple(r.witness() for _ in range(r.seq_len()))
        bt = r.u32()  # BlockType: 0 Memory, 1 CallData(u32), 2 ReturnData
        calldata_id = r.u32() if bt == 1 else 0
        return ir.MemoryInit(block_id, init, bt, calldata_id)
    if variant == OP_BRILLIG_CALL:
        bid = r.u32()
        inputs = []
        for _ in range(r.seq_len()):
            iv = r.u32()
            if iv == 0:
                inputs.append(("single", read_expression(r)))
            elif iv == 1:
                inputs.append(("array", tuple(read_expression(r)
                                              for _ in range(r.seq_len()))))
            elif iv == 2:
                inputs.append(("memory", r.u32()))
            else:
                raise AcirDecodeError(f"unknown BrilligInputs variant {iv}")
        outputs = []
        for _ in range(r.seq_len()):
            ov = r.u32()
            if ov == 0:
                outputs.append(("simple", r.witness()))
            elif ov == 1:
                outputs.append(("array", tuple(r.witness()
                                               for _ in range(r.seq_len()))))
            else:
                raise AcirDecodeError(f"unknown BrilligOutputs variant {ov}")
        predicate = r.option(lambda: read_expression(r))
        return ir.BrilligCall(bid, tuple(inputs), tuple(outputs), predicate)
    if variant == OP_CALL:
        cid = r.u32()
        inputs = tuple(r.witness() for _ in range(r.seq_len()))
        outputs = tuple(r.witness() for _ in range(r.seq_len()))
        predicate = r.option(lambda: read_expression(r))
        return ir.Call(cid, inputs, outputs, predicate)
    raise AcirDecodeError(f"unknown Opcode variant {variant}")


def write_opcode(w: Writer, op):
    if isinstance(op, ir.AssertZero):
        w.u32(OP_ASSERT_ZERO)
        write_expression(w, op.expr)
    elif isinstance(op, (ir.BlackBoxRange, ir.BlackBoxAnd, ir.BlackBoxXor,
                         ir.BlackBoxSha256Compression, ir.BlackBoxEcdsaSecp256k1,
                         ir.BlackBoxOther)):
        w.u32(OP_BLACKBOX)
        write_blackbox(w, op)
    elif isinstance(op, ir.Directive):
        w.u32(OP_DIRECTIVE)
        w.u32(0)
        write_expression(w, op.a)
        w.seq_len(len(op.b))
        for wit in op.b:
            w.witness(wit)
        w.u32(op.radix)
    elif isinstance(op, ir.MemoryOp):
        w.u32(OP_MEMORY_OP)
        w.u32(op.block_id)
        write_expression(w, op.op.operation)
        write_expression(w, op.op.index)
        write_expression(w, op.op.value)
        w.option(op.predicate, lambda p: write_expression(w, p))
    elif isinstance(op, ir.MemoryInit):
        w.u32(OP_MEMORY_INIT)
        w.u32(op.block_id)
        w.seq_len(len(op.init))
        for wit in op.init:
            w.witness(wit)
        w.u32(op.block_type)
        if op.block_type == 1:
            w.u32(op.calldata_id)
    elif isinstance(op, ir.BrilligCall):
        w.u32(OP_BRILLIG_CALL)
        w.u32(op.id)
        w.seq_len(len(op.inputs))
        for kind, val in op.inputs:
            if kind == "single":
                w.u32(0)
                write_expression(w, val)
            elif kind == "array":
                w.u32(1)
                w.seq_len(len(val))
                for e in val:
                    write_expression(w, e)
            else:
                w.u32(2)
                w.u32(val)
        w.seq_len(len(op.outputs))
        for kind, val in op.outputs:
            if kind == "simple":
                w.u32(0)
                w.witness(val)
            else:
                w.u32(1)
                w.seq_len(len(val))
                for wit in val:
                    w.witness(wit)
        w.option(op.predicate, lambda p: write_expression(w, p))
    elif isinstance(op, ir.Call):
        w.u32(OP_CALL)
        w.u32(op.id)
        w.seq_len(len(op.inputs))
        for wit in op.inputs:
            w.witness(wit)
        w.seq_len(len(op.outputs))
        for wit in op.outputs:
            w.witness(wit)
        w.option(op.predicate, lambda p: write_expression(w, p))
    else:
        raise TypeError(f"not an opcode: {op!r}")


# --- Circuit / Program ------------------------------------------------------------


def _read_assert_message(r: Reader):
    # (OpcodeLocation, AssertionPayload)
    lv = r.u32()
    if lv == 0:
        loc = ("acir", r.usize())
    elif lv == 1:
        loc = ("brillig", r.usize(), r.usize())
    else:
        raise AcirDecodeError(f"unknown OpcodeLocation variant {lv}")
    pv = r.u32()
    if pv == 0:
        payload = ("static", r.string())
    elif pv == 1:
        selector = r.u64()
        items = []
        for _ in range(r.seq_len()):
            ev = r.u32()
            if ev == 0:
                items.append(("expr", read_expression(r)))
            elif ev == 1:
                items.append(("memory", r.u32()))
            else:
                raise AcirDecodeError(f"unknown ExpressionOrMemory variant {ev}")
        payload = ("dynamic", selector, tuple(items))
    else:
        raise AcirDecodeError(f"unknown AssertionPayload variant {pv}")
    return (loc, payload)


def _write_assert_message(w: Writer, msg):
    loc, payload = msg
    if loc[0] == "acir":
        w.u32(0)
        w.usize(loc[1])
    else:
        w.u32(1)
        w.usize(loc[1])
        w.usize(loc[2])
    if payload[0] == "static":
        w.u32(0)
        w.string(payload[1])
    else:
        w.u32(1)
        w.u64(payload[1])
        w.seq_len(len(payload[2]))
        for kind, val in payload[2]:
            if kind == "expr":
                w.u32(0)
                write_expression(w, val)
            else:
                w.u32(1)
                w.u32(val)


def read_circuit(r: Reader) -> ir.Circuit:
    cwi = r.u32()
    opcodes = [read_opcode(r) for _ in range(r.seq_len())]
    ew_variant = r.u32()  # ExpressionWidth: 0 Unbounded, 1 Bounded{width: usize}
    if ew_variant == 0:
        expression_width = None
    elif ew_variant == 1:
        expression_width = r.usize()
    else:
        raise AcirDecodeError(f"unknown ExpressionWidth variant {ew_variant}")
    private_parameters = tuple(r.witness() for _ in range(r.seq_len()))
    public_parameters = tuple(r.witness() for _ in range(r.seq_len()))
    return_values = tuple(r.witness() for _ in range(r.seq_len()))
    assert_messages = tuple(_read_assert_message(r) for _ in range(r.seq_len()))
    recursive = r.boolean()
    return ir.Circuit(cwi, opcodes, expression_width, private_parameters,
                      public_parameters, return_values, assert_messages, recursive)


def write_circuit(w: Writer, c: ir.Circuit):
    w.u32(c.current_witness_index)
    w.seq_len(len(c.opcodes))
    for op in c.opcodes:
        write_opcode(w, op)
    if c.expression_width is None:
        w.u32(0)
    else:
        w.u32(1)
        w.usize(c.expression_width)
    for group in (c.private_parameters, c.public_parameters, c.return_values):
        w.seq_len(len(group))
        for wit in group:
            w.witness(wit)
    w.seq_len(len(c.assert_messages))
    for msg in c.assert_messages:
        _write_assert_message(w, msg)
    w.boolean(c.recursive)


def deserialize_program(data: bytes) -> ir.Program:
    """bincode(Program) from gunzipped bytes; Brillig tail kept opaque.

    The tail (Vec<BrilligBytecode>) is carried verbatim, not parsed — but
    its 8-byte element count is validated so a truncated/corrupt artifact
    can't round-trip silently (an empty tail means "no unconstrained
    functions" and re-encodes as a zero count)."""
    r = Reader(data)
    functions = [read_circuit(r) for _ in range(r.seq_len())]
    tail = r.b[r.o:]
    if tail:
        if len(tail) < 8:
            raise AcirDecodeError(
                f"truncated unconstrained-functions tail ({len(tail)} bytes)")
        count = struct.unpack("<Q", tail[:8])[0]
        if count > 1 << 32:
            raise AcirDecodeError(
                f"implausible unconstrained-function count {count}")
        if count == 0 and len(tail) != 8:
            raise AcirDecodeError(
                f"{len(tail) - 8} trailing bytes after an empty "
                f"unconstrained-functions vec")
    return ir.Program(functions, tail if tail else b"\x00" * 8)


def serialize_program(p: ir.Program) -> bytes:
    w = Writer()
    w.seq_len(len(p.functions))
    for c in p.functions:
        write_circuit(w, c)
    w.raw(p.unconstrained_raw)
    return w.bytes_out()


# --- Witness stack -----------------------------------------------------------------


def deserialize_witness_stack(data: bytes) -> ir.WitnessStack:
    r = Reader(data)
    stack = []
    for _ in range(r.seq_len()):
        index = r.u32()
        wmap = {}
        for _ in range(r.seq_len()):
            wit = r.witness()
            wmap[wit] = r.field()
        stack.append(ir.StackItem(index, wmap))
    if not r.done():
        raise AcirDecodeError("trailing bytes after witness stack")
    return ir.WitnessStack(stack)


def serialize_witness_stack(ws: ir.WitnessStack) -> bytes:
    w = Writer()
    w.seq_len(len(ws.stack))
    for item in ws.stack:
        w.u32(item.index)
        w.seq_len(len(item.witness))
        for wit in sorted(item.witness):  # BTreeMap order
            w.witness(wit)
            w.field(item.witness[wit])
    return w.bytes_out()


# --- File-level artifact IO ----------------------------------------------------------


def load_program_artifact(path: str) -> ir.Program:
    """Read a nargo-style JSON artifact: {"bytecode": base64(gzip(bincode))}.

    Mirrors deserialize_program_within_file_path
    (noir_and_plonky2_serialization.rs:42-58).
    """
    with open(path, "r") as f:
        doc = json.load(f)
    bytecode = doc.get("bytecode")
    if not isinstance(bytecode, str):
        raise AcirDecodeError("Expected a different circuit format: no 'bytecode'")
    raw = base64.standard_b64decode(bytecode)
    return deserialize_program(gzip.decompress(raw))


def save_program_artifact(path: str, program: ir.Program, name: str = "main"):
    raw = gzip.compress(serialize_program(program), mtime=0)
    doc = {
        "noir_version": "tpu-acir-prover",
        "name": name,
        "bytecode": base64.standard_b64encode(raw).decode("ascii"),
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def load_witness_stack(path: str) -> ir.WitnessStack:
    """Read a nargo witness file: gzip(bincode(WitnessStack)).

    Mirrors deserialize_witnesses_within_file_path
    (noir_and_plonky2_serialization.rs:60-64).
    """
    with open(path, "rb") as f:
        return deserialize_witness_stack(gzip.decompress(f.read()))


def save_witness_stack(path: str, ws: ir.WitnessStack):
    with open(path, "wb") as f:
        f.write(gzip.compress(serialize_witness_stack(ws), mtime=0))
