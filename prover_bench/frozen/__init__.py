"""Frozen copies of the port's host modules, for the benchmark's reference.

The benchmark's reference must not import the program it judges, and a
later change to the program must not change the yardstick.  So the modules
the reference needs are copied here as they stood when the benchmark was
written: the ACIR codec and translator, the circuit builder, the SHA-256
gadget and the ECDSA secp256k1 gadgets (``ops/``: ``sha256``; ``bigint``,
``glv``, ``secp256k1``, ``ecdsa``, each saying the commit it was copied
at), the python-int transcript, the proof containers, their
byte codecs, the proof compressor and the verifier.  The field arithmetic
is the plain torch twins' (``field/gl_plain.py``, ``field/ext_plain.py``,
``field/poseidon.py``), on the CPU or on the card, never a kernel of the
port.  ``circuit/shape.py`` and ``prover/merkle.py`` are the only modules
written for the benchmark: the part of ``compile_circuit`` that fixes the
circuit's layout, and the Merkle path check with a plain commitment.
"""
