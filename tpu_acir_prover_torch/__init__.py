"""PyTorch + CUDA port of the per-phase prover.

A field element is one ``int64`` tensor element holding the canonical u64
bits of a Goldilocks value; an extension element is a ``(re, im)`` pair of
such tensors.  The host modules (ACIR codec and translator, circuit
compiler, native witness core, transcript, serialization, compression,
verifier) are copies of the JAX package's, under the same module names; the
port imports nothing of ``tpu_acir_prover`` and nothing of JAX.
"""
