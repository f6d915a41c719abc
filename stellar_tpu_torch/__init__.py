"""PyTorch/CUDA port of ``stellar_tpu``'s batch ed25519 verification and
batched SHA-256.

The JAX package ``stellar_tpu`` stays the reference. This package keeps its
layout (``ops/``, ``crypto/``, ``parallel/``, ``utils/``) so each module has
a counterpart there, imports only ``torch``, ``numpy`` and the standard
library, and runs its device work through CUDA kernels written by hand for
Hopper (``csrc/verify_cold.cu``, ``csrc/verify_hot.cu``,
``csrc/sha256.cu``, ``csrc/verify_r16.cu``). Every kernel has a plain
PyTorch version beside it; a wrapper runs that plain version only for
tensors on the CPU.

The default entry points span every visible card (one card unsplit) and
raise when there is none; pass ``device="cpu"`` to run the plain versions
on the host, or ``devices=[...]`` to a ``BatchVerifier`` or
``BatchHasher`` to split each bucket over a list of devices::

    from stellar_tpu_torch.crypto.batch_verifier import default_verifier
    ok = default_verifier().verify_batch([(pk, msg, sig), ...])

    from stellar_tpu_torch.crypto.batch_hasher import hash_many
    digests = hash_many([blob, ...])
"""
