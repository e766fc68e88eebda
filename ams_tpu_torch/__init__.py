"""AMS on PyTorch and CUDA: the port of ``ams_tpu`` to an NVIDIA H100.

The package mirrors ``ams_tpu``'s layout (``models``, ``ops``, ``stream``,
``runtime``, ``utils``, ``distill``) so each module's counterpart is found
under the same path.  It imports neither JAX nor ``ams_tpu``; the numpy-only
modules it needs are copied in, and the tests hold the copies equal.

Ported so far: the deployed edge client's serving path (delta apply,
unfolded and BN-folded inference, per-frame scoring) with the
resize+argmax kernel in ``csrc/resize_argmax.cu``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
