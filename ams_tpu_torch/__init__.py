"""AMS on PyTorch and CUDA: the port of ``ams_tpu`` to an NVIDIA H100.

The package mirrors ``ams_tpu``'s layout (``models``, ``ops``, ``stream``,
``runtime``, ``utils``, ``distill``) so each module's counterpart is found
under the same path.  It imports neither JAX nor ``ams_tpu``; the numpy-only
modules it needs are copied in, and the tests hold the copies equal.

Ported: the edge client (f32 and bf16, BN-folded, with the fused MBConv
kernels), the server's distillation round (f32 and bf16, with the fused
resize+CE kernel), the emulated experiment (``cli/run.py``), the teacher
and its labeler (``cli/extract_labels.py``), the live runtime
(``cli/serve.py`` and ``cli/edge.py``) and the multi-device paths
(``parallel``: the multi-video round and server, the minibatch-parallel
round over ``torch.distributed``, the sharded labeler), and the rest:
the legacy builders (``compat``), TF1 checkpoints read without
TensorFlow, the converter (``cli/convert.py``), the native delta codec
(``native``), TF32 rounds and the space-to-depth stem.  The kernels are
in ``csrc/``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; ROADMAP.md lists what is not ported.
"""

__version__ = "0.1.0"
