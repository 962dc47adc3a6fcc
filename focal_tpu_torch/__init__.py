"""PyTorch/CUDA port of FOCAL for NVIDIA Hopper (H100).

A second package beside the JAX reference (``focal_tpu``): it mirrors that
package's layout and names (``ops/``, ``models/``, ``serve.py``,
``predict.py``) and imports neither JAX nor anything of ``focal_tpu``.
Every TPU kernel on a ported path is a kernel written by hand for
``sm_90a`` under ``csrc/``, built with ``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""
