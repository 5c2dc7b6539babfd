"""gordo-components-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside ``gordo_components_tpu`` (the JAX reference, which
it never imports). It loads the reference's pickle-free artifacts, trains
and writes them (:mod:`gordo_components_tpu_torch.builder`), and serves
``POST /anomaly/prediction`` through the same scoring math; every
Pallas kernel on a ported path is a hand-written CUDA kernel here
(``csrc/``), with a plain PyTorch version beside it.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that explicit choice they
raise (see :func:`gordo_components_tpu_torch.utils.backend.resolve_device`).
"""

__version__ = "0.1.0"
