"""PyTorch and CUDA port of ``deeplearningexamples_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports torch, numpy
and the standard library only. Its hand-written kernels live in ``csrc/`` and
are built at first use (``ops/_build.py``).

Ported: every command of the JAX CLI (``python -m
deeplearningexamples_tpu_torch.cli <command>``), the serving recipes behind
the continuous batcher and HTTP server, the model repository, the hub
(``hub.py``) and the tools; int8 quantization with ``int8_matmul``, the
``fused_lamb`` optimizer and DLRM's hot-row gather. The flash-attention
forward and backward, the flat LAMB, DLRM's embedding row gather and
hot-row gather and the stochastic int8 quantization are CUDA kernels.
"""
