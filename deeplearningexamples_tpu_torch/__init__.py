"""PyTorch and CUDA port of ``deeplearningexamples_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports torch, numpy
and the standard library only. Its hand-written kernels live in ``csrc/`` and
are built at first use (``ops/_build.py``).

Ported so far: BERT-Large question answering, served through the continuous
batcher and HTTP server and through ``predict_squad``; BERT-Large pretraining
and DLRM training through the CLI (``python -m deeplearningexamples_tpu_torch.cli
bert-pretrain|dlrm``). The flash-attention forward and backward, the flat
LAMB and DLRM's embedding row gather are CUDA kernels.
"""
