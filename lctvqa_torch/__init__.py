"""lctvqa_torch: the PyTorch and CUDA port of lctvqa for NVIDIA Hopper.

The JAX package `lctvqa` stays the reference; modules here mirror its
names. This package imports `torch`, never `jax`, and nothing of
`lctvqa`: it keeps its own copy of what it needs from there (config,
text, genotypes, the artifact reader and writer).

Ported so far: the serving path over an exported artifact (W model, EF
model with the fixed VGG19 encoder or the PC-DARTS supernet) and six
kernels in CUDA (`csrc/`): the four LSTM-family kernels, the node-batched
mixed op and the batch-stat BatchNorm, forward.
"""

__version__ = "0.1.0"
