"""lctvqa_torch: the PyTorch and CUDA port of lctvqa for NVIDIA Hopper.

The JAX package `lctvqa` stays the reference; modules here mirror its
names. Host-side modules of `lctvqa` that never import JAX (config,
text, the artifact reader and writer) are imported, not copied. This
package imports no JAX.

Ported so far: the serving path over an exported artifact (W model and
EF model with the fixed VGG19 encoder) and its four LSTM-family kernels
in CUDA (`csrc/`).
"""
