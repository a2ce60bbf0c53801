"""Model-level ops and the CUDA kernel wrappers."""
