"""The plain reference that the check holds the port to: plain PyTorch,
float32, importing nothing of the port or of JAX."""
