"""The plain references: float32 PyTorch with TF32 off, one module a
family. They import nothing of the program and nothing of JAX."""
