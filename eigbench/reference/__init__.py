"""Plain PyTorch references of what the cells compute.

Nothing here imports the port, JAX or the JAX package.
"""
