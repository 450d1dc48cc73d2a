"""The plain reference that decides `correct`: plain PyTorch and NumPy.
It imports nothing of the program, of the JAX package or of JAX, and
takes nothing that the program made: it works out again from the
benchmark's inputs whatever it compares."""
