"""The plain reference: the same functions as the program, in plain
PyTorch, written from the definitions and not from the program's code.

It imports neither ``jax`` nor the JAX package nor anything of
``audio_tokens_tpu_torch``, and takes nothing the program made: the
benchmark hands it the same inputs and weights it hands the program, and
it works out again what the program derives from them.  Every product
goes through ``precision.matmul``, so that one argument computes the
reference in float64 or in a lower precision (the control).
"""
