"""The plain reference of the benchmark: the mathematics of each cell in
plain PyTorch, in a precision the caller picks, from the inputs the
benchmark made and the configuration file's own numbers.

It imports nothing of the program under test (``diffco_tpu_torch``) and
nothing of JAX. What the program derived in its set-up or timed path
(features, labels, weights, optimizer state) is worked out here again.
"""
