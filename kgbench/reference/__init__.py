"""The plain reference that decides ``correct``: ULTRA (arXiv 2310.04562) and
classic NBFNet (arXiv 2106.06935) written out in plain PyTorch from their
published equations, from the triples and weights that the benchmark makes.

It imports nothing of the program: it builds its own relation graph,
inverse edges, degrees, easy-edge masks and filter sets, runs its towers in
blocks of queries and of edges so that it fits beside the program on one
card, and follows the program's first training steps with its own
optimizer. ``common.Precision`` runs every matrix product in fp32 or, for
the control, with its operands rounded to TF32.
"""
