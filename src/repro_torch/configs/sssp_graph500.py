"""Graph500 SSSP edge weights, the port's copy of the JAX package's
``repro/configs/sssp_graph500.py`` constants.

The Graph500 SSSP specification reuses the BFS Kronecker generator and
draws one uniform weight per undirected edge on (0, 1]; the 2^-8 floor keeps
every weight strictly positive, so no zero-weight ties reach the parent
validation.
"""
WEIGHT_LOW = 1.0 / 256.0
WEIGHT_HIGH = 1.0
