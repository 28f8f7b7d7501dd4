"""Models: GCN, GIN, EGNN and NequIP (``models.gnn``), DLRM with the
embedding-bag kernel (``models.dlrm``), and the decoder-only language
models (``models.transformer`` over ``models.layers`` and
``models.moe``); the sharding layer (``models.sharding``) lays the
language models and DLRM's tables over a mesh of ranks."""
