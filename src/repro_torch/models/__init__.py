"""Models: GCN on the SlimSell layout (``models.gnn``) and DLRM with the
embedding-bag kernel (``models.dlrm``)."""
