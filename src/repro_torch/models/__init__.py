"""Models on the SlimSell layout: GCN (``models.gnn``)."""
