"""Models of the port: shared layers, parameter trees, the LM transformer family, GraphSAGE and the recsys rankers."""
